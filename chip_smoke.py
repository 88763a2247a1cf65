#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]
    python3 chip_smoke.py --ab DIR   # K3/K4 against DIR's sources, in turns
    python3 chip_smoke.py --only distributed   # build + phase 7 only
    python3 chip_smoke.py --only scenarios     # build + phase 8 only
    python3 chip_smoke.py --only lm            # build + phases 9-12 only
    python3 chip_smoke.py --only lm_train      # build + phases 13, 15 only
    python3 chip_smoke.py --only ep            # build + phase 14, 15 (e)

Run from the root of a checkout.  With ``--ab DIR`` only the build and an
A/B runs: this checkout's K3 and K4 and the ones built from
``DIR/pinn_mlp_fwd.cu`` / ``DIR/pinn_mlp_bwd.cu`` (another revision, e.g.
``git show HEAD~1:src/repro_torch/csrc/pinn_mlp_fwd.cu``), each held
against the plain versions, timed in turns (other, this, this, other) at
the training shapes of phase 3.  Otherwise, phases in order; a failure in
any of them ends the run with a non-zero exit code and no result line:

1. **build** — compile every CUDA source under ``src/repro_torch/csrc/``
   (one ``nvcc`` per source, all started together) and print the seconds,
   the registers and spill bytes of every K1-K4 instantiation (none may
   spill), and per kernel the count of
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in the built
   library's SASS (``cuobjdump -sass``): the bf16 K5 kernel must hold
   ``HGMMA``, and ``UTMALDG`` in its TMA instantiations.  Meanwhile a
   thread runs phase 15's dry runs (CPU only, nothing launched; they
   predict runs made later and are held to them there);
2. **kernels** — hold each forward kernel (K1/K2) against its plain PyTorch
   version on the card (float32, rtol = atol = 1e-5) over activations
   tanh/sin/cos, d_in 1-3, widths 20/24/40/80/128 at depths 2-5, d2
   directions all / a strict subset / none, n_sub 1 and 4, ragged point
   counts; then the training kernels: K3 (outputs and every spill, same
   tolerance) and K4 (per-leaf error scaled by max(1, max |want|) <= 1e-5,
   the reference's rule) over widths 20/24/80/128 at depths 1/4/3/5, then
   the edges of K4's partition (m = 1, a tile less one, a tile, a tile and
   one, 1120; widths 24/36/100; n_sub 1, 4 and 9, some with blocks owning
   unequal numbers of tiles), then the scenarios' shapes (the cavity's
   d_in = 2, n_out = 3 at 40 x 5 and 80 x 5 with d2 all or none; the
   us_map's ten subdomains at the rows of its example and paper
   megabatches), with K4 launched twice and held bitwise
   equal, and ``torch.autograd.grad`` through ``ops.pinn_mlp_forward2`` on
   the card against the CPU;
3. **timing** — each kernel (CUDA graph of back-to-back launches), its
   wrapper call and its plain version with CUDA events beside the shape's
   bound: K1/K2 at the serving shapes (n_sub=4, m = 64/512/4096 points per
   subdomain) and a dense grid (m = 262,144); K3/K4 at the quickstart's
   training megabatch (n_sub=4, m = 1120) at width 24 x 4 and 80 x 5;
4. **serve** — export the 2x2 space-time Burgers XPINN bundle
   (``MLPConfig(2, 1, 24, 4)``, weights from a seed) and serve it with
   ``repro_torch.launch.serve_field.main`` at ``--order 2`` and
   ``--order 1``, the kernels' launch counts set to 0 just before each run
   and read just after; then evaluate one fixed cloud (inside, interface and
   outside points) through the engine and hold it against the plain
   recurrence on the card;
5. **train** — ``repro_torch.launch.quickstart.main`` trains the same
   XPINN on the card for 1500 steps (chunks of 250), counts set to 0 just
   before and read just after: it must reach rel-L2 < 0.5 against
   Cole-Hopf with one K3 and one K4 launch per loss evaluation and no plain
   version run on a CUDA tensor; then 10 steps from one init on the card
   and on the CPU are held together, the ms per training step is taken over
   three chunks of 100 steps and split into forward kernel, backward kernel
   and everything else, and torch.profiler traces 20 steady steps: device
   busy ms, idle share, K3's and K4's device ms;
6. **runtime** — the fault-tolerant runtime (``repro_torch.runtime``) on
   the card, each run with the counts set to 0 just before and read just
   after: (a) ``quickstart.main(... --supervised --inject
   crash@1,nan_params@2:0,straggler@3*0.1)``, 1500 steps in chunks of 250,
   must report 1 crash, 1 guard trip, 2 restarts and 1 straggler, reach
   rel-L2 < 0.5, and launch K3 and K4 once per step of every chunk attempt
   (committed chunks plus rollbacks, each a whole chunk: the guarded chunk
   keeps computing frozen steps after a trip) with no plain version on a
   CUDA tensor; (b) a supervised 3 x 100-step run with a crash after chunk
   1 equals three uninterrupted chunks exactly (params and Adam moments,
   difference 0.0); (c) (a)'s checkpoint resumed at nx = 3 (4 -> 6
   subdomains) is a better start than a cold init, and 500 more supervised
   steps reach rel-L2 < 0.5; (d) ``serve_field.main --demo cart
   --max-requests 40 --faults engine-raise@3,nan-output@5,
   slow-engine@7*0.05`` at order 2 (K2) and order 1 (K1) answers every
   admitted ticket.  One ``{"runtime": ...}`` line;
7. **distributed** — Algorithm 1 with one rank per subdomain: 4 ``gloo``
   ranks (``repro_torch.launch.mesh``) share the card, each launch count
   set to 0 just before and read just after each step on every rank, the
   ranks' counts sent back to this process: (a) the quickstart problem
   for 10 steps from one init, gathered, within 1e-5 (params) and 1e-4
   relative (summed loss) of ``ReferenceTrainer`` on the card; (b) 1500
   steps in chunks of 250 to rel-L2 < 0.5 (``evaluate_l2`` on rank 0,
   K1) with exactly 1500 K3 and 1500 K4 launches per rank and no plain
   version on a CUDA tensor, then chunks of 100 steps with the exchange
   on and off in turns (on, off, off, on: ms per step, compute and
   communication), the bytes staged through the host per step, the
   ``dd-comp-forward`` / ``dd-comm-halo`` / ``dd-comp-update`` scopes of
   20 steps under torch.profiler on rank 0, the single-process
   trainer's ms per step after the group, and one step under the
   collective recorder (``utils/collectives.py``): every rank's sends and
   bytes equal ``profiling.halo_traffic``'s ``collective_permute_ops``
   and ``per_device_bytes`` exactly; (c) ``DataParallelTrainer`` on
   4 workers, no compression, int8 and top-k 5 %, 30 steps each: the loss
   falls, params stay bitwise replicated, the error-feedback slices differ
   across workers, one K3 and one K4 per step, and one step recorded is
   one packed all-reduce of the gradient and the terms; (d) a supervised 3 x 100
   step run with a crash after chunk 1 equals three uninterrupted chunks
   exactly (params and moments, 0.0), ``nan_params`` on subdomain 0
   trips the guard on every rank by consensus (``ok_sub[0]`` False,
   ``ok_sub[3]`` True, 1 good step), and the run's checkpoint resumes in
   ``ReferenceTrainer`` bitwise; (e) ``python -m repro_torch.launch.train
   pinn --distributed --nx 2 --nt 2 --steps 20`` exits 0.  One
   ``{"distributed": ...}`` line;
8. **scenarios** — the paper's remaining PINN scenarios, each run with
   the launch counts set to 0 just before and read just after: (a)
   ``launch.inverse_heat_map.main --export DIR --serve-demo`` at the
   example's defaults (Table-3 activations, jvp path, 2000 steps) must
   reach rel-L2(T,K) <= 0.0147 and a served K field rel-L2 <= 0.0114 with
   no K1-K4 launch; (b) the same problem at the paper's size (3 x 80 per
   net, Table 3's unscaled counts), 100 steps, timed; (c) the us_map with
   one shared tanh on the fused path at 3 x 80: 10 steps on the card
   against 10 on the CPU from one init (params 1e-5, summed loss 1e-4
   relative), then 500 steps with exactly 2 K3 + 2 K4 a step and its
   rel-L2 through K1; (d) ``launch.navier_stokes_cavity.main`` at its
   defaults (jvp, 40 x 5, 4000 steps) must reach a Ghia centerline RMS
   <= 0.117; (e) the cavity at 80 x 5 on the fused path: 10 steps against
   the jvp path on the card (same bounds), the jvp step eager and both
   paths in turns (fused, jvp, jvp, fused; chunks of 100), then 1000 steps
   with exactly one K3 + one K4 a step; (f) vanilla Burgers
   (``MLPConfig(2, 1, 20, 3)``, 512 + 64 points): 300 Adam steps, then 60
   L-BFGS iterations, monotone and below 0.9 x the Adam loss, gradients
   through K3/K4 (two a step) and the 14 probes a step through K2.  No
   plain version may run on a CUDA tensor.  One ``{"scenarios": ...}``
   line;
9. **lm kernels** — hold K5 (flash attention) against its plain version on
   the card: float32 (rtol = atol = 2e-5, the CUDA-core kernel) and bf16
   (both outputs bf16, rtol = atol = 1e-2, the tensor-core kernel: by TMA
   at head dims 64 and 128, by element loads at 100), heads H/Hk 32/8,
   8/8, 4/1, head dims 64, 128, 100, S = T in {1, 37, 64, 130, 200, 333,
   2048}, and S != T causal (top-left) and not causal, each in the model's
   (B, S, H, dh) layout and as (B, H, S, dh) storage, every case counted on
   the device kernel of its dtype; K5 at minicpm3-4b's MLA shape (H = Hk =
   40, a 96-wide q/k head over a 64-wide v head, causal, S = T in {1, 37,
   130, 1024}, (B, S, H, dh) layout; bf16 by TMA, v zero-padded inside the
   wrapper), under the same tolerances and counts; K5 at the MoE configs'
   prefill shapes (B 2, S = T = 1024: deepseek-moe-16b's H = Hk = 16 and
   phi3.5-moe's 32/8, dh 128), both dtypes; K5 at llava-next-mistral-7b's
   prefill shape (B 1, S = T = 4096: 2304 patches and 1792 tokens; 32/8
   heads of 128) and zamba2-1.2b's (B 2, S = T = 1024; its shared
   attention's 32/32 heads of 64), both dtypes; K5 at the four calls of
   seamless-m4t-large-v2 (ENCDEC_K5, 16/16 heads of 64): the encoder's
   non-causal S = T = 1024, the decoder's causal S = T = 4096, the
   cross-attention's non-causal S 4096 x T 1024 (B 1) and a decode
   step's non-causal S 1 x T 8 (B 4), both dtypes; and K6 (WKV6: a chunk,
   a scan and an output kernel) against its plain version run in float64
   on the same inputs (rtol = atol = 2e-4, the reference's bound; the
   float32 plain version's own distance from it is printed beside): P 16,
   64, 128, T in {1, 5, 17, 31, 33, 256, 1000} (B = 2) and T = 99 at B =
   3, w from U(0.2, 0.98), a strong decay w = 0.05 and a near-1 decay w ~
   exp(-e^-6) (the init's decay_bias);
10. **lm timing** — K5 at llama3.2-1b's per-layer prefill shape (B = 1,
   H = 32, Hk = 8, dh = 64, bf16, causal) at S = T = 4096 and 32768, beside
   its plain version and PyTorch's ``scaled_dot_product_attention`` on the
   same tensors (timed only; the port never calls it); K5 at minicpm3-4b's
   per-layer prefill shape (B = 1, S = T = 4096, H = Hk = 40, dh 96 over
   dv 64, bf16, causal) beside its bound by its real work (2 (96 + 64)
   FLOP per visible pair and head), its plain version and SDPA (on the
   unpadded v where SDPA takes it, else on v padded to 96); K5 at
   deepseek-moe-16b's (H = Hk = 16) and phi3.5-moe's (32/8) per-layer
   prefill shapes (B 1, S = T = 4096, dh 128, bf16, causal) beside the
   same three (llava-next-mistral-7b's shape is phi3.5-moe's); K5 at
   zamba2-1.2b's shared attention (B 1, S = T = 4096, H = Hk = 32, dh 64)
   beside the same three; K5 at seamless-m4t-large-v2's four calls
   (ENCDEC_K5: causal or not, S = T or S != T) beside the same three, the
   bound counting S T visible pairs where the call is not causal and
   reading q and o over S, k and v over T; K6 at rwkv6-3b's
   per-layer shape (B = 1, T = 4096, H = 40, P = 64, float32) beside its
   plain version;
11. **llm** — llama3.2-1b, minicpm3-4b (MLA), rwkv6-3b,
   deepseek-moe-16b (MoE: the dense prelude and 27 MoE layers of 64
   routed experts, top-6, and 2 shared), llava-next-mistral-7b (VLM: the
   mistral backbone behind 2304 projected patch embeddings drawn from the
   seed), zamba2-1.2b (38 Mamba2 layers, the shared attention after
   every 6) and seamless-m4t-large-v2 (encoder-decoder: 24 encoder and
   24 decoder layers behind 1024 frames drawn from the seed) at their
   published width and depth, and phi3.5-moe at full
   width and 4 of its 32 layers (LLM_LAYERS), weights drawn from a seed
   on the card: prefill (B = 2, S = 1024 / B = 2, S = 1024 / B = 1, T =
   1024 / B = 2, S = 1024 / B = 2, S = 1024 / B = 1, S = 2304 patches +
   1792 tokens / B = 2, S = 1024 / B = 1, S = 4096 tokens over 1024
   frames) through the kernels with the launch
   counts set to 0 just before and read just after (exactly n_layers K5
   (dense, VLM, MLA, MoE) or K6 (rwkv) wrapper calls, n_layers // 6 = 6
   for zamba2 (one a stage, ``_kernel_calls``), 24 + 2 x 24 = 72 for
   seamless, by shape 24 non-causal S = T = 1024, 24 causal S = T = 4096
   and 24 non-causal S 4096 x T 1024 (the wrapper's launches recorded),
   each on its device kernels: the bf16 K5 kernel, or K6's chunk, scan
   and output kernels; no plain version on a CUDA tensor), a profiler
   trace of it (the device kernels' share found by their names), the same
   prefill through the plain versions in bf16 (difference printed) and in
   a float32 copy of the config (held at LLM_F32_TOL of max |logit|; for
   the attention families through the float32 K5 kernel, one launch per
   layer; for MoE the (layer, token) routes whose experts differ between
   the kernel and plain passes are counted and printed, and where there are
   any the plain pass is run again on the kernel pass's routes, replayed,
   and held at the same bar), and 16 decode steps (minicpm3's
   absorbed-latent decode; the VLM's decode takes tokens only, so it is
   held against a tokens-only prefill; seamless decodes against a cross
   cache of the prefill's encoded frames, built as the reference's
   ``tests/test_models.py:60-71`` builds it, with exactly 24 float32 K5
   launches a step, S 1 x T 1024, and every other family with none)
   held against the float32 prefill
   (2e-3 of max |logit|, the reference's bound); MoE decode drops no token
   while a
   prefill drops those past capacity, so for MoE a B = 2, S = 64 prompt at
   capacity_factor 64 is prefilled and its first 16 tokens decoded, within
   1e-4 (the reference's drop-free bound);
12. **llm serve** — ``repro_torch.launch.serve.main`` serves each of them
   that runs at full depth (all but phi3.5-moe) at full size
   (``--no-reduced --batch 4 --prompt-len 16 --gen 16``), twice
   (the first run pays the card's first-use costs): a (4, 32) token array,
   its tokens/s printed, each run counted: no kernel launch but
   seamless's, whose run encodes its 8 frames (24 K5 launches) and
   launches K5 24 times in each of its 31 decode steps;
13. **lm train** — ``repro_torch.launch.train.main(["lm", ...])`` on the
   card, each run with the counts set to 0 just before and read just
   after: (a) llama3.2-1b at its published size, B = 4, S = 1024, 30
   steps, checkpointed every 15: every loss finite, exactly steps x
   layers x (1 + remat) K5 wrapper launches, each on the bf16 kernel, and
   steps x layers VJP recomputes (``recomputes``), no plain version on a
   CUDA tensor; (b) its step-15 checkpoint resumed to step 30: losses
   16-30 and the params of the step-30 checkpoint bitwise equal to (a)'s,
   and every leaf's CRC-32 (the Adam moments too) equal; (c) one ``CausalLM.loss`` and its
   gradient, kernel path against ``plain=True`` (B = 1, S = 1024, both
   models): float32 within LM_LOSS_RTOL (loss) and LM_GRAD_TOL (each leaf,
   scaled by max(1, max |want|)), the bf16 difference printed; (d) five
   recipe steps (``train.lm_train_step``) of the reduced models in
   float32 from one set of params, card against CPU, within LM_CPU_TOL
   (losses and params); (e) 40 steps of llama3.2-1b on one repeated batch
   must end at <= 0.9 x the first loss; (f) rwkv6-3b at full width and 12
   of its 32 layers, B = 1, T = 1024, 20 steps, counted as (a) on K6's
   three kernels, and minicpm3-4b at full width and 24 of its 62 layers,
   B = 2, S = 1024, 20 steps, counted as (a) on the bf16 K5 kernel (no
   resume run: (b) is llama's alone), and deepseek-moe-16b at full width
   and 4 of its 28 layers (the dense prelude and 3 MoE layers), B = 2, S =
   1024, 20 steps, counted as (a), its mean load-balance term printed,
   through (c) (routes that differ counted, and replayed where any do, as
   in phase 11) and (d) as well, and llava-next-mistral-7b at full width
   and 8 of its 32 layers, B = 1, S = 2304 patches + 1792 tokens, and
   zamba2-1.2b at its published size, B = 4, S = 1024, through the SSD at
   its chunk of 256, and seamless-m4t-large-v2 at its published size, B =
   4, S = 1024 tokens over 256 frames, 20 steps each, counted as (a)
   (zamba2: steps x 6 K5
   launches and steps x 6 recomputes, its shared attention running once a
   stage outside remat; seamless: steps x 144 launches and steps x 72
   recomputes), through (c) ((c) gives the VLM 1024 tokens
   behind its patches, seamless 1024 tokens over 256 frames) and (d), and
   seamless through (e) as well; (g) ms
   per step (median of the steps after the first two), tokens/s and
   ``torch.cuda.max_memory_allocated`` of (a) and (f), and torch.profiler
   over the last step of each (LM_TRACE_STEPS of (e)):
   device busy ms, idle share, the K5 / K6 kernels' ms and launch counts
   (the traced remat factor), and the device ms inside the
   ``flash_attention_vjp`` / ``wkv6_vjp``, ``fused_head_ce`` and
   ``adam_update`` scopes (read from the profiler's events,
   ``_split``; deepseek's trace also through torch's event tree, the
   two equal); then K5 and K6 at the training shapes beside
   their plain versions, SDPA and the training entry's forward and
   backward;
14. **ep** — expert parallelism (``models/expert_parallel.py``,
   ``moe.moe_ffn_shardmap``) on ``gloo`` ranks sharing the card
   (``launch/mesh.py::make_grid_mesh``, model innermost), every rank
   holding its data shard and its E/M routed experts of each MoE layer
   (drawn from the seed layer by layer, ``CausalLM.init(seed, experts=(m,
   M))``), each rank's collectives recorded
   (``utils/collectives.py::CollectiveRecorder``) and held EXACTLY to the
   prediction (``_ep_predict``, written in ``PERF.md`` before the first
   run): (a) deepseek-moe-16b at full width and EP_PREFILL's 4 of 28
   layers (the prelude and 3 MoE layers), B 2 x 1024 on a (data 2, model
   2) grid: the one-process twin (``EPPlan``) prefills first, alone, in
   float32, shard by shard (the ranks' product shapes: a B 2 product
   rounds otherwise than a B 1 one, and a near-tie route flips), and the
   one-process
   ``moe_ffn`` prefill in bf16 is timed; then each rank's float32
   prefill, counted (exactly 4 K5 launches on the float32 kernel, no
   plain version) and recorded, is held within EP_LOGIT_TOL of max
   |logit| of the twin's rows, and its bf16 prefill is counted, recorded
   and then timed (EP_TIME_REPS); (b) 2 of 28 layers, B 2 x 1024,
   EP_TRAIN's 10 ``lm_train_step``s on a (1, 2) grid (the same group's
   ranks of data shard 0: one spawn for both parts): the twin's 10
   steps first, alone; then each rank's, counted (steps x 2 layers x 2
   K5 launches, steps x 2 recomputes) and recorded, its losses within
   EP_LOSS_TOL of the twin's step by step and its final params within
   EP_PARAM_TOL (scaled by max(1, max |want|)); the twin's and each
   rank's peak within DRYRUN_PEAK_TOL of the dry run of its step (a
   rank's as ``moe_ffn`` over its E/M experts); then EP_TIME_STEPS more
   steps unrecorded (the recorder's cost); (c) a sequence-split decode
   (``models/partition.py::split_kv_attention``): llama3.2-1b at its
   published size, B 2, its cache of SEQ_CELL's 4096 positions split in
   halves along T over the same (1, 2) group (``GridRank.
   sequence_parallel``, ``partition.use_seq``), every weight whole on
   each rank: the one process first, alone, prefills each of two prompts
   (1536, where rank 1 holds only masked positions at every step, and
   3072) in float32 and bf16 with K5 (16 launches a prefill, counted, no
   plain version), fills the cache from the prefill's k and v and runs
   16 greedy decode steps over it whole; then each rank, teacher-forced
   with those tokens over its half, counted (no launch) and recorded:
   its logits within SEQ_TOL of max |logit| of the one process's (1e-4
   float32; 3e-2 bf16, the port's bf16 logits bar: one bf16 ulp of a
   logit near the max is already 2^-8 to 2^-7 of it), a token it picks
   otherwise only at a near tie there (within SEQ_TOL of the best), its
   collectives EXACTLY ``_seq_predict``'s (per layer a MAX
   and a packed SUM all-reduce over the model group).  ``ep_prefill``,
   ``ep_train``, ``ep_seq_decode`` and one ``ep_rank`` line a rank;
15. **dryrun** — the dry run (``repro_torch.launch.dryrun``: the step
   traced on the meta device, nothing launched; computed during the
   build) against the card: (a)
   each LM_TRAIN run's training step at its config, depth cut and batch
   on a (1, 1) mesh, its predicted peak within DRYRUN_PEAK_TOL of the
   run's ``torch.cuda.max_memory_allocated`` less what was allocated
   before the run (the gap printed), its K5 /
   K6 calls equal to the run's launches a step, and its FLOPs over the
   run's steady step time as TFLOP/s and a share of the bf16 peak; (b)
   for each run cut by memory (rwkv6-3b, minicpm3-4b, deepseek-moe-16b,
   llava-next-mistral-7b) the deepest cut whose predicted peak fits
   ``torch.cuda.mem_get_info()``'s total (each depth's peak on the line
   through the cut's and the next layer's, the deepest confirmed by its
   own dry run), and the run's cut no deeper;
   (c) full-size llama3.2-1b and deepseek-moe-16b train / prefill / decode
   cells on the (16, 16) mesh, printed; (d) no launch count moves;
   (e) the partitioned dry run (``lower_cell(partitioned=True)``: the step
   as rank 0 of a fake process group over DTensors) of the ep phase's own
   cells, with the rules replicating every param but the experts as the
   ranks hold them: the (2, 2) prefill in float32 and bf16 and one step of
   the (1, 2) training cell (ten of them for the ranks' ten steps), each
   held against every rank's recorded collectives (group, kind, count,
   bytes) and ``_ep_predict`` exactly, its K5 calls a device against each
   rank's launches, and its ``peak_bytes_per_device`` against the training
   ranks' measured peak within DRYRUN_PEAK_TOL; and (c)'s decode step
   under rules replicating every param and splitting only ``kv_seq``
   over ``model``, times the steps, against every rank's collectives of
   each run and ``_seq_predict`` exactly (no K5); the part prints its
   seconds;
16. **report** — one ``{"kernels": [...]}`` line (K1-K6; K5 and K6 also
   at the training shapes, K5 also at minicpm3's MLA shape, the MoE
   configs' shapes, the VLM's and zamba2's paths, seamless's four calls
   and the ep path's launches a rank), the card's name
   and power limit from ``nvidia-smi``, and as the last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Each phase prints its seconds.

The bound of a shape is the larger of its bytes (inputs read once, outputs
written once; for K3 the spills are outputs, for K4 inputs) over 3.35 TB/s
and its operations over the card's rate for their type: K1-K4 their
matrix-product FLOPs (two per multiply-add, pruned second-order streams not
counted; K4 does two products per stream and layer), K6 the recurrence's
4 P^2 FLOP per step and head, over 67 TFLOP/s, the H100 SXM's float32 rate
outside the tensor cores; K5 its 2 (dh + dv) FLOP per visible (query,
key) pair and head (4 dh where dv = dh; MLA's padded v columns are not
work the function needs; S T pairs where a call is not causal) over 989
TFLOP/s, the bf16 tensor-core rate,
since it takes and returns bf16 at the timed shapes.

Every profiled window opens with PROFILE_PAD spin kernels of about a
microsecond: a torch.profiler session drops the first device records it
would collect, more the later in the process it starts (~46 late in a
whole run on the H100), and the pad takes that loss (printed per window
as ``pad_records_lost``) so that the counts of the K5 / K6 kernels in a
trace are whole.

The script imports nothing of the JAX package.  Without a CUDA card, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

SEED = 0
TOL = 1e-5               # rtol and atol, float32 kernel vs float32 plain
SOURCES = {"pinn_mlp_fwd1": "src/repro_torch/csrc/pinn_mlp_fwd.cu",
           "pinn_mlp_fwd2": "src/repro_torch/csrc/pinn_mlp_fwd.cu",
           "pinn_mlp_fwd2_res": "src/repro_torch/csrc/pinn_mlp_fwd.cu",
           "pinn_mlp_bwd2": "src/repro_torch/csrc/pinn_mlp_bwd.cu",
           "flash_attention": "src/repro_torch/csrc/flash_attention_sm90.cu",
           "wkv6": "src/repro_torch/csrc/wkv6.cu"}
# device kernels behind the K5 / K6 wrappers (launch counters, and the
# names by which the profiler split finds them)
DEVICE_KERNELS = {"flash_attention_sm90": "flash_fwd_sm90_kernel",
                  "flash_attention_f32": "flash_fwd_kernel",
                  "wkv6_chunk": "wkv6_chunk_kernel",
                  "wkv6_scan": "wkv6_scan_kernel",
                  "wkv6_out": "wkv6_out_kernel"}
# device kernels of a training step (the profiler split of the train phase)
TRAIN_KERNELS = {"k3": "pinn_mlp_fwd_kernel", "k4": "pinn_mlp_bwd_kernel",
                 "k4_reduce": "pinn_mlp_bwd_reduce"}
# the trainers' record_function scopes (the reference's named scopes)
SCOPES = ("dd-comp-forward", "dd-comm-halo", "dd-comp-update")
# a profiler session drops the first device records it would collect, more
# the longer the process has run (up to ~55 late in a whole run on the
# H100): every profiled window opens with PROFILE_PAD spin kernels
# (``torch.cuda._sleep`` of PAD_CYCLES cycles each, ~1 us) to take that
# loss; their records are counted apart
PAD_KERNEL = "spin_kernel"
PROFILE_PAD = 256
PAD_CYCLES = 2000
# the LM training step's scopes: the K5 / K6 training entries' VJP
# recomputes, the fused head cross-entropy's chunks (forward and
# backward) and the Adam update
LM_SCOPES = ("flash_attention_vjp", "wkv6_vjp", "fused_head_ce",
             "adam_update")
REPLACES = {"pinn_mlp_fwd1": "src/repro/kernels/pinn_mlp.py:82",
            "pinn_mlp_fwd2": "src/repro/kernels/pinn_mlp.py:148",
            "pinn_mlp_fwd2_res": "src/repro/kernels/pinn_mlp.py:166",
            "pinn_mlp_bwd2": "src/repro/kernels/pinn_mlp.py:184",
            "flash_attention": "src/repro/kernels/flash_attention.py:31",
            "wkv6": "src/repro/kernels/wkv6.py:27"}
# K5 against its plain version: float32 at 2e-5 (the sums run in another
# order); bf16 with both outputs rounded to bf16 at 1e-2 (values that agree
# to float32 precision may round to neighbouring bf16 numbers, 2^-8
# relative).  K6 at 2e-4, the reference's own bound for its WKV6 kernel
# (tests/test_kernels_wkv6.py): exponentials and cumulative sums of log w
# run in another order.
FA_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
WKV_TOL = 2e-4
# full-size prefill, kernels against plain versions on the card in a
# float32 copy of the config, relative to max |logit|: 16 or 32 layers of
# float32 sums in another order (the reduced models agree with the JAX
# package to 4e-7 on the CPU)
LLM_F32_TOL = 1e-4
DECODE_TOL = 2e-3        # decode vs prefill, the reference's bound
# prefill (B, S); the VLM's S counts its 2304 patches and 1792 tokens
# (prefill_32k cut to 4096: the patches alone fill 2304 positions); the
# encoder-decoder's S tokens go with S // 4 = 1024 frames (cut as llava)
LLM = {"llama3.2-1b": (2, 1024), "minicpm3-4b": (2, 1024),
       "rwkv6-3b": (1, 1024), "deepseek-moe-16b": (2, 1024),
       "phi3.5-moe-42b-a6.6b": (2, 1024),
       "llava-next-mistral-7b": (1, 4096), "zamba2-1.2b": (2, 1024),
       "seamless-m4t-large-v2": (1, 4096)}
# depth cuts of the llm phase (the others run at full depth and are also
# served): phi3.5-moe's 41.9 B float32 params (168 GB) do not fit the card,
# 4 of its 32 layers (5.5 B, 22 GB) do
LLM_LAYERS = {"phi3.5-moe-42b-a6.6b": 4}
# the kernel wrapper each family's full forward calls (once a layer; the
# hybrid's shared attention once a stage; the encoder-decoder once an
# encoder layer and twice a decoder layer, ``_kernel_calls``)
FAMILY_KERNEL = {"dense": "flash_attention", "mla": "flash_attention",
                 "moe": "flash_attention", "rwkv": "wkv6",
                 "vlm": "flash_attention", "hybrid": "flash_attention",
                 "encdec": "flash_attention"}
# seamless-m4t-large-v2's K5 calls, (B, S, T, causal) at its 16/16 heads
# of 64: the llm phase's prefill (B 1, 4096 tokens over 1024 frames) and
# the serving decode step (B 4, one query over 32 // 4 = 8 cached frames)
ENCDEC = "seamless-m4t-large-v2"
ENCDEC_K5 = {"encoder self-attention": (1, 1024, 1024, False),
             "decoder self-attention": (1, 4096, 4096, True),
             "cross-attention, prefill": (1, 4096, 1024, False),
             "cross-attention, decode": (4, 1, 8, False)}
# the configs whose K5 shapes this slice added: the VLM's (32/8 heads of
# 128) and zamba2-1.2b's shared attention (32/32 heads of 64)
K5_PATHS = ("llava-next-mistral-7b", "zamba2-1.2b")
# the MoE configs' attention heads (H, Hk, dh): K5's shapes on their path
MOE_HEADS = {"deepseek-moe-16b": (16, 16, 128),
             "phi3.5-moe-42b-a6.6b": (32, 8, 128)}
# MoE decode against prefill with capacity dropping off (a prefill drops
# tokens past capacity, a one-token step never does): a (B, S) prompt at
# capacity_factor 64, its first DROP_FREE_STEPS positions decoded, within
# the reference's bound (tests/test_models.py:90-94)
DROP_FREE = (2, 64)
DROP_FREE_STEPS = 16
DROP_FREE_TOL = 1e-4
# minicpm3-4b's expanded MLA attention: H = Hk = 40 heads, a 96-wide q/k
# head (64 nope + 32 rope) over a 64-wide v head
MLA_HEADS = (40, 96, 64)   # (H = Hk, dh, dv)
# lm_train's runs of ``launch.train lm``: llama3.2-1b at its published size
# (B x S cut from train_4k's 256 x 4096), checkpointed every LM_CKPT_EVERY
# steps and resumed; rwkv6-3b at full width and 12 of its 32 layers, and
# minicpm3-4b at full width and 24 of its 62, deepseek-moe-16b at full
# width and 4 of its 28 (the dense prelude and 3 MoE layers, 2.26 B
# params): with an out-of-place Adam the step's peak holds seven float32
# copies of the params, 86 GB at 3.06 B params and 120 GB at 4.3 B, more
# than the card's 80 GB (minicpm3 at 16 layers peaked at 45.7 GB, so 24
# layers, ~60 GB, still leave room; deepseek at 4 layers ~63 GB);
# llava-next-mistral-7b at full width and 8 of its 32 layers (218 M params
# a layer, 2.01 B in all: ~56 GB at seven copies), B 1 x 4096 (2304
# patches + 1792 tokens); zamba2-1.2b at its published size (1.2 B, ~34
# GB), B 4 x 1024, through the SSD at its chunk of 256;
# seamless-m4t-large-v2 at its published size (1.633 B, ~46 GB), B 4 x
# 1024 tokens over 256 frames.  ``learn``: 40 steps on one batch
LM_TRAIN = {"llama3.2-1b": {"batch": 4, "seq": 1024, "steps": 30,
                            "layers": None, "resume": True, "learn": True},
            "rwkv6-3b": {"batch": 1, "seq": 1024, "steps": 20,
                         "layers": 12, "resume": False, "learn": False},
            "minicpm3-4b": {"batch": 2, "seq": 1024, "steps": 20,
                            "layers": 24, "resume": False, "learn": False},
            "deepseek-moe-16b": {"batch": 2, "seq": 1024, "steps": 20,
                                 "layers": 4, "resume": False,
                                 "learn": False},
            "llava-next-mistral-7b": {"batch": 1, "seq": 4096, "steps": 20,
                                      "layers": 8, "resume": False,
                                      "learn": False},
            "zamba2-1.2b": {"batch": 4, "seq": 1024, "steps": 20,
                            "layers": None, "resume": False, "learn": False},
            ENCDEC: {"batch": 4, "seq": 1024, "steps": 20, "layers": None,
                     "resume": False, "learn": True}}
LM_CKPT_EVERY = 15
# one loss and its gradient, kernel path against plain path in float32:
# the loss relative, each gradient leaf scaled by max(1, max |want|)
# (chip_smoke's rule for K4)
LM_LOSS_RTOL = 1e-5
LM_GRAD_TOL = 1e-4
LM_CPU_TOL = 1e-5        # 5 recipe steps, card against CPU, float32
LM_LEARN_STEPS = 40      # steps on one repeated batch ...
LM_LEARN = 0.9           # ... after which the loss is <= 0.9 x the first
# steps of each LM training run traced by torch.profiler (the last of (e)):
# parsing a trace costs ~15 s a step of ~20,000 device events (zamba2,
# seamless), so one step, not three, keeps the script inside its limit
LM_TRACE_STEPS = 1
# the dryrun phase: each LM_TRAIN run's training step traced on the meta
# device (launch.dryrun) at its config, depth cut and batch on a (1, 1)
# mesh; its predicted peak within DRYRUN_PEAK_TOL of the run's
# torch.cuda.max_memory_allocated less what was allocated before the run
# (gaps of 0.11-0.21 % on the H100); the deepest cut whose predicted peak
# fits the card for the configs LM_TRAIN cuts by memory; the full-size
# cells of DRYRUN_FULL on the (16, 16) production mesh
DRYRUN_PEAK_TOL = 0.02
DRYRUN_FULL = ("llama3.2-1b", "deepseek-moe-16b")
DRYRUN_FULL_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# the serving path's shape (width, depth, points per subdomain): the served
# Burgers net at a serving batch; timing() runs it with n_sub=4, d_in=2
MAIN = (24, 4, 512)
# 10-step trajectory, card (kernels) against the CPU (plain versions): the
# loss terms within TRAJ_RTOL (relative), the params within TRAJ_ATOL.
# Adam's first step moves every parameter by lr * sign(gradient) whatever
# the gradient's size, so a component whose gradient sat at rounding level
# could differ by 2 * lr = 4e-3 after one step; 1e-5 says no component took
# a different direction, and the rest differs by float32 rounding only.
TRAJ_RTOL = 1e-4
TRAJ_ATOL = 1e-5


RECORD: list = []   # every result line of this run, for --out


def emit(obj: dict) -> None:
    """Print one result line and keep it for ``--out``."""
    RECORD.append(obj)
    print(json.dumps(obj))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# --------------------------------------------------------------------- build

def build_phase() -> None:
    from repro_torch.kernels import native

    t0 = time.perf_counter()
    info = native.build()
    secs = time.perf_counter() - t0
    check(set(info) == {p.stem for p in native.sources()},
          f"built {sorted(info)}")
    logs = "".join(v["log"] for v in info.values())
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", logs)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", logs)]
    emit({"build_s": round(secs, 2),
                      "sources": {k: round(v["seconds"], 2)
                                  for k, v in info.items()},
                      "instantiations": len(regs),
                      "registers_max": max(regs, default=None),
                      "spill_bytes_max": max(spills, default=None)})
    train = {stem: _ptxas_report(info[stem]["log"])
             for stem in ("pinn_mlp_fwd", "pinn_mlp_bwd")}
    check(all(train.values()), "no ptxas report for the K1-K4 libraries")
    for stem, rows in train.items():
        for kern, nreg, spill in rows:
            print(f"ptxas {stem}: {kern} registers {nreg} spill bytes "
                  f"{spill}")
    emit({"ptxas_k1_k4": {stem: {
        "instantiations": len(rows),
        "registers": [min(r[1] for r in rows), max(r[1] for r in rows)],
        "spill_bytes_max": max(r[2] for r in rows)}
        for stem, rows in train.items()}})
    check(all(r[2] == 0 for rows in train.values() for r in rows),
          "a K1-K4 instantiation spills registers")
    sass = _sass_counts(info)
    emit({"sass": sass})
    sm90 = {k: v for k, v in sass.items() if "flash_fwd_sm90_kernel" in k}
    check(len(sm90) == 4 and all(v["HGMMA"] > 0 for v in sm90.values()),
          f"bf16 K5 kernel without wgmma: {sm90}")
    # the TMA instantiations (template flag true) load by TMA, the others not
    tma = lambda k: re.search(r"(true|\(bool\)1)>$", k) is not None
    check(sum(map(tma, sm90)) == 2 and
          all((v["UTMALDG"] > 0) == tma(k) for k, v in sm90.items()),
          f"bf16 K5 TMA instantiations without TMA loads: {sm90}")


def _ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes) of every entry function in a
    ``-Xptxas -v`` log, the kernel's name demangled without its argument
    list."""
    rows = []
    for ent in re.split(r"Compiling entry function '", log)[1:]:
        regs = re.search(r"Used (\d+) registers", ent)
        spill = re.search(r"(\d+) bytes spill stores", ent)
        rows.append([ent.split("'", 1)[0], int(regs.group(1)),
                     int(spill.group(1))])
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    names = subprocess.run([os.path.join(cuda, "bin", "cu++filt")],
                           input="\n".join(r[0] for r in rows),
                           capture_output=True, text=True, check=True,
                           timeout=60).stdout.splitlines()
    check(len(names) == len(rows), f"cu++filt gave {len(names)} names")
    return [(_without_args(n), r[1], r[2]) for n, r in zip(names, rows)
            if "pinn_mlp" in n]


def _sass_counts(info) -> dict:
    """Each kernel of the built libraries: its count of HGMMA (wgmma) and
    UTMALDG (TMA load) instructions in the SASS."""
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    procs = {}   # all at once, each into a file of its own
    for stem, lib in sorted(info.items()):
        out = tempfile.TemporaryFile("w+")
        procs[stem] = (out, subprocess.Popen(
            [os.path.join(cuda, "bin", "cuobjdump"), "-sass", lib["path"]],
            stdout=out, text=True))
    counts = {}
    for stem, (out, proc) in procs.items():
        check(proc.wait(timeout=300) == 0, f"cuobjdump -sass failed on {stem}")
        out.seek(0)
        sass = out.read()
        out.close()
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                counts[fn] = {"library": stem, "HGMMA": 0, "UTMALDG": 0}
            elif fn is not None:
                for op in ("HGMMA", "UTMALDG"):
                    counts[fn][op] += op in line
    names = subprocess.run([os.path.join(cuda, "bin", "cu++filt")],
                           input="\n".join(counts), capture_output=True,
                           text=True, check=True, timeout=60).stdout
    names = [_without_args(n) for n in names.splitlines()]
    check(len(names) == len(counts) == len(set(names)),
          f"cu++filt output {names}")
    return dict(zip(names, counts.values()))


def _without_args(name: str) -> str:
    """A demangled kernel name without ``void``, the anonymous namespace
    and its argument list, keeping its template arguments (which cu++filt
    may print as ``(int)64, (bool)1``)."""
    name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::", "",
                  name.strip())
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if name.endswith(")") else name
    return name


# ------------------------------------------------------------------- kernels

def _net(gen, n_sub, n, d_in, width, depth, n_out, dev):
    """Seeded random inputs and packed weight stacks on the card."""
    import torch
    from repro_torch.kernels import ops

    dims = [d_in] + [width] * depth + [n_out]
    Ws = [torch.randn((n_sub, a, b), generator=gen) * (2.0 / (a + b)) ** 0.5
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn((n_sub, b), generator=gen) for b in dims[1:]]
    a = 0.9 + 0.2 * torch.rand((n_sub, depth), generator=gen)
    x = 2.0 * torch.rand((n_sub, n, d_in), generator=gen) - 1.0
    w, b, av = ops.pack_mlp(Ws, bs, a)
    return [t.to(dev).contiguous() for t in (x, w, b, av)]


def _run(kernel: bool, args, n_out, act, d2):
    from repro_torch.kernels import pinn_mlp as K

    if d2 == ():
        fn = K.pinn_mlp_fwd1 if kernel else K.pinn_mlp_fwd1_plain
        return fn(*args, n_out=n_out, act=act)
    fn = K.pinn_mlp_fwd2 if kernel else K.pinn_mlp_fwd2_plain
    return fn(*args, n_out=n_out, act=act, d2_dirs=d2)


def _compare(got, want, d_in, d2) -> tuple[float, float]:
    import torch

    abs_err = rel_err = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != "
                                  f"{tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), "non-finite kernel output")
        diff = (g - w).abs()
        check(bool((diff <= TOL + TOL * w.abs()).all()),
              f"kernel disagrees: max abs {float(diff.max()):.3e}")
        abs_err = max(abs_err, float(diff.max()))
        rel_err = max(rel_err, float((diff / (w.abs() + TOL)).max()))
    if d2 not in (None, ()):   # pruned second-derivative rows: exact zeros
        for j in range(d_in):
            if j not in d2:
                check(not bool(got[2][:, j].any()), f"d2u row {j} not zero")
    return abs_err, rel_err


def sweep(dev) -> dict:
    import torch

    gen = torch.Generator().manual_seed(SEED)
    worst = {"pinn_mlp_fwd1": 0.0, "pinn_mlp_fwd2": 0.0}
    subsets = {1: (None, ()), 2: (None, (1,), ()), 3: (None, (0, 2), ())}
    n_cases = 0
    for act in ("tanh", "sin", "cos"):
        for d_in in (1, 2, 3):
            n_out = 1 if d_in == 2 else 3
            for width, depth in ((20, 2), (24, 4), (40, 3), (80, 5),
                                 (128, 5)):
                sizes = [(1, 1013), (4, 517)]
                if width == 24:
                    sizes += [(4, 5), (4, 64)]
                for d2 in subsets[d_in]:
                    for n_sub, n in sizes:
                        args = _net(gen, n_sub, n, d_in, width, depth,
                                    n_out, dev)
                        got = _run(True, args, n_out, act, d2)
                        want = _run(False, args, n_out, act, d2)
                        torch.cuda.synchronize()
                        ae, re_ = _compare(got, want, d_in, d2)
                        name = "pinn_mlp_fwd1" if d2 == () else \
                            "pinn_mlp_fwd2"
                        worst[name] = max(worst[name], ae)
                        n_cases += 1
                        print(f"{name[-4:]} {act:4s} d{d_in} w{width}x"
                              f"{depth} d2={'all' if d2 is None else d2} "
                              f"{n_sub}x{n} abs {ae:.1e} rel {re_:.1e}")
    emit({"sweep_cases": n_cases, "tol": TOL,
                      "max_abs_err": dict(worst)})
    return worst


def _peaks() -> tuple[float, float, float]:
    """(HBM bytes/s, bf16 FLOP/s, float32 FLOP/s): the H100 SXM datasheet's
    peaks, from ``launch/mesh.py``."""
    from repro_torch.launch import mesh

    return mesh.HBM_BW, mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_FP32


def bound(n_sub, m, d_in, width, depth, n_out, d2) -> tuple[float, str]:
    """Least time (ms) for the work of one call, and what bounds it."""
    dims = [d_in] + [width] * depth + [n_out]
    order2 = d2 != ()
    streams = 1 + d_in + (0 if not order2 else
                          d_in if d2 is None else len(d2))
    flops = 2 * d_in * width          # input layer: h (tangents are rows)
    for a, b in zip(dims[1:-1], dims[2:]):
        flops += streams * 2 * a * b
    flops *= n_sub * m
    n_params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) + depth
    rows_out = 1 + d_in + (d_in if order2 else 0)
    nbytes = 4 * n_sub * (m * d_in + n_params + m * n_out * rows_out)
    hbm, _, fp32 = _peaks()
    t_bytes, t_ops = nbytes / hbm, flops / fp32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _events_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time per launch: ``reps`` launches captured in one CUDA graph
    and replayed, so host launch cost is out of the measurement."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    g.replay()
    e.record()
    e.synchronize()
    del g
    return s.elapsed_time(e) / reps


def timing(dev) -> dict:
    import torch

    gen = torch.Generator().manual_seed(SEED + 1)
    out = {}
    shapes = [(24, 4, m) for m in (64, 512, 4096, 262144)]
    shapes += [(w, 5, m) for w in (80, 128) for m in (4096, 262144)]
    for width, depth, m in shapes:
        d_in, n_out, act, n_sub = 2, 1, "tanh", 4
        args = _net(gen, n_sub, m, d_in, width, depth, n_out, dev)
        dense = m > 100_000
        for name, d2 in (("pinn_mlp_fwd1", ()), ("pinn_mlp_fwd2", (0,))):
            kern = lambda: _run(True, args, n_out, act, d2)
            plain = lambda: _run(False, args, n_out, act, d2)
            bms, by = bound(n_sub, m, d_in, width, depth, n_out, d2)
            row = {"kernel": name, "shape": f"n_sub={n_sub} m={m} "
                   f"w{width}x{depth} d_in={d_in} d2={list(d2)}",
                   "ms": _graph_ms(kern, 20 if dense else 200),
                   "call_ms": _events_ms(kern, 20 if dense else 200),
                   "plain_ms": _events_ms(plain, 3 if dense else 50),
                   "bound_ms": bms, "bound_by": by}
            out[(name, width, depth, m)] = row
            emit({"timing": row})
            torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- serve

def _plain_field(bundle, pts, order, dev) -> dict:
    """The stitched field from the plain recurrence, one subdomain at a time
    (independent of the engine's batching and stitching)."""
    import torch
    from repro_torch.core.nets import act_name, map_tree, params_from_numpy
    from repro_torch.kernels import ref
    from repro_torch.serve import routing

    pde, cfg = bundle.pde, bundle.model_cfg
    ((name, c),) = cfg.nets.items()
    params = params_from_numpy(bundle.params, dev)[name]
    mem = routing.membership_matrix(bundle.decomp, pts, tol=1e-9)
    d2 = pde.d2_dirs if order == 2 else ()
    sums = {}
    for q in range(bundle.n_sub):
        idx = np.nonzero(mem[q])[0]
        if len(idx) == 0:
            continue
        p = map_tree(lambda t: t[q], params)
        a = (c.slope_scale * p["a"] if c.adaptive
             else torch.full_like(p["a"], c.slope_scale))
        x = torch.tensor(pts[idx], dtype=torch.float32, device=dev)
        u, du, d2u = ref.pinn_mlp_ref2(x, p["W"], p["b"], a,
                                       act=act_name(bundle.act_codes[q]),
                                       d2_dirs=d2)
        vals = {"u": u, "grad_u": du.movedim(0, 1),
                "flux": pde.flux_from_derivs(x, u, du)}
        if order == 2:
            vals["residual"] = pde.residual_from_derivs(x, u, du, d2u)
        for k, v in vals.items():
            acc = sums.setdefault(k, np.zeros((len(pts),) + v.shape[1:]))
            acc[idx] += v.double().cpu().numpy()
    n = mem.sum(axis=0)
    return {k: np.where((n > 0).reshape((-1,) + (1,) * (v.ndim - 1)),
                        v / np.maximum(n, 1).reshape((-1,) + (1,) *
                                                     (v.ndim - 1)), np.nan)
            for k, v in sums.items()}


def serve_phase(dev) -> dict:
    from repro_torch.core import CartesianDecomposition
    from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                       stacked_init)
    from repro_torch.core.pdes import Burgers1D
    from repro_torch.kernels import pinn_mlp as K
    from repro_torch.launch import serve_field
    from repro_torch.serve import FieldEngine, export_bundle, load_bundle

    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    params, codes = stacked_init(cfg, dec.n_sub, SEED)
    launches = {k: 0 for k in K.launches}
    with tempfile.TemporaryDirectory() as tmp:
        bdir = os.path.join(tmp, "burgers_2x2")
        export_bundle(bdir, params, cfg, dec, act_codes=codes,
                      pde=Burgers1D())
        for order, kernel in ((2, "pinn_mlp_fwd2"), (1, "pinn_mlp_fwd1")):
            argv = ["--bundle", bdir, "--device", "cuda", "--max-requests",
                    "200", "--rate", "2000", "--order", str(order)]
            buf = io.StringIO()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = serve_field.main(argv)
            secs = time.perf_counter() - t0
            counts = dict(K.launches)
            report = json.loads(buf.getvalue())
            check(rc == 0, f"serve_field --order {order} exited {rc}")
            check(report["drained"]["unanswered"] == 0,
                  f"order {order}: unanswered tickets")
            check(report["goodput"] == 1.0,
                  f"order {order}: goodput {report['goodput']}")
            check(counts[kernel] > 0,
                  f"order {order}: {kernel} was never launched")
            for k in launches:
                launches[k] += counts[k]
            emit({"serve": {
                "order": order, "seconds": round(secs, 3),
                "requests": report["requests"],
                "by_status": report["by_status"],
                "goodput": report["goodput"],
                "degraded_frac": report["degraded_frac"],
                "p50_s": report["p50_s"], "p99_s": report["p99_s"],
                "dispatch_p50_s": report["latency"]["dispatch_s"]["p50"],
                "dispatches": report["latency"]["dispatch_s"]["count"],
                "launches": counts}})
        bundle = load_bundle(bdir)

    # one fixed cloud through the engine on the card
    eng = FieldEngine(bundle)
    check(eng.device.type == "cuda", f"engine on {eng.device}")
    rng = np.random.default_rng(SEED)
    inside = np.concatenate([dec.sample_interior(q, 300, rng)
                             for q in range(dec.n_sub)])
    iface = np.concatenate([
        np.stack([np.zeros(25), np.linspace(0.02, 0.98, 25)], axis=1),
        np.stack([np.linspace(-0.98, 0.98, 25), np.full(25, 0.5)], axis=1),
        [[0.0, 0.5]]])
    outside = np.array([[1.5, 0.5], [0.0, -0.2], [-3.0, 4.0]])
    pts = np.concatenate([inside, iface, outside])
    for order in (2, 1):
        got = eng.evaluate(pts, order=order)
        want = _plain_field(bundle, pts, order, eng.device)
        claims = eng.last_claims
        check(int((claims >= 2).sum()) == len(iface),
              f"interface claims {int((claims >= 2).sum())}")
        check(sorted(got) == sorted(want), f"keys {sorted(got)}")
        err = 0.0
        for k, v in got.items():
            inn, out = v[claims > 0], v[claims == 0]
            check(bool(np.isfinite(inn).all()), f"{k}: non-finite inside")
            check(bool(np.isnan(out).all()), f"{k}: outside not NaN")
            diff = np.abs(inn - want[k][claims > 0])
            check(bool((diff <= TOL + TOL * np.abs(want[k][claims > 0]))
                       .all()), f"order {order} {k}: max abs "
                                f"{float(diff.max()):.3e}")
            err = max(err, float(diff.max()))
        emit({"engine_vs_plain": {
            "order": order, "points": len(pts), "max_abs_err": err,
            "tol": TOL, "outside_nan": int((claims == 0).sum())}})
    return launches


# ------------------------------------------------------------------ training

def _leaf_err(got, want) -> float:
    """|got - want| / max(1, max |want|): the reference's per-leaf scaled
    error for the reverse sweep (tests/test_kernels_pinn_mlp.py:330-335)."""
    if want.numel() == 0:
        return 0.0
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def _run_train(kernel: bool, args, n_out, act, d2, cts):
    """K3 then K4 (or their plain versions) on the same inputs."""
    from repro_torch.kernels import pinn_mlp as K

    x, w, b, av = args
    fwd = K.pinn_mlp_fwd2_res if kernel else K.pinn_mlp_fwd2_res_plain
    bwd = K.pinn_mlp_bwd2 if kernel else K.pinn_mlp_bwd2_plain
    outs = fwd(x, w, b, av, n_out=n_out, act=act, d2_dirs=d2)
    return outs, bwd(x, w, av, outs[3], *cts, n_out=n_out, act=act,
                     d2_dirs=d2)


def _cotangents(gen, n_sub, n, d_in, n_out, dev):
    import torch

    return [torch.randn(s, generator=gen).to(dev) for s in
            ((n_sub, n, n_out), (n_sub, d_in, n, n_out),
             (n_sub, d_in, n, n_out))]


def train_sweep(dev) -> dict:
    """K3 against its plain version (outputs and every spill, rtol = atol =
    TOL) and K4 against its plain version on the same spills and random
    cotangents (per-leaf scaled error <= TOL), K4 launched twice and held
    bitwise; then the autograd boundary on the card against the CPU."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator().manual_seed(SEED + 2)
    worst = {"pinn_mlp_fwd2_res": 0.0, "pinn_mlp_bwd2": 0.0}
    scaled = 0.0
    subsets = {1: (None, ()), 2: (None, (0,), ()), 3: (None, (0, 2), ())}
    n_cases = 0

    def case(act, d_in, n_out, width, depth, d2, n_sub, n):
        nonlocal scaled, n_cases
        args = _net(gen, n_sub, n, d_in, width, depth, n_out, dev)
        cts = _cotangents(gen, n_sub, n, d_in, n_out, dev)
        got, gbar = _run_train(True, args, n_out, act, d2, cts)
        want, wbar = _run_train(False, args, n_out, act, d2, cts)
        again = _run_train(True, args, n_out, act, d2, cts)[1]
        torch.cuda.synchronize()
        ae, _ = _compare(got, want, d_in, d2)
        be = max(_leaf_err(g, w) for g, w in zip(gbar, wbar))
        babs = max(float((g - w).abs().max())
                   for g, w in zip(gbar, wbar) if w.numel())
        check(be <= TOL, f"K4 disagrees: {be:.3e}")
        check(all(torch.equal(g, a) for g, a in zip(gbar, again)),
              "K4 is not bitwise deterministic")
        worst["pinn_mlp_fwd2_res"] = max(worst["pinn_mlp_fwd2_res"], ae)
        worst["pinn_mlp_bwd2"] = max(worst["pinn_mlp_bwd2"], babs)
        scaled = max(scaled, be)
        n_cases += 1
        print(f"res+bwd {act:4s} d{d_in} w{width}x{depth} "
              f"d2={'all' if d2 is None else d2} "
              f"{n_sub}x{n} K3 abs {ae:.1e} K4 {be:.1e}")

    for act in ("tanh", "sin", "cos"):
        for d_in in (1, 2, 3):
            n_out = 1 if d_in == 2 else 3
            for width, depth in ((20, 1), (24, 4), (80, 3), (128, 5)):
                for d2 in subsets[d_in]:
                    for n_sub, n in ((1, 1013), (4, 517)):
                        case(act, d_in, n_out, width, depth, d2, n_sub, n)
    # the edges of K4's partition: one row, a tile less one, a tile, a tile
    # and one, the quickstart's rows (blocks owning unequal numbers of
    # tiles where a subdomain has more tiles than resident blocks); widths
    # 36 and 100, odd numbers (9, 25) of the micro-tiles' 4-column groups;
    # 1, 4 and 9 subdomains
    n_main = n_cases
    unequal = 0
    for d_in, d2, act in ((2, (0,), "tanh"), (3, None, "sin"),
                          (1, (), "cos")):
        n_out = 1 if d_in == 2 else 3
        for width, depth in ((24, 4), (36, 3), (100, 3)):
            tile = _k4_plan(1, 1, d_in, width, depth, n_out, d2)[0]
            for n_sub in (1, 4, 9):
                for n in sorted({1, tile - 1, tile, tile + 1, 1120}):
                    blocks = _k4_plan(n_sub, n, d_in, width, depth, n_out,
                                      d2)[1]
                    n_tiles = -(-n // tile)
                    unequal += n_tiles % blocks != 0
                    case(act, d_in, n_out, width, depth, d2, n_sub, n)
    check(unequal > 0, "no edge case had blocks owning unequal tiles")
    # the scenario shapes: the cavity's d_in = 2, n_out = 3 (u, v, p) at
    # depth 5 with both second-order directions or none (Euler1D's), and
    # the us_map's ten subdomains at the rows of their ragged megabatch
    # (the example's counts and the paper's)
    n_scen = n_cases
    rows = _scenario_rows()
    for width in (40, 80):
        for d2 in (None, ()):
            case("tanh", 2, 3, width, 5, d2, 4, rows["cavity"])
    for n in (rows["us_map"], rows["us_map_paper"]):
        case("tanh", 2, 1, 80, 3, None, 10, n)
    # autograd through the packed call: card (K3 + K4) against the CPU
    args = [t.cpu() for t in _net(gen, 4, 1120, 2, 24, 4, 1, dev)]
    x, w, b, av = args
    dims = [2, 24, 24, 24, 24, 1]
    Ws = [w[:, l, :i, :o] for l, (i, o) in enumerate(zip(dims[:-1],
                                                           dims[1:]))]
    bs = [b[:, l, :o] for l, o in enumerate(dims[1:])]
    a = av[:, :4]
    cts = _cotangents(gen, 4, 1120, 2, 1, "cpu")
    grads = {}
    for d in ("cpu", dev):
        ins = [t.to(d).clone().requires_grad_() for t in [x, *Ws, *bs, a]]
        outs = ops.pinn_mlp_forward2(ins[0], ins[1:6], ins[6:11], ins[11],
                                     act="tanh", d2_dirs=(0,), bwd="fused")
        grads[str(d)] = torch.autograd.grad(outs, ins,
                                            [c.to(d) for c in cts])
    ag = max(_leaf_err(g.cpu(), c) for g, c in zip(grads[str(dev)],
                                                   grads["cpu"]))
    check(ag <= TOL, f"autograd boundary card vs CPU: {ag:.3e}")
    emit({"train_sweep_cases": n_cases, "edge_cases": n_scen - n_main,
          "scenario_cases": n_cases - n_scen, "scenario_rows": rows,
          "edge_cases_unequal_tiles": unequal, "tol": TOL,
          "max_abs_err": worst, "k4_max_scaled_err": scaled,
          "autograd_card_vs_cpu": ag})
    return worst


def _scenario_rows() -> dict:
    """Megabatch rows per subdomain of the scenarios' problems (built on
    the CPU: points only)."""
    from repro_torch.launch import inverse_heat_map as ihm
    from repro_torch.launch import navier_stokes_cavity as nsc

    return {"cavity": _rows(nsc.build_problem(device="cpu").batch),
            "us_map": _rows(ihm.build_problem(device="cpu").batch),
            "us_map_paper": _rows(ihm.build_problem(
                width=80, counts=PAPER_COUNTS, device="cpu").batch)}


def _k4_plan(n_sub, n, d_in, width, depth, n_out, d2) -> tuple[int, int]:
    """K4's (tile rows, blocks per subdomain) for a shape on this card."""
    import ctypes

    from repro_torch.kernels import pinn_mlp as K

    sel = tuple(range(d_in)) if d2 is None else tuple(d2)
    tile, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = K._library_bwd().pinn_mlp_bwd_plan(
        n_sub, n, d_in, -(-width // 4) * 4, depth, n_out, 0, len(sel),
        ctypes.byref(tile), ctypes.byref(blocks))
    check(rc == 0, f"pinn_mlp_bwd_plan failed ({rc})")
    return tile.value, blocks.value


def train_bound(n_sub, m, d_in, width, depth, n_out, ns, kernel):
    """Least time (ms) of one K3 or K4 call, what bounds it, and the counts.

    K3: K2's bytes and FLOPs plus the spills, depth * (1 + d_in + ns) * m
    rows of the padded width.  K4: reads x, the weights, the spills and the
    cotangents of u, du and the kept d2u rows, writes x-bar and the W-bar,
    b-bar, a-bar stacks; per hidden layer two matrix products on every
    stream (W-bar and the W^T product), plus x-bar and W-bar_0."""
    wp = -(-width // 4) * 4
    dims = [d_in] + [width] * depth + [n_out]
    streams = 1 + d_in + ns
    spill = depth * streams * m * wp
    n_params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:])) + depth
    if kernel == "pinn_mlp_fwd2_res":
        flops = 2 * d_in * width
        for a, b in zip(dims[1:-1], dims[2:]):
            flops += streams * 2 * a * b
        words = m * d_in + n_params + m * n_out * (1 + 2 * d_in) + spill
    else:
        flops = 2 * 2 * d_in * width       # x-bar and W-bar_0
        for a, b in zip(dims[1:-1], dims[2:]):
            flops += 2 * streams * 2 * a * b
        words = (m * d_in + n_params + spill + m * n_out * streams
                 + m * d_in + n_params)
    flops *= n_sub * m
    nbytes = 4 * n_sub * words
    hbm, _, fp32 = _peaks()
    t_bytes, t_ops = nbytes / hbm, flops / fp32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", nbytes, flops)


def train_timing(dev, m_main: int) -> dict:
    """K3 and K4 at the quickstart megabatch (n_sub=4, width 24 x 4,
    d2_dirs=(0,)) and at width 80 x 5, same rows: device ms (CUDA graph of
    launches), wrapper-call ms, plain-version ms, bound."""
    import torch

    from repro_torch.kernels import pinn_mlp as K

    gen = torch.Generator().manual_seed(SEED + 3)
    out = {}
    for width, depth in ((24, 4), (80, 5)):
        d_in, n_out, act, n_sub, d2 = 2, 1, "tanh", 4, (0,)
        args = _net(gen, n_sub, m_main, d_in, width, depth, n_out, dev)
        cts = _cotangents(gen, n_sub, m_main, d_in, n_out, dev)
        res = K.pinn_mlp_fwd2_res(*args, n_out=n_out, act=act, d2_dirs=d2)[3]
        x, w, b, av = args
        calls = {
            "pinn_mlp_fwd2_res": (
                lambda: K.pinn_mlp_fwd2_res(*args, n_out=n_out, act=act,
                                            d2_dirs=d2),
                lambda: K.pinn_mlp_fwd2_res_plain(*args, n_out=n_out,
                                                  act=act, d2_dirs=d2)),
            "pinn_mlp_bwd2": (
                lambda: K.pinn_mlp_bwd2(x, w, av, res, *cts, n_out=n_out,
                                        act=act, d2_dirs=d2),
                lambda: K.pinn_mlp_bwd2_plain(x, w, av, res, *cts,
                                              n_out=n_out, act=act,
                                              d2_dirs=d2))}
        for name, (kern, plain) in calls.items():
            bms, by, nbytes, flops = train_bound(n_sub, m_main, d_in, width,
                                                 depth, n_out, len(d2), name)
            row = {"kernel": name, "shape": f"n_sub={n_sub} m={m_main} "
                   f"w{width}x{depth} d_in={d_in} d2={list(d2)}",
                   "ms": _graph_ms(kern, 200),
                   "call_ms": _events_ms(kern, 200),
                   "plain_ms": _events_ms(plain, 20), "bound_ms": bms,
                   "bound_by": by, "bytes": nbytes, "flops": flops}
            out[(name, width, depth, m_main)] = row
            emit({"timing": row})
    return out


def ab_phase(dev, other: str, m_main: int) -> None:
    """K3 and K4 of this checkout against those built from the sources in
    the directory ``other`` (``pinn_mlp_fwd.cu`` and ``pinn_mlp_bwd.cu`` of
    another revision, with the same C interface), in one process on one
    card: each library held against the plain versions, then both timed in
    turns (other, this, this, other) at train_timing's two shapes."""
    import ctypes

    import torch
    from repro_torch.kernels import native
    from repro_torch.kernels import pinn_mlp as K

    libs = {"this": (K._library, K._library_bwd)}
    other_libs = []
    for stem, bind in (("pinn_mlp_fwd", K.bind_fwd),
                       ("pinn_mlp_bwd", K.bind_bwd)):
        built = native.build([os.path.join(other, stem + ".cu")])[stem]
        rows = _ptxas_report(built["log"])
        emit({"ab_build": {"source": os.path.join(other, stem + ".cu"),
                           "registers": [min(r[1] for r in rows),
                                         max(r[1] for r in rows)],
                           "spill_bytes_max": max(r[2] for r in rows)}})
        lib = bind(ctypes.CDLL(built["path"]))
        other_libs.append(lambda lib=lib: lib)
    libs["other"] = tuple(other_libs)
    gen = torch.Generator().manual_seed(SEED + 3)
    try:
        for width, depth in ((24, 4), (80, 5)):
            d_in, n_out, act, n_sub, d2 = 2, 1, "tanh", 4, (0,)
            args = _net(gen, n_sub, m_main, d_in, width, depth, n_out, dev)
            cts = _cotangents(gen, n_sub, m_main, d_in, n_out, dev)
            want, wbar = _run_train(False, args, n_out, act, d2, cts)
            x, w, b, av = args
            res = want[3]
            calls = {
                "pinn_mlp_fwd2_res": lambda: K.pinn_mlp_fwd2_res(
                    *args, n_out=n_out, act=act, d2_dirs=d2),
                "pinn_mlp_bwd2": lambda: K.pinn_mlp_bwd2(
                    x, w, av, res, *cts, n_out=n_out, act=act, d2_dirs=d2)}
            times = {}
            for side in ("other", "this", "this", "other"):
                K._library, K._library_bwd = libs[side]
                got, gbar = _run_train(True, args, n_out, act, d2, cts)
                torch.cuda.synchronize()
                _compare(got, want, d_in, d2)
                be = max(_leaf_err(g, v) for g, v in zip(gbar, wbar))
                check(be <= TOL, f"{side} K4 disagrees: {be:.3e}")
                for name, fn in calls.items():
                    times.setdefault((name, side), []).append(
                        _graph_ms(fn, 200))
            for name in calls:
                bms = train_bound(n_sub, m_main, d_in, width, depth, n_out,
                                  len(d2), name)[0]
                emit({"ab": {"kernel": name,
                             "shape": f"n_sub={n_sub} m={m_main} "
                                      f"w{width}x{depth} d_in={d_in} "
                                      f"d2={list(d2)}",
                             "other_ms": times[(name, "other")],
                             "this_ms": times[(name, "this")],
                             "bound_ms": bms}})
    finally:
        K._library, K._library_bwd = libs["this"]


def _train_setup(device, seed=SEED):
    """The quickstart's model, batch and trainer on ``device``."""
    from repro_torch.core import (Burgers1D, CartesianDecomposition, DDConfig,
                                  ReferenceTrainer, XPINN, build_topology)
    from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
    from repro_torch.data import make_batch

    pde = Burgers1D()
    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    topo = build_topology(dec, n_iface=20)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    batch = make_batch(dec, topo, pde, n_res=1000, n_bnd=80,
                       rng=np.random.default_rng(seed))
    trainer = ReferenceTrainer(pde, cfg, topo,
                               DDConfig(method=XPINN, residual_path="fused"),
                               lrs=2e-3, device=device)
    return trainer, batch.device_arrays(trainer.device)


def _rows(b) -> int:
    """Megabatch rows per subdomain: residual, interface and data points."""
    return int(b.res_pts.shape[1] + b.iface_pts.shape[1] * b.iface_pts.shape[2]
               + b.data_pts.shape[1])


def train_phase(dev) -> dict:
    """The quickstart on the card through the port's entry point, its
    launch counts, a 10-step card-vs-CPU trajectory and the step time."""
    import torch
    from repro_torch.core import TrainState
    from repro_torch.core.nets import map_tree, tree_leaves
    from repro_torch.kernels import pinn_mlp as K
    from repro_torch.launch import quickstart
    from repro_torch.optim.adam import init_adam

    steps = 1500
    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = quickstart.main(["--device", "cuda", "--steps", str(steps),
                              "--chunk", "250"])
    secs = time.perf_counter() - t0
    counts, plain = dict(K.launches), dict(K.plain_calls)
    report = json.loads(buf.getvalue().strip().splitlines()[-1])["quickstart"]
    check(rc == 0, f"quickstart exited {rc}")
    check(report["rel_l2"] < 0.5, f"rel-L2 {report['rel_l2']:.4f} >= 0.5")
    for k in ("pinn_mlp_fwd2_res", "pinn_mlp_bwd2"):
        check(counts[k] == steps, f"{k}: {counts[k]} launches for {steps} "
                                  "loss evaluations")
    check(counts["pinn_mlp_fwd1"] > 0, "rel-L2 evaluation never ran K1")
    check(not any(plain.values()), f"plain versions on CUDA tensors: {plain}")
    emit({"train": {
        "seconds": round(secs, 3), "rel_l2": report["rel_l2"],
        "chunks": [{"step": r["step"], "steps_per_s": r["steps_per_s"],
                    "rel_l2": r["rel_l2"]} for r in report["chunks"]],
        "launches": counts, "plain_calls_on_cuda": plain}})

    # 10 steps from one init on the card (kernels) and on the CPU (plain)
    tr_gpu, b_gpu = _train_setup(dev)
    tr_cpu, b_cpu = _train_setup("cpu")
    s_cpu = tr_cpu.init(SEED)
    p_gpu = map_tree(lambda t: t.to(dev), s_cpu.params)
    s_gpu = TrainState(params=p_gpu, opt=init_adam(p_gpu),
                       step=s_cpu.step.to(dev))
    s_gpu, t_gpu = tr_gpu.run_chunk(s_gpu, b_gpu, 10)
    s_cpu, t_cpu = tr_cpu.run_chunk(s_cpu, b_cpu, 10)
    term_err = max(float(((t_gpu[k].cpu() - t_cpu[k]).abs()
                          / t_cpu[k].abs().clamp(min=1e-6)).max())
                   for k in t_cpu)
    par_err = max(float((g.cpu() - c).abs().max()) for g, c in
                  zip(tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)))
    check(term_err <= TRAJ_RTOL, f"10-step terms card vs CPU: {term_err:.3e}")
    check(par_err <= TRAJ_ATOL, f"10-step params card vs CPU: {par_err:.3e}")

    # ms per training step at the quickstart shape, over chunks of 100
    # steps (three repeats), then a profiler split of 20 steady steps
    trainer, b = _train_setup(dev)
    state = trainer.init(SEED)
    state, _ = trainer.run_chunk(state, b, 20)       # warm-up
    torch.cuda.synchronize()
    n, reps = 100, []
    for _ in range(3):
        t0 = time.perf_counter()
        state, terms = trainer.run_chunk(state, b, n)
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) * 1e3 / n)
    step_ms = sorted(reps)[1]
    holder = {}

    def twenty():
        holder["s"] = trainer.run_chunk(state, b, 20)[0]

    t0 = time.perf_counter()
    twenty()
    torch.cuda.synchronize()
    wall20 = (time.perf_counter() - t0) * 1e3
    split = _device_split(twenty, TRAIN_KERNELS)
    k = split["kernel_ms"]
    trace = {"steps": 20, "wall_ms": wall20,
             "profiled_wall_ms": split["profiled_wall_ms"],
             "device_busy_ms": split["device_busy_ms"],
             "idle_share": 1.0 - split["device_busy_ms"] / wall20,
             "k3_ms": k["k3"], "k4_ms": k["k4"] + k["k4_reduce"],
             "k4_sweep_ms": k["k4"], "k4_reduce_ms": k["k4_reduce"],
             "device_events": split["device_events"], "top": split["top"]}
    check(k["k3"] > 0 and k["k4"] > 0,
          f"the training trace shows no K3 / K4 time: {k}")
    emit({"train_check": {
        "traj_term_rel_err": term_err, "traj_param_abs_err": par_err,
        "traj_rtol": TRAJ_RTOL, "traj_atol": TRAJ_ATOL,
        "step_ms": step_ms, "step_ms_repeats": reps,
        "m_per_sub": _rows(b), "trace": trace}})
    return {"launches": counts, "step_ms": step_ms}


# ------------------------------------------------------------------- runtime

def _counted(fn, *args):
    """Run ``fn`` with the PINN kernels' counts set to 0 just before and
    read just after: (result, seconds, launches, plain calls on CUDA)."""
    from repro_torch.kernels import pinn_mlp as K

    buf = io.StringIO()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = fn(*args)
    secs = time.perf_counter() - t0
    return res, buf.getvalue(), secs, dict(K.launches), dict(K.plain_calls)


def _quickstart_trainer(dev, nx):
    """The quickstart's trainer at nx x 2 subdomains on ``dev``."""
    from repro_torch.core import (Burgers1D, CartesianDecomposition, DDConfig,
                                  ReferenceTrainer, XPINN, build_topology)
    from repro_torch.core.nets import MLPConfig, SubdomainModelConfig

    dec = CartesianDecomposition(((-1, 1), (0, 1)), nx, 2)
    topo = build_topology(dec, n_iface=20)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    tr = ReferenceTrainer(Burgers1D(), cfg, topo,
                          DDConfig(method=XPINN, residual_path="fused"),
                          lrs=2e-3, device=dev)
    return tr, dec


def runtime_phase(dev) -> dict:
    """The fault-tolerant runtime on the card: (a) the supervised quickstart
    under the fault matrix, (b) bitwise crash recovery, (c) elastic resume
    4 -> 6 subdomains, (d) field serving under the serve fault matrix."""
    import torch
    from repro_torch.core import evaluate_l2
    from repro_torch.core.nets import tree_leaves
    from repro_torch.launch import quickstart, serve_field
    from repro_torch.runtime import (Fault, FaultInjector, Supervisor,
                                     SupervisorConfig, elastic_resume)

    t_phase = time.perf_counter()
    out = {"card": _smi()}
    k3, k4 = "pinn_mlp_fwd2_res", "pinn_mlp_bwd2"
    with tempfile.TemporaryDirectory() as tmp:
        # (a) supervised quickstart under crash, NaN and straggler faults
        ck = os.path.join(tmp, "ck")
        steps, chunk = 1500, 250
        spec = "crash@1,nan_params@2:0,straggler@3*0.1"
        rc, text, secs, counts, plain = _counted(quickstart.main, [
            "--device", "cuda", "--steps", str(steps), "--chunk", str(chunk),
            "--supervised", "--ckpt", ck, "--inject", spec])
        rep = json.loads(text.strip().splitlines()[-1])["quickstart"]
        sup = rep["supervisor"]
        check(rc == 0, f"supervised quickstart exited {rc}")
        check((sup["crashes"], sup["guard_trips"], sup["restarts"],
               sup["stragglers"]) == (1, 1, 2, 1), f"supervisor {sup}")
        check(rep["rel_l2"] < 0.5, f"supervised rel-L2 {rep['rel_l2']:.4f}")
        # every attempt ran a whole chunk (250 divides 1500): the committed
        # ones and the two rolled back, whose guarded chunk went on through
        # frozen steps after the trip
        attempts = sup["chunks"] + sup["restarts"]
        check(attempts == 8, f"{attempts} chunk attempts, expected 8")
        for k in (k3, k4):
            check(counts[k] == attempts * chunk,
                  f"{k}: {counts[k]} launches for {attempts} attempts x "
                  f"{chunk} steps")
        check(counts["pinn_mlp_fwd1"] > 0, "rel-L2 evaluation never ran K1")
        check(not any(plain.values()), f"plain versions on CUDA: {plain}")
        out["supervised"] = {
            "argv_inject": spec, "steps": steps, "chunk": chunk,
            "seconds": secs, "rel_l2": rep["rel_l2"], "attempts": attempts,
            "committed_steps_per_s": [chunk / w for w in sup["walltimes"]],
            "supervisor": sup, "launches": counts,
            "plain_calls_on_cuda": plain}

        # (b) crash recovery is bitwise on the card
        def crash_and_replay():
            tr, b = _train_setup(dev)
            s = Supervisor(tr, os.path.join(tmp, "ck_b"),
                           SupervisorConfig(chunk_steps=100),
                           FaultInjector([Fault(chunk=1, kind="crash")]))
            s_f, report = s.run(tr.init(SEED), b, 300)
            s_b = tr.init(SEED)
            for _ in range(3):
                s_b, _ = tr.run_chunk(s_b, b, 100)
            diff = max(float((x - y).abs().max()) for x, y in zip(
                tree_leaves((s_f.params, s_f.opt["m"], s_f.opt["v"])),
                tree_leaves((s_b.params, s_b.opt["m"], s_b.opt["v"]))))
            same = (int(s_f.step) == int(s_b.step) == 300
                    and int(s_f.opt["count"]) == int(s_b.opt["count"]))
            return report, diff, same, s_f.params["u"]["W"][0].is_cuda

        (report, diff, same, on_card), _, secs, counts, plain = _counted(
            crash_and_replay)
        check(report.crashes == 1 and report.chunks == 3,
              f"crash run: {report.as_dict()}")
        check(on_card and same, "crash run: state off the card or steps "
                                "differ")
        check(diff == 0.0, f"crash recovery differs by {diff:.3e} on the "
                           "card (must be bitwise)")
        # 4 supervised attempts + 3 uninterrupted chunks of 100 steps
        check(counts[k3] == counts[k4] == 700, f"crash run launches {counts}")
        check(not any(plain.values()), f"plain versions on CUDA: {plain}")
        out["bitwise_recovery"] = {
            "steps": 300, "chunk": 100, "max_abs_diff": diff,
            "recovery_s": report.recovery_s, "seconds": secs,
            "launches": counts}

        # what the guard costs: ms per step of guarded and plain chunks of
        # 100 steps from one state, in turns (guarded, plain, plain,
        # guarded), then 20 steps of each under the profiler
        tr, b = _train_setup(dev)
        st, _ = tr.run_chunk(tr.init(SEED), b, 20)          # warm-up
        chunks = {"guarded": lambda n: tr.run_chunk_guarded(st, b, n),
                  "plain": lambda n: tr.run_chunk(st, b, n)}
        turns = {"guarded": [], "plain": []}
        for kind in ("guarded", "plain", "plain", "guarded"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chunks[kind](100)
            torch.cuda.synchronize()
            turns[kind].append((time.perf_counter() - t0) * 1e3 / 100)
        cost = {"ms_per_step": turns}
        for kind, run in chunks.items():
            split = _device_split(lambda: run(20), TRAIN_KERNELS)
            cost[kind] = {
                "device_events_per_step": split["device_events"] / 20,
                "device_busy_ms_per_step": split["device_busy_ms"] / 20,
                "profiled_wall_ms_per_step": split["profiled_wall_ms"] / 20,
                "top": split["top"]}
        out["guard_cost"] = cost

        # (c) elastic resume of (a)'s checkpoint at 3 x 2 subdomains
        def warm_cold():
            tr6, dec6 = _quickstart_trainer(dev, 3)
            resumed, meta = elastic_resume(ck, tr6, dec6)
            l2 = lambda p: evaluate_l2(dec6, tr6.model_cfg, p, tr6.act_codes,
                                       tr6.pde, device=dev)
            return (l2(resumed.params), l2(tr6.init(SEED).params),
                    meta["supervisor"]["decomp"]["n_sub"], int(resumed.step))

        (warm, cold, n_old, at), _, _, _, _ = _counted(warm_cold)
        check(n_old == 4 and at == steps, f"resumed n_sub {n_old} step {at}")
        check(warm < cold, f"warm start {warm:.4f} not better than cold "
                           f"{cold:.4f}")
        more = 500
        rc, text, secs, counts, plain = _counted(quickstart.main, [
            "--device", "cuda", "--nx", "3", "--steps", str(steps + more),
            "--chunk", str(chunk), "--supervised", "--resume", ck,
            "--ckpt", os.path.join(tmp, "ck6")])
        rep = json.loads(text.strip().splitlines()[-1])["quickstart"]
        check(rc == 0, f"elastic quickstart exited {rc}")
        check(rep["resumed"]["n_sub_from"] == 4 and
              rep["resumed"]["n_sub"] == 6, f"resume {rep['resumed']}")
        check(rep["rel_l2"] < 0.5, f"elastic rel-L2 {rep['rel_l2']:.4f}")
        for k in (k3, k4):
            check(counts[k] == more, f"elastic {k}: {counts[k]} launches")
        check(not any(plain.values()), f"plain versions on CUDA: {plain}")
        out["elastic"] = {"n_sub": [4, 6], "rel_l2_warm": warm,
                          "rel_l2_cold": cold, "steps_more": more,
                          "rel_l2": rep["rel_l2"], "seconds": secs,
                          "launches": counts}

    # (d) field serving under the serve fault matrix, order 2 (K2), 1 (K1)
    faults = "engine-raise@3,nan-output@5,slow-engine@7*0.05"
    out["serve"] = []
    for order, kernel in ((2, "pinn_mlp_fwd2"), (1, "pinn_mlp_fwd1")):
        argv = ["--demo", "cart", "--device", "cuda", "--max-requests", "40",
                "--order", str(order), "--faults", faults]
        with contextlib.redirect_stderr(io.StringIO()):
            rc, text, secs, counts, plain = _counted(serve_field.main, argv)
        report = json.loads(text[text.index("{"):])
        check(rc == 0, f"serve_field --faults --order {order} exited {rc}")
        check(report["drained"]["unanswered"] == 0,
              f"order {order}: unanswered tickets under faults")
        check(sum(report["by_status"].values()) == report["requests"],
              f"order {order}: statuses {report['by_status']}")
        check(counts[kernel] > 0, f"order {order}: {kernel} never launched")
        check(not any(plain.values()), f"plain versions on CUDA: {plain}")
        st = report["stats"]
        out["serve"].append({
            "order": order, "faults": faults, "seconds": secs,
            "requests": report["requests"], "by_status": report["by_status"],
            "goodput": report["goodput"], "p50_s": report["p50_s"],
            "p99_s": report["p99_s"], "guard_trips": st["guard_trips"],
            "flush_failures": st["flush_failures"], "retries": st["retries"],
            "launches": counts})
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    emit({"runtime": out})
    return out


# ---------------------------------------------------------------- distributed

# phase ep: deepseek-moe-16b's routed experts split over gloo ranks
EP_ARCH = "deepseek-moe-16b"
EP_PREFILL = {"grid": (2, 2), "layers": 4, "batch": 2, "seq": 1024}
EP_TRAIN = {"grid": (1, 2), "layers": 2, "batch": 2, "seq": 1024,
            "steps": 10, "lr": 3e-4}
EP_TIME_REPS = 3         # bf16 prefills timed after the recorded one
EP_TIME_STEPS = 3        # training steps timed without the recorder
EP_LOGIT_TOL = 1e-4      # float32 ranks against the twin, of max |logit|
EP_LOSS_TOL = 1e-5       # the ranks' losses against the twin's, each step
EP_PARAM_TOL = 1e-4      # final params, of max(1, max |want|)
# (c) a sequence-split decode: llama3.2-1b's cache split along T over the
# model group of (b)'s ranks
SEQ_ARCH = "llama3.2-1b"
SEQ_CELL = {"grid": (1, 2), "batch": 2, "cache": 4096,
            "prompts": (1536, 3072), "steps": 16}
# of max |logit|: float32 EP_LOGIT_TOL's bar; bf16 the port's bf16 logits
# bar (tests/test_torch_lm.py: roundings placed otherwise), since one bf16
# ulp of a logit near max |logit| is 2^-8 to 2^-7 of it, above DECODE_TOL
# (a float32 bar)
SEQ_TOL = {"float32": EP_LOGIT_TOL, "bfloat16": 3e-2}
DIST_RANKS = 4
DIST_STEPS, DIST_CHUNK = 1500, 250
DIST_TURN_STEPS = 100
# the distributed trainer against ReferenceTrainer after 10 steps: the
# reference's bounds (tests/test_parallel_equivalence.py)
DIST_PARAM_TOL = 1e-5
DIST_LOSS_RTOL = 1e-4


def _dist_setup(dev, rank_trainer=True, **dd):
    """The quickstart's problem (2 x 2 Burgers XPINN, 24 x 4 nets, n_iface
    20, n_res 1000, n_bnd 80, lrs 2e-3, fused path) with a
    DistributedDDTrainer (inside a process group) or a ReferenceTrainer;
    the global batch on ``dev``."""
    from repro_torch.core import (Burgers1D, CartesianDecomposition,
                                  DDConfig, DistributedDDTrainer,
                                  ReferenceTrainer, XPINN, build_topology)
    from repro_torch.core.nets import MLPConfig, SubdomainModelConfig
    from repro_torch.data import make_batch

    pde = Burgers1D()
    dec = CartesianDecomposition(((-1, 1), (0, 1)), 2, 2)
    topo = build_topology(dec, n_iface=20)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 24, 4)})
    batch = make_batch(dec, topo, pde, n_res=1000, n_bnd=80,
                       rng=np.random.default_rng(SEED))
    cls = DistributedDDTrainer if rank_trainer else ReferenceTrainer
    tr = cls(pde, cfg, topo, DDConfig(method=XPINN, residual_path="fused",
                                      **dd), lrs=2e-3, device=dev)
    return tr, batch.device_arrays(dev), dec


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _leaves_np(tree) -> list:
    from repro_torch.core.nets import tree_leaves
    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


def _dist_rank(mesh, ck_dir: str) -> dict:
    """One rank of the distributed phase, (a)-(d); every step with the
    PINN kernels' counts set to 0 just before and read just after."""
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import DataParallelTrainer, evaluate_l2
    from repro_torch.core.domain import build_topology
    from repro_torch.core.nets import tree_leaves
    from repro_torch.data import make_batch
    from repro_torch.kernels import pinn_mlp as K
    from repro_torch.optim import CompressionConfig
    from repro_torch.runtime import (Fault, FaultInjector, Supervisor,
                                     SupervisorConfig, inject_nan)
    from repro_torch.core import TrainState
    from repro_torch.utils.collectives import (CollectiveRecorder,
                                               collective_bytes)

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    dev = mesh.rank_device(rank)
    out = {"rank": rank, "device": str(dev)}

    def counted(fn):
        K.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        return (res, time.perf_counter() - t0, dict(K.launches),
                dict(K.plain_calls))

    tr, b_glob, dec = _dist_setup(dev)
    b = tr.shard_batch(b_glob)

    # (a) 10 steps from one init, gathered for the parent's comparison
    (s, terms), secs, cnt, plain = counted(
        lambda: tr.run_chunk(tr.init(SEED), b, 10))
    g = tr.gather_state(s)
    out["a"] = {"params": _leaves_np(g.params) if rank == 0 else None,
                "loss": float(terms["loss"][-1].sum()), "seconds": secs,
                "launches": cnt, "plain": plain}

    # (b) 1500 steps in chunks of 250, then rel-L2 through K1 on rank 0
    def train():
        st = tr.init(SEED)
        for _ in range(DIST_STEPS // DIST_CHUNK):
            st, _ = tr.run_chunk(st, b, DIST_CHUNK)
        return st

    s_b, secs, cnt, plain = counted(train)
    params = tr.gather_state(s_b).params
    l2, _, l2_cnt, l2_plain = counted(
        lambda: evaluate_l2(dec, tr.model_cfg, params, tr.act_codes, tr.pde,
                            device=dev) if rank == 0 else None)
    out["b"] = {"seconds": secs, "launches": cnt, "plain": plain,
                "rel_l2": l2, "l2_launches": l2_cnt, "l2_plain": l2_plain}
    # one step under the collective recorder: the halo exchange's sends
    dist.barrier()
    with CollectiveRecorder() as rec:
        tr.step(s_b, b)
        _sync(dev)
    out["halo_record"] = {**collective_bytes(rec.record),
                          "by_group": _ep_recorded(rec.record)[0]}

    # exchange on / off in turns (on, off, off, on) from s_b: the
    # compute / communication split per step
    tr_off, _, _ = _dist_setup(dev, disable_exchange=True)
    run = {"on": tr, "off": tr_off}
    turns = {"on": [], "off": []}
    staged = []
    for kind in ("on", "off", "off", "on"):
        dist.barrier()
        _sync(dev)
        b0 = tr.comm.staged_bytes
        t0 = time.perf_counter()
        run[kind].run_chunk(s_b, b, DIST_TURN_STEPS)
        _sync(dev)
        turns[kind].append((time.perf_counter() - t0) * 1e3
                           / DIST_TURN_STEPS)
        if kind == "on":
            staged.append((tr.comm.staged_bytes - b0) / DIST_TURN_STEPS)
    out["turns_ms"] = turns
    out["staged_bytes_per_step"] = staged
    # named scopes of 20 steps under the profiler (rank 0; the others run
    # the same chunk unprofiled, in lockstep)
    dist.barrier()
    if rank == 0:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.run_chunk(s_b, b, 20)
            _sync(dev)
        # a scope is a host range and, with CUDA activity on, a device
        # annotation of the same name: keep both
        host, card = dict.fromkeys(SCOPES, 0.0), dict.fromkeys(SCOPES, 0.0)
        for e in prof.key_averages():
            if e.key not in SCOPES:
                continue
            if e.device_type == DeviceType.CPU:
                host[e.key] += e.cpu_time_total / 1e3 / 20
            else:
                card[e.key] += e.device_time_total / 1e3 / 20
        out["scopes_ms_per_step"] = {"host": host, "device_span": card}
    else:
        tr.run_chunk(s_b, b, 20)

    # (c) data parallel, 4 workers, none / int8 / top-k, 30 steps each
    from repro_torch.core import Burgers1D, CartesianDecomposition
    from repro_torch.core.nets import MLPConfig, SubdomainModelConfig

    pde = Burgers1D()
    dec4 = CartesianDecomposition(((-1, 1), (0, 1)), 4, 1)
    bdp = make_batch(dec4, build_topology(dec4, 4), pde, n_res=64, n_bnd=16,
                     rng=np.random.default_rng(0)).device_arrays(dev)
    cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 20, 3)})
    out["c"] = []
    for comp in (None, CompressionConfig("int8"),
                 CompressionConfig("topk", topk_frac=0.05)):
        dp = DataParallelTrainer(pde, cfg, n_workers=mesh.n_sub,
                                 compression=comp, lr=5e-4,
                                 residual_path="fused", device=dev)

        def thirty():
            st, losses = dp.init(SEED), []
            for _ in range(30):
                st, t = dp.step(st, bdp)
                losses.append(float(t["loss"]))
            return st, losses

        (st, losses), secs, cnt, plain = counted(thirty)
        full = dp.gather_state(st)
        row = {"scheme": None if comp is None else comp.scheme,
               "loss_first": losses[0], "loss_last": losses[-1],
               "seconds": secs, "launches": cnt, "plain": plain}
        # one step recorded: one packed all-reduce of the gradient and
        # the terms
        with CollectiveRecorder() as rec:
            _, terms = dp.step(st, bdp)
            _sync(dev)
        row["record"] = collective_bytes(rec.record)
        row["packed_bytes"] = 4 * (sum(t.numel() for t in
                                       tree_leaves(st["params"]))
                                   + len(terms))
        # params stay replicated bitwise: every worker applies one gradient
        p = torch.cat([t.reshape(-1) for t in tree_leaves(st["params"])])
        allp = dp.comm.all_gather(p)
        row["param_spread"] = float((allp - allp[0]).abs().max())
        if comp is not None:
            e0 = tree_leaves(full["err"])[0]
            row["err_spread"] = float(max((e0[i] - e0[0]).abs().max()
                                          for i in range(1, mesh.n_sub)))
        out["c"].append(row)

    # (d) supervised crash replay (3 x 100 steps, crash after chunk 1)
    # against three uninterrupted chunks; the consensus guard
    def crash_replay():
        sup = Supervisor(tr, ck_dir, SupervisorConfig(chunk_steps=100),
                         FaultInjector([Fault(chunk=1, kind="crash")]),
                         decomp=dec)
        s_f, report = sup.run(tr.init(SEED), b, 300)
        s_u = tr.init(SEED)
        for _ in range(3):
            s_u, _ = tr.run_chunk(s_u, b, 100)
        diff = max(float(np.abs(x - y).max()) for x, y in zip(
            _leaves_np((s_f.params, s_f.opt["m"], s_f.opt["v"])),
            _leaves_np((s_u.params, s_u.opt["m"], s_u.opt["v"]))))
        same = (int(s_f.step) == int(s_u.step) == 300 and
                s_f.opt["count"].tolist() == s_u.opt["count"].tolist())
        st = tr.init(SEED)
        if tr.fault_target(0):
            tree = inject_nan({"params": st.params, "opt": st.opt,
                               "step": st.step}, "nan_params", 0)
            st = TrainState(params=tree["params"], opt=tree["opt"],
                            step=tree["step"])
        _, _, health = tr.run_chunk_guarded(st, b, 4)
        return (report, diff, same, tr.gather_state(s_f),
                health["ok_sub"].tolist(), int(health["good_steps"]))

    (report, diff, same, g_f, ok_sub, good), secs, cnt, plain = counted(
        crash_replay)
    out["d"] = {"report": {k: v for k, v in report.as_dict().items()
                           if isinstance(v, int)},
                "recovery_s": report.recovery_s, "max_abs_diff": diff,
                "same_step_and_count": same, "ok_sub": ok_sub,
                "good_steps": good, "seconds": secs, "launches": cnt,
                "plain": plain,
                "params": _leaves_np(g_f.params) if rank == 0 else None}

    # does gloo's all-reduce take a tensor on the card as it is?
    try:
        t = torch.ones(1, device=dev)
        dist.all_reduce(t)
        out["gloo_all_reduce_cuda"] = float(t) == mesh.n_sub
    except (RuntimeError, ValueError) as e:
        out["gloo_all_reduce_cuda"] = f"{type(e).__name__}: {e}"[:200]
    return out


def distributed_phase(dev) -> dict:
    """Algorithm 1 with one rank per subdomain on the card: 4 ``gloo`` ranks
    (``repro_torch.launch.mesh``) sharing it, (a) parity with
    ReferenceTrainer after 10 steps, (b) 1500 steps to rel-L2 < 0.5 with
    the compute / communication split, (c) the data-parallel baseline
    with and without compression, (d) supervised crash replay, the
    consensus guard and the checkpoint resumed in ReferenceTrainer, (e)
    ``launch.train pinn --distributed``."""
    from repro_torch.core.nets import tree_leaves
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.runtime import elastic_resume

    t_phase = time.perf_counter()
    k3, k4, k1 = "pinn_mlp_fwd2_res", "pinn_mlp_bwd2", "pinn_mlp_fwd1"
    res = {"card": _smi(), "ranks": DIST_RANKS}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        mesh = mesh_lib.make_pinn_mesh(DIST_RANKS, tmp, dev.type,
                                       timeout_s=300)
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        ranks = mesh_lib.run_ranks(mesh, _dist_rank, ck, deadline_s=600)
        res["group_seconds"] = time.perf_counter() - t0
        res["backend"] = mesh.backend
        res["devices"] = [r["device"] for r in ranks]
        res["gloo_all_reduce_cuda"] = ranks[0]["gloo_all_reduce_cuda"]
        launches = {}

        def add(cnt):
            for k, v in cnt.items():
                launches[k] = launches.get(k, 0) + v

        # (a) parity with ReferenceTrainer on the card
        ref, b, dec = _dist_setup(dev, rank_trainer=False)
        s_ref, t_ref = ref.run_chunk(ref.init(SEED), b, 10)
        par = max(float(np.abs(x - y.detach().cpu().numpy()).max())
                  for x, y in zip(ranks[0]["a"]["params"],
                                  tree_leaves(s_ref.params)))
        l_ref = float(t_ref["loss"][-1].sum())
        l_d = ranks[0]["a"]["loss"]
        check(par <= DIST_PARAM_TOL, f"(a) params differ by {par:.3e}")
        check(abs(l_d - l_ref) <= DIST_LOSS_RTOL * max(1.0, abs(l_ref)),
              f"(a) loss {l_d} against {l_ref}")
        for r in ranks:
            check(r["a"]["launches"][k3] == r["a"]["launches"][k4] == 10,
                  f"(a) rank {r['rank']} launches {r['a']['launches']}")
            check(not any(r["a"]["plain"].values()),
                  f"(a) plain calls on CUDA {r['a']['plain']}")
            add(r["a"]["launches"])
        res["a"] = {"param_max_abs_diff": par, "loss": l_d,
                    "loss_reference": l_ref, "tol": DIST_PARAM_TOL}

        # (b) training: exactly one K3 and one K4 per step on every rank
        for r in ranks:
            cnt = r["b"]["launches"]
            check(cnt[k3] == cnt[k4] == DIST_STEPS,
                  f"(b) rank {r['rank']}: {cnt[k3]} K3 / {cnt[k4]} K4 for "
                  f"{DIST_STEPS} steps")
            check(not any(r["b"]["plain"].values())
                  and not any(r["b"]["l2_plain"].values()),
                  f"(b) plain calls on CUDA on rank {r['rank']}")
            add(cnt)
            add(r["b"]["l2_launches"])
        r0 = ranks[0]
        check(r0["b"]["rel_l2"] < 0.5, f"(b) rel-L2 {r0['b']['rel_l2']:.4f}")
        check(r0["b"]["l2_launches"][k1] > 0, "(b) rel-L2 never ran K1")
        on = sorted(max(r["turns_ms"]["on"][i] for r in ranks)
                    for i in range(2))
        off = sorted(max(r["turns_ms"]["off"][i] for r in ranks)
                     for i in range(2))
        on_ms, off_ms = sum(on) / 2, sum(off) / 2
        # the single-process trainer, same problem, same card, same run
        st, _ = ref.run_chunk(ref.init(SEED), b, 20)
        ref_ms = []
        for _ in range(2):
            _sync(dev)
            t0 = time.perf_counter()
            ref.run_chunk(st, b, DIST_TURN_STEPS)
            _sync(dev)
            ref_ms.append((time.perf_counter() - t0) * 1e3 / DIST_TURN_STEPS)
        res["b"] = {
            "steps": DIST_STEPS, "chunk": DIST_CHUNK,
            "rel_l2": r0["b"]["rel_l2"],
            "seconds": [r["b"]["seconds"] for r in ranks],
            "ms_per_step_1500": [r["b"]["seconds"] * 1e3 / DIST_STEPS
                                 for r in ranks],
            "turns_ms_per_step": {"on": [r["turns_ms"]["on"] for r in ranks],
                                  "off": [r["turns_ms"]["off"]
                                          for r in ranks]},
            "ms_per_step": on_ms, "compute_ms_per_step": off_ms,
            "comm_ms_per_step": on_ms - off_ms,
            "comm_share": (on_ms - off_ms) / on_ms,
            "staged_bytes_per_step": [r["staged_bytes_per_step"]
                                      for r in ranks],
            "scopes_ms_per_step_rank0": r0["scopes_ms_per_step"],
            "reference_trainer_ms_per_step": ref_ms}
        # the recorded step's sends against the analytic halo traffic
        from repro_torch.obs.profiling import halo_traffic
        traffic = halo_traffic(ref.topo, ref.pde.n_fields + ref.pde.n_eq)
        sent = [r["halo_record"]["bytes_by_kind"].get("collective-permute",
                                                      0.0) for r in ranks]
        sends = [r["halo_record"]["counts"].get("collective-permute", 0)
                 for r in ranks]
        check(sent == traffic["per_device_bytes"]
              and max(sends) == traffic["collective_permute_ops"],
              f"(b) recorded sends {sends} of {sent} bytes, analytic "
              f"{traffic['collective_permute_ops']} of "
              f"{traffic['per_device_bytes']}")
        res["b"]["halo_recorded"] = {
            "per_device_bytes": sent, "sends": sends,
            "analytic": {k: traffic[k] for k in (
                "per_device_bytes", "collective_permute_ops")},
            "rank0": r0["halo_record"]}

        # (c) data parallel
        for i, row in enumerate(r0["c"]):
            for r in ranks:
                cnt = r["c"][i]["launches"]
                check(cnt[k3] == cnt[k4] == 30,
                      f"(c) {row['scheme']}: rank {r['rank']} launches {cnt}")
                check(not any(r["c"][i]["plain"].values()),
                      f"(c) plain calls on CUDA {r['c'][i]['plain']}")
                add(cnt)
            check(row["loss_last"] < row["loss_first"],
                  f"(c) {row['scheme']}: loss {row['loss_first']} -> "
                  f"{row['loss_last']}")
            check(row["param_spread"] == 0.0,
                  f"(c) {row['scheme']}: params differ across workers")
            for r in ranks:
                rec = r["c"][i]["record"]
                check(rec["counts"] == {"all-reduce": 1} and
                      rec["bytes_by_kind"]["all-reduce"]
                      == r["c"][i]["packed_bytes"],
                      f"(c) {row['scheme']}: rank {r['rank']} recorded "
                      f"{rec}, want one all-reduce of "
                      f"{r['c'][i]['packed_bytes']} bytes")
            if row["scheme"] is not None:
                check(row["err_spread"] > 0.0, f"(c) {row['scheme']}: the "
                      "error feedback is the same on every worker")
        res["c"] = [{k: v for k, v in row.items()
                     if k not in ("launches", "plain")} for row in r0["c"]]

        # (d) supervisor: crash replay exact, the guard by consensus, the
        # distributed checkpoint resumed in ReferenceTrainer
        for r in ranks:
            d = r["d"]
            check(d["max_abs_diff"] == 0.0 and d["same_step_and_count"],
                  f"(d) rank {r['rank']}: replay differs by "
                  f"{d['max_abs_diff']:.3e}")
            check(d["report"]["crashes"] == 1 and d["report"]["chunks"] == 3,
                  f"(d) rank {r['rank']}: {d['report']}")
            check(d["ok_sub"][0] is False and d["ok_sub"][3] is True
                  and d["good_steps"] == 1,
                  f"(d) guard: ok_sub {d['ok_sub']} good {d['good_steps']}")
            # 4 supervised attempts + 3 uninterrupted chunks of 100, and 4
            # guarded steps
            check(d["launches"][k3] == d["launches"][k4] == 704,
                  f"(d) rank {r['rank']} launches {d['launches']}")
            check(not any(d["plain"].values()), "(d) plain calls on CUDA")
            add(d["launches"])
        resumed, meta = elastic_resume(ck, ref, dec)
        rdiff = max(float(np.abs(x - y.detach().cpu().numpy()).max())
                    for x, y in zip(r0["d"]["params"],
                                    tree_leaves(resumed.params)))
        check(rdiff == 0.0 and int(resumed.step) == 300
              and int(resumed.opt["count"]) == 300,
              f"(d) ReferenceTrainer resume differs by {rdiff:.3e}")
        res["d"] = {k: r0["d"][k] for k in ("report", "recovery_s",
                                            "max_abs_diff", "ok_sub",
                                            "good_steps", "seconds")}
        res["d"]["reference_resume_max_abs_diff"] = rdiff

        # (e) the CLI, as a user runs it
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=SRC)
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "pinn",
             "--distributed", "--nx", "2", "--nt", "2", "--steps", "20",
             "--device", dev.type],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        check(p.returncode == 0, f"(e) train pinn --distributed exited "
              f"{p.returncode}: {p.stderr[-2000:]}")
        last = json.loads(p.stdout.strip().splitlines()[-1])["train"]
        res["e"] = {"seconds": time.perf_counter() - t0, "result": last,
                    "head": p.stdout.strip().splitlines()[:6]}
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    emit({"distributed": res})
    return launches


# ------------------------------------------------------------------ scenarios

# The bars hold the entry points at the reference examples' own settings,
# each a ratio of the reference's result (the examples at their defaults on
# a CPU, jax 0.9.0): trajectories part with the order of float32 sums, so a
# bar is a ratio, not a match.  Inverse problem: rel-L2 of (T, K) after
# 2000 steps at most 1.5 x the reference's 0.0098, and the served K field's
# rel-L2 at most 2 x its 0.0057 (K is the inferred unknown, and one number
# is a thin sample of its spread, hence the wider ratio).  Cavity: the Ghia
# centerline RMS after 4000 steps at most 1.5 x the reference's 0.0782 (a
# field of u = 0 scores 0.272).
INVERSE_BAR = 1.5 * 0.0098
INVERSE_SERVE_BAR = 2 * 0.0057
CAVITY_BAR = 1.5 * 0.0782
# paper Table 3's residual points per region, unscaled (the example divides
# them by 10)
PAPER_COUNTS = [3000, 4000, 5000, 4000, 3000, 4000, 800, 3000, 5000, 4000]
PAPER_STEPS = 100            # (b): the paper's size, timed; no bar
FUSED_INVERSE_STEPS = 500    # (c): no bar
CAVITY_FUSED_STEPS = 1000    # (e): no bar
CAVITY_TURN_STEPS = 100      # (e): chunks timed in turns
LBFGS_ADAM_STEPS, LBFGS_ITERS = 300, 60
LBFGS_PROBES = 14            # LBFGSConfig.n_probes
# 10 steps of one problem on two routes from one init: the distributed
# phase's bounds (params, summed loss relative)
SCEN_PARAM_TOL, SCEN_LOSS_RTOL = 1e-5, 1e-4
K1, K2, K3, K4 = ("pinn_mlp_fwd1", "pinn_mlp_fwd2", "pinn_mlp_fwd2_res",
                  "pinn_mlp_bwd2")


def _last_json(text: str, key: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])[key]


def _train_timed(tr, b, steps, chunk, state=None):
    """``steps`` outer steps in chunks from ``state`` (a fresh init by
    default): (state, ms per step over the chunks, last summed loss)."""
    import torch

    state = tr.init(SEED) if state is None else state
    done, secs, loss = 0, 0.0, float("nan")
    while done < steps:
        n = min(chunk, steps - done)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, terms = tr.run_chunk(state, b, n)
        loss = float(terms["loss"][-1].sum())    # waits for the chunk
        secs += time.perf_counter() - t0
        done += n
    return state, secs * 1e3 / steps, loss


def _parity(tr_a, b_a, tr_b, b_b, steps=10) -> dict:
    """``steps`` steps of two trainers of one problem from one init (drawn
    on ``tr_a``'s side, moved to ``tr_b``'s device): the largest parameter
    difference and the largest relative difference of the summed loss."""
    from repro_torch.core import TrainState
    from repro_torch.core.nets import map_tree, tree_leaves
    from repro_torch.optim.adam import init_adam

    s_a = tr_a.init(SEED)
    p_b = map_tree(lambda t: t.to(tr_b.device), s_a.params)
    s_b = TrainState(params=p_b, opt=init_adam(p_b),
                     step=s_a.step.to(tr_b.device))
    s_a, t_a = tr_a.run_chunk(s_a, b_a, steps)
    s_b, t_b = tr_b.run_chunk(s_b, b_b, steps)
    la, lb = t_a["loss"].sum(1).cpu(), t_b["loss"].sum(1).cpu()
    par = max(float((x.cpu() - y.cpu()).abs().max()) for x, y in
              zip(tree_leaves(s_a.params), tree_leaves(s_b.params)))
    loss = float(((la - lb).abs() / la.abs()).max())
    check(par <= SCEN_PARAM_TOL, f"{steps}-step params differ by {par:.3e}")
    check(loss <= SCEN_LOSS_RTOL, f"{steps}-step loss differs by {loss:.3e}")
    return {"param_max_abs": par, "loss_max_rel": loss,
            "loss_last": float(lb[-1]), "states": (s_a, s_b)}


def _no_kernels(counts, plain, what):
    check(not any(counts.values()), f"{what}: kernels launched {counts}")
    check(not any(plain.values()), f"{what}: plain versions on CUDA {plain}")


def scenarios_phase(dev) -> dict:
    """The paper's PINN scenarios on the card, each run with the launch
    counts set to 0 just before and read just after: (a) the inverse heat
    map at the example's defaults (jvp path, Table-3 activations) through
    ``launch.inverse_heat_map.main --export --serve-demo``, held to its
    bars, no kernel; (b) the same problem at the paper's size (3 x 80 per
    net, Table 3's unscaled counts), timed; (c) the us_map with one shared
    tanh on the fused path at 3 x 80: 10 steps card against CPU, then 500
    steps with two K3 and two K4 a step; (d) the cavity at its defaults
    through ``launch.navier_stokes_cavity.main``, held to its bar; (e) the
    cavity at 80 x 5 fused: 10 steps against the jvp path, 1000 steps with
    one K3 and one K4 a step, both paths timed in turns; (f) Adam then
    L-BFGS on vanilla Burgers, gradients through K3/K4 and probes through
    K2."""
    import torch
    from repro_torch.kernels import pinn_mlp as K
    from repro_torch.launch import inverse_heat_map as ihm
    from repro_torch.launch import navier_stokes_cavity as nsc

    t_phase = time.perf_counter()
    out = {"card": _smi()}
    total = dict.fromkeys((K1, K2, K3, K4), 0)

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # (a) the inverse problem at the example's defaults, train -> serve
    with tempfile.TemporaryDirectory(prefix="chip_smoke_inv_") as tmp:
        rc, text, secs, counts, plain = _counted(ihm.main, [
            "--device", str(dev), "--export", os.path.join(tmp, "field"),
            "--serve-demo"])
    rep = _last_json(text, "inverse")
    srv = rep["serve"]
    check(rc == 0, f"inverse_heat_map exited {rc}")
    _no_kernels(counts, plain, "(a) inverse, Table-3 activations")
    check(rep["rel_l2"] <= INVERSE_BAR,
          f"(a) rel-L2(T,K) {rep['rel_l2']:.4f} > {INVERSE_BAR:.4f}")
    check(srv["k_rel_l2"] <= INVERSE_SERVE_BAR,
          f"(a) served K rel-L2 {srv['k_rel_l2']:.4f} > "
          f"{INVERSE_SERVE_BAR:.4f}")
    check(srv["dispatches"] == 1 and srv["frontend"]["cache_hits"] == 1,
          f"(a) serve demo: {srv['dispatches']} dispatches")
    out["a_inverse"] = {
        "steps": rep["steps"], "seconds": secs, "rel_l2": rep["rel_l2"],
        "bar": INVERSE_BAR, "k_rel_l2_served": srv["k_rel_l2"],
        "serve_bar": INVERSE_SERVE_BAR,
        "residual_median": srv["residual_median"],
        "residual_p99": srv["residual_p99"],
        "cold_pts_per_s": srv["cold_pts_per_s"],
        "cached_pts_per_s": srv["cached_pts_per_s"],
        "steps_per_s": [r["steps_per_s"] for r in rep["chunks"]],
        "rel_l2_rows": [[r["step"], r["rel_l2"]] for r in rep["chunks"]],
        "launches": counts}
    emit({"scenario": "a", **out["a_inverse"]})

    # (b) the paper's size: 3 x 80 per net, Table 3's unscaled counts
    def paper():
        prob = ihm.build_problem(width=80, counts=PAPER_COUNTS, device=dev)
        b = prob.batch.device_arrays(dev)
        st, ms, loss = _train_timed(prob.trainer, b, PAPER_STEPS, 250)
        return ms, loss, prob.rel_l2(st.params), _rows(prob.batch)

    (ms, loss, err, rows), _, secs, counts, plain = _counted(paper)
    _no_kernels(counts, plain, "(b) inverse at the paper's size")
    out["b_inverse_paper"] = {"steps": PAPER_STEPS, "ms_per_step": ms,
                              "loss": loss, "rel_l2": err, "rows": rows,
                              "seconds": secs}
    emit({"scenario": "b", **out["b_inverse_paper"]})

    # (c) one shared tanh on the fused path at 3 x 80: parity, then 2000
    def fused_inverse(device):
        prob = ihm.build_problem(width=80, act_codes=["tanh"] * 10,
                                 residual_path="fused", device=device)
        return prob, prob.batch.device_arrays(prob.trainer.device)

    (p_cpu, b_cpu), (p_gpu, b_gpu) = fused_inverse("cpu"), \
        fused_inverse(dev)
    par, _, _, counts, plain = _counted(_parity, p_cpu.trainer, b_cpu,
                                        p_gpu.trainer, b_gpu)
    check(counts[K3] == counts[K4] == 20, f"(c) parity launches {counts}")
    add(counts)

    def fused_run():
        st, ms, loss = _train_timed(p_gpu.trainer, b_gpu,
                                    FUSED_INVERSE_STEPS, 250)
        return ms, loss, st

    (ms, loss, st), _, secs, counts, plain = _counted(fused_run)
    check(counts[K3] == counts[K4] == 2 * FUSED_INVERSE_STEPS,
          f"(c) {counts} launches for {FUSED_INVERSE_STEPS} steps x 2 nets")
    check(not any(plain.values()), f"(c) plain versions on CUDA {plain}")
    add(counts)
    err, _, _, c_l2, plain = _counted(p_gpu.rel_l2, st.params)
    check(c_l2[K1] == 2 and not any(plain.values()),
          f"(c) rel-L2 through K1: {c_l2}, plain {plain}")
    add(c_l2)
    out["c_inverse_fused"] = {
        "steps": FUSED_INVERSE_STEPS, "ms_per_step": ms, "loss": loss,
        "rel_l2": err, "parity_10": {k: par[k] for k in
                                     ("param_max_abs", "loss_max_rel")},
        "launches": counts, "rel_l2_launches": c_l2, "seconds": secs}
    emit({"scenario": "c", **out["c_inverse_fused"]})

    # (d) the cavity at its defaults (jvp, 40 x 5, 4000 steps)
    rc, text, secs, counts, plain = _counted(nsc.main,
                                             ["--device", str(dev)])
    rep = _last_json(text, "cavity")
    check(rc == 0, f"navier_stokes_cavity exited {rc}")
    _no_kernels(counts, plain, "(d) cavity, jvp path")
    check(rep["ghia_rms"] <= CAVITY_BAR,
          f"(d) Ghia RMS {rep['ghia_rms']:.4f} > {CAVITY_BAR:.4f}")
    out["d_cavity"] = {
        "steps": rep["steps"], "seconds": secs, "ghia_rms": rep["ghia_rms"],
        "bar": CAVITY_BAR, "centerline": rep["centerline"],
        "losses": [[r["step"], r["loss"]] for r in rep["chunks"]],
        "steps_per_s": [r["steps_per_s"] for r in rep["chunks"]]}
    emit({"scenario": "d", **out["d_cavity"]})

    # (e) the cavity at the paper's width on the fused path
    probs = {path: nsc.build_problem(width=80, residual_path=path,
                                     device=dev) for path in ("fused", "jvp")}
    bs = {k: p.batch.device_arrays(dev) for k, p in probs.items()}
    par, _, _, counts, plain = _counted(
        _parity, probs["jvp"].trainer, bs["jvp"], probs["fused"].trainer,
        bs["fused"])
    check(counts[K3] == counts[K4] == 10, f"(e) parity launches {counts}")
    add(counts)
    s_j, s_f = par["states"]
    # the jvp step without its graph (the eager step loop), for scale
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs["jvp"].trainer._loop(s_j, lambda i: bs["jvp"], 5)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / 5
    states = {"fused": s_f, "jvp": s_j}
    turns = {"fused": [], "jvp": []}
    for path in ("fused", "jvp", "jvp", "fused"):
        states[path], ms, _ = _train_timed(
            probs[path].trainer, bs[path], CAVITY_TURN_STEPS,
            CAVITY_TURN_STEPS, states[path])
        turns[path].append(ms)
    steps = CAVITY_FUSED_STEPS

    def cavity_fused():
        st, ms, loss = _train_timed(probs["fused"].trainer, bs["fused"],
                                    steps, nsc.REPORT_EVERY)
        line = nsc.centerline(probs["fused"], st.params)
        return ms, loss, line

    (ms, loss, line), _, secs, counts, plain = _counted(cavity_fused)
    check(counts[K3] == counts[K4] == steps,
          f"(e) {counts} launches for {steps} steps")
    check(not any(plain.values()), f"(e) plain versions on CUDA {plain}")
    add(counts)
    out["e_cavity_fused"] = {
        "steps": steps, "ms_per_step": ms, "loss": loss,
        "ghia_rms": nsc.ghia_rms(line), "centerline": line.tolist(),
        "parity_10_vs_jvp": {k: par[k] for k in
                             ("param_max_abs", "loss_max_rel")},
        "turns_ms_per_step": turns, "jvp_eager_ms_per_step": eager_ms,
        "launches": counts, "seconds": secs}
    emit({"scenario": "e", **out["e_cavity_fused"]})
    del probs, bs, states, par

    # (f) Adam then L-BFGS on vanilla Burgers, on the fused path
    def recipe():
        from repro_torch.core import (Burgers1D, CartesianDecomposition,
                                      losses)
        from repro_torch.core.nets import (MLPConfig, SubdomainModelConfig,
                                           init_model, map_tree, tree_leaves,
                                           tree_unflatten)
        from repro_torch.data import make_vanilla_batch
        from repro_torch.optim import adam, lbfgs_refine

        pde = Burgers1D()
        dec = CartesianDecomposition(((-1, 1), (0, 1)), 1, 1)
        cfg = SubdomainModelConfig(nets={"u": MLPConfig(2, 1, 20, 3)})
        batch = make_vanilla_batch(dec, pde, 512, 64,
                                   np.random.default_rng(SEED), device=dev)
        path = losses.ResidualPath(act="tanh")
        loss_fn = lambda p: losses.vanilla_pinn_loss(
            pde, cfg, losses.LossWeights(), p, 0, None, batch, path)[0]
        params = map_tree(lambda t: t.to(dev),
                          init_model(cfg, torch.Generator().manual_seed(SEED)))
        opt = adam.init_adam(params)
        for _ in range(LBFGS_ADAM_STEPS):
            leaves = [t.detach().requires_grad_()
                      for t in tree_leaves(params)]
            p = tree_unflatten(params, leaves)
            loss = loss_fn(p)
            grads = tree_unflatten(p, torch.autograd.grad(loss, leaves))
            params, opt = adam.adam_update(grads, opt, params, 2e-3)
        adam_loss = float(loss.detach())
        adam_counts = dict(K.launches)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, hist = lbfgs_refine(loss_fn, params, LBFGS_ITERS)
        ms = (time.perf_counter() - t0) * 1e3 / LBFGS_ITERS
        return adam_loss, hist, ms, adam_counts

    (adam_loss, hist, ms, adam_counts), _, secs, counts, plain = _counted(
        recipe)
    check(adam_counts[K3] == adam_counts[K4] == LBFGS_ADAM_STEPS,
          f"(f) Adam launches {adam_counts}")
    check(counts[K3] == counts[K4] == 2 * LBFGS_ITERS,
          f"(f) L-BFGS gradients: {counts}")
    check(counts[K2] == LBFGS_PROBES * LBFGS_ITERS,
          f"(f) L-BFGS probes on K2: {counts}")
    check(not any(plain.values()), f"(f) plain versions on CUDA {plain}")
    check(all(b <= a + 1e-6 for a, b in zip(hist, hist[1:])),
          "(f) L-BFGS losses increased")
    check(hist[-1] < 0.9 * adam_loss,
          f"(f) L-BFGS {hist[-1]:.4e} not below 0.9 x Adam {adam_loss:.4e}")
    add(adam_counts)
    add(counts)
    out["f_lbfgs"] = {"adam_steps": LBFGS_ADAM_STEPS, "adam_loss": adam_loss,
                      "iterations": LBFGS_ITERS, "losses": hist,
                      "ms_per_iteration": ms, "adam_launches": adam_counts,
                      "launches": counts, "seconds": secs}
    emit({"scenario": "f", **{k: v for k, v in out["f_lbfgs"].items()
                              if k != "losses"}})
    torch.cuda.synchronize()
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    emit({"scenarios": out})
    return total


# ---------------------------------------------------------------- LLM kernels

def _allclose(got, want, tol) -> float:
    """Raise unless |got - want| <= tol + tol |want| everywhere and got is
    finite; returns the max abs difference."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tuple(got.shape)} {got.dtype} != {tuple(want.shape)} "
          f"{want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), "non-finite kernel output")
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    check(bool((diff <= tol + tol * w.abs()).all()),
          f"kernel disagrees: max abs {err:.3e} (tol {tol})")
    return err


def _qkv(gen, B, S, T, H, Hk, dh, dtype, heads_first, dev, dv=None):
    """q (B, S, H, dh), k (B, T, Hk, dh), v (B, T, Hk, dv) (dv = dh unless
    given) on the card; with ``heads_first`` stored as (B, H, S, dh) and
    passed as transposed views (the layout of the reference's ops
    signature)."""
    import torch

    dv = dh if dv is None else dv
    if heads_first:
        shapes = ((B, H, S, dh), (B, Hk, T, dh), (B, Hk, T, dv))
        return [torch.randn(sh, generator=gen, device=dev).to(dtype)
                .transpose(1, 2) for sh in shapes]
    shapes = ((B, S, H, dh), (B, T, Hk, dh), (B, T, Hk, dv))
    return [torch.randn(sh, generator=gen, device=dev).to(dtype)
            for sh in shapes]


def _rkvwu(gen, B, T, H, P, w_mode, dev):
    import torch

    r, k, v = (torch.randn((B, T, H, P), generator=gen, device=dev)
               for _ in range(3))
    if w_mode == "uniform":
        w = 0.2 + 0.78 * torch.rand((B, T, H, P), generator=gen, device=dev)
    elif w_mode == "strong":
        w = torch.full((B, T, H, P), 0.05, device=dev)
    else:   # near 1: the init's decay_bias = -6, w = exp(-e^(-6 + dw))
        w = torch.exp(-torch.exp(-6.0 + 0.01 * torch.randn(
            (B, T, H, P), generator=gen, device=dev)))
    u = torch.randn((H, P), generator=gen, device=dev)
    return r, k, v, w, u


def lm_sweep(dev) -> dict:
    """K5 and K6 against their plain versions on the card, each case
    counted on the device kernels it must launch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import wkv6 as WK

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = []
    for H, Hk in ((32, 8), (8, 8), (4, 1)):
        for dh in (64, 128, 100):
            cases += [(H, Hk, dh, n, n, True)
                      for n in (1, 37, 64, 130, 200, 333, 2048)]
    cases += [(32, 8, dh, S, T, c) for dh in (64, 128, 100)
              for S, T in ((50, 130), (130, 50), (1, 64), (200, 333),
                           (333, 200)) for c in (True, False)]

    def one(q, k, v, causal, dname):
        """One K5 case: exactly one wrapper call on the device kernel of
        its dtype (and, for bf16, the producer its strides allow), the
        output in q's layout with v's width, within FA_TOL of the plain
        version."""
        before = {**FA.launches, **FA.producers}
        got = FA.flash_attention(q, k, v, causal=causal)
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        after = {**FA.launches, **FA.producers}
        kern = ("flash_attention_sm90" if dname == "bfloat16"
                else "flash_attention_f32")
        ran = {n for n in after if after[n] != before[n]}
        want_ran = {"flash_attention", kern}
        dh = q.shape[-1]
        if dname == "bfloat16":   # TMA where dh is a multiple of 8
            want_ran.add("tma" if dh % 8 == 0 else "loads")
        check(ran == want_ran, f"K5 {dname} dh{dh} launched {ran}")
        check(got.shape == q.shape[:3] + v.shape[3:] and
              got.stride() == q.stride(), "output layout")
        err = _allclose(got, want, FA_TOL[dname])
        worst[dname] = max(worst[dname], err)

    n_fa = 0
    for H, Hk, dh, S, T, causal in cases:
        for dname in ("float32", "bfloat16"):
            for heads_first in (False, True):
                B = 1 if max(S, T) > 1000 else 2
                one(*_qkv(gen, B, S, T, H, Hk, dh, getattr(torch, dname),
                          heads_first, dev), causal, dname)
                n_fa += 1
        print(f"K5 H{H}/{Hk} dh{dh} S{S} T{T} causal={causal} ok")
    # minicpm3-4b's MLA attention: v narrower than q and k
    H, dh, dv = MLA_HEADS
    n_mla = 0
    for n in (1, 37, 130, 1024):
        for dname in ("float32", "bfloat16"):
            one(*_qkv(gen, 1, n, n, H, H, dh, getattr(torch, dname), False,
                      dev, dv=dv), True, dname)
            n_mla += 1
        print(f"K5 MLA H{H}/{H} dh{dh} dv{dv} S=T={n} causal ok")
    # the MoE configs' attention at their prefill shape (B 2, S = T = 1024)
    n_moe = 0
    for H, Hk, dh in MOE_HEADS.values():
        for dname in ("float32", "bfloat16"):
            one(*_qkv(gen, 2, 1024, 1024, H, Hk, dh, getattr(torch, dname),
                      False, dev), True, dname)
            n_moe += 1
        print(f"K5 MoE H{H}/{Hk} dh{dh} S=T=1024 causal ok")
    # the VLM's and zamba2's prefill shapes (LLM's B x S)
    n_path = 0
    for name in K5_PATHS:
        cfg = get_config(name)
        B, S = LLM[name]
        H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        for dname in ("float32", "bfloat16"):
            one(*_qkv(gen, B, S, S, H, Hk, dh, getattr(torch, dname), False,
                      dev), True, dname)
            n_path += 1
        print(f"K5 {name} B{B} H{H}/{Hk} dh{dh} S=T={S} causal ok")
    # seamless-m4t-large-v2's calls (ENCDEC_K5): non-causal S = T and S !=
    # T, causal S = T, and a decode step's one query over the frames
    cfg = get_config(ENCDEC)
    n_encdec = 0
    for role, (B, S, T, causal) in ENCDEC_K5.items():
        for dname in ("float32", "bfloat16"):
            one(*_qkv(gen, B, S, T, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      getattr(torch, dname), False, dev), causal, dname)
            n_encdec += 1
        print(f"K5 {ENCDEC} {role}: B{B} S{S} T{T} causal={causal} ok")
    emit({"k5_sweep_cases": n_fa + n_mla + n_moe + n_path + n_encdec,
          "k5_mla_cases": n_mla, "k5_moe_cases": n_moe,
          "k5_vlm_hybrid_cases": n_path, "k5_encdec_cases": n_encdec,
          "tol": FA_TOL, "max_abs_err": dict(worst)})

    # K6's plain version in float64 on the same (cast) inputs: the
    # float32 plain version at a long chunk is itself off the recurrence at
    # a strong decay (its cumulative log-decays reach -3 x 64), so each
    # case also prints the float32 plain version's distance from it
    wworst, pworst, n_wkv = 0.0, 0.0, 0
    wcases = [(2, T, chunk) for T, chunk in ((1, 1), (5, 5), (17, 17),
                                             (31, 31), (33, 11), (256, 64),
                                             (1000, 50))]
    wcases.append((3, 99, 33))
    for P in (16, 64, 128):
        for B, T, chunk in wcases:
            for w_mode in ("uniform", "strong", "near1"):
                args = _rkvwu(gen, B, T, 4, P, w_mode, dev)
                before = dict(WK.launches)
                got = WK.wkv6(*args)
                want = WK.wkv6_plain(*(a.double() for a in args),
                                     chunk=chunk)
                plain32 = WK.wkv6_plain(*args, chunk=chunk)
                torch.cuda.synchronize()
                check(all(WK.launches[n] == before[n] + 1 for n in before),
                      f"K6 launches {before} -> {WK.launches}")
                err = _allclose(got, want.float(), WKV_TOL)
                perr = float((plain32.double() - want).abs().max())
                wworst, pworst = max(wworst, err), max(pworst, perr)
                n_wkv += 1
                print(f"K6 P{P} B{B} T{T} w={w_mode} abs {err:.1e} "
                      f"(float32 plain at chunk {chunk}: {perr:.1e})")
    emit({"k6_sweep_cases": n_wkv, "tol": WKV_TOL, "max_abs_err": wworst,
          "oracle": "wkv6_plain in float64",
          "float32_plain_max_abs_err": pworst})
    return {"flash_attention": max(worst.values()), "wkv6": wworst}


def fa_bound(B, S, H, Hk, dh, nbytes_el=2, dv=None, T=None,
             causal=True) -> tuple[float, str, int, int]:
    """K5's bound: its bytes and FLOPs (``kernels.flash_attention.work``:
    S queries over T keys, 2 (dh + dv) FLOP per visible pair and head)
    over HBM and the bf16 tensor-core rate."""
    from repro_torch.kernels import flash_attention as FA

    nbytes, flops = FA.work(B, S, H, Hk, dh, T=T, dv=dv, causal=causal,
                            nbytes_el=nbytes_el)
    hbm, bf16, _ = _peaks()
    t_bytes, t_ops = nbytes / hbm, flops / bf16
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", nbytes, flops)


def wkv_bound(B, T, H, P) -> tuple[float, str, int, int]:
    """K6's bound: its bytes and FLOPs (``kernels.wkv6.work``: 4 P^2 FLOP
    per step and head) over HBM and the float32 rate."""
    from repro_torch.kernels import wkv6 as WK

    nbytes, flops = WK.work(B, T, H, P)
    hbm, _, fp32 = _peaks()
    t_bytes, t_ops = nbytes / hbm, flops / fp32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", nbytes, flops)


def _sdpa(q, k, v, causal=True):
    """PyTorch's fused attention on the same (B, S, H, dh) tensors, causal
    (its mask is aligned top-left too) or not, with GQA; the math backend
    is excluded, so it is a fused kernel or an error."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION]):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal,
            enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


def lm_timing(dev) -> dict:
    """K5 at llama3.2-1b's per-layer prefill shape (4096 and 32768 tokens),
    at minicpm3-4b's, the MoE configs' and zamba2-1.2b's (4096 tokens), and
    K6 at rwkv6-3b's (4096 steps): device ms of the kernel (CUDA graph of
    launches), its plain version, and for K5 PyTorch's SDPA."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import wkv6 as WK

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = {}
    B, H, Hk, dh = 1, 32, 8, 64
    for S, reps, preps in ((4096, 20, 3), (32768, 2, 1)):
        q, k, v = _qkv(gen, B, S, S, H, Hk, dh, torch.bfloat16, False, dev)
        kern = lambda: FA.flash_attention(q, k, v, causal=True)
        plain = lambda: FA.flash_attention_plain(q, k, v, causal=True)
        lib = lambda: _sdpa(q, k, v)
        sdpa_err = float((lib().float() - kern().float()).abs().max())
        bms, by, nbytes, flops = fa_bound(B, S, H, Hk, dh)
        row = {"kernel": "flash_attention",
               "shape": f"B={B} S=T={S} H={H} Hk={Hk} dh={dh} bf16 causal",
               "ms": _graph_ms(kern, reps), "plain_ms": _events_ms(plain,
                                                                   preps),
               "library_ms": _graph_ms(lib, reps), "bound_ms": bms,
               "bound_by": by, "bytes": nbytes, "flops": flops,
               "sdpa_max_abs_diff": sdpa_err}
        row["tflops"] = flops / row["ms"] * 1e-9
        out[("flash_attention", S)] = row
        emit({"timing": row})
        del q, k, v
        torch.cuda.empty_cache()
    # minicpm3-4b's per-layer prefill attention (MLA: dv 64 under dh 96)
    H, dh, dv = MLA_HEADS
    S = 4096
    q, k, v = _qkv(gen, B, S, S, H, H, dh, torch.bfloat16, False, dev, dv=dv)
    kern = lambda: FA.flash_attention(q, k, v, causal=True)
    plain = lambda: FA.flash_attention_plain(q, k, v, causal=True)
    # SDPA for timing only: on the unpadded v where one of its fused
    # backends takes dv != dh, else on v padded to dh (as K5 takes it)
    try:
        sdpa_ref = _sdpa(q, k, v)
        sdpa_v, lib = "unpadded", lambda: _sdpa(q, k, v)
    except RuntimeError as e:
        vp = torch.nn.functional.pad(v, (0, dh - dv))
        sdpa_v, lib = f"padded to {dh} ({str(e)[:80]})", \
            lambda: _sdpa(q, k, vp)[..., :dv]
        sdpa_ref = lib()
    sdpa_err = float((sdpa_ref.float() - kern().float()).abs().max())
    bms, by, nbytes, flops = fa_bound(B, S, H, H, dh, dv=dv)
    row = {"kernel": "flash_attention",
           "shape": f"B={B} S=T={S} H={H} Hk={H} dh={dh} dv={dv} bf16 causal"
                    " (minicpm3-4b MLA)",
           "ms": _graph_ms(kern, 20), "plain_ms": _events_ms(plain, 3),
           "library_ms": _graph_ms(lib, 20), "sdpa_v": sdpa_v,
           "bound_ms": bms, "bound_by": by, "bytes": nbytes, "flops": flops,
           "sdpa_max_abs_diff": sdpa_err}
    row["tflops"] = flops / row["ms"] * 1e-9
    out[("flash_attention_mla", S)] = row
    emit({"timing": row})
    del q, k, v, sdpa_ref
    torch.cuda.empty_cache()
    # the MoE configs' per-layer prefill attention (dense GQA, dh 128)
    for name, (H, Hk, dh) in MOE_HEADS.items():
        q, k, v = _qkv(gen, B, S, S, H, Hk, dh, torch.bfloat16, False, dev)
        kern = lambda: FA.flash_attention(q, k, v, causal=True)
        lib = lambda: _sdpa(q, k, v)
        sdpa_err = float((lib().float() - kern().float()).abs().max())
        bms, by, nbytes, flops = fa_bound(B, S, H, Hk, dh)
        row = {"kernel": "flash_attention",
               "shape": f"B={B} S=T={S} H={H} Hk={Hk} dh={dh} bf16 causal"
                        f" ({name})",
               "ms": _graph_ms(kern, 20),
               "plain_ms": _events_ms(lambda: FA.flash_attention_plain(
                   q, k, v, causal=True), 3),
               "library_ms": _graph_ms(lib, 20), "bound_ms": bms,
               "bound_by": by, "bytes": nbytes, "flops": flops,
               "sdpa_max_abs_diff": sdpa_err}
        row["tflops"] = flops / row["ms"] * 1e-9
        out[("flash_attention_moe", name)] = row
        emit({"timing": row})
        del q, k, v
        torch.cuda.empty_cache()
    # zamba2-1.2b's shared attention (H = Hk = 32, dh 64; llava's 32/8 of
    # 128 is phi3.5-moe's shape, timed above)
    cfg = get_config("zamba2-1.2b")
    B, S, H, dh = 1, 4096, cfg.n_heads, cfg.hd
    q, k, v = _qkv(gen, B, S, S, H, H, dh, torch.bfloat16, False, dev)
    kern = lambda: FA.flash_attention(q, k, v, causal=True)
    lib = lambda: _sdpa(q, k, v)
    sdpa_err = float((lib().float() - kern().float()).abs().max())
    bms, by, nbytes, flops = fa_bound(B, S, H, H, dh)
    row = {"kernel": "flash_attention",
           "shape": f"B={B} S=T={S} H={H} Hk={H} dh={dh} bf16 causal"
                    " (zamba2-1.2b)",
           "ms": _graph_ms(kern, 20),
           "plain_ms": _events_ms(lambda: FA.flash_attention_plain(
               q, k, v, causal=True), 3),
           "library_ms": _graph_ms(lib, 20), "bound_ms": bms,
           "bound_by": by, "bytes": nbytes, "flops": flops,
           "sdpa_max_abs_diff": sdpa_err}
    row["tflops"] = flops / row["ms"] * 1e-9
    out[("flash_attention_hybrid", cfg.name)] = row
    emit({"timing": row})
    del q, k, v
    torch.cuda.empty_cache()
    # seamless-m4t-large-v2's four K5 calls (ENCDEC_K5), non-causal ones
    # too, each beside its bound, its plain version and SDPA
    cfg = get_config(ENCDEC)
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for role, (B, S, T, causal) in ENCDEC_K5.items():
        q, k, v = _qkv(gen, B, S, T, H, Hk, dh, torch.bfloat16, False, dev)
        kern = lambda: FA.flash_attention(q, k, v, causal=causal)
        lib = lambda: _sdpa(q, k, v, causal)
        sdpa_err = float((lib().float() - kern().float()).abs().max())
        bms, by, nbytes, flops = fa_bound(B, S, H, Hk, dh, T=T,
                                          causal=causal)
        row = {"kernel": "flash_attention", "role": role,
               "shape": f"B={B} S={S} T={T} H={H} Hk={Hk} dh={dh} bf16 "
                        f"{'causal' if causal else 'non-causal'} ({ENCDEC})",
               "ms": _graph_ms(kern, 20),
               "plain_ms": _events_ms(lambda: FA.flash_attention_plain(
                   q, k, v, causal=causal), 3),
               "library_ms": _graph_ms(lib, 20), "bound_ms": bms,
               "bound_by": by, "bytes": nbytes, "flops": flops,
               "sdpa_max_abs_diff": sdpa_err}
        row["tflops"] = flops / row["ms"] * 1e-9
        out[("flash_attention_encdec", role)] = row
        emit({"timing": row})
        del q, k, v
    torch.cuda.empty_cache()
    B, T, H, P = 1, 4096, 40, 64
    args = _rkvwu(gen, B, T, H, P, "near1", dev)
    bms, by, nbytes, flops = wkv_bound(B, T, H, P)
    # the plain version at its default chunk of 64 steps: its (c, c, P)
    # decay tensors take 2.7 GB here (at the model's ssm_chunk of 256 they
    # would take 10.7 GB each)
    row = {"kernel": "wkv6", "shape": f"B={B} T={T} H={H} P={P} float32",
           "ms": _graph_ms(lambda: WK.wkv6(*args), 20),
           "plain_ms": _events_ms(lambda: WK.wkv6_plain(*args, chunk=64), 3),
           "plain_chunk": 64, "library_ms": None, "bound_ms": bms,
           "bound_by": by, "bytes": nbytes, "flops": flops,
           "device_kernel_ms": {
               n: t for n, t in _device_split(
                   lambda: WK.wkv6(*args))["kernel_ms"].items() if t}}
    out[("wkv6", T)] = row
    emit({"timing": row})
    del args
    torch.cuda.empty_cache()
    return out


def _device_split(fn, kernels=None, scopes=(), reference=False) -> dict:
    """One call of ``fn`` under torch.profiler: the device time of every
    kernel and copy it ran (events on the CUDA device only, each counted
    once), the part of it in each device kernel of ``kernels`` (name ->
    symbol; DEVICE_KERNELS, the K5/K6 kernels, by default) and how many
    times each ran, the device time of the kernels launched inside each
    ``record_function`` scope named in ``scopes``, the largest items, and
    the host-clock ms of the profiled call.  Read by :func:`_split` from
    the profiler's own events; with ``reference`` also by
    :func:`_split_reference` (torch's event tree, ~17 s a step of ~21k
    device events), and the two must agree."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kernels = DEVICE_KERNELS if kernels is None else kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):   # takes the session's record loss
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    keys, scope_ms = _split(prof, scopes)
    parse_s = time.perf_counter() - t0
    if reference:
        t0 = time.perf_counter()
        ref_keys, ref_scope_ms = _split_reference(prof, scopes)
        ref_s = time.perf_counter() - t0
        check(keys.keys() == ref_keys.keys() and all(
            keys[k][1] == ref_keys[k][1] and
            abs(keys[k][0] - ref_keys[k][0]) <= 1e-6 * ref_keys[k][0]
            for k in keys), "the profiler's events and torch's tree give "
              "other device times")
        check(all(abs(scope_ms[k] - ref_scope_ms[k])
                  <= 1e-6 * max(ref_scope_ms[k], 1e-3) for k in scopes),
              f"scopes {scope_ms} against torch's tree {ref_scope_ms}")
    busy, pad = 0.0, 0
    kern = dict.fromkeys(kernels, 0.0)
    count = dict.fromkeys(kernels, 0)
    top = []
    for key, (us, n) in keys.items():
        if re.search(rf"\b{PAD_KERNEL}\b", key):
            pad += n
            continue
        ms = us / 1e3
        busy += ms
        for name, sym in kernels.items():
            if re.search(rf"\b{sym}\b", key):
                kern[name] += ms
                count[name] += n
        top.append((ms, n, key[:70]))
    top.sort(reverse=True)
    out = {"device_busy_ms": busy, "k5_k6_ms": sum(kern.values()),
           "kernel_ms": kern, "kernel_count": count, "scope_ms": scope_ms,
           "device_events": sum(n for _, n, _ in top),
           "top": [[round(t, 3), n, k] for t, n, k in top[:8]],
           "profiled_wall_ms": wall,
           "pad_records_lost": PROFILE_PAD - pad, "parse_s": parse_s}
    if reference:
        out["reference_parse_s"] = ref_s
    return out


def _split(prof, scopes):
    """``({name: [device us, count]}, {scope: device ms})`` of a profile:
    the device events (kernels, copies) by name, a scope's or a user
    annotation's own device span left out, and each scope's device time,
    the kernels launched by the ops inside it.  The sums of torch's
    ``key_averages()`` and ``FunctionEvent.device_time_total`` (see
    :func:`_split_reference`), taken from the profiler's kineto events
    without building torch's event objects: the same event filter, the
    same nesting of a thread's synchronous CPU events by their intervals
    (sorted by start, the longer first), a device event charged to the op
    whose correlation id it links, and an op with one child of its own
    name merged into it."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name

    left_out = set(SCOPES + LM_SCOPES)
    keys: dict = {}
    launched: dict = {}   # an op's correlation id -> device us it launched
    cpu = []              # [thread, start, end, name, corr id, link]
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event",
                                         lambda: False)():
            continue
        link = e.linked_correlation_id()
        if e.device_type() == DeviceType.CUDA:
            us = (e.end_ns() - e.start_ns()) / 1e3
            if link > 0:
                launched[link] = launched.get(link, 0.0) + us
            key = _rewrite_name(name=name, with_wildcard=True)
            if getattr(e, "is_user_annotation", lambda: False)() or \
                    key in left_out:
                continue
            row = keys.setdefault(key, [0.0, 0])
            row[0] += us
            row[1] += 1
        elif e.device_type() == DeviceType.CPU and not e.is_async() and \
                e.start_thread_id() == e.end_thread_id():
            cpu.append([e.start_thread_id(), e.start_ns(), e.end_ns(),
                        _rewrite_name(name=name, with_wildcard=True),
                        e.correlation_id(), link])
    keys = {k: v for k, v in keys.items() if v[0] > 0}
    # a linked CPU event (a runtime call) sits on its op's thread
    op_thread = {c[4]: c[0] for c in cpu if c[5] == 0}
    for c in cpu:
        if c[5] > 0 and c[5] in op_thread:
            c[0] = op_thread[c[5]]
    own = [launched.get(c[4], 0.0) if c[5] == 0 else 0.0 for c in cpu]
    order = sorted(range(len(cpu)),
                   key=lambda i: (cpu[i][0], cpu[i][1], -cpu[i][2]))
    parent = [-1] * len(cpu)
    children: dict = {}
    stack, thread = [], None
    for i in order:
        if cpu[i][0] != thread:
            stack, thread = [], cpu[i][0]
        while stack:
            top = cpu[stack[-1]]
            if cpu[i][1] >= top[2] or cpu[i][2] > top[2]:
                stack.pop()
            else:
                parent[i] = stack[-1]
                children.setdefault(stack[-1], []).append(i)
                break
        stack.append(i)
    # torch's _remove_dup_nodes: a parent with one child of its own name
    # takes the child's children and the child's kernels; the child goes
    gone = set()
    merged = True
    while merged:
        merged = False
        for i in order:
            p = parent[i]
            if i in gone or p < 0 or cpu[p][3] != cpu[i][3] or \
                    len(children.get(p, ())) != 1:
                continue
            children[p] = children.pop(i, [])
            own[p] = own[i]
            for c in children[p]:
                parent[c] = p
            gone.add(i)
            merged = True
    total = list(own)
    for i in reversed(order):
        if i not in gone and parent[i] >= 0:
            total[parent[i]] += total[i]
    scope_ms = dict.fromkeys(scopes, 0.0)
    for i, c in enumerate(cpu):
        if c[3] in scope_ms and i not in gone:
            scope_ms[c[3]] += total[i] / 1e3
    return keys, scope_ms


def _split_reference(prof, scopes):
    """:func:`_split`'s figures from torch's own event tree
    (``key_averages()``, ``events()``): the reference it is held to."""
    from torch.autograd import DeviceType

    keys = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or \
                ev.self_device_time_total <= 0:
            continue
        # a record_function scope is also a device-side annotation whose
        # span covers the kernels inside it: it is not work of its own
        if getattr(ev, "is_user_annotation", False) or \
                ev.key in SCOPES + LM_SCOPES:
            continue
        keys[ev.key] = [ev.self_device_time_total, ev.count]
    # a host-side scope's device time: the kernels its ops (and their
    # children) launched
    scope_ms = dict.fromkeys(scopes, 0.0)
    for ev in prof.events():
        if ev.name in scope_ms and ev.device_type == DeviceType.CPU:
            scope_ms[ev.name] += ev.device_time_total / 1e3
    return keys, scope_ms


@contextlib.contextmanager
def _moe_routes(replay=None):
    """Record the experts each MoE layer's router picks (``moe.route``), in
    call order, while the block runs; with ``replay`` (an earlier pass's
    record, call for call) route by those experts instead, their gates
    taken from this pass's probabilities, still recording this pass's own
    picks."""
    import torch
    from repro_torch.models import moe

    own, route = [], moe.route

    def wrapped(cfg, p, xg):
        probs, gate, idx = route(cfg, p, xg)
        own.append(idx)
        if replay is None:
            return probs, gate, idx
        idx = replay[len(own) - 1]
        gate = torch.gather(probs, -1, idx)
        return probs, gate / torch.clamp(gate.sum(-1, keepdim=True),
                                         min=1e-9), idx

    moe.route = wrapped
    try:
        yield own
    finally:
        moe.route = route


@contextlib.contextmanager
def _k5_shapes():
    """Record (causal, S, T) of every K5 launch (the wrapper's
    ``_launch``) while the block runs."""
    from repro_torch.kernels import flash_attention as FA

    seen, launch = [], FA._launch

    def wrapped(q, k, v, causal):
        seen.append((bool(causal), q.shape[1], k.shape[1]))
        return launch(q, k, v, causal)

    FA._launch = wrapped
    try:
        yield seen
    finally:
        FA._launch = launch


def _encdec_shapes(cfg, S) -> dict:
    """(causal, S, T) -> K5 launches of one encoder-decoder prefill of S
    tokens over S // enc_ratio frames."""
    F = max(1, S // cfg.enc_ratio)
    return {(False, F, F): cfg.n_layers, (True, S, S): cfg.n_dec_layers,
            (False, S, F): cfg.n_dec_layers}


def _decode_calls(cfg) -> int:
    """K5 / K6 launches of one decode step: the encoder-decoder's
    cross-attention (one query over the cached frames) once a decoder
    layer; every other family decodes against its cache in plain torch."""
    return cfg.n_dec_layers if cfg.family == "encdec" else 0


def _route_flips(a, b) -> tuple[int, int]:
    """(routes, routes whose expert sets differ) between two passes'
    records (one (..., k) tensor of experts per router call)."""
    check(len(a) == len(b), f"router calls {len(a)} != {len(b)}")
    n = sum(x[..., 0].numel() for x in a)
    flips = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
                for x, y in zip(a, b))
    return n, flips


def _drop_free_decode(cfg, params, tokens, dev) -> float:
    """MoE decode against prefill with capacity dropping off: the first
    DROP_FREE prompt of ``tokens`` prefilled at capacity_factor 64 in
    float32, its first DROP_FREE_STEPS tokens decoded one at a time from
    an empty cache; the largest logit difference over max |logit|."""
    import dataclasses

    import torch
    from repro_torch.models import build_model

    B, S = DROP_FREE
    model = build_model(dataclasses.replace(cfg, dtype="float32",
                                            capacity_factor=64.0), dev)
    toks = tokens[:B, :S]
    full = model.prefill(params, {"tokens": toks})[..., :cfg.vocab]
    cache = model.init_cache(B, DROP_FREE_STEPS)
    dec = []
    for t in range(DROP_FREE_STEPS):
        lg, cache = model.decode_step(params, cache,
                                      {"tokens": toks[:, t:t + 1]}, t)
        dec.append(lg[:, 0, :cfg.vocab])
    diff = (torch.stack(dec, 1) - full[:, :DROP_FREE_STEPS]).abs().max()
    return float(diff) / float(full.abs().max())


def _kernel_calls(model) -> tuple[int, int, int]:
    """K5 / K6 wrapper calls of one full forward of ``model`` (a prefill),
    and of one training step: the forward's launches (under remat a
    layer's forward runs again in the backward) and the VJP recomputes.
    One a layer; the hybrid's shared attention runs once a stage, outside
    remat; the encoder-decoder's once an encoder and twice a decoder layer
    (``model.attn_calls`` / ``attn_remat``)."""
    n = model.attn_calls
    return n, n * (1 + int(model.attn_remat)), n


def llm_phase(dev) -> dict:
    """The published llama3.2-1b, minicpm3-4b, rwkv6-3b, deepseek-moe-16b,
    llava-next-mistral-7b, zamba2-1.2b and seamless-m4t-large-v2, and
    phi3.5-moe at 4 of its 32 layers, on the card: prefill through the
    kernels (counted; the VLM with its patches, seamless with its frames
    and its K5 calls by shape), its trace, the plain versions in bf16 and
    float32 (MoE: the routes that differ counted, the values held on the
    kernel pass's routes), and decode against prefill, counted (MoE: drop
    free; the VLM on a tokens-only prompt; seamless against its cross
    cache).  Returns the launches of the counted prefills, summed over the
    models and by model, and seamless's K5 calls by shape in a prefill and
    a decode step."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import wkv6 as WK
    from repro_torch.models import build_model

    launches, by_arch, encdec = {}, {}, None
    for name, (B, S) in LLM.items():
        cfg = get_config(name)
        if name in LLM_LAYERS:
            cfg = dataclasses.replace(cfg, n_layers=LLM_LAYERS[name])
        model = build_model(cfg, dev)
        params = model.init(SEED)
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        n_pat = cfg.n_patches if cfg.family == "vlm" else 0
        tokens = torch.randint(0, cfg.vocab, (B, S - n_pat), generator=gen,
                               device=dev)
        batch = {"tokens": tokens}
        if n_pat:   # the stub frontend's patch embeddings, from the seed
            batch["patch_embeds"] = torch.randn(
                (B, n_pat, cfg.patch_dim), generator=gen,
                device=dev).to(getattr(torch, cfg.dtype))
        if cfg.family == "encdec":   # the stub frontend's frames
            batch["frames"] = torch.randn(
                (B, S // cfg.enc_ratio, cfg.d_model), generator=gen,
                device=dev).to(getattr(torch, cfg.dtype))
        kname = FAMILY_KERNEL[cfg.family]
        calls = _kernel_calls(model)[0]
        model.prefill(params, batch)          # warm-up (cuBLAS, the build)
        torch.cuda.synchronize()
        for m in (FA, WK):
            m.reset_launch_counts()
        with _k5_shapes() as shapes:
            t0 = time.perf_counter()
            logits = model.prefill(params, batch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        counts = {**FA.launches, **WK.launches}
        plain = {**FA.plain_calls, **WK.plain_calls}
        # one wrapper call per layer (the hybrid: per stage), each on the
        # bf16 K5 kernel or on K6's chunk, scan and output kernels, and
        # nothing else
        device = (("flash_attention_sm90",) if kname == "flash_attention"
                  else ("wkv6_chunk", "wkv6_scan", "wkv6_out"))
        expect = {n: calls if n in (kname, *device) else 0 for n in counts}
        check(counts == expect, f"{name}: launches {counts}, want {expect}")
        check(not any(plain.values()), f"plain versions on CUDA: {plain}")
        k5_shapes = {}
        for sh in shapes:
            k5_shapes[sh] = k5_shapes.get(sh, 0) + 1
        if cfg.family == "encdec":   # non-causal S = T, causal, S != T
            check(k5_shapes == _encdec_shapes(cfg, S),
                  f"{name}: K5 shapes {k5_shapes}")
        check(tuple(logits.shape) == (B, S, cfg.padded_vocab),
              f"{name}: logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
              f"{name}: non-finite logits")
        by_arch[name] = {n: counts[n] for n in (kname, *device)}
        for n, c in by_arch[name].items():
            launches[n] = launches.get(n, 0) + c
        split = _device_split(lambda: model.prefill(params, batch))
        split["idle_share"] = 1.0 - split["device_busy_ms"] / (secs * 1e3)
        check(all(split["kernel_ms"][n] > 0 for n in device),
              f"{name}: the trace shows no time in {device}: {split}")
        plain_bf16 = model.prefill(params, batch, plain=True)
        scale = float(plain_bf16[..., :cfg.vocab].float().abs().max())
        bf16_rel = float((logits.float() - plain_bf16.float())[
            ..., :cfg.vocab].abs().max()) / scale
        del logits, plain_bf16

        m32 = build_model(dataclasses.replace(cfg, dtype="float32"), dev)
        FA.reset_launch_counts()
        with _moe_routes() as k_routes:
            got = m32.prefill(params, batch)
        check(kname != "flash_attention" or
              FA.launches["flash_attention_f32"] == calls,
              f"{name}: float32 prefill launches {FA.launches}")
        with _moe_routes() as p_routes:
            want = m32.prefill(params, batch, plain=True)
        scale = float(want[..., :cfg.vocab].abs().max())
        f32_rel = float((got - want)[..., :cfg.vocab].abs().max()) / scale
        moe = {}
        if cfg.family == "moe":
            # a near-tie can flip a route under float32 reordering, and a
            # flipped route moves its token's values by far more than the
            # bar: the flips are counted, and where there are any the
            # values are held on the kernel pass's routes, replayed
            n_routes, flips = _route_flips(k_routes, p_routes)
            moe = {"routes": n_routes, "route_flips": flips,
                   "f32_rel_own_routes": f32_rel}
            if flips:
                del want
                with _moe_routes(replay=k_routes):
                    want = m32.prefill(params, batch, plain=True)
                f32_rel = float((got - want)[..., :cfg.vocab].abs().max()) \
                    / scale
                moe["f32_rel_replayed_routes"] = f32_rel
            print(f"{name}: {flips} of {n_routes} (layer, token) routes "
                  "differ between the float32 kernel and plain passes")
        del k_routes, p_routes
        check(f32_rel <= LLM_F32_TOL,
              f"{name}: float32 prefill kernels vs plain {f32_rel:.3e} "
              f"{moe}")
        del want
        dec_counts = {}
        if cfg.family == "moe":
            del got
            dec_rel, dec_tol = _drop_free_decode(cfg, params, tokens,
                                                 dev), DROP_FREE_TOL
        else:
            if n_pat:   # decode takes tokens only: a tokens-only prefill
                del got
                got = m32.prefill(params, {"tokens": tokens})
                scale = float(got[..., :cfg.vocab].abs().max())
            cache = m32.init_cache(B, 16)
            if cfg.family == "encdec":
                # the cross K/V of the prefill's encoded frames, built as
                # the reference's tests/test_models.py:60-71 builds them
                cache = m32.fill_cross_cache(params, cache, batch["frames"])
            _reset_lm_counts()
            dec = []
            with _k5_shapes() as dshapes:
                for t in range(16):
                    lg, cache = m32.decode_step(
                        params, cache, {"tokens": tokens[:, t:t + 1]}, t)
                    dec.append(lg[:, 0])
                torch.cuda.synchronize()
            dec_counts = _lm_counts()
            n_dec = 16 * _decode_calls(cfg)
            dec_want = {k: n_dec if k in ("flash_attention",
                                          "flash_attention_f32") else 0
                        for k in dec_counts}
            check(dec_counts == dec_want,
                  f"{name}: 16 decode steps counted {dec_counts}")
            check(set(dshapes) <= {(False, 1, S // cfg.enc_ratio)},
                  f"{name}: decode K5 shapes {set(dshapes)}")
            dec_rel = float((torch.stack(dec, 1) - got[:, :16])[
                ..., :cfg.vocab].abs().max()) / scale
            dec_tol = DECODE_TOL
            del got, dec, cache
        check(dec_rel <= dec_tol, f"{name}: decode vs prefill "
                                  f"{dec_rel:.3e}")
        emit({"llm": {
            "arch": name, "batch": B, "seq": S, "patches": n_pat,
            "layers": cfg.n_layers,
            "d_model": cfg.d_model, "prefill_s": secs,
            "prefill_tokens_per_s": B * S / secs, "launches": counts,
            "plain_calls_on_cuda": plain,
            "k5_shapes": {f"{'causal' if c else 'non-causal'} S={a} T={b}": n
                          for (c, a, b), n in k5_shapes.items()},
            "bf16_kernel_vs_plain_rel": bf16_rel,
            "f32_kernel_vs_plain_rel": f32_rel, "f32_tol": LLM_F32_TOL,
            "decode_vs_prefill_rel": dec_rel, "decode_tol": dec_tol,
            "decode_launches_16_steps": {k: v for k, v in dec_counts.items()
                                         if v},
            **({"moe": moe, "drop_free_decode": {
                "prompt": list(DROP_FREE), "steps": DROP_FREE_STEPS,
                "capacity_factor": 64.0}} if moe else {}),
            "profile": split}})
        if cfg.family == "encdec":
            encdec = {"prefill_shapes": k5_shapes,
                      "decode_per_step": dec_counts["flash_attention"] // 16}
        del params, model, m32
        torch.cuda.empty_cache()
    return {"launches": launches, "by_arch": by_arch, "encdec": encdec}


def llm_serve_phase(dev) -> dict:
    """``launch.serve.main`` on the card at full width and depth, each run
    counted: the encoder-decoder's frames encoded once (K5 a layer) and
    K5 for the cross-attention in each of its 31 decode steps; no kernel
    in any other family's decode.  Returns the K5 launches of a serving
    run by model."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    smi = _smi()
    B, P, G = 4, 16, 16
    argv = ["--no-reduced", "--batch", str(B), "--prompt-len", str(P),
            "--gen", str(G)]
    served = {}
    for name in LLM:
        if name in LLM_LAYERS:   # cut in depth: not served
            continue
        cfg = get_config(name)
        want = (cfg.n_layers if cfg.family == "encdec" else 0) + \
            (P + G - 1) * _decode_calls(cfg)
        runs = []
        for _ in range(2):   # the first one pays the card's first-use costs
            buf = io.StringIO()
            _reset_lm_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = serve.main(["--arch", name] + argv)
            secs = time.perf_counter() - t0
            counts = {k: v for k, v in _lm_counts().items() if v}
            check(counts == ({"flash_attention": want,
                              "flash_attention_sm90": want} if want
                             else {}),
                  f"serve {name}: counted {counts}, want {want} K5")
            report = json.loads(
                buf.getvalue().strip().splitlines()[-1])["serve"]
            check(rc == 0, f"serve {name} exited {rc}")
            check(report["shape"] == [4, 32] and not report["reduced"],
                  f"serve {name}: {report}")
            check(report["device"].startswith("cuda"), f"serve on {report}")
            runs.append((secs, report))
            torch.cuda.empty_cache()
        served[name] = want
        emit({"llm_serve": {
            "arch": name, "argv": argv, "seconds": [r[0] for r in runs],
            "tokens_per_s": [r[1]["tokens_per_s"] for r in runs],
            "new_tokens": runs[-1][1]["new_tokens"], "launches": counts,
            "card": smi}})
    return served


# ---------------------------------------------------------------- LM training

def _train_lm(argv) -> dict:
    """``launch.train.main(["lm", *argv])`` on the card: its JSON line."""
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(["lm", *argv])
    check(rc == 0, f"train lm {argv} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])["train_lm"]


@contextlib.contextmanager
def _moe_aux():
    """Record the load-balance term of every MoE layer call (``moe.moe_ffn``;
    a remat recompute calls it again) while the block runs."""
    from repro_torch.models import moe

    auxes, ffn = [], moe.moe_ffn

    def wrapped(cfg, p, x):
        out, aux = ffn(cfg, p, x)
        auxes.append(aux.detach())
        return out, aux

    moe.moe_ffn = wrapped
    try:
        yield auxes
    finally:
        moe.moe_ffn = ffn


def _lm_counts() -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import wkv6 as WK

    return {**FA.launches, **FA.recomputes, **FA.plain_calls, **WK.launches,
            **WK.recomputes, **WK.plain_calls}


def _reset_lm_counts() -> None:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import wkv6 as WK

    FA.reset_launch_counts()
    WK.reset_launch_counts()


def _check_lm_counts(name, cfg, steps) -> dict:
    """Exactly steps x layers x (1 + remat) wrapper launches of K5 (on the
    bf16 kernel) or K6 (on its chunk, scan and output kernels) and steps x
    layers VJP recomputes (the hybrid: steps x stages of each,
    ``_kernel_calls``); nothing else, no plain version on the card."""
    from repro_torch.models import build_model

    counts = _lm_counts()
    _, fwd, n = _kernel_calls(build_model(cfg, "cuda"))
    fwd, n = steps * fwd, steps * n
    want = ({"flash_attention": fwd, "flash_attention_sm90": fwd,
             "flash_attention_vjp": n}
            if FAMILY_KERNEL[cfg.family] == "flash_attention" else
            {"wkv6": fwd, "wkv6_chunk": fwd, "wkv6_scan": fwd,
             "wkv6_out": fwd, "wkv6_vjp": n})
    want = {k: want.get(k, 0) for k in counts}
    check(counts == want, f"{name}: counts {counts}, want {want}")
    return {k: v for k, v in counts.items() if v}


def _lm_cfg(name):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(name)
    layers = LM_TRAIN[name]["layers"]
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def _lm_grads(model, params, batch, plain):
    """``model.loss`` and its gradient in every param leaf."""
    import torch
    from repro_torch.core.nets import tree_leaves

    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, batch, plain=plain)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), grads


def _ckpt_diff(a: str, b: str, step: int) -> tuple[int, int, list]:
    """Checkpoint ``step`` under ``a`` and under ``b`` (the reference's
    layout): the params leaves compared bitwise one at a time, every leaf
    (the Adam moments too) by the CRC-32 of its bytes that the manifest
    carries.  (params leaves, leaves, differing paths)."""
    name = f"step_{step:010d}"
    man = []
    for root in (a, b):
        with open(os.path.join(root, name, "manifest.json")) as f:
            man.append(json.load(f))
    paths = man[0]["paths"]
    check(man[1]["paths"] == paths, "checkpoint trees differ")
    crcs = [m["integrity"]["arrays"] for m in man]
    bad = [p for i, p in enumerate(paths)
           if crcs[0][f"leaf_{i:05d}"] != crcs[1][f"leaf_{i:05d}"]]
    n_params = 0
    with np.load(os.path.join(a, name, "arrays.npz")) as za, \
            np.load(os.path.join(b, name, "arrays.npz")) as zb:
        for i, path in enumerate(paths):
            if not path.startswith("['params']"):
                continue
            key = f"leaf_{i:05d}"
            n_params += 1
            if not np.array_equal(za[key], zb[key]):
                bad.append(path)
    return n_params, len(paths), bad


def _link_step(src: str, dst: str, step: int) -> None:
    """``dst`` as a checkpoint root whose latest step is ``src``'s
    ``step`` (hard links to its files)."""
    name = f"step_{step:010d}"
    os.makedirs(os.path.join(dst, name))
    for f in os.listdir(os.path.join(src, name)):
        os.link(os.path.join(src, name, f), os.path.join(dst, name, f))
    with open(os.path.join(dst, "LATEST"), "w") as f:
        f.write(name)


def _steady_ms(step_s) -> float:
    """Median ms of the steps after the first two (the first pays cuBLAS's
    and the allocator's first-use costs)."""
    tail = sorted(step_s[2:] or step_s)
    return 1e3 * tail[len(tail) // 2]


def _lm_trace(model, state, batch, start, total, kname,
              reference=False) -> dict:
    """Recipe steps ``start`` to ``total`` under torch.profiler from
    ``state`` = [params, Adam state], updated in place (the caller holds no
    other reference, so a step's peak is the untraced step's): device busy
    ms, idle share, the K5 / K6 device kernels' ms and launch counts, the
    LM scopes' device ms and the steps' losses (``reference``: the trace
    also read through torch's event tree, as :func:`_device_split`)."""
    import torch
    from repro_torch.launch import train

    losses = []

    def steps():
        for s in range(start, total):
            state[0], state[1], loss, _ = train.lm_train_step(
                model, state[0], state[1], batch, s, 3e-4, total)
            losses.append(loss)
        losses[:] = [float(x) for x in losses]

    kernels = {n: DEVICE_KERNELS[n] for n in DEVICE_KERNELS
               if n.startswith(kname) and n != "flash_attention_f32"}
    split = _device_split(steps, kernels, LM_SCOPES, reference)
    split["idle_share"] = 1.0 - split["device_busy_ms"] / \
        split["profiled_wall_ms"]
    split["losses"] = losses
    torch.cuda.synchronize()
    return split


def _lm_kernel_times(dev) -> dict:
    """K5 and K6 at the training shapes (llama3.2-1b's B = 4, S = 1024;
    rwkv6-3b's B = 1, T = 1024): the kernel (CUDA graph), its plain
    version, SDPA for K5, the training entry's VJP recompute, the bound."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import wkv6 as WK

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    out = {}
    B, S, H, Hk, dh = 4, 1024, 32, 8, 64
    q, k, v = _qkv(gen, B, S, S, H, Hk, dh, torch.bfloat16, False, dev)
    do = torch.randn_like(q)

    def vjp_fa():
        ts = [t.detach().requires_grad_() for t in (q, k, v)]
        o = FA.flash_attention_train(*ts, causal=True)
        torch.autograd.grad(o, ts, do)

    bms, by, nbytes, flops = fa_bound(B, S, H, Hk, dh)
    out["flash_attention"] = {
        "shape": f"B={B} S=T={S} H={H} Hk={Hk} dh={dh} bf16 causal",
        "ms": _graph_ms(lambda: FA.flash_attention(q, k, v, causal=True),
                        20),
        "plain_ms": _events_ms(lambda: FA.flash_attention_plain(
            q, k, v, causal=True), 3),
        "library_ms": _graph_ms(lambda: _sdpa(q, k, v), 20),
        "train_fwd_bwd_ms": _events_ms(vjp_fa, 3),
        "bound_ms": bms, "bound_by": by, "bytes": nbytes, "flops": flops}
    del q, k, v, do
    B, T, H, P = 1, 1024, 40, 64
    r, k, v, w, u = _rkvwu(gen, B, T, H, P, "near1", dev)
    dy = torch.randn_like(r)

    def vjp_wkv():
        ts = [t.detach().requires_grad_() for t in (r, k, v, w, u)]
        y = WK.wkv6_train(*ts, chunk=256)
        torch.autograd.grad(y, ts, dy)

    bms, by, nbytes, flops = wkv_bound(B, T, H, P)
    out["wkv6"] = {
        "shape": f"B={B} T={T} H={H} P={P} float32",
        "ms": _graph_ms(lambda: WK.wkv6(r, k, v, w, u), 20),
        "plain_ms": _events_ms(lambda: WK.wkv6_plain(r, k, v, w, u,
                                                     chunk=256), 3),
        "plain_chunk": 256, "library_ms": None,
        "train_fwd_bwd_ms": _events_ms(vjp_wkv, 3),
        "bound_ms": bms, "bound_by": by, "bytes": nbytes, "flops": flops}
    del r, k, v, w, u, dy
    torch.cuda.empty_cache()
    for name, row in out.items():
        emit({"lm_train_timing": {"kernel": name, **row}})
    return out


def lm_train_phase(dev) -> dict:
    """``launch.train lm`` on the card (the docstring's phase 13): returns
    the K5/K6 wrapper launches of its main runs."""
    import dataclasses

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.nets import map_tree, tree_leaves
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models import make_batch as make_lm_batch
    from repro_torch.optim.adam import init_adam

    smi = _smi()
    launches = {}
    res = {"card": smi}
    tmp = tempfile.mkdtemp(prefix="lm-train-")
    try:
        # (a) + (f): the entry point, counted; (b) llama resumed bitwise
        for name, cell in LM_TRAIN.items():
            cfg = _lm_cfg(name)
            argv = ["--arch", name, "--steps", str(cell["steps"]),
                    "--batch", str(cell["batch"]), "--seq", str(cell["seq"]),
                    "--log-every", "10"]
            if cell["layers"]:
                argv += ["--n-layers", str(cell["layers"])]
            a_dir = os.path.join(tmp, f"{name}-a")
            if cell["resume"]:
                argv += ["--ckpt-every", str(LM_CKPT_EVERY)]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            allocated_before = torch.cuda.memory_allocated()
            _reset_lm_counts()
            t0 = time.perf_counter()
            with _moe_aux() as auxes:
                run = _train_lm(argv + (["--ckpt-dir", a_dir]
                                        if cell["resume"] else []))
            secs = time.perf_counter() - t0
            counts = _check_lm_counts(name, cfg, cell["steps"])
            for k, v in counts.items():
                if k in ("flash_attention", "wkv6"):
                    launches[k] = launches.get(k, 0) + v
            losses = run["losses"]
            check(len(losses) == cell["steps"] and
                  all(np.isfinite(losses)), f"{name}: losses {losses}")
            check(run["device"].startswith("cuda"), f"{name} on {run}")
            row = {"arch": name, "layers": cfg.n_layers,
                   "batch": cell["batch"], "seq": cell["seq"],
                   "steps": cell["steps"], "seconds": secs,
                   "first_loss": losses[0], "final_loss": losses[-1],
                   "steady_ms_per_step": _steady_ms(run["step_s"]),
                   "tokens_per_s": run["tokens_per_s"],
                   "steady_tokens_per_s": cell["batch"] * cell["seq"] * 1e3
                   / _steady_ms(run["step_s"]),
                   "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "memory_allocated_before": allocated_before,
                   "steps_s": sum(run["step_s"]), "launches": counts}
            if auxes:   # MoE: the load-balance term (1.0 when balanced)
                aux = [float(a) for a in auxes]
                check(all(np.isfinite(aux)), f"{name}: aux {aux}")
                row["mean_aux"] = sum(aux) / len(aux)
                row["aux_calls"] = len(aux)
            del auxes
            if cell["resume"]:
                b_dir = os.path.join(tmp, f"{name}-b")
                _link_step(a_dir, b_dir, LM_CKPT_EVERY)
                _reset_lm_counts()
                t0 = time.perf_counter()
                again = _train_lm(argv + ["--ckpt-dir", b_dir, "--resume"])
                row["resume_seconds"] = time.perf_counter() - t0
                rest = cell["steps"] - LM_CKPT_EVERY
                _check_lm_counts(name, cfg, rest)
                check(again["start"] == LM_CKPT_EVERY and
                      again["losses"] == losses[LM_CKPT_EVERY:],
                      f"{name}: resumed losses {again['losses']} != "
                      f"{losses[LM_CKPT_EVERY:]}")
                t0 = time.perf_counter()
                n_params, n_leaves, bad = _ckpt_diff(a_dir, b_dir,
                                                     cell["steps"])
                check(not bad, f"{name}: resumed checkpoint differs in "
                               f"{bad[:5]}")
                row["resume"] = {"from": LM_CKPT_EVERY, "losses_equal": True,
                                 "params_leaves_bitwise_equal": n_params,
                                 "leaves_crc32_equal": n_leaves,
                                 "compare_s": time.perf_counter() - t0,
                                 "steps_s": sum(again["step_s"])}
                shutil.rmtree(b_dir, ignore_errors=True)
            shutil.rmtree(a_dir, ignore_errors=True)
            emit({"lm_train": row})
            res[name] = row

        # (c) kernel path against plain path, one loss and its gradient
        # (1024 tokens; the VLM's patches in front of them)
        t_part = time.perf_counter()
        for name in LM_TRAIN:
            cfg = _lm_cfg(name)
            params = build_model(cfg, dev).init(SEED + 1)
            seq = 1024 + (cfg.n_patches if cfg.family == "vlm" else 0)
            shape = ShapeConfig("c", seq, 1, "train")
            batch = make_lm_batch(cfg, shape, "train", seed=SEED + 7,
                                  device=dev)
            row = {"arch": name, "layers": cfg.n_layers, "batch": 1,
                   "seq": seq}
            for dtype in ("float32", "bfloat16"):
                model = build_model(dataclasses.replace(cfg, dtype=dtype),
                                    dev)
                kname = FAMILY_KERNEL[cfg.family]
                _reset_lm_counts()
                with _moe_routes() as k_routes:
                    lk, gk = _lm_grads(model, params, batch, False)
                kern = _lm_counts()
                with _moe_routes() as p_routes:
                    lp, gp = _lm_grads(model, params, batch, True)
                if cfg.family == "moe":
                    # as in the llm phase: flipped routes counted, the
                    # values then held on the kernel pass's routes
                    n_routes, flips = _route_flips(k_routes, p_routes)
                    row[f"{dtype}_route_flips"] = [flips, n_routes]
                    if flips:
                        del gp
                        with _moe_routes(replay=k_routes):
                            lp, gp = _lm_grads(model, params, batch, True)
                del k_routes, p_routes
                after = _lm_counts()
                fwd = _kernel_calls(model)[1]
                # the plain path adds plain calls, no kernel launch
                check(kern[kname] == fwd and after[kname] == fwd,
                      f"{name} {dtype}: kernel path {kern}, then {after}")
                rel = abs(float(lk) - float(lp)) / abs(float(lp))
                gerr = max(_leaf_err(a.float(), b.float())
                           for a, b in zip(gk, gp))
                check(np.isfinite(float(lk)), f"{name} {dtype}: loss {lk}")
                if dtype == "float32":
                    check(rel <= LM_LOSS_RTOL, f"{name}: kernel loss vs "
                                               f"plain {rel:.3e}")
                    check(gerr <= LM_GRAD_TOL, f"{name}: kernel grads vs "
                                               f"plain {gerr:.3e}")
                row[dtype] = {"loss": float(lk), "loss_rel": rel,
                              "grad_err": gerr}
                del gk, gp
            row["tol"] = {"loss_rel": LM_LOSS_RTOL, "grad": LM_GRAD_TOL}
            row["seconds"] = time.perf_counter() - t_part
            t_part = time.perf_counter()
            emit({"lm_train_vs_plain": row})
            del params
            torch.cuda.empty_cache()

        # (d) card against CPU, the recipe from one set of params
        for name in LM_TRAIN:
            cfg = dataclasses.replace(_lm_cfg(name).reduced(),
                                      dtype="float32")
            p0 = build_model(cfg, "cpu").init(SEED + 2)
            shape = ShapeConfig("d", 64, 2, "train")
            runs = {}
            for device in ("cpu", dev):
                model = build_model(cfg, device)
                params = map_tree(lambda t: t.to(device), p0)
                opt = init_adam(params)
                losses = []
                for s in range(5):
                    batch = make_lm_batch(cfg, shape, "train",
                                          seed=SEED * 100003 + s,
                                          device=device)
                    params, opt, loss, _ = train.lm_train_step(
                        model, params, opt, batch, s, 3e-4, 5)
                    losses.append(float(loss))
                runs[device] = (losses, params)
            (lc, pc), (lg, pg) = runs["cpu"], runs[dev]
            lerr = max(abs(a - b) / max(1.0, abs(a)) for a, b in zip(lc, lg))
            perr = max(float((b.cpu() - a).abs().max()) for a, b in
                       zip(tree_leaves(pc), tree_leaves(pg)))
            check(lerr <= LM_CPU_TOL and perr <= LM_CPU_TOL,
                  f"{name}: card vs CPU losses {lerr:.3e}, params "
                  f"{perr:.3e}")
            emit({"lm_train_card_vs_cpu": {
                "arch": name, "reduced": True, "steps": 5, "loss_err": lerr,
                "param_err": perr, "tol": LM_CPU_TOL,
                "seconds": time.perf_counter() - t_part}})
            t_part = time.perf_counter()

        # (e) learning on one repeated batch, then (g) a trace of its last
        # step (LM_TRACE_STEPS); the others traced on a fresh init
        for name, cell in LM_TRAIN.items():
            cfg = _lm_cfg(name)
            kname = FAMILY_KERNEL[cfg.family]
            model = build_model(cfg, dev)
            params = model.init(SEED + 3)
            opt = init_adam(params)
            shape = ShapeConfig("e", cell["seq"], cell["batch"], "train")
            batch = make_lm_batch(cfg, shape, "train", seed=SEED + 8,
                                  device=dev)
            total = LM_LEARN_STEPS if cell["learn"] else 4
            losses = []
            start = total - LM_TRACE_STEPS
            for s in range(start):
                params, opt, loss, _ = train.lm_train_step(
                    model, params, opt, batch, s, 3e-4, total)
                losses.append(float(loss))
            _reset_lm_counts()
            state = [params, opt]
            del params, opt
            # deepseek's trace, the smallest, also through torch's tree
            split = _lm_trace(model, state, batch, start, total, kname,
                              name == "deepseek-moe-16b")
            traced = _lm_counts()
            losses += split["losses"]
            dev_kernel = "flash_attention_sm90" if kname == \
                "flash_attention" else "wkv6_chunk"
            per_fwd, per_step, _ = _kernel_calls(model)
            want = LM_TRACE_STEPS * per_step
            check(split["kernel_count"][dev_kernel] == want ==
                  traced[dev_kernel],
                  f"{name}: traced {split['kernel_count']}, counted "
                  f"{traced}, want {want} {dev_kernel}")
            row = {"arch": name, "trace_steps": LM_TRACE_STEPS,
                   "profile": split,
                   "seconds": time.perf_counter() - t_part,
                   "remat_factor_traced": split["kernel_count"][dev_kernel]
                   / (LM_TRACE_STEPS * per_fwd)}
            if cell["learn"]:
                row["learn"] = {"steps": total, "first_loss": losses[0],
                                "final_loss": losses[-1],
                                "bar": LM_LEARN * losses[0],
                                "losses": losses}
                check(len(losses) == total and
                      losses[-1] <= LM_LEARN * losses[0],
                      f"{name}: loss {losses[0]} -> {losses[-1]} on one "
                      "batch")
            emit({"lm_train_trace": row})
            res[name]["trace"] = row
            del state, model
            torch.cuda.empty_cache()
            t_part = time.perf_counter()
        res["kernel_times"] = _lm_kernel_times(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["launches"] = launches
    return res


# ------------------------------------------------------------------ dry run

# ------------------------------------------------------------------ phase ep

def _ep_cfg(layers, dtype, shard_map=True):
    """deepseek-moe-16b at full width and ``layers`` of its 28 (the dense
    prelude first), in ``dtype``, expert-parallel or not."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(EP_ARCH), n_layers=layers,
                               dtype=dtype, moe_shard_map=shard_map)


def _ep_tokens(dev, cell):
    """The prefill's (B, S) tokens, drawn from the seed on the card (every
    rank draws the same)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    return torch.randint(0, _ep_cfg(1, "float32").vocab,
                         (cell["batch"], cell["seq"]), generator=gen,
                         device=dev)


def _ep_predict(cfg, cell, steps=0) -> dict:
    """The collectives one rank of the ep path issues (the prediction
    written in ``PERF.md`` §6 before the phase first ran): ``{group:
    {kind: [count, bytes]}}``.

    A prefill: per MoE layer one all-reduce over the model group of the
    partial (T_loc, d) output.  ``steps`` training steps, each: per MoE
    layer that forward all-reduce, twice under remat (the recompute runs
    it again), and the backward all-reduce of the tokens and gates (T_loc, d +
    k) over the model group; one float32 scalar over the model group (the
    expert leaves' squares of the global norm).  Training is predicted on a
    (1, M) grid only, the one (b) runs.  A group of one rank issues
    nothing."""
    D, M = cell["grid"]
    t_loc = cell["batch"] // D * cell["seq"]
    n_moe = cfg.n_layers - cfg.first_dense
    el = 4 if cfg.dtype == "float32" else 2
    out_b = t_loc * cfg.d_model * el
    model = {}

    def add(group, count, nbytes):
        row = group.setdefault("all-reduce", [0, 0])
        row[0] += count
        row[1] += nbytes

    if not steps:
        if M > 1:
            add(model, n_moe, n_moe * out_b)
        return {"model": model} if model else {}
    if D > 1:
        raise ValueError(f"training is predicted on a (1, M) grid, not "
                         f"({D}, {M})")
    fwd = 1 + int(bool(cfg.remat))
    if M > 1:
        add(model, steps * fwd * n_moe, steps * fwd * n_moe * out_b)
        add(model, steps * n_moe, steps * n_moe * t_loc
            * (cfg.d_model + cfg.top_k) * el)
        add(model, steps, steps * 4)
    return {"model": model} if model else {}


def _ep_recorded(record) -> dict:
    """A record as ``{group: {kind: [count, bytes]}}`` (the prediction's
    form) and the ms of each kind."""
    from repro_torch.utils import collectives as COL

    groups = COL.by_group(record)
    return ({g: {k: [v["count"], v["bytes"]] for k, v in kinds.items()}
             for g, kinds in groups.items()},
            {g: {k: v["ms"] for k, v in kinds.items()}
             for g, kinds in groups.items()})


def _ep_prefill(ep, dev, logits_path) -> dict:
    """A rank's part of (a): the float32 prefill counted and recorded, held
    against the twin's logits; the bf16 prefill recorded, then timed."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import build_model
    from repro_torch.models import expert_parallel as EP
    from repro_torch.utils.collectives import CollectiveRecorder

    cell = EP_PREFILL
    out = {}
    batch = ep.shard_batch({"tokens": _ep_tokens(dev, cell)})
    params = None
    for dtype in ("float32", "bfloat16"):
        cfg = _ep_cfg(cell["layers"], dtype)
        model = build_model(cfg, dev)
        if params is None:
            params = model.init(SEED, experts=(ep.m, ep.model))
        staged = ep.comm.staged_bytes
        with EP.use_ep(ep), CollectiveRecorder() as rec:
            dist.barrier()
            _reset_lm_counts()
            logits = model.prefill(params, batch)
            _sync(dev)
            counts = _lm_counts()
        got, ms = _ep_recorded(rec.record)
        row = {"counts": {k: v for k, v in counts.items() if v},
               "collectives": got, "collective_ms": ms,
               "staged_bytes": ep.comm.staged_bytes - staged,
               "finite": bool(torch.isfinite(logits).all())}
        if dtype == "float32":
            n = cell["batch"] // ep.data
            want = torch.load(logits_path, mmap=True)[ep.d * n:(ep.d + 1) * n]
            want = want.to(dev)
            row["max_abs_err"] = float((logits - want).abs().max())
            row["max_abs_logit"] = float(want.abs().max())
            del want
        else:
            times = []
            with EP.use_ep(ep):
                for _ in range(EP_TIME_REPS):
                    dist.barrier()
                    _sync(dev)
                    t0 = time.perf_counter()
                    model.prefill(params, batch)
                    _sync(dev)
                    times.append((time.perf_counter() - t0) * 1e3)
            row["ms"] = times
        del logits
        out[dtype] = row
    return out


def _ep_batch(cfg, cell, step, dev):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import make_batch as make_lm_batch

    shape = ShapeConfig("ep", cell["seq"], cell["batch"], "train")
    return make_lm_batch(cfg, shape, "train", seed=SEED * 100003 + step,
                         device=dev)


def _ep_train(model, box, cell, dev, shard, steps, start=0, peaks=None):
    """``steps`` of ``lm_train_step`` from ``start``, from the params in
    ``box`` (a one-element list, emptied: a caller's reference to the
    first params would keep them alive through every later step, one
    float32 copy above the step's own peak); (params, losses, seconds a
    step).  ``peaks`` (a list) gets each step's ``max_memory_allocated``,
    the first with Adam's state."""
    import torch

    from repro_torch.launch.train import lm_train_step
    from repro_torch.optim.adam import init_adam

    params = box.pop()
    opt = init_adam(params)
    losses, secs = [], []
    for s in range(start, start + steps):
        batch = shard(_ep_batch(model.cfg, cell, s, dev))
        t0 = time.perf_counter()
        params, opt, loss, _ = lm_train_step(model, params, opt, batch, s,
                                             cell["lr"], cell["steps"])
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
        if peaks is not None:
            peaks.append(torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
    return params, losses, secs


def _ep_train_part(ep, dev, params_path) -> dict:
    """A rank's part of (b): 10 steps counted and recorded, the final params
    held against the twin's; then steps timed without the recorder."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.nets import tree_leaves
    from repro_torch.models import build_model
    from repro_torch.models import expert_parallel as EP
    from repro_torch.utils.collectives import CollectiveRecorder

    cell = EP_TRAIN
    cfg = _ep_cfg(cell["layers"], "float32")
    left = torch.cuda.memory_allocated(dev)   # (a)'s leftovers
    model = build_model(cfg, dev)
    box = [model.init(SEED, experts=(ep.m, ep.model))]
    out = {"params": sum(t.numel() for t in tree_leaves(box[0])),
           "memory_left_by_a": left}
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    staged = ep.comm.staged_bytes
    peaks = []
    with EP.use_ep(ep), CollectiveRecorder() as rec:
        dist.barrier(group=ep.model_group)
        _reset_lm_counts()
        params, losses, secs = _ep_train(model, box, cell, dev,
                                         ep.shard_batch, cell["steps"],
                                         peaks=peaks)
        _sync(dev)
        counts = _lm_counts()
    out["collectives"], out["collective_ms"] = _ep_recorded(rec.record)
    out["staged_bytes"] = ep.comm.staged_bytes - staged
    out["counts"] = {k: v for k, v in counts.items() if v}
    out["losses"], out["step_s_recorded"] = losses, secs
    out["max_memory_allocated"] = max(peaks)
    out["max_memory_allocated_by_step"] = peaks
    out["memory_allocated_before"] = before
    # the final params against the twin's (experts: this rank's cut)
    want = torch.load(params_path, mmap=True)
    cut = EP.shard_experts(want, ep.m, ep.model)
    errs = []
    for got, w in zip(tree_leaves(params), tree_leaves(cut)):
        w = w.to(dev)
        errs.append(float((got - w).abs().max())
                    / max(1.0, float(w.abs().max())))
    out["param_err"] = max(errs)
    del want, cut
    # the same step unrecorded: the recorder's cost
    with EP.use_ep(ep):
        dist.barrier(group=ep.model_group)
        _, _, secs = _ep_train(model, [params], cell, dev, ep.shard_batch,
                               EP_TIME_STEPS, start=cell["steps"])
    out["step_s_unrecorded"] = secs
    return out


def _seq_cfg(dtype):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(SEQ_ARCH), dtype=dtype)


def _seq_predict(cfg, cell, steps=1) -> dict:
    """The collectives one rank of (c) issues in ``steps`` decode steps
    (the prediction written in ``PERF.md`` §6 before the part first ran):
    per layer a MAX all-reduce of the (B, 1, H) float32 row maxima and one
    SUM all-reduce of the packed (B, 1, H, hd) outputs and (B, 1, H) sums,
    float32, over the model group; nothing else (every weight whole on
    every rank)."""
    B, H, L = cell["batch"], cfg.n_heads, cfg.n_layers
    per_layer = 4 * B * H + 4 * B * H * (cfg.hd + 1)
    return {"model": {"all-reduce": [steps * 2 * L, steps * L * per_layer]}}


@contextlib.contextmanager
def _kv_capture():
    """The k and v of every K5 wrapper call, in call order (one a layer
    in a dense prefill): the prefill's rows of the cache, after rope, in
    the compute dtype, as a decode step writes its row."""
    from repro_torch.kernels import flash_attention as FA

    calls, inner = [], FA.flash_attention

    def capture(q, k, v, **kw):
        calls.append((k, v))
        return inner(q, k, v, **kw)
    FA.flash_attention = capture
    try:
        yield calls
    finally:
        FA.flash_attention = inner


def _seq_tokens(cfg, prompt, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    return torch.randint(0, cfg.vocab, (SEQ_CELL["batch"], prompt),
                         generator=gen, device=dev)


def _seq_one_process(dev, tmp) -> dict:
    """(c)'s one-process runs, on the card before the ranks start: for
    each dtype and prompt, the prefill (16 K5 launches, counted, no plain
    version) fills a cache of SEQ_CELL's length, then SEQ_CELL's greedy
    decode steps run over it whole.  The cache, the steps' input tokens
    and logits go to files under ``tmp`` for the ranks."""
    import torch

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import build_model

    cell = SEQ_CELL
    out = {"runs": {}, "k5": 0}
    params = None
    for dtype in ("float32", "bfloat16"):
        cfg = _seq_cfg(dtype)
        model = build_model(cfg, dev)
        if params is None:
            params = model.init(SEED)
        for prompt in cell["prompts"]:
            tokens = _seq_tokens(cfg, prompt, dev)
            FA.reset_launch_counts()
            with torch.no_grad(), _kv_capture() as kv:
                logits = model.prefill(params, {"tokens": tokens})
            _sync(dev)
            counts = {"launches": FA.launches["flash_attention"],
                      "plain": FA.plain_calls["flash_attention_plain"]}
            check(counts == {"launches": cfg.n_layers, "plain": 0}
                  and len(kv) == cfg.n_layers,
                  f"(c) {dtype} prefill {prompt}: K5 {counts}, "
                  f"{len(kv)} layers captured")
            out["k5"] += counts["launches"]
            cache = model.init_cache(cell["batch"], cell["cache"])
            for l, (k, v) in enumerate(kv):
                cache["k"][l, :, :prompt] = k
                cache["v"][l, :, :prompt] = v
            del kv
            tok = logits[:, -1:, :cfg.vocab].argmax(-1)
            del logits
            tag = f"{dtype}_{prompt}"
            cache_path = os.path.join(tmp, f"seq_cache_{tag}.pt")
            torch.save({k: t.cpu() for k, t in cache.items()}, cache_path)
            steps, lgs = [], []
            t0 = time.perf_counter()
            for s in range(cell["steps"]):
                steps.append(tok)
                lg, cache = model.decode_step(params, cache,
                                              {"tokens": tok}, prompt + s)
                lgs.append(lg[:, :, :cfg.vocab].float())
                tok = lg[:, :, :cfg.vocab].argmax(-1)
            _sync(dev)
            secs = time.perf_counter() - t0
            check(FA.launches["flash_attention"] == cfg.n_layers,
                  f"(c) {dtype} {prompt}: decode launched K5")
            run = {"cache": cache_path,
                   "tokens": os.path.join(tmp, f"seq_tokens_{tag}.pt"),
                   "logits": os.path.join(tmp, f"seq_logits_{tag}.pt"),
                   "decode_s": secs}
            torch.save(torch.cat(steps, 1).cpu(), run["tokens"])
            torch.save(torch.cat(lgs, 1).cpu(), run["logits"])
            out["runs"][tag] = run
            del cache, lgs
        del model
    del params
    torch.cuda.empty_cache()
    return out


def _seq_part(grid, runs) -> dict:
    """A rank's part of (c): its half of each run's cache, the full
    weights, SEQ_CELL's decode steps teacher-forced with the one-process
    run's tokens under ``partition.use_seq``, counted and recorded; its
    greedy tokens and logits held against the one-process run's."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import build_model
    from repro_torch.models import partition as PT
    from repro_torch.utils.collectives import CollectiveRecorder

    t_part = time.perf_counter()
    dev = grid.device
    seq = grid.sequence_parallel()
    out = {"index": seq.index, "n": seq.n, "runs": {}}
    params = None
    for dtype in ("float32", "bfloat16"):
        cfg = _seq_cfg(dtype)
        model = build_model(cfg, dev)
        if params is None:
            params = model.init(SEED)
        for prompt in SEQ_CELL["prompts"]:
            run = runs[f"{dtype}_{prompt}"]
            whole = torch.load(run["cache"], mmap=True)
            cache = {k: seq.shard_cache(t, 2).to(dev)
                     for k, t in whole.items()}
            del whole
            tokens = torch.load(run["tokens"]).to(dev)
            want = torch.load(run["logits"], mmap=True)
            staged = seq.comm.staged_bytes
            lgs = []
            with PT.use_seq(seq), CollectiveRecorder() as rec:
                dist.barrier(group=seq.group)
                _reset_lm_counts()
                t0 = time.perf_counter()
                for s in range(SEQ_CELL["steps"]):
                    lg, cache = model.decode_step(
                        params, cache, {"tokens": tokens[:, s:s + 1]},
                        prompt + s)
                    lgs.append(lg[:, :, :cfg.vocab].float())
                _sync(dev)
                secs = time.perf_counter() - t0
                counts = _lm_counts()
            got = torch.cat(lgs, 1)
            del lgs, cache
            w = want.to(dev)
            top = float(w.abs().max())
            mine, theirs = got.argmax(-1), w.argmax(-1)
            # a token this rank picks otherwise than the one process is
            # a near tie there: the one process scores it within the
            # dtype's logit tolerance of its best
            picked = w.gather(-1, mine[..., None])[..., 0]
            near = bool((w.max(-1).values - picked
                         <= SEQ_TOL[dtype] * top).all())
            collectives, ms = _ep_recorded(rec.record)
            out["runs"][f"{dtype}_{prompt}"] = {
                "max_abs_err": float((got - w).abs().max()),
                "max_abs_logit": top,
                "tokens_differing": int((mine != theirs).sum()),
                "differing_are_near_ties": near,
                "finite": bool(torch.isfinite(got).all()),
                "counts": {k: v for k, v in counts.items() if v},
                "collectives": collectives, "collective_ms": ms,
                "staged_bytes": seq.comm.staged_bytes - staged,
                "decode_s": secs,
                "positions_held": [seq.index * SEQ_CELL["cache"] // seq.n,
                                   (seq.index + 1) * SEQ_CELL["cache"]
                                   // seq.n]}
            del got, w, want
        del model
    out["seconds"] = time.perf_counter() - t_part
    return out


def _seq_checks(ranks, one) -> dict:
    """(c)'s checks over the ranks that ran it: each run's logits within
    SEQ_TOL of the one process's, its differing tokens (if any) near ties
    there, no K5 launch and no plain version in the decode, and its
    collectives exactly ``_seq_predict``'s."""
    cell = SEQ_CELL
    parts = [r for r in ranks if "c" in r]
    check(sorted(r["c"]["index"] for r in parts)
          == list(range(cell["grid"][1])),
          f"(c) ranks {[r['c']['index'] for r in parts]} ran it")
    c = {"arch": SEQ_ARCH, "grid": list(cell["grid"]),
         "batch": cell["batch"], "cache": cell["cache"],
         "prompts": list(cell["prompts"]), "steps": cell["steps"],
         "one_process_seconds": one["seconds"],
         "one_process_decode_s": {k: v["decode_s"]
                                  for k, v in one["runs"].items()},
         "prefill_k5_launches": one["k5"],
         "part_seconds": {r["rank"]: r["c"]["seconds"] for r in parts},
         "runs": {}}
    for tag in one["runs"]:
        dtype = tag.split("_")[0]
        pred = _seq_predict(_seq_cfg(dtype), cell, cell["steps"])
        row = {"predicted": pred, "ranks": {}}
        for r in parts:
            got = r["c"]["runs"][tag]
            err = got["max_abs_err"] / got["max_abs_logit"]
            row["ranks"][r["rank"]] = {
                **{k: got[k] for k in ("tokens_differing", "collectives",
                                       "collective_ms", "staged_bytes",
                                       "decode_s", "positions_held")},
                "logit_err": err}
            check(got["finite"] and err <= SEQ_TOL[dtype],
                  f"(c) {tag} rank {r['rank']}: logits {err:.3e} of max "
                  "off the one process's")
            check(got["differing_are_near_ties"],
                  f"(c) {tag} rank {r['rank']}: {got['tokens_differing']} "
                  "tokens differ, not at near ties")
            check(got["counts"] == {}, f"(c) {tag} rank {r['rank']}: "
                  f"decode launched {got['counts']}")
            check(got["collectives"] == pred,
                  f"(c) {tag} rank {r['rank']}: collectives "
                  f"{got['collectives']}, predicted {pred}")
        c["runs"][tag] = row
    c["max_logit_err"] = {tag: max(v["logit_err"]
                                   for v in row["ranks"].values())
                          for tag, row in c["runs"].items()}
    c["tokens_differing"] = sum(v["tokens_differing"]
                                for row in c["runs"].values()
                                for v in row["ranks"].values())
    emit({"ep_seq_decode": c})
    return c


def _ep_rank(grid, logits_path, params_path, seq_runs) -> dict:
    """One rank of the EP_PREFILL grid: its part of (a); then the ranks of
    data shard 0, with their model group and no data group (a (1, M)
    grid), run (b) and (c) while the others wait."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import expert_parallel as EP

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = grid.device
    ep = grid.expert_parallel()
    out = {"rank": grid.rank, "d": ep.d, "m": ep.m, "device": str(dev),
           "a": _ep_prefill(ep, dev, logits_path)}
    out["a"]["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    dist.barrier()
    if ep.d == 0:
        sub = EP.EPRank(data=1, model=ep.model, d=0, m=ep.m, data_group=None,
                        model_group=ep.model_group, comm=ep.comm)
        out["b"] = _ep_train_part(sub, dev, params_path)
        torch.cuda.empty_cache()
        out["c"] = _seq_part(grid, seq_runs)
    return out


def ep_phase(dev) -> dict:
    """Expert parallelism on ``gloo`` ranks sharing the card (the
    docstring's phase 14): the twins first, alone, then one group of
    EP_PREFILL's ranks for (a) and, on its data shard 0, (b)."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.nets import map_tree
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.models import expert_parallel as EP

    res = {"card": _smi(), "arch": EP_ARCH}
    launches = {}
    D, M = EP_PREFILL["grid"]
    check(EP_TRAIN["grid"] == (1, M), "(b) runs on (a)'s data shard 0")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ep_")
    try:
        # (a) the twin shard by shard (EPPlan(1, M) on each data shard's
        # rows: the same function as EPPlan(D, M) on the batch, with the
        # ranks' product shapes; a B 2 product rounds otherwise than a B 1
        # one, and a near-tie route flips); the one-process moe_ffn
        # prefill in bf16, timed
        cell = EP_PREFILL
        model = build_model(_ep_cfg(cell["layers"], "float32"), dev)
        params = model.init(SEED)
        tokens = _ep_tokens(dev, cell)
        n = cell["batch"] // D
        with EP.use_ep(EP.EPPlan(1, M)):
            twin = torch.cat([model.prefill(params,
                                            {"tokens": tokens[d * n:
                                                              (d + 1) * n]})
                              for d in range(D)])
        logits_path = os.path.join(tmp, "twin_logits.pt")
        torch.save(twin.cpu(), logits_path)
        del twin
        one = build_model(_ep_cfg(cell["layers"], "bfloat16", False), dev)
        times = []
        for _ in range(1 + EP_TIME_REPS):
            _sync(dev)
            t0 = time.perf_counter()
            one.prefill(params, {"tokens": tokens})
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        del params, model, one
        torch.cuda.empty_cache()

        # (b) the peaks reckoned by the dry run (the twin's step; a rank's
        # as moe_ffn over its E/M experts), then the twin's steps
        cell = EP_TRAIN
        cfg = _ep_cfg(cell["layers"], "float32")
        mesh11 = make_production_mesh(shape=(1, 1))
        shape = ShapeConfig("ep", cell["seq"], cell["batch"], "train")
        rank_dry = dryrun.lower_cell(
            EP_ARCH, None, cfg_override=dataclasses.replace(
                cfg, n_experts=cfg.n_experts // M, moe_shard_map=False),
            mesh=mesh11, shape_override=shape)[1]["peak_bytes"]
        with EP.use_ep(EP.EPPlan(1, M)):
            twin_dry = dryrun.lower_cell(EP_ARCH, None, cfg_override=cfg,
                                         mesh=mesh11,
                                         shape_override=shape)[1]["peak_bytes"]
        t_left = torch.cuda.memory_allocated(dev)   # earlier phases' leftovers
        model = build_model(cfg, dev)
        box = [model.init(SEED)]
        torch.cuda.reset_peak_memory_stats(dev)
        t_peaks = []
        with EP.use_ep(EP.EPPlan(1, M)):
            params, t_losses, t_secs = _ep_train(
                model, box, cell, dev, lambda b: b, cell["steps"],
                peaks=t_peaks)
        params_path = os.path.join(tmp, "twin_params.pt")
        torch.save(map_tree(lambda t: t.cpu(), params), params_path)
        del params, model
        torch.cuda.empty_cache()

        # (c) the one-process prefills and decodes over the whole cache
        check(SEQ_CELL["grid"] == (1, M), "(c) runs on (a)'s data shard 0")
        t0 = time.perf_counter()
        seq_one = _seq_one_process(dev, tmp)
        seq_one["seconds"] = time.perf_counter() - t0
        launches["flash_attention"] = seq_one["k5"]

        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=tmp) as store:
            ranks = mesh_lib.run_ranks(
                mesh_lib.make_grid_mesh(D, M, store, dev.type,
                                        timeout_s=300),
                _ep_rank, logits_path, params_path, seq_one["runs"],
                deadline_s=600)
        res["group_seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in ranks:   # printed before the checks
        emit({"ep_rank": r})
    for r in ranks:
        check(r["device"].startswith("cuda"), f"rank {r['rank']} on "
              f"{r['device']}")

    cell = EP_PREFILL
    a = {"grid": [D, M], "layers": cell["layers"],
         "batch": [cell["batch"], cell["seq"]],
         "one_process_moe_ffn_bf16_ms": times[1:]}
    for r in ranks:
        f32, bf16 = r["a"]["float32"], r["a"]["bfloat16"]
        err = f32["max_abs_err"] / f32["max_abs_logit"]
        check(f32["finite"] and bf16["finite"] and err <= EP_LOGIT_TOL,
              f"(a) rank {r['rank']}: logits {err:.3e} of max off the "
              "twin's")
        for dtype, kern in (("float32", "flash_attention_f32"),
                            ("bfloat16", "flash_attention_sm90")):
            want = {"flash_attention": cell["layers"], kern: cell["layers"]}
            check(r["a"][dtype]["counts"] == want,
                  f"(a) rank {r['rank']} {dtype}: K5 "
                  f"{r['a'][dtype]['counts']}, want {want}")
            pred = _ep_predict(_ep_cfg(cell["layers"], dtype), cell)
            check(r["a"][dtype]["collectives"] == pred,
                  f"(a) rank {r['rank']} {dtype}: collectives "
                  f"{r['a'][dtype]['collectives']}, predicted {pred}")
            launches["flash_attention"] = \
                launches.get("flash_attention", 0) + cell["layers"]
    a["max_logit_err"] = max(r["a"]["float32"]["max_abs_err"]
                             / r["a"]["float32"]["max_abs_logit"]
                             for r in ranks)
    res["a"] = a
    emit({"ep_prefill": a})

    cell = EP_TRAIN
    trained = [r for r in ranks if "b" in r]
    check(len(trained) == M, f"(b) {len(trained)} ranks trained, want {M}")
    b = {"grid": [1, M], "layers": cell["layers"],
         "batch": [cell["batch"], cell["seq"]], "steps": cell["steps"],
         "twin_losses": t_losses, "twin_step_s": t_secs,
         "twin_max_memory_allocated_by_step": t_peaks,
         "memory_left_by_earlier_phases": t_left,
         "twin_dryrun_peak_bytes": twin_dry, "rank_dryrun_peak_bytes": rank_dry}
    n_k5 = cell["steps"] * cell["layers"] * (1 + int(cfg.remat))
    for r in trained:
        rb = r["b"]
        diff = max(abs(x - y) for x, y in zip(rb["losses"], t_losses))
        check(diff <= EP_LOSS_TOL, f"(b) rank {r['rank']}: losses "
              f"{rb['losses']} against the twin's {t_losses}")
        check(rb["param_err"] <= EP_PARAM_TOL,
              f"(b) rank {r['rank']}: params {rb['param_err']:.3e} off")
        want = {"flash_attention": n_k5, "flash_attention_f32": n_k5,
                "flash_attention_vjp": cell["steps"] * cell["layers"]}
        check(rb["counts"] == want,
              f"(b) rank {r['rank']}: K5 {rb['counts']}, want {want}")
        pred = _ep_predict(cfg, cell, cell["steps"])
        check(rb["collectives"] == pred,
              f"(b) rank {r['rank']}: collectives {rb['collectives']}, "
              f"predicted {pred}")
        launches["flash_attention"] = launches.get("flash_attention", 0) \
            + n_k5
    # the peaks against the dry runs, less what was allocated before
    gaps = {"twin": (max(t_peaks) - t_left) / twin_dry - 1}
    for r in trained:
        gaps[f"rank{r['rank']}"] = ((r["b"]["max_memory_allocated"]
                                     - r["b"]["memory_left_by_a"])
                                    / rank_dry - 1)
    b["peak_gap_vs_dryrun"] = gaps
    check(all(abs(g) <= DRYRUN_PEAK_TOL for g in gaps.values()),
          f"(b) peaks off their dry runs by {gaps}")
    b["max_loss_diff"] = max(abs(x - y) for r in trained
                             for x, y in zip(r["b"]["losses"], t_losses))
    b["max_param_err"] = max(r["b"]["param_err"] for r in trained)
    res["b"] = b
    emit({"ep_train": b})

    res["c"] = _seq_checks(ranks, seq_one)
    res["ranks"] = ranks
    res["launches"] = launches
    print(res["card"])
    return res


def _all_launches() -> dict:
    """Every kernel wrapper's launch and plain-call counts (K1-K6)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import pinn_mlp as PM
    from repro_torch.kernels import wkv6 as WK

    return {**PM.launches, **PM.plain_calls, **FA.launches, **FA.plain_calls,
            **WK.launches, **WK.plain_calls}


def _train_peak(name, n_layers) -> dict:
    """The dry run of LM_TRAIN[name]'s training step at ``n_layers`` on a
    (1, 1) mesh."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cell = LM_TRAIN[name]
    cfg = _lm_cfg(name)
    if n_layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return dryrun.lower_cell(
        name, None, cfg_override=cfg,
        mesh=make_production_mesh(shape=(1, 1)),
        shape_override=ShapeConfig("lm_train", cell["seq"], cell["batch"],
                                   "train"))[1]


def _deepest_fit(name, cut, peak_at_cut, total) -> dict:
    """The deepest depth whose predicted peak fits ``total`` bytes.  A
    homogeneous stack adds the same bytes a layer (dry runs at other
    depths agree with the line to the byte), so the cut's peak and the
    next layer's give every depth's; the deepest that fits is then
    dry-run to confirm it."""
    from repro_torch.configs import get_config

    full = get_config(name).n_layers
    peaks = {cut: peak_at_cut}

    def peak(n):
        if n not in peaks:
            peaks[n] = _train_peak(name, n)["peak_bytes"]
        return peaks[n]

    slope = max(1, peak(cut + 1) - peak_at_cut) if cut < full else 1

    def line(n):
        return peak_at_cut + (n - cut) * slope

    n = cut
    while n < full and line(n + 1) <= total:
        n += 1
    while n > 1 and peak(n) > total:   # the line's deepest, confirmed
        n -= 1
    return {"deepest_fit": n, "full_depth": full,
            "peak_at_deepest": peak(n),
            "line_one_deeper": line(n + 1) if n < full else None,
            "dry_runs": {k: peaks[k] for k in sorted(peaks)}}


def _ep_dry_runs() -> dict:
    """The partitioned dry runs of the ep phase's cells (``lower_cell(
    partitioned=True)``, the rules replicating every param but the experts
    as the ranks hold them): ``{"extra_rules", "prefill": {dtype: (record,
    seconds)}, "train": (record, seconds)}``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.sharding import SINGLE_POD_RULES

    rules = {k: None for k in SINGLE_POD_RULES if k not in ("batch",
                                                           "expert")}
    out = {"extra_rules": rules, "prefill": {}}
    for cell, kinds in ((EP_PREFILL, ("float32", "bfloat16")),
                        (EP_TRAIN, ("float32",))):
        kind = "train" if cell is EP_TRAIN else "prefill"
        for dtype in kinds:
            t0 = time.perf_counter()
            _, rec = dryrun.lower_cell(
                EP_ARCH, None, cfg_override=_ep_cfg(cell["layers"], dtype),
                mesh=make_production_mesh(shape=cell["grid"]),
                shape_override=ShapeConfig("ep", cell["seq"], cell["batch"],
                                           kind),
                partitioned=True, extra_rules=rules)
            row = (rec, time.perf_counter() - t0)
            if kind == "train":
                out["train"] = row
            else:
                out["prefill"][dtype] = row
    # (c)'s decode: every param replicated, the cache split along T over
    # the model axis
    seq_rules = {k: None for k in SINGLE_POD_RULES if k != "batch"}
    seq_rules["kv_seq"] = "model"
    out["seq_rules"], out["seq"] = seq_rules, {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        _, rec = dryrun.lower_cell(
            SEQ_ARCH, None, cfg_override=_seq_cfg(dtype),
            mesh=make_production_mesh(shape=SEQ_CELL["grid"]),
            shape_override=ShapeConfig("seq", SEQ_CELL["cache"],
                                       SEQ_CELL["batch"], "decode"),
            partitioned=True, extra_rules=seq_rules)
        out["seq"][dtype] = (rec, time.perf_counter() - t0)
    return out


def _ep_partitioned(ep, runs) -> dict:
    """Part (e) of the dryrun phase: the partitioned dry runs of the ep
    phase's cells (``runs``: :func:`_ep_dry_runs`) against what its ranks
    recorded (``ep``: ep_phase's result)."""
    t_part = time.perf_counter()
    out = {"extra_rules": sorted(runs["extra_rules"])}

    def groups(rec):
        return {g: {k: [v["count"], v["bytes"]] for k, v in kinds.items()}
                for g, kinds in rec["collectives_by_group"].items()}

    cell = EP_PREFILL
    for dtype in ("float32", "bfloat16"):
        cfg = _ep_cfg(cell["layers"], dtype)
        rec, secs = runs["prefill"][dtype]
        got = groups(rec)
        row = {"collectives": got, "kernel_calls": rec["kernel_calls"],
               "peak_bytes_per_device": rec["peak_bytes_per_device"],
               "flops_per_device": rec["flops_per_device"],
               "collective_s": rec["roofline"]["collective_s"],
               "dry_run_s": secs}
        out[f"prefill_{dtype}"] = row
        pred = _ep_predict(cfg, cell)
        check(got == pred, f"(e) prefill {dtype}: dry run {got}, predicted "
              f"{pred}")
        for r in ep["ranks"]:
            check(got == r["a"][dtype]["collectives"],
                  f"(e) prefill {dtype}: dry run {got}, rank {r['rank']} "
                  f"{r['a'][dtype]['collectives']}")
            check(rec["kernel_calls"]["flash_attention"]
                  == r["a"][dtype]["counts"]["flash_attention"],
                  f"(e) prefill {dtype}: K5 {rec['kernel_calls']}, rank "
                  f"{r['rank']} {r['a'][dtype]['counts']}")
    cell = EP_TRAIN
    cfg = _ep_cfg(cell["layers"], "float32")
    rec, secs = runs["train"]
    n = cell["steps"]
    got = {g: {k: [c * n, b * n] for k, (c, b) in kinds.items()}
           for g, kinds in groups(rec).items()}
    trained = [r for r in ep["ranks"] if "b" in r]
    gaps = {}
    for r in trained:
        check(got == r["b"]["collectives"],
              f"(e) train: dry run x {n} {got}, rank {r['rank']} "
              f"{r['b']['collectives']}")
        k5 = rec["kernel_calls"]["flash_attention"] * n
        check(k5 == r["b"]["counts"]["flash_attention"],
              f"(e) train: K5 {k5}, rank {r['rank']} {r['b']['counts']}")
        measured = r["b"]["max_memory_allocated"] - \
            r["b"]["memory_left_by_a"]
        gaps[f"rank{r['rank']}"] = \
            rec["peak_bytes_per_device"] / measured - 1
        check(abs(gaps[f"rank{r['rank']}"]) <= DRYRUN_PEAK_TOL,
              f"(e) train: peak {rec['peak_bytes_per_device']} vs rank "
              f"{r['rank']}'s {measured}")
    pred = _ep_predict(cfg, cell, n)
    check(got == pred, f"(e) train: dry run x {n} {got}, predicted {pred}")
    out["train"] = {"collectives_one_step": groups(rec),
                    "collectives_steps": got, "steps": n,
                    "kernel_calls_one_step": rec["kernel_calls"],
                    "peak_bytes_per_device": rec["peak_bytes_per_device"],
                    "peak_gap_vs_ranks": gaps,
                    "collective_s": rec["roofline"]["collective_s"],
                    "dry_run_s": secs}
    # (c): one decode step's record times the steps, against each rank
    # of each run and _seq_predict
    n = SEQ_CELL["steps"]
    out["seq"] = {"rules": {k: v for k, v in runs["seq_rules"].items()
                            if v is not None}}
    train_secs = secs
    for dtype, (rec, secs) in runs["seq"].items():
        got = {g: {k: [c * n, b * n] for k, (c, b) in kinds.items()}
               for g, kinds in groups(rec).items()}
        pred = _seq_predict(_seq_cfg(dtype), SEQ_CELL, n)
        check(got == pred, f"(e) seq {dtype}: dry run x {n} {got}, "
              f"predicted {pred}")
        for tag, row in ep["c"]["runs"].items():
            if not tag.startswith(dtype):
                continue
            for rank, r in row["ranks"].items():
                check(got == r["collectives"],
                      f"(e) seq {tag}: dry run x {n} {got}, rank {rank} "
                      f"{r['collectives']}")
        check(rec["kernel_calls"]["flash_attention"] == 0,
              f"(e) seq {dtype}: K5 {rec['kernel_calls']} in a decode")
        out["seq"][dtype] = {
            "collectives_one_step": groups(rec), "collectives_steps": got,
            "peak_bytes_per_device": rec["peak_bytes_per_device"],
            "collective_s": rec["roofline"]["collective_s"],
            "dominant": rec["roofline"]["dominant"], "dry_run_s": secs}
    out["seconds"] = time.perf_counter() - t_part + sum(
        v[1] for v in runs["prefill"].values()) + train_secs + sum(
        v[1] for v in runs["seq"].values())
    emit({"dryrun_partitioned_ep": out})
    return out


def dry_runs(total=None, ep=False) -> dict:
    """The dryrun phase's dry runs, on the CPU (``meta`` tensors; no
    card work, so they run in a thread while nvcc builds the kernels,
    before any run they predict): with ``total`` (the card's bytes) (a)
    each LM_TRAIN step, (b) the deepest cut that fits ``total`` for the
    configs cut by memory and (c) the full-size cells; with ``ep`` (e)
    the ep cells partitioned.  Prints nothing: ``dryrun_phase`` emits the
    rows and holds them against the card.  The launch counters before
    and after are kept for (d)."""
    from repro_torch.launch import dryrun

    t_start = time.perf_counter()
    out = {"launches_before": _all_launches(), "total": total, "a": {},
           "b": {}, "c": []}
    for name, cell in (LM_TRAIN if total else {}).items():
        t0 = time.perf_counter()
        rec = _train_peak(name, _lm_cfg(name).n_layers)
        out["a"][name] = (rec, time.perf_counter() - t0)
    t0 = time.perf_counter()
    for name, cell in (LM_TRAIN if total else {}).items():
        if cell["layers"]:
            out["b"][name] = _deepest_fit(name, cell["layers"],
                                          out["a"][name][0]["peak_bytes"],
                                          total)
    out["b_seconds"] = time.perf_counter() - t0
    for name in (DRYRUN_FULL if total else ()):
        for shape in DRYRUN_FULL_SHAPES:
            t0 = time.perf_counter()
            _, rec = dryrun.lower_cell(name, shape)
            rec["dry_run_s"] = time.perf_counter() - t0
            out["c"].append(rec)
    out["e"] = _ep_dry_runs() if ep else None
    out["launches_after"] = _all_launches()
    out["seconds"] = time.perf_counter() - t_start
    return out


class _Background(threading.Thread):
    """``fn(*args)`` in a thread; :meth:`get` waits for it and returns its
    result or raises its error."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self._fn, self._args = fn, args
        self._result = self._error = None

    def run(self):
        try:
            self._result = self._fn(*self._args)
        except BaseException as e:   # raised again by get()
            self._error = e

    def get(self):
        self.join()
        if self._error is not None:
            raise self._error
        return self._result


def dryrun_phase(dev, dry, lm_train=None, ep=None) -> dict:
    """The dry run (``launch.dryrun``) against the card (the docstring's
    phase 15), from ``dry`` (:func:`dry_runs`' records): (a) each LM_TRAIN
    run's step predicted against what the lm train phase measured (peak,
    K5/K6 launches a step, FLOPs over the step's time); (b) the deepest
    cut that fits the card for the configs cut by memory; (c) full-size
    cells on the (16, 16) mesh; (d) no launch counter moved during the dry
    runs; (e) with ``ep`` (the ep phase's result), the partitioned dry run
    of the ep cells against its ranks.  (a)-(c) run with ``lm_train``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    from repro_torch.models import build_model
    from repro_torch.utils import tree_bytes, tree_count

    smi = _smi()
    res = {"card": smi, "tol": DRYRUN_PEAK_TOL,
           "dry_runs_s": dry["seconds"]}
    # (a) each LM_TRAIN run's step
    for name, cell in (LM_TRAIN if lm_train else {}).items():
        cfg = _lm_cfg(name)
        rec, secs = dry["a"][name]
        params = dryrun.param_structs(build_model(cfg, "meta"))
        row = lm_train[name]
        # the run's own peak: less what earlier phases left allocated
        measured = row["max_memory_allocated"] - row["memory_allocated_before"]
        gap = (rec["peak_bytes"] - measured) / measured
        per_step = {k: row["launches"].get(k, 0) // cell["steps"]
                    for k in ("flash_attention", "wkv6")}
        step_s = row["steady_ms_per_step"] / 1e3
        out = {"arch": name, "layers": cfg.n_layers, "batch": cell["batch"],
               "seq": cell["seq"], "params": tree_count(params),
               "param_bytes": tree_bytes(params),
               "predicted_peak": rec["peak_bytes"],
               "peak_in_param_copies": rec["peak_bytes"] / tree_bytes(params),
               "max_memory_allocated": row["max_memory_allocated"],
               "run_peak": measured,
               "memory_allocated_before": row["memory_allocated_before"],
               "peak_gap": gap, "kernel_calls": rec["kernel_calls"],
               "card_launches_per_step": per_step, "flops": rec["flops"],
               "steady_ms_per_step": row["steady_ms_per_step"],
               "tflops_per_s": rec["flops"] / step_s / 1e12,
               "share_of_bf16_peak": rec["flops"] / step_s / PEAK_FLOPS_BF16,
               "dry_run_s": secs}
        emit({"dryrun_vs_card": out})
        check(abs(gap) <= DRYRUN_PEAK_TOL,
              f"{name}: predicted peak {rec['peak_bytes']} vs the run's "
              f"{measured} ({gap:+.3%})")
        check(rec["kernel_calls"] == per_step,
              f"{name}: dry run {rec['kernel_calls']} vs card {per_step}")
        res[name] = out
    # (b) the deepest cut that fits, for the configs cut by memory
    res["mem_get_info_total"] = total = dry["total"]
    for name, cell in (LM_TRAIN if lm_train else {}).items():
        if not cell["layers"]:
            continue
        fit = dict(dry["b"][name], cut_run=cell["layers"])
        emit({"dryrun_deepest_fit": {"arch": name, "total": total, **fit}})
        check(cell["layers"] <= fit["deepest_fit"],
              f"{name}: the run's cut {cell['layers']} is deeper than the "
              f"deepest that fits, {fit['deepest_fit']}")
        res[name]["fit"] = fit
    res["b_seconds"] = dry["b_seconds"]
    # (c) full size on the production mesh
    for rec in (dry["c"] if lm_train else ()):
        emit({"dryrun_full": {k: v for k, v in rec.items()
                              if k != "notes"}})
        check(rec["ok"], f"{rec['arch']} {rec['shape']}: {rec}")
    # (e) the partitioned dry run of the ep cells
    if ep is not None:
        res["e"] = _ep_partitioned(ep, dry["e"])
        res["e_seconds"] = res["e"]["seconds"]
    # (d) no launch
    check(dry["launches_after"] == dry["launches_before"],
          f"launch counts moved during the dry runs: "
          f"{dry['launches_before']} -> {dry['launches_after']}")
    print(smi)
    return res


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


# -------------------------------------------------------------------- report

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every phase's numbers to this JSON")
    ap.add_argument("--only", default=None,
                    choices=("distributed", "scenarios", "lm", "lm_train",
                             "ep"),
                    help="only the build and this phase (no result line)")
    ap.add_argument("--ab", default=None, metavar="DIR",
                    help="only time this checkout's K3/K4 against the "
                         "pinn_mlp_fwd.cu / pinn_mlp_bwd.cu in DIR (another "
                         "revision's), in turns; no other phase runs")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on a "
                         "card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {ROOT}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version in
    torch.backends.cudnn.allow_tf32 = False         # full float32
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        emit({"phase": name, "seconds": round(time.perf_counter() - t0, 2)})
        return res

    if args.ab:
        _, b_main = _train_setup("cpu")
        phase("build", build_phase)
        phase("ab", ab_phase, dev, args.ab, _rows(b_main))
        print(_smi())
        return 0
    if args.only == "lm":
        phase("build", build_phase)
        phase("lm kernels", lm_sweep, dev)
        phase("lm timing", lm_timing, dev)
        phase("llm", llm_phase, dev)
        phase("llm serve", llm_serve_phase, dev)
        print(_smi())
        return 0
    if args.only in ("lm_train", "ep"):
        lm = args.only == "lm_train"
        dry = _Background(dry_runs, torch.cuda.mem_get_info()[1] if lm
                          else None, not lm)
        dry.start()
        phase("build", build_phase)
        dry = phase("dry runs (after the build)", dry.get)
        if lm:
            lm_train = phase("lm train", lm_train_phase, dev)
            phase("dryrun", dryrun_phase, dev, dry, lm_train)
        else:
            ep = phase("ep", ep_phase, dev)
            phase("dryrun", dryrun_phase, dev, dry, None, ep)
        print(_smi())
        return 0
    if args.only:
        phase("build", build_phase)
        phase(args.only, {"distributed": distributed_phase,
                          "scenarios": scenarios_phase}[args.only], dev)
        print(_smi())
        return 0
    # the dry runs (CPU only) while nvcc builds; held to the card at the end
    dry = _Background(dry_runs, torch.cuda.mem_get_info()[1], True)
    dry.start()
    phase("build", build_phase)
    dry = phase("dry runs (after the build)", dry.get)
    worst = phase("kernels", sweep, dev)
    worst.update(phase("train kernels", train_sweep, dev))
    _, b_main = _train_setup("cpu")
    m_train = _rows(b_main)
    times = phase("timing", timing, dev)
    times.update(phase("train timing", train_timing, dev, m_train))
    launches = phase("serve", serve_phase, dev)
    train = phase("train", train_phase, dev)
    for k, v in train["launches"].items():
        launches[k] = launches.get(k, 0) + v
    t3 = times[("pinn_mlp_fwd2_res", 24, 4, m_train)]
    t4 = times[("pinn_mlp_bwd2", 24, 4, m_train)]
    emit({"train_step": {
        "step_ms": train["step_ms"], "forward_kernel_ms": t3["ms"],
        "backward_kernel_ms": t4["ms"],
        "other_ms": train["step_ms"] - t3["ms"] - t4["ms"]}})
    phase("runtime", runtime_phase, dev)
    for k, v in phase("distributed", distributed_phase, dev).items():
        launches[k] = launches.get(k, 0) + v
    for k, v in phase("scenarios", scenarios_phase, dev).items():
        launches[k] = launches.get(k, 0) + v
    worst.update(phase("lm kernels", lm_sweep, dev))
    times.update(phase("lm timing", lm_timing, dev))
    llm = phase("llm", llm_phase, dev)
    for k, v in llm["launches"].items():
        launches[k] = launches.get(k, 0) + v
    served = phase("llm serve", llm_serve_phase, dev)
    launches["flash_attention"] += 2 * sum(served.values())   # two runs each
    lm_train = phase("lm train", lm_train_phase, dev)
    for k, v in lm_train["launches"].items():
        launches[k] = launches.get(k, 0) + v
    ep = phase("ep", ep_phase, dev)
    for k, v in ep["launches"].items():
        launches[k] = launches.get(k, 0) + v
    phase("dryrun", dryrun_phase, dev, dry, lm_train, ep)

    kernels = []
    shapes = {"pinn_mlp_fwd1": MAIN, "pinn_mlp_fwd2": MAIN,
              "pinn_mlp_fwd2_res": (24, 4, m_train),
              "pinn_mlp_bwd2": (24, 4, m_train),
              "flash_attention": (4096,), "wkv6": (4096,)}
    for name, shape in shapes.items():
        t = times[(name, *shape)]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "device_kernels": {n: launches[n] for n in DEVICE_KERNELS
                               if n.startswith(name) and n in launches},
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            "shape": t["shape"]})
        if name in lm_train["kernel_times"]:   # at the training shapes
            kernels[-1]["train_shape"] = {
                k: v for k, v in lm_train["kernel_times"][name].items()
                if k not in ("bytes", "flops")}
            kernels[-1]["lm_train_launches"] = lm_train["launches"][name]
        if name == "flash_attention":   # minicpm3-4b's MLA shape
            mla = lm_train["minicpm3-4b"]
            kernels[-1]["mla_shape"] = {
                **{k: v for k, v in times[("flash_attention_mla", 4096)]
                   .items() if k not in ("bytes", "flops")},
                "prefill_launches": llm["by_arch"]["minicpm3-4b"][name],
                "lm_train_launches": mla["launches"][name],
                "lm_train_launches_per_step": mla["launches"][name]
                / mla["steps"]}
            kernels[-1]["moe_shapes"] = {
                arch: {**{k: v for k, v in times[("flash_attention_moe",
                                                  arch)].items()
                          if k not in ("bytes", "flops")},
                       "prefill_launches": llm["by_arch"][arch][name],
                       **({"lm_train_launches":
                           lm_train[arch]["launches"][name]}
                          if arch in lm_train else {})}
                for arch in MOE_HEADS}
            # the VLM's shape is phi3.5-moe's (32/8 heads of 128), timed
            # there; zamba2's shared attention is timed at its own
            timed = {"llava-next-mistral-7b": {
                         "timed_as": "moe_shapes.phi3.5-moe-42b-a6.6b"},
                     "zamba2-1.2b": {
                         k: v for k, v in times[("flash_attention_hybrid",
                                                 "zamba2-1.2b")].items()
                         if k not in ("bytes", "flops")}}
            kernels[-1]["vlm_hybrid_paths"] = {
                arch: {**timed[arch],
                       "prefill_launches": llm["by_arch"][arch][name],
                       "lm_train_launches": lm_train[arch]["launches"][name],
                       "lm_train_launches_per_step":
                       lm_train[arch]["launches"][name]
                       / lm_train[arch]["steps"]}
                for arch in K5_PATHS}
            # seamless-m4t-large-v2: each call's shape timed, with its
            # launches in one prefill (B 1 x 4096) or one decode step
            enc = llm["encdec"]
            per_role = {}
            for role, (B, S, T, causal) in ENCDEC_K5.items():
                per_role[role] = (
                    {"launches_per_decode_step": enc["decode_per_step"]}
                    if S == 1 else
                    {"launches_per_prefill":
                     enc["prefill_shapes"][(causal, S, T)]})
            # expert parallelism: deepseek-moe-16b on gloo ranks (phase
            # 14), each rank's launches
            kernels[-1]["ep_path"] = {
                "arch": EP_ARCH,
                "prefill_launches_per_rank": {
                    dt: [r["a"][dt]["counts"][name] for r in ep["ranks"]]
                    for dt in ("float32", "bfloat16")},
                "prefill_grid": list(EP_PREFILL["grid"]),
                "lm_train_launches_per_rank":
                    [r["b"]["counts"][name] for r in ep["ranks"]
                     if "b" in r],
                "lm_train_grid": list(EP_TRAIN["grid"]),
                "lm_train_steps": EP_TRAIN["steps"],
                "seq_decode_prefill_launches": ep["c"]["prefill_k5_launches"]}
            et = lm_train[ENCDEC]
            kernels[-1]["encdec_path"] = {
                "arch": ENCDEC,
                "prefill_launches": llm["by_arch"][ENCDEC][name],
                "serve_launches_per_run": served[ENCDEC],
                "lm_train_launches": et["launches"][name],
                "lm_train_launches_per_step": et["launches"][name]
                / et["steps"],
                "calls": {role: {**{k: v for k, v in times[(
                    "flash_attention_encdec", role)].items()
                    if k not in ("bytes", "flops")}, **per_role[role]}
                    for role in ENCDEC_K5}}
    smi = _smi()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"kernels": kernels, "nvidia_smi": smi,
                       "results": RECORD,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    emit({"kernels": kernels})
    print(smi)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
