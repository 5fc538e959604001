"""Serve CF-KAN-1, mamba2-1.3b, the KAN-FFN LLM, mistral-nemo-12b and
recurrentgemma-2b, train CF-KAN-1 and search its per-layer operating points
at full width on one CUDA card through the port's hand-written kernels,
serve the KAN-FFN LLM and mamba2-1.3b through the continuous-batching
engine and the KAN-FFN LLM through the multi-replica router and the
launcher's fleet path, run mixtral-8x7b and internvl2-76b over measured
cuts of their layers, serve whisper-base through the engine, train the
KAN-FFN LLM, whisper-base and mamba2-1.3b end to end, train the KAN-FFN
LLM, mamba2-1.3b and mixtral-8x7b sharded over a device mesh of ranks
sharing the card, and hold every kernel against its plain version.

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Build: the kernels in ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, all started together), with the build time.
3. Kernels against their plain versions on the same inputs, at the shapes
   the main path gives them (CF-KAN-1 encoder and decoder, batch 256, inputs
   from the synthetic users). ``kan_fused`` is held to the plain formula
   in float64 (the exact sum) at ``1e-6 * sum|terms|``, the terms being
   ``E[b,i,s] * codes[i,s,o] * scale[o]`` (its sums run over up to 163,840
   terms in another order), and to the plain f32 version at the same bar
   plus that version's own distance from the exact sum (whose f32 sums
   reach past 1e-6 * sum|terms| at some of the tuner's shapes); a second
   launch on the same inputs must give bitwise the same output; its rows
   also report both distances from the exact sum in units of ``atol 2e-5 +
   rtol 1e-5`` and of ``sum|terms|``.
   ``cim_mac`` (As in 128..1024, gamma0 0.08; at As 256 also, for the
   encoder, seeded WL values with no zero, the dense worst case) is held to
   ``atol 2e-3, rtol 1e-4`` (the JAX suite's bar, set at R <= 256) plus the
   same ``1e-6 * sum|terms|``, the terms being ``2^k * readout`` over up to
   1280 arrays x 8 slices summed in another order; a larger difference must
   be a whole number of ADC steps, in under 0.1% of the outputs. A second
   launch on the same inputs must give bitwise the same output; each row
   prints the share of (batch row, row) pairs whose terms the kernel
   formed, as that launch counted them (``rows_iterated``), and only the
   rows at the main path's As with the main path's inputs count toward its
   per-apply time.
   ``cim_mac_tiled`` (As in 128..1024, Cc 64, gamma0 0.08, gains from
   ``variation.grid_gain`` at sigma 0.05, seed 0) takes the WL values in the
   physical order that ``chip.place_layer`` gives them (uniform mapping;
   at As 256 also KAN-SAM from Phase-A stats on the first two batches, and
   for the encoder seeded WL values with no zero, the dense worst case)
   and must give bit-identical int32 codes, twice; each row prints the
   share of (batch row, row) pairs whose terms the kernel formed, as its
   second launch counted them (``rows_iterated``), and only the uniform
   rows count toward its per-apply time. ``kan_basis`` (the crossbar
   backends' dense basis) must equal ``quant.quantized_basis`` bit for bit,
   twice, at CF-KAN-1's encoder and decoder inputs (its per-apply time)
   and at CF-KAN-2's (G 15: the same bounded items, a seeded decoder
   input); its bound counts x, the table and the basis once, and its rows
   give ``device_ms`` and ``host_ms`` as ``kan_fused``'s do; no one
   PyTorch call computes it. Times come from CUDA events with the
   L2 cache flushed before every launch (``Timer``); ``kan_fused``'s rows
   and its library call's also give the device's time alone (``device_ms``,
   ``library_device_ms``) and the host's time per call (``host_ms``,
   ``library_host_ms``). ``bound_ms`` is the larger of bytes over
   3.35 TB/s and operations over the peak of their type (H100 SXM data
   sheet): f32 over 67 TFLOP/s, except ``kan_fused``, whose exact result
   takes 3 bf16 products (the three-way split of each tap) per nonzero
   basis entry and output at 989 TFLOP/s; its row keeps the f32 count on
   the CUDA cores beside it as ``bound_f32_ms``.
4. The main path, CF-KAN-1 from ``init(seed=0)`` and 1024 synthetic users
   served in batches of 256 through ``kan.apply``, in two runs, each with
   the launch counts zeroed just before and read just after:
   (a) Phase-A stats on two batches and one deploy each for ``fused``,
   ``cim`` uniform and ``cim`` KAN-SAM (As 256): ``kan_fused`` and
   ``cim_mac`` must be launched; (b) ``kan.deploy`` to ``cim_tiled``
   uniform and KAN-SAM (As 256, Cc 64, gamma0 0.08, sigma 0.05) from the
   same stats, with the chip report: ``cim_mac_tiled`` must be launched;
   ``kan_basis`` must be launched over (a) and (b).
5. A small-input reference: a narrow CF-KAN served layer by layer on the
   card and on the CPU (plain versions) from one artifact and one input;
   and mamba2 ``SMOKE`` at f32, ``kan_llm`` ``SMOKE`` deployed on
   ``lut_int8`` and on ``fused``, and mistral-nemo ``SMOKE`` at f32, each
   from one set of weights on both: ``generate`` tokens identical, forward,
   prefill and decode logits within ``2e-4`` (the JAX serving suite's bar).
   A KAN-FFN quantises its inputs to 2^8 levels, so an input an ulp from a
   level boundary can take the neighbouring code on one device: every KAN
   layer's input codes are captured on both, and logits of a batch row from
   the first position whose code differs on are held to ``BF16_REL`` of
   their largest magnitude instead (the port's test rule); tokens must then
   agree up to the first near tie. At f32 the codes that differ
   independently of an earlier differing one must stay within 1e-3 of
   those compared, so that a wrong kernel cannot widen its own bar.
6. Fig. 18 on the kernel path: one 64 -> 64 KAN layer (G=8, batch 128),
   gamma0 0.2, sigma 0.05, chip seeds 0-2, As 128..1024, uniform and
   KAN-SAM mapping: the uniform error against ``lut`` must grow with As and
   KAN-SAM must be below uniform at As 1024. One As-1024 cell runs once more
   with a generator, through the noisy plain readout, on the card.

7. ``ssd_scan`` against its plain versions (the chunked form
   ``ref.ssd_chunked_ref`` and the sequential ``ref.ssd_ref``) on layer 0's
   scan inputs, computed by the port from mamba2-1.3b (seed 0) and phase
   8's prompts: T = 2048 (the prefill's shape), a ragged T = 2000, rows
   1000..2000 from the state of rows 0..1000 (``init_state``), and the JAX
   suite's (2, 37, 3, 8, 16) at chunk 8 on numpy inputs. y and the final
   state are held to the JAX suite's ``atol 3e-5, rtol 1e-4`` plus
   ``1e-6 * sum|terms|`` (the f32 sums run over up to 256 steps and 128
   state columns in another order; ``sum|terms|`` is the scan of |x|,
   |B|, |C|, |D| and |init|); each row gives the largest err/tolerance
   against both. Timed like phase 3; ``bound_ms`` counts the chunked
   algorithm's f32 operations on these inputs, ``bound_tf32_ms`` three
   times as many at the tf32 tensor-core peak (the kernel's 3xTF32
   products), ``tflops`` the f32 count over the measured time. The prefill
   row also gives ``mma_sync_ms``, the 3xTF32 count at the rate that the
   kernel's mma.sync building block alone reaches on the card
   (``ssd_mma_probe``), and, once phase 8 is done, each of the kernel's
   five CUDA kernels' device time from a ``torch.profiler`` trace.
8. The LM main path at full width: mamba2-1.3b ``CONFIG`` (48 layers,
   1,343,532,032 parameters, bf16 compute, f32 parameters) initialised on
   the card from a seeded CUDA generator, 4 prompts of 2048 tokens from
   ``lm_synth.batch_at(vocab=50280, batch=4, seq_len=2048, seed=0)``:
   ``decode.generate(n_new=32)``, then the same prefill and 31 decode steps
   timed one by one, then a teacher-forced ``forward`` over each prompt and
   its first 31 generated tokens (T = 2079). Launch counts are zeroed just
   before ``generate`` and before ``forward`` and read just after each:
   ``ssd_scan`` must run 48 times in each. Then an f32 control: the same
   weights and tokens at f32 compute, where prefill and decode logits must
   agree with ``forward``'s within ``F32_PATH_BAR`` and each step's argmax
   must be ``forward``'s wherever its top-1 logit leads its top-2 by more
   than that bar. At bf16 compute the residual stream is rounded after each
   layer and decode convolves a conv history rounded to bf16 where forward
   convolves f32 (both as in JAX), so the bf16 paths are held, in the same
   two checks, to the reach of bf16 rounding on these weights and tokens:
   the largest distance between the bf16 and the f32 forward.

9. Training at full width: CF-KAN-1 with ``backend="fused"`` from
   ``init(seed=0)``, the users of phase 4 split 819 / 205 into training and
   validation. (a) The autograd Function ``ops.kan_spline_fused`` per layer
   on the first training batch of 64 (the decoder's input the encoder's QAT
   output), dy seeded: its forward within ``kan_fused``'s
   ``1e-6 * sum|terms|`` of ``ref.kan_spline_ref``; d/dcoeffs within
   ``atol 1e-5 + rtol 1e-5 + 1e-6 * sum|terms|`` (the JAX suite's gradient
   bar, plus the summation-order part) of the quantised-basis product in
   float64; the decoder's d/dx within the same bar of the float path's
   derivative in float64 (the encoder's input is data and gets none); each
   row prints its largest err/tolerance. ``kan_fused`` at batch 64 (its
   split path) is held as in phase 3. (b) ``train_cf_kan.train``: 100 SGD
   steps of batch 64 at the JAX example's lr 2e-2 on the QAT loss, twice,
   launch counts zeroed before each run and read after: ``kan_fused``
   exactly twice a step, no crossbar kernel; every loss finite, the first
   within 5% of ``n_observed * ln(n_items)`` (near-uniform logits at init).
   The first run ends each step in a synchronize and gives the median host
   time per step; the second is the loop as users run it, with one
   synchronize after the last step, and gives its window over the steps.
   (c) On the trained weights, launch-counted: float (``ref``) and
   ASP-8-bit (QAT) Recall@20 and NDCG@20 of the validation users; the Fig. 18 protocol over every user
   through ``cim`` (gamma0 0.08, As 128..1024, uniform and KAN-SAM), whose
   uniform error must grow with As and KAN-SAM be below it at As 1024; the
   Fig. 19 cost of CF-KAN-1. (d) Over 5 more steps (profiler): the device's
   busy time per step, its idle share of (b)'s window and median per step,
   ``kan_fused``'s part, and the ops whose kernels took the most.

10. The KAN-FFN LLM and an attention LM at full width.
   (a) ``kan_llm`` ``CONFIG`` (4 layers, d 256, 8/4 heads, KAN-FFN 256 ->
   85 -> 256 with G 8, K 3, f32) from a seeded CUDA generator, deployed by
   ``transformer.deploy_kan`` once per backend (``lut``, ``lut_int8`` with
   ``kan_llm_int8``'s config, ``fused``); 16 prompts of 512 tokens from
   ``lm_synth.batch_at(vocab=4096, batch=16, seq_len=512, seed=0)``;
   ``decode.generate(n_new=32)`` launch-counted with
   ``quant.quantize_coeffs`` poisoned: ``fused`` launches ``kan_fused``
   exactly 8 times a pass (4 blocks x up/down), 256 in all, the others no
   kernel; then the prefill and each decode step timed (host clock, ending
   in a synchronize) and a forward. ``kan_fused`` is held as in phase 3 at
   the path's shapes (the prefill's up [8192, 256] -> 85 and down [8192,
   85] -> 256, a decode step's up [16, 256] -> 85 and down [16, 85] ->
   256, inputs captured from the path); ``lut_int8``'s KAN-FFN of layer 0 on the prefill's input gives
   bitwise the same int32 accumulators and f32 outputs on the card and on
   the CPU; ``fused``'s greedy tokens equal ``lut``'s up to the first step
   whose top-1 logit leads its top-2 by less than ``F32_PATH_BAR``.
   (b) mistral-nemo-12b ``CONFIG`` (GQA 32/8, head_dim 128, d_ff 14336,
   vocab 131072, bf16 compute, f32 parameters) at all 40 layers
   (11,576,693,760 parameters, 46.31 GB f32, and ``forward``'s bf16
   ``prescan_cast`` copy of them), 4 prompts of 2048 tokens (``batch_at(vocab=131072, batch=4,
   seq_len=2048, seed=0)``): phase 8's path, checks and f32 control.

11. The co-design tuner at full width: ``kan_neurosim_search.run`` on
   phase 9's trained CF-KAN-1 (``fused``; 819 / 205 users), budget 24,
   seed 0, grids (2, 4, 7, 8, 16, 32, 64) (the reference's lattice and the
   base G 7, so that the baseline is CF-KAN-1's own point). Algorithm-2
   sensitivities on the QAT loss seed it; every candidate is refit,
   deployed and scored by the validation users' Recall@20 (the first 16
   users as the quick screen). Launch counts zeroed before and read after:
   ``kan_fused`` exactly twice per deployed candidate (full evaluations
   and quick screens) and per sensitivity batch, no other kernel; every
   candidate's forward runs with ``quant.quantize_coeffs`` poisoned. A
   second search with the same seed gives the same candidates, scores,
   costs, frontier and history; every point is in the lattice and
   feasible; each cost equals ``space.assignment_cost`` on the host. The
   baseline and each frontier point are deployed again on ``fused`` (the
   search's score repeated exactly) and on ``lut``: each user's top-20
   hits agree, except for users with a decoder input code that differs
   between the two (capped at ``MAX_FLIP_SHARE`` of the codes) or whose
   20th and 21st ``lut`` scores lie within twice their largest fused-lut
   score distance. ``kan_fused`` is held as in phase 3 once per layer
   config (I, O, G, LD, coeff_bits) the search deployed, on that layer's
   input from the search. Prints the baseline, the frontier, the best
   sub-8 point's savings and whether a sub-8 point dominates the baseline
   at <= 0.5% loss (``bench_pareto``'s criterion, a finding, not a check).
12. recurrentgemma-2b ``CONFIG`` (arXiv:2402.19427; 26 layers, 18
   ``rglru`` and 8 ``local`` with window 2048, MQA 10/1 heads of 256,
   RG-LRU width 2560, d_ff 7680, vocab 256000, logits softcap 30; bf16
   compute, f32 parameters; 2,894,528,000 parameters) from a seeded CUDA
   generator, 4 prompts of 2048 tokens (``batch_at(vocab=256000, batch=4,
   seq_len=2048, seed=0)``, as long as the window, so every decode step
   writes over the ring): phase 8's path, checks and f32 control, and a
   profiler breakdown of one prefill and three decode steps.
13. The continuous-batching engine (``serve.engine.Engine``: paged KV
   pool, chunked prefill, admission queue, an ``EngineRecorder``), each
   run launch-counted, with the launch counts zeroed just before ``run``
   and read just after. (a) ``kan_llm`` ``CONFIG`` (seeded CUDA
   generator) on ``fused``, then ``lut``: 16 slots, pages of 64 (chunks of
   64), max_len 704, 64 requests from ``synth_trace(4096, 64,
   min_prompt=128, max_prompt=512, common_prefix=128, min_new=16,
   max_new=64, stagger=1, seed=0)`` (the prefix comes before prompts of
   128..512, so prompts reach 640 tokens and max_len is 640 + 64 rounded
   up to whole pages). The run is inside ``quantisation_poisoned()``;
   every request completes its budget, some slot serves more than one,
   some page reaches refcount 2 and the prefix cache hits; ``fused``
   launches ``kan_fused`` exactly 8 times per fused tick and per chunk;
   on ``fused`` each request's tokens are its solo run's
   (``decode.prefill`` then ``decode_step``, batch 1, on the card, fed
   the engine's tokens) at every step whose solo top-1 logit leads its
   top-2 by more than ``F32_PATH_BAR`` (phase 8's rule: so up to the
   first near tie, and at each clear step after it), and ``fused``'s equal
   ``lut``'s up to ``lut``'s first lead under it (phase 10a's rule; the
   leads from a teacher-forced ``forward``). ``kan_fused`` is held as
   in phase 3 on layer 0's inputs captured from the run at the tick's 16
   rows and a chunk's 64, up and down. The example twin runs once on its
   own trace. (b) mamba2-1.3b ``CONFIG``, all 48 layers: 8 slots, pages
   of 64 (chunks of 256), max_len 2112, 16 requests from
   ``synth_trace(50280, 16, min_prompt=512, max_prompt=2048, min_new=16,
   max_new=32, stagger=1, seed=0)``; every request completes; ``ssd_scan``
   is launched 48 times per chunk, of which exactly 48 x (sum over
   requests of (chunks - 1)) with ``init_state``; each request's carried
   state after its last chunk, and its tokens at the clear steps, against
   a solo whole-prompt prefill and its decode steps, at twice the reach of
   bf16 rounding (solo bf16 against solo f32: two bf16 paths to one f32
   result); ``check_ssd_scan`` on the first carried-state
   scan's inputs ([1, 256, 64, 64], N 128). Per run it prints ticks,
   tokens/s, TTFT and TPOT p50/p99 (host clock: a non-final chunk does not
   synchronise), mean occupancy, peak pages, prefix-hit pages, the bytes a
   fused tick moves (from the shapes), and from ``torch.profiler`` traces
   on a fresh engine the device's time per tick and its idle share over 6
   ticks (after 10 unprofiled), and its time per fused tick and per chunk
   (one call of each from that window, repeated 5 times).

14. The fleet layer and MoE. (a) The router (``serve.router.Router``)
   over 4 replicas of phase 13a's ``kan_llm`` ``CONFIG`` engine on
   ``fused`` (16 slots, pages of 64, max_len 704), all on the one card,
   sharing one deploy (the single engine's, whose profiler state each
   replica adopts) and each holding its own page pool; 128 requests from
   ``synth_trace(4096, 128, min_prompt=128, max_prompt=512,
   common_prefix=128, min_new=16, max_new=64, stagger=1, seed=0)``. First
   a single engine runs the trace (the tokens every fleet is held to, and
   the one-engine throughput), then three fleet runs, each
   launch-counted (``kan_fused`` exactly 8 times per fused tick and per
   chunk of every replica): plain routing; ``schedule_drain(1, 20)``;
   ``ChipHealth`` canaries on every replica (tiles of 64 x 16, layers 0
   and 1, 2 row tiles) with drift rate 0.05, tau 4 on replica 2 only,
   polled every 2 ticks at threshold 0.05 under the launcher's lenient
   SLOs. Every request completes its budget, every replica is routed to,
   affinity hits, pages all return; the drain requeues and nothing is
   dispatched to replica 1 after it; the health run drains replica 2 and
   never the last live replica; each request's tokens equal the single
   engine's up to the first step whose lead (a teacher-forced forward on
   the single engine's tokens) is within ``F32_PATH_BAR`` (phase 10a's
   rule). Per run: ticks, ``agg_tokens_per_s`` (the reference's modeled
   concurrency: router_s + the slowest replica's busy_s, the replicas
   being stepped one after the other), its scaling efficiency against 4 x
   the single engine's tokens/s, router_s as a share of wall time,
   busy_s per replica, fleet TTFT/TPOT p50/p99 from the merged sketches,
   requeued and drained, and the device's time and idle share over router
   ticks 10-16 of a second fleet set up the same way on the same trace
   (profiler; the measured run stays unprofiled). ``kan_fused`` is held
   as in phase 3 on layer
   0's inputs captured at the tick's 16 rows. (b) The launcher,
   ``launch.serve.main`` in process: ``--arch kan_llm --kan-backend
   cim_tiled --replicas 2 --drift-replica 1 --check --slots 16 --requests
   32 --stagger 1 --metrics-out``: ``--check`` passes (no lost request, a
   health drain, the fleet's tokens those of a healthy single engine),
   the metrics hold the ``chip_*`` and ``chip_layer_*`` gauges
   (``hw.chip.publish_report``) and canary gauges for both replicas;
   ``cim_mac_tiled`` launches in the engine's tick at 16 rows (up and
   down layers), and every input the run gave it (each layer at each row
   count, in the tick and in prefills, on the row attenuation and gains
   it was given) is held bit for bit against the plain version, each
   shape timed once; ``kan_basis`` launches in the tick too (at 16 rows,
   I 1024 and 2816), once for each spied call, and every (layer, rows)
   input it was given is held against ``quant.quantized_basis`` bit for
   bit, twice, each shape timed once (off the per-apply time). (c)
   mixtral-8x7b ``CONFIG`` (d 4096, 32/8 heads, 8 experts top-2, d_ff
   14336, window 4096, bf16 compute, f32 params, capacity factor 1.25)
   from a seeded CUDA generator over the deepest cut of its 32 layers that
   fits: the phase's path at 2 and 3 layers (``CALIB``) gives
   each part's peak memory and its growth per layer, and the cut is the
   most layers whose every part stays under 88% of the card (phase 10b ran at 87.8%). 2 prompts
   of 5120 tokens (``batch_at(vocab=32000, batch=2, seq_len=5120,
   seed=0)``, past the window): ``generate`` 32, both prompts routed
   together, with every MoE call's ``moe_drop_frac`` held to the share of
   slots past capacity that its expert counts give; the prefill and
   decode steps timed (they repeat generate); the ring cache holds
   exactly ``window`` slots, each written. Then each prompt alone, so
   that the served path and not the check sets the cut: forward's bf16
   run records its top-k choices and every other path (forward in f32,
   prefill and decode in bf16 and f32) routes each token to the same
   experts, with the weights from its own probabilities. At capacity
   factor 1.25 the prefill's last logits and drop fractions are held to
   forward over the prompt (the same T: the same capacity, the same slots
   dropped); where nothing is dropped (capacity factor E / top_k),
   prefill and decode are held to forward over prompt and tokens. The f32
   control within ``F32_PATH_BAR``; bf16 within twice the bf16 reach on
   those choices (phase 13b's rule for two bf16 paths), so a lost cast, a
   wrong expert weight or a wrong drop fails. Prints the cut, the peaks,
   prefill s, decode ms a step, the drop fractions, the slots per expert
   and the router inputs' mean cosine at prefill and, from
   ``torch.profiler``, the device's share of the expert products, the
   dispatch and the combine.
15. (a) whisper-base ``CONFIG`` (6 + 6 layers, d 512, 8 heads, vocab
   51865, bf16 compute, f32 params) through the engine, 8 slots: 16
   requests, each with 1500 seeded frames (Whisper's 30-second window)
   and a prompt of 4..64 tokens, 32 new; a request with short or no
   frames is refused (``ValueError``); no kernel launches; each request
   equals its solo ``prefill`` + ``decode_step`` run, teacher-forced, at
   every step whose lead is over twice the bf16 reach of its prefill
   (phase 13b's rule); encode and prefill alone timed, a profiled tick
   window; then 2 prompts of 64 tokens with frames through prefill,
   decode and forward with the f32 control (phase 8's bars). (b)
   internvl2-76b ``CONFIG`` (d 8192, heads 64/8, d_ff 28672, vocab
   128256, 256 vision patches; 69,503,033,344 parameters counted on the
   meta device) over the deepest cut of its 80 layers under 88% of the
   card (its path at 2 and 3 layers gives each part's peak, as 14c): 2
   prompts of 1024 positions, the first 256 seeded vision embeddings,
   prefill, 8 decode steps and forward, held to each other, bf16 against
   the f32 control; the embeddings must move the logits. (c) Training:
   ``kan_llm`` ``CONFIG`` on ``fused`` through ``launch.train.main`` at
   16 x 512, AdamW, ``warmup_cosine(3e-4, 10, steps)``: 60 steps saving
   every 20, then a run that prints ``resumed from step 60`` and goes to
   80; ``kan_fused`` launches equal the calls the code makes (each
   KAN-FFN's two spline layers in the forward and again in the block's
   recompute, 16 a step), the loss falls, ``kan_fused`` at the training
   shapes [8192, 256] -> 85 and [8192, 85] -> 256 is held as in phase 3,
   and one step's gradients on the card match the CPU's plain run
   (``tests/test_torch_train.py``'s ``atol 1e-5, rtol 1e-5`` plus twice
   the reach of f32 rounding, measured on the CPU alone as its f32 run's
   distance from the same run with float64 weights and compute dtype;
   every entry of every leaf). whisper-base: 10 AdamW
   steps at lr 1e-3 on 8 x 1500 frames and 448 tokens; the loss falls.
   mamba2-1.3b, 48 layers, 2 x 2048: every parameter leaf gets a finite,
   nonzero gradient (``ssd_scan`` inside the autograd Function
   ``ops._SsdScan``); layer 0's scan gradients through the Function
   against the plain chunked form's on the card at the JAX suite's bar,
   and against the sequential ``ref.ssd_ref``'s, which shares no code
   with the Function, within ``SSD_SEQ_GRAD_REL`` of each leaf's largest;
   the scan's forward, the Function's backward and the plain form's
   forward + backward timed; 5 AdamW steps through ``launch.train``
   (``ssd_scan`` twice a layer a step). Per model: ms a step, as the
   median of synchronized steps and over a window, the device's busy ms
   a step and its idle share (profiler), peak GB.

16. LM training sharded over a torch ``DeviceMesh`` of ranks that share
   the one card (``torchrun`` processes over gloo: NCCL takes one rank a
   card; gloo stages every collective through host memory). (a)
   ``kan_llm`` on ``fused`` at 16 x 512, AdamW, remat: step 0's
   gradients on 2x2 against 15c.1's single-card ones at its bar (``atol
   1e-5, rtol 1e-5`` plus twice the CPU's f32-vs-f64 reach, every entry);
   ``launch.train --host-mesh --model-parallel 2`` for 4 steps on 2x2
   saving at step 2, and a second launch resuming steps 2-4 on 1x2
   from that checkpoint, every restored leaf bitwise the saved one
   (``--verify-restore``), every step's loss within ``MESH_LOSS_REL`` of
   the same command run without the mesh, ``kan_fused`` 16 launches a
   step on every rank; ``kan_fused`` at a rank's shapes, as in phase 3.
   (b) mamba2-1.3b on 1x2, its first 3 layers (a depth cut for the
   run's time limit; fewer if the two ranks' peak at 2 and 3 layers
   predicts past ``MEM_SHARE`` of the card): step 0's gradients against
   rank 0's single-card run at the same bar, the reach being that run's
   bf16 against its f32 gradients; 3 AdamW steps, ``ssd_scan`` 2 launches
   a layer a step on each rank, and at a rank's shape
   [2, 2048, 32, 64] against its plain versions. (c) mixtral-8x7b's
   first layer on 1x2 (4 experts a rank; one layer, as rank 0 keeps the
   single-card tree and two sets of its gradients beside the mesh's on
   the shared card): the expert-parallel ``forward`` and one step's
   gradients, and the weights-stationary ``apply_moe``, on rank 0's
   pinned top-k choices, within twice the bf16 reach (plus
   ``F32_PATH_BAR`` for the logits). (d) ``psum_int8_error_feedback``
   over 4 ranks at [8, 4096]: codes bitwise the CPU's, the residual what
   the rounding dropped, every rank's mean bitwise the same and within
   0.02 of the exact mean. Per rank: ms a step, the device's busy ms and
   idle share (profiler), peak GB, and the calls and input bytes of each
   collective DTensor issued in a step. The ranks are host-bound, so the
   tasks run in pairs, side by side on the card and its host (their times
   include each other's load): (a)'s gradients and (d) beside (b), then
   (a)'s two launches beside (c).
17. Serving under a ``DeviceMesh`` of ranks sharing the card (gloo), each
   rank one process of ``launch.serve --mesh-model`` under ``torchrun``
   (``--rank-task kan17|mamba17``), launch-counted; (a) and (b) side by
   side, (c) beside them in a process of its own. (a) ``kan_llm`` on
   ``fused`` at full width on 2x2: 13a's engine (16 slots, pages of 64,
   the 128-token common prefix) on the launcher's trace of 12 requests
   (prompts of 256-512 after the prefix, 32-64 new tokens, ``--check``);
   every rank's tokens equal, and equal to the single card's solo runs up
   to the first near tie (13a's rule); ``kan_fused`` 8 launches per decode
   tick and per chunk on every rank, and at a rank's tick [8, 256] / [8,
   85] and chunk [64, 256] / [64, 85] inputs against its plain version, as
   in phase 3. (b) mamba2-1.3b at full width on 1x2, computing in f32:
   2 requests of 384-768 tokens, 4-8 new, 1 slot; tokens as (a), and each
   request's carried state (every layer's) within twice the bf16 reach
   of its solo prefill (13b's rule); ``ssd_scan`` 48 launches per chunk
   on each rank, and at a rank's carried-state chunk against its plain
   versions. Both (a) and (b) compare at least one clear step, and rank 0
   kept an input at every kernel shape it checks. Per rank: tokens/s,
   TTFT and TPOT p50, a profiled window of 4 decode ticks (device busy ms,
   idle share), peak GB, one decode tick's collectives (calls, input
   bytes, ring bytes moved by ``analysis.collective_traffic``). (c) The
   dry run (``launch.dryrun``) in a process of its own: the reference's
   CI cell (mamba2-1.3b SMOKE, decode_32k, 4x2) and ``kan_llm`` decode_32k
   on 16x16 (256 fake ranks), each ``ok``, with rank 0's bytes and
   traffic.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate  # noqa: E402

from repro_torch.analysis import CollectiveBytes  # noqa: E402
from repro_torch.configs import cf_kan_1, cf_kan_2, mamba2_1p3b  # noqa: E402
from repro_torch.configs import kan_llm, kan_llm_int8  # noqa: E402
from repro_torch.configs import mistral_nemo_12b, mixtral_8x7b  # noqa: E402
from repro_torch.configs import recurrentgemma_2b  # noqa: E402
from repro_torch.configs import internvl2_76b, whisper_base  # noqa: E402
from repro_torch.core import kan, kan_sam, quant, splines  # noqa: E402
from repro_torch.data import cf_synth, lm_synth  # noqa: E402
from repro_torch.dist import compress  # noqa: E402
from repro_torch.dist import sharding as shlib  # noqa: E402
from repro_torch.examples import kan_neurosim_search  # noqa: E402
from repro_torch.examples import serve_kan_llm, train_cf_kan  # noqa: E402
from repro_torch.hw import chip, cim, health, tiles, variation  # noqa: E402
from repro_torch.hw.health import ChipHealth  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import cim_mac as cim_kernels  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_kernels  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import serve as serve_launch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import cf_kan, layers  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import rglru as rglru_lib  # noqa: E402
from repro_torch.models import ssd as ssd_lib  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.obs import EngineRecorder  # noqa: E402
from repro_torch.serve import decode  # noqa: E402
from repro_torch.serve.engine import Engine, synth_trace  # noqa: E402
from repro_torch.serve.router import Router  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402
from repro_torch.optim import make_optimizer, warmup_cosine  # noqa: E402
from repro_torch.optim.optimizers import clip_by_global_norm  # noqa: E402
from repro_torch.train.train_step import (TrainConfig,  # noqa: E402
                                          make_train_step, value_and_grad)
from repro_torch.tune import space  # noqa: E402

PEAK_F32 = 67e12          # FLOP/s, H100 SXM, outside the tensor cores
PEAK_BF16 = 989e12        # FLOP/s, H100 SXM, bf16 tensor cores, dense
PEAK_TF32 = 495e12        # FLOP/s, H100 SXM, tf32 tensor cores, dense
PEAK_BYTES = 3.35e12      # B/s, H100 SXM HBM3
BATCH, N_USERS = 256, 1024
ARRAY_SIZES = (128, 256, 512, 1024)
SERVE_AS = 256
GAMMA0 = 0.08
TILE_COLS, SIGMA = 64, 0.05   # cim_tiled: columns per tile, cell variation
ORDER_REL = 1e-6          # summation-order bound, relative to sum |terms|
CIM_ATOL, CIM_RTOL = 2e-3, 1e-4
CIM_MAX_STEP_SHARE = 1e-3
METRIC_TOL = 2e-3         # fused vs lut Recall@20 / NDCG@20 (2 of 1024 users)
SOURCES = {
    "kan_fused": ("src/repro_torch/kernels/csrc/kan_fused.cu",
                  "src/repro/kernels/kan_fused.py:99"),
    "cim_mac": ("src/repro_torch/kernels/csrc/cim_mac.cu",
                "src/repro/kernels/cim_mac.py:148"),
    "cim_mac_tiled": ("src/repro_torch/kernels/csrc/cim_mac_tiled.cu",
                      "src/repro/kernels/cim_mac.py:111"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:77"),
    "kan_basis": ("src/repro_torch/kernels/csrc/kan_basis.cu",
                  "none (the JAX package computes the basis in jnp)"),
}
# the LM main path: mamba2-1.3b at full width
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
MAMBA2_PARAMS = 1_343_532_032
SSD_ATOL, SSD_RTOL = 3e-5, 1e-4   # the JAX suite's ssd bar
# the chunked form's VJP against the sequential scan's at mamba2-1.3b's
# layer shape (T 2048, chunk 256), per leaf over its largest entry: the
# chunked form rounds each chunk's cumulative log-decay (up to 256 terms)
# in f32, and the decays are exps of its differences; the sequential f32
# scan is within 1e-6 of an f64 one there
SSD_SEQ_GRAD_REL = 1e-4
LM_SMALL_BAR = 2e-4               # the JAX serving suite's bar (f32)
# f32 compute: prefill/decode (the step recurrence) against forward (the
# chunked scan) differ by f32 sums in another order, compounded over 48
# layers and T up to 2079 (the JAX serving suite's 2e-4 was set at 3
# layers and 24 tokens)
F32_PATH_BAR = 1e-3
# Fig. 18 phase: the JAX package's kernel-path means (uniform, KAN-SAM) on
# its own random weights and draws, printed for orientation only
FIG18_GAMMA0, FIG18_SEEDS = 0.2, (0, 1, 2)
FIG18_JAX = {128: (0.1330, 0.0759), 256: (0.2382, 0.1144),
             512: (0.4176, 0.1950), 1024: (0.6455, 0.2993)}
# phase 9: QAT training of CF-KAN-1 at full width with the JAX example's lr
# and batch (``train_cf_kan.BATCH``); 100 steps are 8 passes over the 819
# training users and 4 batches of a ninth
TRAIN_STEPS, TRAIN_LR = 100, 2e-2
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5   # the JAX suite's gradient bar
TRAIN_LOSS_REL = 0.05     # first loss against n_observed * ln(n_items)
PROFILE_STEPS = 5
# phase 10: the KAN-FFN LLM at full width on three backends, and
# mistral-nemo-12b at full width and depth
KAN_LLM_BATCH, KAN_LLM_PROMPT, KAN_LLM_NEW = 16, 512, 32
KAN_LLM_PARAMS = 3_926_272
KAN_BACKENDS = ("lut", "lut_int8", "fused")
MISTRAL_LAYERS = 40
MISTRAL_PARAMS = 11_576_693_760
BF16_REL = 2 ** -6        # a differing KAN input code: the port's test rule
MAX_FLIP_SHARE = 1e-3     # independent differing KAN input codes (f32)
# phase 11: the co-design tuner on phase 9's trained CF-KAN-1; the grids of
# the reference's lattice and the base G 7, so that the baseline is CF-KAN-1
# itself and not a refit onto a lattice grid
TUNE_BUDGET, TUNE_SEED = 24, 0
TUNE_GRIDS = (2, 4, 7, 8, 16, 32, 64)
ACC_LOSS_BUDGET = 0.005   # bench_pareto's dominance criterion
# phase 12: recurrentgemma-2b at full width and depth
RGEMMA_PARAMS = 2_894_528_000
# phase 13: the continuous-batching engine at full width. kan_llm: 16
# slots, pages of 64; synth_trace puts the 128-token common prefix before
# prompts of 128..512, so prompts reach 640 tokens and a request 640 + 64 -
# 1 = 703 cached tokens: max_len 704 (11 pages). mamba2-1.3b: 8 slots,
# pages of 64, chunks of lcm(64, 256) = 256.
ENGINE_KAN = dict(n_slots=16, page_size=64, max_len=704)
ENGINE_KAN_TRACE = dict(n_requests=64, min_prompt=128, max_prompt=512,
                        common_prefix=128, min_new=16, max_new=64, stagger=1,
                        seed=0)
ENGINE_MAMBA = dict(n_slots=8, page_size=64, max_len=2112)
ENGINE_MAMBA_TRACE = dict(n_requests=16, min_prompt=512, max_prompt=2048,
                          min_new=16, max_new=32, stagger=1, seed=0)
# phase 14: (a) the router, 4 replicas of phase 13a's engine on the one card
# sharing one deploy; a drain of replica 1 at tick 20; drift (replica, rate,
# tau) on one replica, polled every 2 ticks at threshold 0.05; a profiler
# window of 6 router ticks from tick 10. (b) the launcher's fleet path on
# cim_tiled at 16 slots. (c) mixtral-8x7b: 2 prompts of 5120 (past its
# window of 4096), at most this share of the card's memory (phase 10b's
# mistral peaked at 87.8% of it)
ROUTER_REPLICAS = 4
ROUTER_ENGINE = dict(n_slots=16, page_size=64, max_len=704)
ROUTER_TRACE = dict(n_requests=128, min_prompt=128, max_prompt=512,
                    common_prefix=128, min_new=16, max_new=64, stagger=1,
                    seed=0)
ROUTER_DRAIN = (1, 20)
ROUTER_DRIFT = (2, 0.05, 4.0)
ROUTER_HEALTH = dict(poll_every=2, drift_threshold=0.05)
ROUTER_PROFILE = (10, 6)
LAUNCH_FLEET_SLOTS = 16
MIXTRAL_BATCH, MIXTRAL_PROMPT = 2, 5120
# a model cut to the card (14c, 15b): at most this share of the card's
# memory, and the depths whose peaks give the cut's linear fit (a single
# layer's stage is not stacked, so its peaks sit off the line the deeper
# stages lie on)
MEM_SHARE = 0.88
CALIB = (2, 3)
# phase 15: (a) whisper-base served: 16 requests, each with 1500 frames
# (Whisper's 30-second window) and a prompt of 4..64 tokens, 32 new tokens,
# through the engine at 8 slots (max_len 64 + 32 - 1 -> 96); the static f32
# control on 2 prompts of 64 tokens, 16 new. (b) internvl2-76b over the
# deepest cut of its 80 layers under 88% of the card (calibrated at 2 and
# 3 layers as phase 14c): 2 prompts of 1024 positions, the first 256 the
# vision embeddings, 8 new tokens. (c) training: kan_llm on fused through
# launch.train (60 steps saving every 20, resumed to 80) at 16 x 512;
# whisper-base 10 AdamW steps at lr 1e-3 on 8 x 1500 frames and 448
# tokens (Whisper's decoder length); mamba2-1.3b at 2 x 2048, 5 AdamW
# steps; per model the synchronized steps, a window and profiled steps
WHISPER_REQUESTS, WHISPER_FRAMES = 16, 1500
WHISPER_PROMPTS, WHISPER_NEW = (4, 64), 32
WHISPER_ENGINE = dict(n_slots=8, max_len=96)
WHISPER_STATIC = (2, 64, 16)
INTERNVL2_PARAMS = 69_503_033_344
VLM_BATCH, VLM_PROMPT, VLM_NEW = 2, 1024, 8
KAN_TRAIN = dict(batch=16, seq=512, steps=(60, 80), save_every=20)
WHISPER_TRAIN = dict(batch=8, frames=1500, seq=448, steps=10, lr=1e-3)
MAMBA_TRAIN = dict(batch=2, seq=2048, steps=5)
TRAIN_TIMING = (5, 5, 3)    # synchronized steps, window steps, profiled
MAMBA_TIMING = (2, 1)       # window and profiled steps (its 5 are synced)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


class Timer:
    """Median per-call time from CUDA events, each call preceded by a write
    of 128 MB so that no input is left in the 50 MB L2 cache. The start
    event runs when the flush ends, so the part of a call's host time that
    outlasts the flush on the card is counted too. With ``spin=True`` the
    card first spins for about 1 ms after the flush, so that the host has
    queued the call's launches before the start event runs: the events then
    hold the device's work alone. ``host_ms`` is the median host time, from
    entry to return (launches queued), of the last ``ms`` call's calls."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, dev):
        self.flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
        self.host_ms = float("nan")

    def ms(self, fn, reps: int, warmup: int = 2, spin: bool = False
           ) -> float:
        for _ in range(warmup):
            fn()
        times, host = [], []
        for _ in range(reps):
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            host.append(1e3 * (time.perf_counter() - t0))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        self.host_ms = float(np.median(host))
        return float(np.median(times))


def bound(n_ops: float, n_bytes: float, peak: float = PEAK_F32):
    t_ops, t_bytes = n_ops / peak, n_bytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# --- phase 3: kernels against their plain versions --------------------------

def check_kan_fused(timer, label, x, layer, asp):
    """x: bounded layer input [B, I]; layer: a DeployedLayer."""
    codes, scale, hemi = layer.codes, layer.scale.reshape(-1), layer.hemi
    got = ops.kan_spline_fused_deployed(x, codes, scale, asp, hemi=hemi)
    want = ref.kan_spline_ref(x, codes, scale, asp, hemi)
    e = quant.quantized_basis(x, hemi, asp).reshape(x.shape[0], -1)
    c = codes.to(torch.float32).reshape(e.shape[1], -1)
    mass = (e.abs() @ c.abs()) * scale.abs()          # sum |terms| per output
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"kan_fused {label}: not finite")
    # the plain formula in float64 (the exact sum): the kernel is held to it
    # at the summation-order bar, and to the plain f32 version at the same
    # bar plus that version's own distance from the exact sum (its f32
    # sums are not charged to the kernel, as in the kernel's cuda tests)
    exact = (e.double() @ c.double()) * scale.double()
    plain_off = (want.double() - exact).abs()
    worst_exact = float(((got.double() - exact).abs()
                         / mass.clamp_min(1e-30)).max())
    check(bool(((got.double() - exact).abs() <= ORDER_REL * mass).all()),
          f"kan_fused {label}: |kernel - exact| / sum|terms| = "
          f"{worst_exact:.3g} > {ORDER_REL}")
    worst = float((err / mass.clamp_min(1e-30)).max())
    check(bool((err <= ORDER_REL * mass + plain_off).all()),
          f"kan_fused {label}: |kernel - plain| over sum|terms| "
          f"{worst:.3g}, past {ORDER_REL} * sum|terms| + |plain - exact|")
    again = ops.kan_spline_fused_deployed(x, codes, scale, asp, hemi=hemi)
    check(torch.equal(got, again), f"kan_fused {label}: two launches on the "
          "same inputs differ")
    b, i = x.shape
    o = codes.shape[-1]
    # both against the exact sum, in units of the kernel tests' bar
    jax_bar = 2e-5 + 1e-5 * exact.abs()
    over_bar = {name: float(((y.double() - exact).abs() / jax_bar).max())
                for name, y in (("kernel", got), ("plain", want))}
    plain_worst = float((plain_off / mass.clamp_min(1e-30)).max())
    del exact, jax_bar, plain_off
    c_deq = quant.dequantize_coeffs(codes, layer.scale).reshape(e.shape[1], o)
    row = dict(shape=label, B=b, I=i, O=o, max_abs_err=float(err.max()),
               max_err_over_sum_abs_terms=worst,
               kernel_vs_exact_over_sum_abs_terms=worst_exact,
               plain_vs_exact_over_sum_abs_terms=plain_worst,
               kernel_vs_exact_over_bar=over_bar["kernel"],
               plain_vs_exact_over_bar=over_bar["plain"],
               ms=timer.ms(lambda: ops.kan_spline_fused_deployed(
                   x, codes, scale, asp, hemi=hemi), reps=20))
    row["host_ms"] = timer.host_ms
    row["device_ms"] = timer.ms(lambda: ops.kan_spline_fused_deployed(
        x, codes, scale, asp, hemi=hemi), reps=20, spin=True)
    row["plain_ms"] = timer.ms(lambda: ref.kan_spline_ref(
        x, codes, scale, asp, hemi), reps=5)
    row["library_ms"] = timer.ms(lambda: torch.matmul(e, c_deq), reps=20)
    row["library_host_ms"] = timer.host_ms
    row["library_device_ms"] = timer.ms(lambda: torch.matmul(e, c_deq),
                                        reps=20, spin=True)
    nnz = float((e != 0).sum())
    n_bytes = (x.numel() * 4 + codes.numel() + scale.numel() * 4
               + hemi.numel() * 4 + b * o * 4)
    # the exact result on the tensor cores: 3 split products per nonzero
    # basis entry and output; on the CUDA cores: one f32 FMA; the epilogue
    row["bound_ms"], row["bound_by"] = bound(3 * 2.0 * nnz * o + b * o,
                                             n_bytes, PEAK_BF16)
    row["bound_f32_ms"] = bound(2.0 * nnz * o + b * o, n_bytes)[0]
    return row


def kan_basis_held(label, x, hemi, asp):
    """x: bounded layer input [B, I]; the dense basis of the crossbar
    backends must equal ``quant.quantized_basis`` bit for bit, twice.
    Returns the kernel's basis."""
    got = ops.kan_basis(x, hemi, asp)
    want = quant.quantized_basis(x, hemi, asp)
    check(torch.equal(got, want), f"kan_basis {label}: "
          f"{int((got != want).sum())} entries differ from the plain version")
    check(torch.equal(ops.kan_basis(x, hemi, asp), got),
          f"kan_basis {label}: two launches on the same inputs differ")
    return got


def check_kan_basis(timer, label, x, hemi, asp, on_path):
    """``kan_basis_held``, then the kernel's row. The row counts toward the
    kernel's per-apply time if ``on_path``."""
    got = kan_basis_held(label, x, hemi, asp)
    b, i = x.shape
    row = dict(shape=label, B=b, I=i, S=asp.n_basis, max_abs_err=0.0,
               ms=timer.ms(lambda: ops.kan_basis(x, hemi, asp), reps=20))
    row["host_ms"] = timer.host_ms
    row["device_ms"] = timer.ms(lambda: ops.kan_basis(x, hemi, asp),
                                reps=20, spin=True)
    row["plain_ms"] = timer.ms(lambda: quant.quantized_basis(x, hemi, asp),
                               reps=5)
    row["library_ms"] = None
    row["on_path"] = on_path
    # x and the table read once, the dense basis written once; a compare
    # and a select an entry
    n_bytes = 4.0 * (x.numel() + hemi.numel() + got.numel())
    row["bound_ms"], row["bound_by"] = bound(2.0 * got.numel(), n_bytes)
    return row


def check_cim_mac(timer, label, v, w, array_size, on_path=None):
    """v: WL values [B, R]; w: codes [R, C]; uniform row attenuation. A
    second launch must give the same output. The row counts toward the
    kernel's per-apply time if ``on_path`` (by default: at the main path's
    As)."""
    ccfg = cim.CIMConfig(array_size=array_size, gamma0=GAMMA0)
    att = cim.row_attenuation(w.shape[0], ccfg, v.device)
    kw = dict(array_size=array_size, adc_bits=ccfg.adc_bits,
              in_scale=ccfg.adc_in_scale)
    got = ops.cim_mac(v, w, att, **kw)
    want = ref.cim_mac_ref(v, w, att, array_size, ccfg.adc_bits,
                           ccfg.adc_in_scale)
    check(bool(torch.isfinite(got).all()), f"cim_mac {label}: not finite")
    lsb = array_size * ccfg.adc_in_scale / (2 ** ccfg.adc_bits - 1)
    n_arrays = -(-v.shape[1] // array_size)
    # sum over arrays and slices of |2^k * readout|, bounded from above
    mass = ((v * att).abs() @ w.to(torch.float32).abs()
            + n_arrays * (2 ** ccfg.adc_bits - 1) * lsb / 2)
    err = (got - want).abs()
    tol = CIM_ATOL + CIM_RTOL * want.abs() + ORDER_REL * mass
    off = err > tol
    steps = torch.round(err / lsb)
    resid = (err - steps * lsb).abs()
    bad = off & ((steps < 1) | (resid > tol))
    if bool(bad.any()):
        j = int(torch.argmax(torch.where(bad, resid - tol, -torch.inf)))
        raise AssertionError(
            f"cim_mac {label}: {int(bad.sum())} differences are not whole "
            f"ADC steps; worst: plain {float(want.flatten()[j]):.6g}, "
            f"kernel {float(got.flatten()[j]):.6g}, tolerance "
            f"{float(tol.flatten()[j]):.3g}, lsb {lsb:.4g}")
    share = float(off.float().mean())
    check(share < CIM_MAX_STEP_SHARE,
          f"cim_mac {label}: {share:.3%} of outputs off by ADC steps")
    # a second launch, which counts the (b, r) pairs it iterated
    counter = torch.zeros(1, dtype=torch.int64, device=v.device)
    again = cim_kernels.cim_mac(v, w, att, array_size=array_size, lsb=lsb,
                                rows_iterated=counter)
    check(torch.equal(got, again),
          f"cim_mac {label}: two launches on the same inputs differ")
    b, r = v.shape
    c = w.shape[1]
    mag = w.to(torch.int32).abs()
    popcount = sum(((mag >> k) & 1) for k in range(8)).sum(dim=1)  # [R]
    live = ((v * att) != 0).sum(dim=0)                              # [R]
    adds = float((live.to(torch.float64) * popcount.to(torch.float64)).sum())
    # one add per set bit and live row; the ADC's divide, round, multiply and
    # weighted add per (b, array, c, bit); v * atten once per (b, r)
    flops = adds + 4.0 * 8 * b * n_arrays * c + b * r
    n_bytes = v.numel() * 4 + w.numel() + att.numel() * 4 + b * c * 4
    row = dict(shape=label, B=b, R=r, C=c, array_size=array_size,
               max_abs_err=float(err.max()), adc_step_share=share,
               ms=timer.ms(lambda: ops.cim_mac(v, w, att, **kw), reps=10),
               plain_ms=timer.ms(lambda: ref.cim_mac_ref(
                   v, w, att, array_size, ccfg.adc_bits, ccfg.adc_in_scale),
                   reps=3, warmup=1),
               library_ms=None,
               on_path=array_size == SERVE_AS if on_path is None else on_path,
               rows_iterated=int(counter) / (b * r))
    row["bound_ms"], row["bound_by"] = bound(flops, n_bytes)
    return row


def chip_cfg(array_size, gamma0=GAMMA0, seed=0):
    return chip.ChipConfig(
        tile=tiles.TileConfig(array_size=array_size, tile_cols=TILE_COLS,
                              gamma0=gamma0),
        variation=variation.VariationConfig(sigma=SIGMA, seed=seed))


def check_cim_mac_tiled(timer, label, wl, codes, layer_uid, array_size,
                        crit=None, on_path=None):
    """wl: WL values [B, R] in logical order; codes: the layer's [I, S, O]
    int8 codes, placed (uniform mapping, or KAN-SAM from ``crit``) as the
    cim_tiled deploy places them, so the kernel sees the main path's
    physical-order inputs. A second launch must give the same codes. The
    row counts toward the kernel's per-apply time if ``on_path`` (by
    default: at the main path's As)."""
    ccfg = chip_cfg(array_size)
    tiled = chip.place_layer(codes, crit, ccfg, layer_uid=layer_uid)
    v = torch.where(tiled.valid, wl[:, tiled.logical_of_phys.long()], 0.0)
    return cim_tiled_row(timer, label, v, tiled.w_phys, tiled.gain,
                         ccfg.tile, array_size == SERVE_AS if on_path is None
                         else on_path)


def cim_tiled_held(label, v, w, g, att, tile):
    """``cim_mac_tiled`` on physical-order WL values ``v`` [B, R], codes
    ``w``, gains ``g`` (or None) and row attenuation ``att`` of ``tile``'s
    geometry, against its plain version bit for bit. Returns both."""
    got = ops.cim_mac_tiled(v, w, att, gain=g, array_size=tile.array_size,
                            adc_bits=tile.adc_bits,
                            in_scale=tile.adc_in_scale)
    want = ref.cim_mac_tiled_ref(v, w, g, att, tile.array_size,
                                 tile.adc_bits, tile.adc_in_scale)
    n_off = int((got != want).sum())
    check(n_off == 0, f"cim_mac_tiled {label}: {n_off} codes differ from "
          "the plain version")
    return got, want


def cim_tiled_row(timer, label, v, w, g, tile, on_path, att=None):
    """``cim_tiled_held`` (``att`` by default the tile's slot attenuation),
    then a second launch that must give the same codes; with its time and
    bound."""
    array_size = tile.array_size
    if att is None:
        att = tiles.slot_attenuation(v.shape[1], tile, v.device)
    kw = dict(array_size=array_size, adc_bits=tile.adc_bits,
              in_scale=tile.adc_in_scale)
    got, want = cim_tiled_held(label, v, w, g, att, tile)
    # a second launch, which counts the (b, r) pairs it iterated
    counter = torch.zeros(1, dtype=torch.int64, device=v.device)
    lsb = array_size * tile.adc_in_scale / (2 ** tile.adc_bits - 1)
    again = cim_kernels.cim_mac_tiled(v, w, g, att, array_size=array_size,
                                      lsb=lsb, rows_iterated=counter)
    check(torch.equal(got, again),
          f"cim_mac_tiled {label}: two launches on the same inputs differ")
    b, r = v.shape
    c = w.shape[1]
    mag = w.to(torch.int32).abs()
    popcount = sum(((mag >> k) & 1) for k in range(8)).sum(dim=1)   # [R]
    nonzero = ((w != 0).sum(dim=1) if g is not None
               else torch.zeros_like(popcount))                     # [R]
    live = ((v * att) != 0).sum(dim=0)                              # [R]
    # per live (b, r): one add per set code bit and one gain multiply per
    # nonzero cell; the ADC's divide, round, shift and add per (b, tile, c,
    # bit); v * atten once per (b, r)
    per_row = (popcount + nonzero).to(torch.float64)
    flops = (float((live.to(torch.float64) * per_row).sum())
             + 4.0 * 8 * b * (r // array_size) * c + b * r)
    n_bytes = (v.numel() * 4 + w.numel() + att.numel() * 4 + b * c * 4
               + (g.numel() * 4 if g is not None else 0))
    row = dict(shape=label, B=b, R=r, C=c, array_size=array_size,
               max_abs_err=float((got - want).abs().max()), codes_differing=0,
               ms=timer.ms(lambda: ops.cim_mac_tiled(v, w, att, gain=g, **kw),
                           reps=10),
               plain_ms=timer.ms(lambda: ref.cim_mac_tiled_ref(
                   v, w, g, att, array_size, tile.adc_bits,
                   tile.adc_in_scale), reps=3, warmup=1),
               library_ms=None,
               on_path=on_path, rows_iterated=int(counter) / (b * r))
    row["bound_ms"], row["bound_by"] = bound(flops, n_bytes)
    return row


def kan_basis_rows(timer, xe, xd, enc, dec):
    """``check_kan_basis`` at the crossbar cells' shapes: CF-KAN-1's encoder
    and decoder inputs (G 7, the main path's), then CF-KAN-2's (G 15): its
    encoder reads the same bounded items (both configs bound into [-1, 1]),
    its decoder a seeded bounded input."""
    asp_e, asp_d = cf_kan_1.MODEL.asp_enc, cf_kan_1.MODEL.asp_dec
    rows = [check_kan_basis(timer, "cf-kan-1 enc", xe, enc.hemi, asp_e, True),
            check_kan_basis(timer, "cf-kan-1 dec", xd, dec.hemi, asp_d, True)]
    cfg2 = cf_kan_2.MODEL
    gen = torch.Generator(device=xe.device).manual_seed(0)
    h2 = kan.bound_input(torch.randn((xe.shape[0], cfg2.hidden),
                                     generator=gen, device=xe.device),
                         cfg2.asp_dec)
    for label, x, asp in (("cf-kan-2 enc", xe, cfg2.asp_enc),
                          ("cf-kan-2 dec", h2, cfg2.asp_dec)):
        rows.append(check_kan_basis(timer, label, x,
                                    quant.hemi_for(asp, x.device), asp,
                                    False))
    return rows


# --- phase 4: the main path -------------------------------------------------

def enc_only(deployed):
    """The encoder layer of a CF-KAN artifact as a one-layer artifact."""
    spec = dataclasses.replace(deployed.spec, dims=deployed.spec.dims[:2],
                               asp=deployed.spec.asp[:1],
                               layer_names=("enc",))
    return kan.DeployedKAN(deployed.layers[:1], spec)


def serve(deployed, x_all):
    """Serve every user in batches through kan.apply; returns the scores and
    the host time of each batch (ending in a synchronize), in ms."""
    scores, times = [], []
    for s in range(0, x_all.shape[0], BATCH):
        t0 = time.perf_counter()
        y = kan.apply(deployed, x_all[s:s + BATCH])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        check(y.shape == (min(BATCH, x_all.shape[0] - s), x_all.shape[1]),
              f"scores have shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), "scores are not finite")
        scores.append(y)
    return torch.cat(scores), times


def rel_err(a, b):
    return float((a - b).abs().mean() / b.abs().mean())


# --- phase 5: a small-input reference ---------------------------------------

def small_reference(dev):
    """A narrow CF-KAN (128 items, hidden 16) deployed once on the CPU and
    copied to the card; each layer is fed one bounded input on both, so the
    card's kernels meet the CPU's plain versions on identical inputs."""
    cfg = dataclasses.replace(cf_kan_1.SMOKE_MODEL, n_items=128, hidden=16,
                              backend="fused")
    ds = cf_synth.generate(n_users=192, n_items=128, seed=1)
    params = cf_kan.init(1, cfg, device="cpu")
    stats = cf_kan.collect_layer_stats(
        params, [torch.from_numpy(ds.observed[:64]),
                 torch.from_numpy(ds.observed[64:128])], cfg)
    ccfg = cim.CIMConfig(array_size=64, gamma0=GAMMA0)
    tcfg = chip.ChipConfig(
        tile=tiles.TileConfig(array_size=64, tile_cols=16, gamma0=GAMMA0),
        variation=variation.VariationConfig(sigma=SIGMA, seed=0))
    spec = cfg.kan_spec
    variants = {
        "fused": (lambda: cf_kan.deploy(params, cfg), (2e-5, 1e-5)),
        "cim": (lambda: cf_kan.deploy(params, cfg, cim_cfg=ccfg),
                (CIM_ATOL, CIM_RTOL)),
        "cim_sam": (lambda: cf_kan.deploy(params, cfg, cim_cfg=ccfg,
                                          use_sam=True, stats=stats),
                    (CIM_ATOL, CIM_RTOL)),
        "cim_tiled": (lambda: kan.deploy(params, spec.with_backend(
            "cim_tiled", cim=tcfg)), (2e-5, 1e-5)),
        "cim_tiled_sam": (lambda: kan.deploy(params, spec.with_backend(
            "cim_tiled", cim=tcfg, use_sam=True), stats=stats),
            (2e-5, 1e-5))}
    worst = {}
    for name, (make, (atol, rtol)) in variants.items():
        dep = make()
        x = torch.from_numpy(ds.observed[128:])
        worst[name] = 0.0
        for i, layer in enumerate(dep.layers):
            lspec = dep.spec.layer(i)
            spec1 = dataclasses.replace(
                dep.spec, dims=(lspec.in_dim, lspec.out_dim),
                asp=(lspec.asp,), layer_names=(), bound_input=False)
            on_card = dataclasses.replace(layer, **{
                f.name: getattr(layer, f.name).to(dev)
                for f in dataclasses.fields(layer)
                if getattr(layer, f.name) is not None})
            xb = kan.bound_input(x, lspec.asp)
            want = kan.apply(kan.DeployedKAN((layer,), spec1), xb)
            got = kan.apply(kan.DeployedKAN((on_card,), spec1),
                            xb.to(dev)).cpu()
            err = (got - want).abs()
            check(bool((err <= atol + rtol * want.abs()).all()),
                  f"small reference {name} layer {i}: card and CPU differ "
                  f"by {float(err.max()):.3g}")
            worst[name] = max(worst[name], float(err.max()))
            x = want
    return worst


# --- phase 6: Fig. 18 on the kernel path ------------------------------------

def fig18(dev):
    """Relative error of the chip against ``lut`` over As and chip seeds,
    uniform and KAN-SAM (the JAX package's bench_chip setting, rebuilt from
    the port's own generator)."""
    spec = kan.KANSpec.single(64, 64, quant.ASPConfig(grid_size=8),
                              base_activation="")
    gen = torch.Generator().manual_seed(0)
    params = kan.init(gen, spec, device=dev)
    x = torch.clamp(torch.randn((128, 64), generator=gen) * 0.35, -0.999,
                    0.999).to(dev)
    xs = torch.clamp(torch.randn((512, 64), generator=gen) * 0.35, -0.999,
                     0.999).to(dev)
    asp = spec.asp[0]
    stats = kan_sam.update_stats(kan_sam.init_stats(64, asp, dev),
                                 kan.bound_input(xs, asp), asp)
    y_ideal = kan.apply(kan.deploy(params, spec.with_backend("lut")), x)
    denom = float(torch.linalg.norm(y_ideal))

    def make_eval(a, sam, generator=None):
        def eval_seed(seed):
            dep = kan.deploy(params, spec.with_backend(
                "cim_tiled", cim=chip_cfg(a, FIG18_GAMMA0, seed),
                use_sam=sam), stats=stats if sam else None)
            y = kan.apply(dep, x, generator=generator)
            check(bool(torch.isfinite(y).all()), "Fig. 18: not finite")
            return float(torch.linalg.norm(y - y_ideal)) / denom
        return eval_seed

    rows = {sam: {r["As"]: r for r in variation.sweep_array_size(
        lambda a, sam=sam: make_eval(a, sam), ARRAY_SIZES, FIG18_SEEDS)}
        for sam in (False, True)}
    uni = [rows[False][a]["mean"] for a in ARRAY_SIZES]
    top = ARRAY_SIZES[-1]
    noisy = make_eval(top, False, torch.Generator(device=dev).manual_seed(
        10_000))(0)
    for a in ARRAY_SIZES:
        print(f"Fig. 18 As={a}: uniform {rows[False][a]['mean']:.4f} "
              f"(ci95 {rows[False][a]['ci95']:.4f}), KAN-SAM "
              f"{rows[True][a]['mean']:.4f} (ci95 {rows[True][a]['ci95']:.4f})"
              f"; JAX package {FIG18_JAX[a][0]:.4f} / {FIG18_JAX[a][1]:.4f}")
    print(f"Fig. 18 As={top} uniform seed 0 with readout noise: "
          f"{noisy:.4f} (without: {rows[False][top]['values'][0]:.4f})")
    check(all(lo < hi for lo, hi in zip(uni, uni[1:])),
          f"Fig. 18: uniform error does not grow with As: {uni}")
    check(rows[True][top]["mean"] < rows[False][top]["mean"],
          f"Fig. 18: KAN-SAM does not recover at As={top}")
    check(np.isfinite(noisy), "Fig. 18: noisy readout not finite")
    return rows


class KanCodes:
    """While active, the input codes of every KAN layer call (the wrapped
    ``kan.bound_input``), on the CPU, in call order."""

    def __enter__(self):
        self.calls, self._bound = [], kan.bound_input

        def hook(x, asp):
            xb = self._bound(x, asp)
            self.calls.append(quant.quantize_input(xb, asp).cpu())
            return xb
        kan.bound_input = hook
        return self

    def __exit__(self, *exc):
        kan.bound_input = self._bound


def code_flips(a, b, offsets):
    """Per KAN layer call, the (batch row, position) pairs at which the two
    runs' input codes differ. ``a``, ``b``: KanCodes calls [B, s, I] in the
    same order; ``offsets[c]``: call c's first position."""
    assert len(a) == len(b), (len(a), len(b))
    return [{(r, off + p) for r, p in torch.nonzero(ca != cb)[:, :2].tolist()}
            for ca, cb, off in zip(a, b, offsets)]


def first_flips(flips, n_rows):
    """Per batch row, the first position whose codes differed (or None)."""
    first = [None] * n_rows
    for f in flips:
        for r, p in f:
            first[r] = p if first[r] is None else min(first[r], p)
    return first


def root_flips(flips, n_rows):
    """How many differing (row, position) pairs of ``flips`` (in call
    order) are independent events: a code that differs downstream of an
    earlier one (the same row, a position at or after it) follows from it
    and is not counted."""
    first, roots = [None] * n_rows, 0
    for f in flips:
        roots += sum(1 for r, p in f if first[r] is None or p < first[r])
        first = first_flips([f, {(r, q) for r, q in enumerate(first)
                                 if q is not None}], n_rows)
    return roots


def small_lm_reference(dev, cfg, backend=None):
    """An LM ``SMOKE`` config from one set of weights on the CPU (plain
    versions) and on the card (the kernels), deployed with ``backend`` if
    given: forward, prefill, decode and generate. Logits within
    ``LM_SMALL_BAR``, tokens identical, except downstream of a KAN input
    code that differs between the devices (the port's test rule: logits
    within ``BF16_REL`` of their largest magnitude, tokens up to the first
    step whose top-1 leads its top-2 by no more than twice that). At f32
    the differing codes that do not follow from an earlier one must stay
    within ``MAX_FLIP_SHARE`` of the codes compared, so that a wrong kernel,
    whose error moves the next layer's codes everywhere, cannot widen its
    own bar. Returns the worst logit difference and the independent
    differing codes."""
    if backend is not None:
        cfg = dataclasses.replace(cfg, kan_backend=backend)
    p_cpu = tfm.deploy_kan(tfm.init_model(0, cfg, device="cpu"), cfg)
    p_dev = tfm.tree_map(lambda t: t.to(dev), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))          # T = 40: chunk 16 is ragged
    worst, roots, n_codes = 0.0, 0, 0
    label = cfg.name + ("" if backend is None else f" on {backend}")

    def run(fn, *args):
        with KanCodes() as codes:
            out = fn(*args)
        return out, codes.calls

    def count(flips, calls):
        nonlocal roots, n_codes
        roots += root_flips(flips, 2)
        n_codes += sum(c.numel() for c in calls)

    def hold(got, want, what, positions, first):
        nonlocal worst
        err = (got.cpu().float() - want.float()).abs().amax(-1)   # [B, s]
        loose = torch.tensor([[f is not None and q >= f for q in positions]
                              for f in first])
        bar = torch.where(loose, BF16_REL * float(want.abs().max()),
                          LM_SMALL_BAR)
        worst = max(worst, float(err.max()))
        check(bool((err <= bar).all()), f"small LM reference {label} {what}: "
              f"card and CPU differ by {float(err.max()):.3g} (bars "
              f"{LM_SMALL_BAR}, {BF16_REL * float(want.abs().max()):.3g} "
              f"downstream of a differing KAN input code)")

    n_kan = sum(sp.ffn == "kan" for sp in cfg.layer_specs()) * 2
    (fc, _), cc = run(tfm.forward, p_cpu, cfg, {"tokens": toks})
    (fd, _), cd = run(tfm.forward, p_dev, cfg, {"tokens": toks.to(dev)})
    flips = code_flips(cc, cd, [0] * len(cc))
    count(flips, cc)
    hold(fd, fc, "forward", range(40), first_flips(flips, 2))
    s0 = 36
    (lc, kc), cc = run(decode.prefill, p_cpu, cfg, {"tokens": toks[:, :s0]},
                       40, True)
    (ld, kd), cd = run(decode.prefill, p_dev, cfg,
                       {"tokens": toks[:, :s0].to(dev)}, 40, True)
    ca, flips = list(cc), code_flips(cc, cd, [0] * len(cc))
    hold(ld, lc, "prefill", [s0 - 1], first_flips(flips, 2))
    for i in range(s0, 40):
        (lc, kc), cc = run(decode.decode_step, p_cpu, kc, toks[:, i:i + 1], i,
                           cfg)
        (ld, kd), cd = run(decode.decode_step, p_dev, kd,
                           toks[:, i:i + 1].to(dev), i, cfg)
        ca, flips = ca + cc, flips + code_flips(cc, cd, [i] * len(cc))
        hold(ld, lc, f"decode step {i}", [i], first_flips(flips, 2))
    count(flips, ca)
    g_cpu, cc = run(decode.generate, p_cpu, cfg, toks[:, :16], 8)
    g_dev, cd = run(decode.generate, p_dev, cfg, toks[:, :16].to(dev), 8)
    offs = [0] * n_kan + [16 + c // max(n_kan, 1) for c in
                          range(len(cc) - n_kan)]
    flips = code_flips(cc, cd, offs)
    count(flips, cc)
    first = first_flips(flips, 2)
    g_dev = g_dev.cpu()
    if cfg.dtype == torch.float32:
        check(roots <= MAX_FLIP_SHARE * n_codes, f"small LM reference "
              f"{label}: {roots} independent KAN input codes differ between "
              f"the card and the CPU, over {MAX_FLIP_SHARE} of {n_codes}")
    if any(f is not None for f in first):
        # the CPU's own logits at each generated step, to find near ties
        lg, kv = decode.prefill(p_cpu, cfg, {"tokens": toks[:, :16]}, 24,
                                True)
        steps = [lg[:, -1]]
        for j in range(7):
            lg, kv = decode.decode_step(p_cpu, kv, g_cpu[:, j:j + 1], 16 + j,
                                        cfg)
            steps.append(lg[:, 0])
        for r, f in enumerate(first):
            tie = 2 * BF16_REL * float(torch.stack(steps).abs().max())
            until = next((j for j, lg in enumerate(steps) if f is not None
                          and 15 + j >= f and float(
                              (lambda t: t[0] - t[1])(torch.topk(
                                  lg[r].float(), 2).values)) <= tie), 8)
            check(torch.equal(g_dev[r, :until], g_cpu[r, :until]),
                  f"small LM reference {label}: generate tokens differ in "
                  f"row {r}: {g_dev[r].tolist()} vs {g_cpu[r].tolist()}")
    else:
        check(torch.equal(g_dev, g_cpu), f"small LM reference {label}: "
              f"generate tokens differ: {g_dev.tolist()} vs "
              f"{g_cpu.tolist()}")
    return worst, roots, n_codes


# --- phase 7: ssd_scan against its plain versions ----------------------------

def layer0_scan_inputs(params, cfg, tokens):
    """Layer 0's scan inputs, as the port's prefill computes them."""
    x = tfm.embed_inputs(params, cfg, {"tokens": tokens})
    p0 = tfm.layer_of(params["stages"][0], 0)["l0"]
    xn = layers.NORM_APPLY[cfg.norm](p0["mixer_norm"], x)
    s = ssd_lib.ssd_inputs(p0["ssd"], xn, cfg.ssd_cfg)
    return {k: s[k] for k in ("x", "dt", "a", "B", "C", "d_skip")}


def ssd_work(x_shape, n, chunk, init):
    """(f32 operations, bytes) of the chunked SSD on these shapes: C B^T
    once per (b, chunk), lower triangle; per head the masked decay and the
    intra-chunk product over (i, j <= i), the carry-in readout and the
    state update over (t, p, n); the elementwise terms per (t, h, p)."""
    b, t, h, p = x_shape
    tri = sum(l * (l + 1) // 2 for l in
              (min(chunk, t - c0) for c0 in range(0, t, chunk)))
    flops = (2.0 * b * tri * n                   # C B^T
             + b * h * tri * (3 + 2 * p)          # exp, L * scores, product
             + 4.0 * b * t * h * p * n            # carry-in, state update
             + 6.0 * b * t * h * p + 3.0 * b * t * h)
    n_bytes = 4 * (2 * b * t * h * p + b * t * h + 2 * b * t * n + 2 * h
                   + b * h * p * n * (2 if init else 1))
    return flops, n_bytes


def check_ssd_scan(timer, label, s, chunk, init=None, on_path=False,
                   mma_tflops=None):
    """Kernel against the chunked plain form and the sequential oracle."""
    args = [s[k] for k in ("x", "dt", "a", "B", "C", "d_skip")]
    got_y, got_s = ops.ssd_state(*args, chunk=chunk, init_state=init)
    want_y, want_s = ref.ssd_chunked_ref(*args, chunk=chunk, init_state=init)
    seq_y, seq_s = ref.ssd_ref(*args, init)
    mass_y, mass_s = ref.ssd_chunked_ref(
        s["x"].abs(), s["dt"], s["a"], s["B"].abs(), s["C"].abs(),
        s["d_skip"].abs(), chunk=chunk,
        init_state=None if init is None else init.abs())
    row = dict(shape=label, T=s["x"].shape[1], chunk=chunk,
               init_state=init is not None, on_path=on_path)
    for name, got, want, mass in (
            ("y", got_y, want_y, mass_y), ("state", got_s, want_s, mass_s)):
        check(bool(torch.isfinite(got).all()), f"ssd_scan {label}: {name} "
              "not finite")
        for oname, ref_t in (("plain", want), ("ssd_ref", seq_y if name ==
                                                "y" else seq_s)):
            err = (got - ref_t).abs()
            jax_bar = SSD_ATOL + SSD_RTOL * ref_t.abs()
            tol = jax_bar + ORDER_REL * mass
            worst = float((err / tol).max())
            check(worst <= 1.0, f"ssd_scan {label}: {name} vs {oname}: "
                  f"max |err| / tolerance {worst:.3g} (max |err| "
                  f"{float(err.max()):.3g})")
            row[f"{name}_vs_{oname}_max_abs_err"] = float(err.max())
            row[f"{name}_vs_{oname}_err_over_tol"] = worst
            row[f"{name}_vs_{oname}_over_jax_bar"] = float(
                (err > jax_bar).float().mean())
    row["max_abs_err"] = max(row["y_vs_plain_max_abs_err"],
                             row["state_vs_plain_max_abs_err"])
    row["ms"] = timer.ms(lambda: ops.ssd_state(*args, chunk=chunk,
                                               init_state=init), reps=10)
    row["plain_ms"] = timer.ms(lambda: ref.ssd_chunked_ref(
        *args, chunk=chunk, init_state=init), reps=3, warmup=1)
    row["library_ms"] = None
    flops, n_bytes = ssd_work(tuple(s["x"].shape), s["B"].shape[-1], chunk,
                              init is not None)
    row["bound_ms"], row["bound_by"] = bound(flops, n_bytes)
    # the kernel's products run as three tf32 products on the tensor cores
    row["bound_tf32_ms"], _ = bound(3 * flops, n_bytes, PEAK_TF32)
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    if mma_tflops:  # the same 3xTF32 work at the rate mma.sync reaches
        row["mma_sync_ms"] = 3 * flops / (mma_tflops * 1e9)
    return row


def mma_probe_tflops(dev, blocks=132 * 8, iters=512):
    """TF32 TFLOP/s of ``ssd_scan.cu``'s tensor-core building block alone
    (``ssd_mma_probe``: 24 mma.sync.m16n8k8 a k-step on register operands,
    no memory traffic), the ceiling of the kernel's design on this card."""
    lib = build.load()
    out = torch.empty(blocks * 128, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        build.check(lib.ssd_mma_probe(out.data_ptr(), blocks, iters, stream),
                    "ssd_mma_probe")

    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    check(bool(torch.isfinite(out).all()), "ssd_mma_probe: not finite")
    return blocks * 4 * iters * 24 * 2048 / (start.elapsed_time(end) * 1e9)


def ssd_stage_ms(args, chunk, init, reps=5):
    """Device time per call of each of the kernel's five CUDA kernels, from
    a ``torch.profiler`` trace of ``reps`` calls (inputs warm in L2); empty
    when the trace holds no device times."""
    from torch.profiler import ProfilerActivity, profile
    ops.ssd_state(*args, chunk=chunk, init_state=init)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ops.ssd_state(*args, chunk=chunk, init_state=init)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "device_time_total", 0.0)
              or getattr(ev, "cuda_time_total", 0.0))
        name = next((k for k in ("split", "scores", "state", "pass", "scan")
                     if f"ssd_{k}_kernel" in ev.key), None)
        if name and us:
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def ssd_phase(timer, params, cfg, prompt):
    """Phase 7: the rows of the kernel table for ``ssd_scan``."""
    chunk = cfg.ssd_cfg.chunk
    mma = mma_probe_tflops(prompt.device)
    print(f"kernel ssd_scan: its mma.sync building block alone reaches "
          f"{mma:.1f} TF32 TFLOP/s (peak {PEAK_TF32 / 1e12:.0f})")
    s = layer0_scan_inputs(params, cfg, prompt)
    rows = [check_ssd_scan(timer, f"layer0 T={LM_PROMPT}", s, chunk,
                           on_path=True, mma_tflops=mma)]
    cut = {k: v[:, :2000] if v.ndim > 1 else v for k, v in s.items()}
    rows.append(check_ssd_scan(timer, "layer0 T=2000 (ragged)", cut, chunk))
    head = {k: v[:, :1000] if v.ndim > 1 else v for k, v in s.items()}
    tail = {k: v[:, 1000:2000] if v.ndim > 1 else v for k, v in s.items()}
    _, init = ref.ssd_chunked_ref(*(head[k] for k in ("x", "dt", "a", "B",
                                                       "C", "d_skip")),
                                  chunk=chunk)
    rows.append(check_ssd_scan(timer, "layer0 T=1000..2000 init_state",
                               tail, chunk, init=init))
    rng = np.random.default_rng(0)
    b, t, h, p, n = 2, 37, 3, 8, 16
    suite = {"x": rng.normal(size=(b, t, h, p)),
             "dt": np.log1p(np.exp(rng.normal(size=(b, t, h)))),
             "a": -np.exp(rng.normal(size=h) * 0.3),
             "B": rng.normal(size=(b, t, n)) * 0.3,
             "C": rng.normal(size=(b, t, n)) * 0.3,
             "d_skip": np.full(h, 0.5)}
    suite = {k: torch.from_numpy(v.astype(np.float32)).to(prompt.device)
             for k, v in suite.items()}
    rows.append(check_ssd_scan(timer, "JAX suite (2, 37, 3, 8, 16)", suite,
                               8))
    return rows


# --- phase 8: the LM main path -----------------------------------------------

def teacher_forced(params, cfg, prompt, toks, extra=None):
    """prefill(last_only) and one decode step per generated token, each
    timed to its synchronize, then ``forward`` over the prompt and all but
    the last generated token. Returns the prefill's last logits, the decode
    logits [B, n-1, V], forward's logits and the times; launch counts are
    zeroed before ``forward`` and returned from just after it. ``extra``:
    the frontend's inputs (frames, vision_embeds), given to prefill and
    forward alike."""
    s = prompt.shape[1]
    extra = extra or {}
    t0 = time.perf_counter()
    logits_p, cache = decode.prefill(params, cfg, {"tokens": prompt, **extra},
                                     s + toks.shape[1], last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step_ms, step_logits = [], []
    for i in range(toks.shape[1] - 1):
        t0 = time.perf_counter()
        logits_d, cache = decode.decode_step(params, cache, toks[:, i:i + 1],
                                             s + i, cfg)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        step_logits.append(logits_d[:, 0])
    full = torch.cat([prompt, toks[:, :-1].to(prompt.dtype)], dim=1)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits_f, _ = tfm.forward(params, cfg, {"tokens": full, **extra})
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    launches_fwd = ops.launch_counts()
    check(logits_f.shape == (prompt.shape[0], full.shape[1], cfg.vocab)
          and bool(torch.isfinite(logits_f).all()),
          f"forward logits {tuple(logits_f.shape)} or not finite")
    return (logits_p[:, -1], torch.stack(step_logits, dim=1), logits_f,
            dict(prefill_s=prefill_s, step_ms=step_ms, forward_s=fwd_s,
                 forward_T=full.shape[1]), launches_fwd)


def paths_agree(label, logits_p, logits_d, logits_f, bar):
    """Prefill and decode logits against forward's at the same positions,
    and their greedy tokens against forward's argmax wherever its top-1
    logit leads its top-2 by more than ``bar``."""
    s = logits_f.shape[1] - logits_d.shape[1]
    toks = torch.argmax(torch.cat([logits_p[:, None], logits_d], dim=1), -1)
    err_p = float((logits_p.float() - logits_f[:, s - 1].float()).abs().max())
    err_d = float((logits_d.float() - logits_f[:, s:].float()).abs().max())
    check(err_p <= bar, f"{label}: prefill vs forward logits differ by "
          f"{err_p:.3g} > {bar:.3g}")
    check(err_d <= bar, f"{label}: decode vs forward logits differ by "
          f"{err_d:.3g} > {bar:.3g}")
    f_pred = logits_f[:, s - 1:].float()                     # [B, n, V]
    top2 = torch.topk(f_pred, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > bar
    agree = torch.argmax(f_pred, dim=-1) == toks
    check(bool(agree[clear].all()), f"{label}: greedy tokens differ from "
          f"forward's argmax at {int((clear & ~agree).sum())} of "
          f"{int(clear.sum())} positions with a clear lead")
    return {f"{label}_prefill_vs_forward_max_abs": err_p,
            f"{label}_decode_vs_forward_max_abs": err_d,
            f"{label}_bar": bar,
            f"{label}_greedy_positions_checked": int(clear.sum()),
            f"{label}_greedy_equal_to_forward_argmax": int(agree.sum())}


def check_launches(what, launches, expected):
    """Each kernel launched exactly ``expected.get(name, 0)`` times."""
    for name, n in launches.items():
        check(n == expected.get(name, 0), f"{what}: {name} launched {n} "
              f"times, not {expected.get(name, 0)}")


def lm_main_path(params, cfg, prompt, expected):
    """Phases 8 and 10b: generate, the same prefill and decode steps timed,
    and forward at full width and bf16 compute; then the f32 control on the
    same weights and tokens. ``expected``: each kernel's launches in
    generate and in forward (the others none). Returns the metrics and the
    launch counts."""
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = decode.generate(params, cfg, prompt, n_new=LM_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches_gen = ops.launch_counts()
    check(toks.shape == (LM_BATCH, LM_NEW), f"generate gave {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          "generate: tokens out of the vocabulary")
    check_launches(f"{cfg.name} generate", launches_gen, expected)
    lp, ld, lf, times, launches_fwd = teacher_forced(params, cfg, prompt,
                                                     toks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_launches(f"{cfg.name} forward", launches_fwd, expected)
    check(torch.equal(torch.argmax(lp, -1), toks[:, 0])
          and torch.equal(torch.argmax(ld, -1), toks[:, 1:]),
          "the timed prefill and decode steps do not repeat generate")

    # the f32 control: the same weights and tokens at f32 compute, where
    # the paths must agree to F32_PATH_BAR
    lp32, ld32, lf32, _, _ = teacher_forced(
        params, dataclasses.replace(cfg, dtype=torch.float32), prompt, toks)
    metrics = paths_agree("f32", lp32, ld32, lf32, F32_PATH_BAR)
    # bf16 compute: held to the reach of bf16 rounding itself, the largest
    # distance between the bf16 and f32 forwards of these weights and tokens
    bf16_reach = float((lf.float() - lf32).abs().max())
    del lp32, ld32, lf32
    metrics.update(paths_agree("bf16", lp, ld, lf, bf16_reach))
    step_ms = times["step_ms"]
    metrics.update(
        generate_s=gen_s, prefill_s=times["prefill_s"],
        decode_ms_median=float(np.median(step_ms)),
        decode_ms_all=[round(t, 3) for t in step_ms],
        decode_tokens_per_s=LM_BATCH / (float(np.median(step_ms)) / 1e3),
        generate_tokens_per_s=LM_BATCH * LM_NEW / gen_s,
        forward_s=times["forward_s"], forward_T=times["forward_T"],
        peak_gb=peak_gb)
    return metrics, launches_gen, launches_fwd


# --- phase 9: training at full width -----------------------------------------

def over_tol(got, want, mass):
    """Largest |got - want| over the gradient bar ``GRAD_ATOL + GRAD_RTOL *
    |want| + ORDER_REL * mass`` (want in float64)."""
    tol = GRAD_ATOL + GRAD_RTOL * want.abs() + ORDER_REL * mass
    return float(((got.double() - want).abs() / tol).max())


def grad_check(params, cfg, x):
    """The autograd Function ``ops.kan_spline_fused`` per layer of CF-KAN-1
    on one batch of training users (the decoder's input is the encoder's
    QAT output), with dy drawn from a seeded generator: the forward against
    ``ref.kan_spline_ref`` at ``kan_fused``'s bar, d/dcoeffs against the
    quantised-basis product in float64 and the decoder's d/dx against the
    float path's derivative in float64, each at the gradient bar."""
    dev = x.device
    gen = torch.Generator(device=dev).manual_seed(0)
    enc_spec = dataclasses.replace(cfg.kan_spec, dims=cfg.kan_spec.dims[:2],
                                   asp=(cfg.asp_enc,), layer_names=())
    with torch.no_grad():
        h = kan.train_apply(params["enc"], x, enc_spec, qat=True)
    rows = []
    for label, xb, coeffs, asp in (
            ("enc", kan.bound_input(x, cfg.asp_enc), params["enc"]["coeffs"],
             cfg.asp_enc),
            ("dec", kan.bound_input(h, cfg.asp_dec), params["dec"]["coeffs"],
             cfg.asp_dec)):
        xg = xb.clone().requires_grad_(label == "dec")
        cg = coeffs.clone().requires_grad_()
        y = ops.kan_spline_fused(xg, cg, asp)
        dy = torch.randn(y.shape, generator=gen, device=dev)
        y.backward(dy)
        codes, scale = quant.quantize_coeffs(coeffs, asp, axis=(0, 1))
        scale = scale.reshape(-1)
        want = ref.kan_spline_ref(xb, codes, scale, asp)
        e = quant.quantized_basis(xb, quant.hemi_for(asp, dev), asp
                                  ).reshape(xb.shape[0], -1)
        mass = (e.abs() @ codes.to(torch.float32).reshape(e.shape[1], -1)
                .abs()) * scale.abs()
        err = (y.detach() - want).abs()
        row = dict(layer=label, B=xb.shape[0],
                   forward_max_abs_err=float(err.max()),
                   forward_err_over_tol=float((err / (ORDER_REL * mass)
                                               .clamp_min(1e-30)).max()))
        e64 = e.double()
        row["dcoeffs_err_over_tol"] = over_tol(
            cg.grad, (e64.T @ dy.double()).reshape(coeffs.shape),
            (e64.abs().T @ dy.double().abs()).reshape(coeffs.shape))
        row["dcoeffs_max_abs"] = float(cg.grad.abs().max())
        if label == "dec":
            want_dx, mass_dx = ref.kan_spline_dx_f64(xb, coeffs, asp, dy)
            row["dx_err_over_tol"] = over_tol(xg.grad, want_dx, mass_dx)
            row["dx_max_abs"] = float(xg.grad.abs().max())
        else:
            check(xg.grad is None, "grad check: the encoder's data got a "
                  "gradient")
        del e, e64, mass
        for k, v in row.items():
            if k.endswith("_err_over_tol"):
                check(v <= 1.0, f"grad check {label}: {k} {v:.3g} > 1")
        rows.append(row)
    return rows


def step_profile(params, cfg, train_ds, window_ms, median_ms,
                 steps=PROFILE_STEPS):
    """Device time per training step from a ``torch.profiler`` trace of
    ``steps`` steps after two warm ones: the device's busy time (the sum
    over CUDA kernels and copies), ``kan_fused``'s part of it, and the ops
    whose kernels took the most (an op's self device time is that of the
    kernels it launched) and the ops that took the most host time (self
    CPU time, which the profiler inflates). The idle shares divide the busy
    time by this run's unprofiled times per step: the window's (the loop as
    users run it) and the median of the synchronized steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    train_cf_kan.train(params, cfg, train_ds, steps=2, lr=TRAIN_LR)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_cf_kan.train(params, cfg, train_ds, steps=steps, lr=TRAIN_LR)
        torch.cuda.synchronize()
    kernels, ops_ms, host_ms = {}, {}, {}
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", 0.0)
              or getattr(ev, "self_cuda_time_total", 0.0))
        if us:
            side = kernels if ev.device_type == DeviceType.CUDA else ops_ms
            side[ev.key[:90]] = us / 1e3 / steps
        if ev.device_type == DeviceType.CPU and ev.self_cpu_time_total:
            host_ms[ev.key[:90]] = ev.self_cpu_time_total / 1e3 / steps
    busy = sum(kernels.values())
    check(busy > 0, "step profile: the trace holds no device time")
    return dict(device_ms_per_step=busy,
                idle_share_window=1 - busy / window_ms,
                idle_share_synchronized=1 - busy / median_ms,
                kan_fused_ms_per_step=sum(v for k, v in kernels.items()
                                          if "kan_fused" in k),
                top_ops_ms=dict(sorted(ops_ms.items(),
                                       key=lambda kv: -kv[1])[:12]),
                host_ms_per_step_profiled=sum(host_ms.values()),
                top_host_ops_ms=dict(sorted(host_ms.items(),
                                            key=lambda kv: -kv[1])[:12]))


def counted_training(params, cfg, train_ds, on_step=None):
    """One launch-counted run of ``train_cf_kan.train`` over TRAIN_STEPS:
    ``kan_fused`` exactly twice a step, no crossbar kernel. Returns the
    result, the seconds from the call to a synchronize after it, and the
    launches."""
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_cf_kan.train(params, cfg, train_ds, steps=TRAIN_STEPS,
                             lr=TRAIN_LR, on_step=on_step)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(launches["kan_fused"] == 2 * TRAIN_STEPS,
          f"kan_fused launched {launches['kan_fused']} times in "
          f"{TRAIN_STEPS} training steps, not {2 * TRAIN_STEPS}")
    check(launches["cim_mac"] == launches["cim_mac_tiled"] == 0,
          f"training launched crossbar kernels: {launches}")
    return res, seconds, launches


def train_phase(timer, params, cfg, ds, art):
    """Phase 9. Returns the metrics, the extra ``kan_fused`` rows (batch 64),
    the launches of the training run and of the evaluation, and the trained
    weights."""
    dev = art.layers[0].codes.device
    train_ds, val_ds = cf_synth.split(ds)
    x = torch.from_numpy(next(cf_synth.batches(train_ds, train_cf_kan.BATCH,
                                               seed=0))).to(dev)
    out = {"grad_check": grad_check(params, cfg, x)}
    for r in out["grad_check"]:
        print(f"phase 9 grad check {r['layer']} (B={r['B']}): forward "
              f"max|err| {r['forward_max_abs_err']:.3g}, err/tol forward "
              f"{r['forward_err_over_tol']:.3g}, dcoeffs "
              f"{r['dcoeffs_err_over_tol']:.3g}"
              + (f", dx {r['dx_err_over_tol']:.3g}" if "dx_err_over_tol" in r
                 else ", no dx (data)"))
    # kan_fused at the training batch (its split path), as phase 3 holds it
    enc, dec = art.layers
    xe = kan.bound_input(x, cfg.asp_enc)
    h = (ref.kan_spline_ref(xe, enc.codes, enc.scale.reshape(-1),
                            cfg.asp_enc, enc.hemi)
         + kan.base_branch(xe, enc.w_base, "relu"))
    krows = [check_kan_fused(timer, f"enc B={train_cf_kan.BATCH}", xe, enc,
                             cfg.asp_enc),
             check_kan_fused(timer, f"dec B={train_cf_kan.BATCH}",
                             kan.bound_input(h, cfg.asp_dec), dec,
                             cfg.asp_dec)]
    for r in krows:
        r["on_path"] = False    # the kernel line's ms stays per serving apply
        print(f"kernel kan_fused {r['shape']}: max|err| {r['max_abs_err']:.3g}"
              f", err/sum|terms| {r['max_err_over_sum_abs_terms']:.3g}, "
              f"{r['ms']:.4f} ms, device {r['device_ms']:.4f} (plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']})")

    # training, launch-counted: first each step ending in a synchronize
    # (its median), then the loop as users run it, one synchronize at the
    # end (its window over the steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ends = []

    def synchronized(step, loss):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    t0 = time.perf_counter()
    res, train_s, launches_sync = counted_training(params, cfg, train_ds,
                                                   synchronized)
    step_ms = np.diff([t0] + ends) * 1e3
    res_w, window_s, launches_window = counted_training(params, cfg,
                                                        train_ds)
    launches_train = {k: launches_sync[k] + launches_window[k]
                      for k in launches_sync}
    losses = res.losses
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          "training: a loss is not finite")
    n_obs = float(x.sum(-1).mean())
    init_loss = n_obs * np.log(cfg.n_items)
    check(abs(losses[0] / init_loss - 1) <= TRAIN_LOSS_REL,
          f"training: first loss {losses[0]:.2f}, not within "
          f"{TRAIN_LOSS_REL:.0%} of {n_obs:.0f} * ln {cfg.n_items} = "
          f"{init_loss:.2f}")
    for layer in res.params.values():
        for p in layer.values():
            check(bool(torch.isfinite(p).all()), "training: weights not "
                  "finite")
    out.update(train_s=train_s, window_s=window_s, steps=TRAIN_STEPS,
               lr=TRAIN_LR, batch=train_cf_kan.BATCH, loss_first=losses[0],
               loss_last=losses[-1], loss_at_init_uniform=init_loss,
               loss_every_10=[round(v, 4) for v in losses[::10]],
               losses_equal_across_runs=res_w.losses == losses,
               step_ms_median=float(np.median(step_ms)),
               step_ms_first=float(step_ms[0]),
               step_ms_all=[round(float(t), 3) for t in step_ms],
               window_ms_per_step=1e3 * window_s / TRAIN_STEPS,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"phase 9 training: {TRAIN_STEPS} steps of {train_cf_kan.BATCH} "
          f"users, lr {TRAIN_LR}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(uniform logits: {init_loss:.2f}); each step synchronized: "
          f"median {out['step_ms_median']:.3f} ms (first {step_ms[0]:.1f}), "
          f"{train_s:.2f} s in all; the loop unsynchronized: "
          f"{out['window_ms_per_step']:.3f} ms per step over the window, "
          f"losses the same as the first run's: "
          f"{out['losses_equal_across_runs']}; peak {out['peak_gb']:.2f} GB; "
          f"launches {launches_sync} per run")

    # evaluation on the trained weights, launch-counted
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out["metrics"] = train_cf_kan.evaluate(res.params, cfg, val_ds)
    out["fig18"], cost = train_cf_kan.fig18(res.params, cfg, ds, train_ds)
    out["eval_s"] = time.perf_counter() - t0
    launches_eval = ops.launch_counts()
    n_cim = 2 * 2 * len(train_cf_kan.ARRAY_SIZES)  # 2 mappings x 2 layers
    check(launches_eval["cim_mac"] == n_cim,
          f"fig18 launched cim_mac {launches_eval['cim_mac']} times, not "
          f"{n_cim}")
    m = out["metrics"]
    check(all(0.0 <= v <= 1.0 for v in m.values()),
          f"evaluation: metrics out of [0, 1]: {m}")
    print(f"phase 9 evaluation ({len(val_ds.observed)} validation users): "
          f"float Recall@20 {m['recall_float']:.6f} NDCG@20 "
          f"{m['ndcg_float']:.6f}; ASP-8bit Recall@20 {m['recall_asp']:.6f} "
          f"NDCG@20 {m['ndcg_asp']:.6f}")
    for r in out["fig18"]:
        print(f"phase 9 Fig. 18 As={r['As']}: score-err uniform "
              f"{r['err_uniform']:.4f} KAN-SAM {r['err_sam']:.4f}; recall-deg"
              f" uniform {r['recall_deg_uniform']:.4f} KAN-SAM "
              f"{r['recall_deg_sam']:.4f}")
    uni = [r["err_uniform"] for r in out["fig18"]]
    check(all(np.isfinite(uni)) and all(lo < hi for lo, hi in
                                        zip(uni, uni[1:])),
          f"phase 9 Fig. 18: uniform error does not grow with As: {uni}")
    check(out["fig18"][-1]["err_sam"] < uni[-1],
          "phase 9 Fig. 18: KAN-SAM does not recover at the largest As")
    out["cost"] = dataclasses.asdict(cost)
    print(f"phase 9 Fig. 19 cost model @22nm ({cfg.n_params:,} params): "
          f"{cost.area_mm2:.2f} mm^2, {cost.power_w * 1e3:.1f} mW, "
          f"{cost.latency_ns:.0f} ns, {cost.energy_nj:.1f} nJ; evaluation "
          f"{out['eval_s']:.2f} s; launches {launches_eval}")

    # where a step's time goes (after the counted runs)
    out["profile"] = step_profile(params, cfg, train_ds,
                                  out["window_ms_per_step"],
                                  out["step_ms_median"])
    pr = out["profile"]
    print(f"phase 9 step profile ({PROFILE_STEPS} steps, profiler): device "
          f"{pr['device_ms_per_step']:.3f} ms per step, idle "
          f"{pr['idle_share_window']:.3f} of the unsynchronized window's "
          f"{out['window_ms_per_step']:.3f} ms and "
          f"{pr['idle_share_synchronized']:.3f} of the synchronized median "
          f"{out['step_ms_median']:.3f} ms; kan_fused "
          f"{pr['kan_fused_ms_per_step']:.3f} ms; device ms per step by op "
          + json.dumps({k: round(v, 4) for k, v in
                        pr["top_ops_ms"].items()}))
    print(f"phase 9 step profile: host (self CPU time, profiled) "
          f"{pr['host_ms_per_step_profiled']:.3f} ms per step; by op "
          + json.dumps({k: round(v, 4) for k, v in
                        pr["top_host_ops_ms"].items()}))
    return out, krows, launches_train, launches_eval, res.params


# --- phase 10: the KAN-FFN LLM and mistral-nemo-12b at full width -----------

@contextlib.contextmanager
def quantisation_poisoned():
    """While active, ``quant.quantize_coeffs`` raises: serving a deployed
    model must never requantise its coefficients."""
    orig = quant.quantize_coeffs

    def boom(*args, **kwargs):
        raise AssertionError("quant.quantize_coeffs was called while "
                             "serving a deployed model")
    quant.quantize_coeffs = boom
    try:
        yield
    finally:
        quant.quantize_coeffs = orig


def capture_fused_inputs(params, cfg, prompt, toks):
    """The bounded inputs that layer 0's KAN-FFN hands ``kan_fused`` in a
    prefill of ``prompt`` and in the first decode step (up and down in
    each), with the layers of the artifact: [(label, x [rows, I], layer,
    asp)]."""
    seen, orig = [], ops.kan_spline_fused_deployed

    def spy(x, codes, scale, asp, hemi=None):
        seen.append(x.reshape(-1, x.shape[-1]).clone())
        return orig(x, codes, scale, asp, hemi=hemi)
    ops.kan_spline_fused_deployed = spy
    try:
        _, cache = decode.prefill(params, cfg, {"tokens": prompt},
                                  prompt.shape[1] + 1, last_only=True)
        n_prefill = len(seen)
        decode.decode_step(params, cache, toks[:, :1], prompt.shape[1], cfg)
    finally:
        ops.kan_spline_fused_deployed = orig
    up, down = tfm.layer_of(params["stages"][0], 0)["l0"]["kan"].layers
    asp = cfg.kan_spec.asp[0]
    return [(f"kan_llm {what} {name} [{x.shape[0]}, {x.shape[1]}]", x,
             layer, asp)
            for what, at in (("prefill", 0), ("decode", n_prefill))
            for name, layer, x in (("up", up, seen[at]),
                                   ("down", down, seen[at + 1]))]


def lut_int8_card_equals_cpu(params, x_up):
    """Layer 0's KAN-FFN on ``lut_int8`` on the card and on the CPU from
    one artifact: each layer fed the same bounded input (the down layer the
    CPU's up output), the int32 accumulators and the f32 outputs bitwise
    equal. Returns the number of values compared."""
    art = tfm.layer_of(params["stages"][0], 0)["l0"]["kan"]
    spec, backend = art.spec, kan.get_backend("lut_int8")
    x_cpu, n = x_up.cpu(), 0
    for i, layer in enumerate(art.layers):
        lspec = spec.layer(i)
        on_cpu = tfm.tree_map(lambda t: t.cpu(), layer)
        accs, ys = [], []
        for lay, xx in ((layer, x_cpu.to(x_up.device)), (on_cpu, x_cpu)):
            e = quant.quantized_basis(xx, lay.hemi_q, lspec.asp
                                      ).reshape(xx.shape[0], -1)
            accs.append(kan.int8_matmul(e, lay.codes_t,
                                        lay.codes.shape[-1]).cpu())
            ys.append(backend.run(lay, lspec, spec, xx).cpu())
        check(accs[0].dtype == torch.int32 and torch.equal(*accs),
              f"lut_int8 layer {i}: int32 accumulators differ between the "
              f"card and the CPU in {int((accs[0] != accs[1]).sum())} places")
        check(torch.equal(*ys), f"lut_int8 layer {i}: outputs differ "
              f"between the card and the CPU by "
              f"{float((ys[0] - ys[1]).abs().max()):.3g}")
        n += accs[0].numel()
        if i + 1 < len(art.layers):
            x_cpu = kan.bound_input(ys[1] + kan.base_branch(
                x_cpu, on_cpu.w_base, spec.base_activation),
                spec.layer(i + 1).asp)
    return n


# the model functions whose device time a serving profile reports by name:
# (span, module, function)
SPANS = (("attention", attn_lib, "chunked_attention"),
         ("attention", attn_lib, "windowed_attention"),
         ("attention", attn_lib, "decode_attention"),
         ("kv_cache", attn_lib, "cache_update"),
         ("qkv_projections", tfm, "qkv"), ("out_projection", tfm, "heads_out"),
         ("mlp_ffn", tfm, "mlp_ffn"), ("kan_ffn", tfm, "kan_ffn"),
         ("norm_unembed", tfm, "logits_from"),
         ("rglru", decode, "_rglru_prefill"),
         ("rglru", rglru_lib, "apply_rglru_block_decode"),
         ("rglru_scan", rglru_lib, "rglru_scan"),
         ("moe_dispatch", moe_lib, "_dispatch"),
         ("moe_expert_products", moe_lib, "_expert_ffn"),
         ("moe_combine", moe_lib, "_combine"))


@contextlib.contextmanager
def spans():
    """While active, each function of ``SPANS`` runs inside a profiler
    range of its span's name (the module attributes are wrapped, then
    restored)."""
    saved = []
    for name, mod, attr in SPANS:
        fn = getattr(mod, attr)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            with torch.profiler.record_function(_name):
                return _fn(*args, **kwargs)
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def top_kernels(ms_by_name, n):
    """The ``n`` kernel names (template arguments and parameters dropped,
    so that the instances of one kernel add up) with the most time."""
    out = {}
    for name, ms in ms_by_name.items():
        short = re.split(r"[<(]", re.sub(r"^void |\(anonymous namespace\)::",
                                         "", name))[0][:56]
        out[short] = out.get(short, 0.0) + ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:n])


def serve_profile(params, cfg, prompt, toks, steps=3):
    """Device time of one prefill (last position unembedded) and of
    ``steps`` decode steps, from ``torch.profiler`` traces: the device's
    busy time (its kernels and copies, the spans' own device-side ranges
    left out), each span's device time (the kernels launched by the ops
    under its range, each kernel counted once, through the op it is linked
    to), the kernels linked to no op (``kan_fused``'s, launched through
    ctypes, are not), and the kernels that took the most. The spans must
    sum to at most the busy time. Empty where the trace holds no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = {n for n, _, _ in SPANS}

    def summary(prof, reps):
        evs = prof.events()
        kernels = [e for e in evs if e.device_type == DeviceType.CUDA
                   and e.name not in names
                   and not getattr(e, "is_user_annotation", False)]
        if not kernels:
            return {}
        by_kernel = {}
        for e in kernels:
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3 / reps)
        busy = sum(by_kernel.values())
        span_ms, linked, seen = {}, {}, set()
        for e in evs:
            ks = [k for k in e.kernels if k.name not in names]
            if e.device_type != DeviceType.CPU or not ks or e.id in seen:
                continue
            seen.add(e.id)
            p = e
            while p is not None and p.name not in names:
                p = p.cpu_parent
            where = p.name if p is not None else "outside spans"
            for k in ks:
                ms = k.duration / 1e3 / reps
                span_ms[where] = span_ms.get(where, 0.0) + ms
                linked[k.name] = linked.get(k.name, 0.0) + ms
        check(sum(span_ms.values()) <= busy * (1 + 1e-6),
              f"{cfg.name} serving profile: the spans sum to "
              f"{sum(span_ms.values()):.4f} ms, over the device's busy "
              f"{busy:.4f} ms")
        unlinked = {k: v - linked.get(k, 0.0) for k, v in by_kernel.items()
                    if v - linked.get(k, 0.0) > 1e-6}
        return dict(device_ms=busy, span_ms=span_ms,
                    unlinked_ms=sum(unlinked.values()),
                    unlinked_kernels_ms=top_kernels(unlinked, 4),
                    kan_fused_kernels_ms=sum(
                        v for k, v in by_kernel.items() if "kan_fused" in k),
                    top_kernels_ms=top_kernels(by_kernel, 8))

    s = prompt.shape[1]
    out = {}
    with spans():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, cache = decode.prefill(params, cfg, {"tokens": prompt},
                                      s + steps + 1, last_only=True)
            torch.cuda.synchronize()
        out["prefill"] = summary(prof, 1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                _, cache = decode.decode_step(params, cache, toks[:, i:i + 1],
                                              s + i, cfg)
            torch.cuda.synchronize()
        out["decode_step"] = summary(prof, steps)
    return out


def print_profile(label, prof, step_ms):
    """One line per profiled pass; the decode step's idle share is taken
    against the unprofiled median step time."""
    def r4(d):
        return json.dumps({k: round(v, 4) for k, v in d.items()})
    for what, p in prof.items():
        if not p:
            print(f"{label} {what} profile: not measured (no device times in "
                  "the trace)")
            continue
        idle = (f", idle {1 - p['device_ms'] / step_ms:.3f} of the "
                f"unprofiled median step {step_ms:.3f} ms"
                if what == "decode_step" else "")
        print(f"{label} {what} profile: device {p['device_ms']:.4f} ms"
              f"{idle}; by span {r4(p['span_ms'])}, linked to no op "
              f"{p['unlinked_ms']:.4f} {r4(p['unlinked_kernels_ms'])} "
              f"(kan_fused kernels {p['kan_fused_kernels_ms']:.4f}); top "
              f"kernels {r4(p['top_kernels_ms'])}")


def kan_llm_phase(timer, dev):
    """Phase 10a. Returns the metrics, the ``kan_fused`` rows at the path's
    shapes and the ``kan_fused`` launches of the fused generate and
    forward."""
    base = kan_llm.CONFIG.model
    data = lm_synth.batch_at(lm_synth.LMDataConfig(
        vocab=base.vocab, batch=KAN_LLM_BATCH, seq_len=KAN_LLM_PROMPT,
        seed=0), 0)
    prompt = torch.from_numpy(data["tokens"]).to(dev)
    t0 = time.perf_counter()
    params = tfm.init_model(0, base)
    torch.cuda.synchronize()
    n_params = tfm.count_params(params)
    check(n_params == KAN_LLM_PARAMS, f"kan_llm has {n_params:,} parameters, "
          f"not {KAN_LLM_PARAMS:,}")
    spec = base.kan_spec
    print(f"phase 10a init: {base.name}, {n_params:,} parameters "
          f"({base.n_layers} layers, d_model {base.d_model}, heads "
          f"{base.n_heads}/{base.n_kv_heads}, KAN-FFN {spec.dims} G "
          f"{base.kan_grid} K {base.kan_order} L "
          f"{spec.asp[0].levels_per_interval}), compute {base.dtype}, on the "
          f"card in {time.perf_counter() - t0:.2f} s; prompts "
          f"{KAN_LLM_BATCH}x{KAN_LLM_PROMPT}, generate {KAN_LLM_NEW}")
    kan_per_pass = 2 * sum(sp.ffn == "kan" for sp in base.layer_specs())
    out, steps, toks_by, deployed, launches_fused = {}, {}, {}, {}, 0
    for backend in KAN_BACKENDS:
        cfg = (kan_llm_int8.CONFIG.model if backend == "lut_int8" else
               dataclasses.replace(base, kan_backend=backend))
        t0 = time.perf_counter()
        dep = tfm.deploy_kan(params, cfg)
        torch.cuda.synchronize()
        deploy_s = time.perf_counter() - t0
        per_pass = {"kan_fused": kan_per_pass} if backend == "fused" else {}
        with quantisation_poisoned():
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            toks = decode.generate(dep, cfg, prompt, n_new=KAN_LLM_NEW)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            launches_gen = ops.launch_counts()
            check_launches(f"kan_llm {backend} generate", launches_gen,
                           {k: v * KAN_LLM_NEW for k, v in per_pass.items()})
            lp, ld, lf, times, launches_fwd = teacher_forced(dep, cfg, prompt,
                                                             toks)
            check_launches(f"kan_llm {backend} forward", launches_fwd,
                           per_pass)
        launches_fused += launches_gen["kan_fused"] + launches_fwd["kan_fused"]
        check(toks.shape == (KAN_LLM_BATCH, KAN_LLM_NEW) and bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()),
              f"kan_llm {backend}: generate gave {tuple(toks.shape)}")
        check(torch.equal(torch.argmax(lp, -1), toks[:, 0])
              and torch.equal(torch.argmax(ld, -1), toks[:, 1:]),
              f"kan_llm {backend}: the timed prefill and decode steps do not "
              "repeat generate")
        s = prompt.shape[1]
        step_ms = times["step_ms"]
        out[backend] = dict(
            deploy_s=deploy_s, generate_s=gen_s, prefill_s=times["prefill_s"],
            decode_ms_median=float(np.median(step_ms)),
            decode_ms_all=[round(t, 3) for t in step_ms],
            decode_tokens_per_s=KAN_LLM_BATCH / (float(np.median(step_ms))
                                                 / 1e3),
            forward_s=times["forward_s"], forward_T=times["forward_T"],
            launches_generate=launches_gen, launches_forward=launches_fwd,
            prefill_vs_forward_max_abs=float(
                (lp - lf[:, s - 1]).abs().max()),
            decode_vs_forward_max_abs=float((ld - lf[:, s:]).abs().max()))
        steps[backend] = torch.cat([lp[:, None], ld], dim=1)
        toks_by[backend], deployed[backend] = toks, (dep, cfg)
        del lf
        out[backend]["profile"] = serve_profile(dep, cfg, prompt, toks)
        print(f"phase 10a kan_llm {backend}: deploy {deploy_s:.3f} s, prefill "
              f"{KAN_LLM_BATCH}x{KAN_LLM_PROMPT} {times['prefill_s']:.4f} s, "
              f"decode {out[backend]['decode_ms_median']:.3f} ms per step of "
              f"{KAN_LLM_BATCH} ({out[backend]['decode_tokens_per_s']:.1f} "
              f"tokens/s), generate {gen_s:.3f} s, forward T="
              f"{times['forward_T']} {times['forward_s']:.4f} s; launches "
              f"generate {launches_gen}, forward {launches_fwd}; prefill / "
              f"decode vs forward max|logit diff| "
              f"{out[backend]['prefill_vs_forward_max_abs']:.3g} / "
              f"{out[backend]['decode_vs_forward_max_abs']:.3g}")
        print_profile(f"phase 10a kan_llm {backend}",
                      out[backend]["profile"],
                      out[backend]["decode_ms_median"])
    # fused against lut: the same greedy tokens up to lut's first near tie
    top2 = torch.topk(steps["lut"].float(), 2, dim=-1).values
    near = ((top2[..., 0] - top2[..., 1]) < F32_PATH_BAR).any(dim=0)
    until = int(torch.nonzero(near)[0]) if bool(near.any()) else KAN_LLM_NEW
    check(torch.equal(toks_by["fused"][:, :until], toks_by["lut"][:, :until]),
          f"kan_llm: fused and lut greedy tokens differ before step {until}, "
          f"lut's first top-1/top-2 lead under {F32_PATH_BAR}")
    out["fused_vs_lut"] = dict(
        steps_compared=until,
        tokens_equal_share=float((toks_by["fused"] == toks_by["lut"])
                                 .float().mean()),
        max_abs_logit_diff=float((steps["fused"] - steps["lut"]).abs().max()))
    out["lut_int8_vs_lut"] = dict(
        tokens_equal_share=float((toks_by["lut_int8"] == toks_by["lut"])
                                 .float().mean()),
        max_abs_logit_diff=float((steps["lut_int8"] - steps["lut"])
                                 .abs().max()))
    print(f"phase 10a fused vs lut: tokens equal through step {until} (lut's "
          f"first lead under {F32_PATH_BAR}); " + json.dumps(
              {k: out[k] for k in ("fused_vs_lut", "lut_int8_vs_lut")}))
    # kan_fused at the path's shapes, and lut_int8 on the card and the CPU
    inputs = capture_fused_inputs(*deployed["fused"], prompt,
                                  toks_by["fused"])
    rows = []
    for label, x, layer, asp in inputs:
        rows.append(check_kan_fused(timer, label, x, layer, asp))
        rows[-1]["on_path"] = False   # the line's ms stays per CF-KAN apply
    n = lut_int8_card_equals_cpu(deployed["lut_int8"][0], inputs[0][1])
    out["lut_int8_card_equals_cpu_values"] = n
    print(f"phase 10a lut_int8: layer 0's KAN-FFN on the prefill's input, "
          f"{n:,} int32 accumulators and f32 outputs bitwise equal on the "
          f"card and the CPU")
    return out, rows, launches_fused


def mistral_phase(dev):
    """Phase 10b: mistral-nemo-12b at full width, ``MISTRAL_LAYERS`` of
    its 40 layers."""
    cfg = dataclasses.replace(mistral_nemo_12b.CONFIG.model,
                              n_layers=MISTRAL_LAYERS)
    data = lm_synth.batch_at(lm_synth.LMDataConfig(
        vocab=cfg.vocab, batch=LM_BATCH, seq_len=LM_PROMPT, seed=0), 0)
    prompt = torch.from_numpy(data["tokens"]).to(dev)
    t0 = time.perf_counter()
    params = tfm.init_model(0, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tfm.count_params(params)
    check(n_params == MISTRAL_PARAMS, f"mistral-nemo-12b at {MISTRAL_LAYERS} "
          f"layers has {n_params:,} parameters, not {MISTRAL_PARAMS:,}")
    print(f"phase 10b init: {cfg.name}, {cfg.n_layers} of its "
          f"{mistral_nemo_12b.CONFIG.model.n_layers} layers, {n_params:,} "
          f"parameters ({4 * n_params / 1e9:.2f} GB f32; d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"compute {cfg.dtype}, params {cfg.param_dtype}, on the card in "
          f"{init_s:.2f} s")
    metrics, launches_gen, launches_fwd = lm_main_path(params, cfg, prompt,
                                                       {})
    metrics["init_s"] = init_s
    toks = decode.generate(params, cfg, prompt, n_new=4)
    metrics["profile"] = serve_profile(params, cfg, prompt, toks)
    metrics["phase_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    metrics["card_gb"] = torch.cuda.get_device_properties(0).total_memory / 1e9
    print_profile("phase 10b mistral-nemo-12b", metrics["profile"],
                  metrics["decode_ms_median"])
    print("phase 10b mistral-nemo-12b: " + json.dumps(metrics))
    print(f"phase 10b mistral-nemo-12b: prefill {LM_BATCH}x{LM_PROMPT} "
          f"{metrics['prefill_s']:.3f} s, decode "
          f"{metrics['decode_ms_median']:.2f} ms per step of {LM_BATCH} "
          f"tokens ({metrics['decode_tokens_per_s']:.1f} tokens/s), generate "
          f"{LM_NEW} tokens {metrics['generate_s']:.3f} s, forward "
          f"T={metrics['forward_T']} {metrics['forward_s']:.3f} s, peak "
          f"{metrics['peak_gb']:.2f} GB to the bf16 forward, "
          f"{metrics['phase_peak_gb']:.2f} GB over the phase, of the card's "
          f"{metrics['card_gb']:.2f} GB; launches generate {launches_gen}, "
          f"forward {launches_fwd}")
    return metrics


# --- phase 11: the co-design tuner on CF-KAN-1 at full width -----------------

@contextlib.contextmanager
def tuner_spies(calls, seen):
    """While active: ``kan.deploy`` counts its calls in ``calls``; every
    ``kan.apply`` (each candidate's ``score`` and ``quick`` forward) runs
    with ``quant.quantize_coeffs`` poisoned; and each ``kan_fused`` call's
    input and layer are kept in ``seen`` per layer config (I, O, G, LD,
    coeff_bits), at the largest batch that config met."""
    deploy, apply_, fused = kan.deploy, kan.apply, \
        ops.kan_spline_fused_deployed

    def counted_deploy(*args, **kwargs):
        calls["deploy"] += 1
        return deploy(*args, **kwargs)

    def poisoned_apply(*args, **kwargs):
        with quantisation_poisoned():
            return apply_(*args, **kwargs)

    def kept(x, codes, scale, asp, hemi=None):
        key = (x.shape[-1], codes.shape[-1], asp.grid_size, asp.ld,
               asp.coeff_bits)
        if key not in seen or seen[key][0].shape[0] < x.shape[0]:
            seen[key] = (x.detach().reshape(-1, x.shape[-1]).clone(),
                         types.SimpleNamespace(codes=codes, scale=scale,
                                               hemi=hemi), asp)
        return fused(x, codes, scale, asp, hemi=hemi)

    kan.deploy, kan.apply = counted_deploy, poisoned_apply
    ops.kan_spline_fused_deployed = kept
    try:
        yield
    finally:
        kan.deploy, kan.apply = deploy, apply_
        ops.kan_spline_fused_deployed = fused


def counted_search(params, cfg, val_ds, seen):
    """One launch-counted ``kan_neurosim_search.run`` on ``fused``: the
    sensitivity pass (two ``kan_fused`` launches a batch, through the QAT
    Function) and two launches per deployed candidate (full evaluations
    and quick screens), no other kernel. Returns the result, its seconds,
    the candidates deployed and the launches."""
    calls = {"deploy": 0}
    n_sens = len(list(cf_synth.batches(val_ds, kan_neurosim_search.BATCH)))
    with tuner_spies(calls, seen):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = kan_neurosim_search.run(params, cfg, val_ds, backend="fused",
                                      budget=TUNE_BUDGET, seed=TUNE_SEED,
                                      grids=TUNE_GRIDS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.launch_counts()
    n_dep = calls["deploy"]
    check(len(res.evaluated) == TUNE_BUDGET and n_dep >= TUNE_BUDGET,
          f"the search evaluated {len(res.evaluated)} of {TUNE_BUDGET} "
          f"candidates in {n_dep} deploys")
    check_launches("the search", launches,
                   {"kan_fused": 2 * (n_dep + n_sens)})
    return res, seconds, n_dep, launches


def candidate_rows(res):
    return [(c.assignment, c.accuracy, c.area_mm2, c.power_w, c.latency_ns,
             c.meta) for c in res]


def user_hits(scores, held, observed):
    """Held-out items in each user's top 20 unobserved scores."""
    return torch.gather(held, -1, cf_kan._top_k(scores, observed, 20)
                        ).sum(-1)


def lut_cross_check(params, cfg, cand, xv, hv):
    """One candidate deployed on ``fused`` and on ``lut`` and scored on the
    validation users: the fused score must repeat the search's, and each
    user's top-20 hits must agree, except for users whose decoder input
    codes differ between the backends or whose 20th and 21st unobserved
    ``lut`` scores lie within twice the user's largest fused-lut score
    distance of each other (a near tie). The differing codes are capped at
    ``MAX_FLIP_SHARE``."""
    spec = cfg.kan_spec
    ns = space.assignment_spec(spec, cand.assignment)
    refit = space.refit_params(params, spec, ns)
    dep = {"fused": kan.deploy(refit, ns),
           "lut": kan.deploy(refit, ns.with_backend("lut"))}
    with quantisation_poisoned():
        s = {k: kan.apply(d, xv) for k, d in dep.items()}
        asp_d = ns.asp[1]
        q = {k: quant.quantize_input(kan.bound_input(
            kan.apply(enc_only(d), xv), asp_d), asp_d) for k, d in dep.items()}
    recall = {k: float(cf_kan.recall_at_k(v, hv, xv)) for k, v in s.items()}
    check(recall["fused"] == cand.accuracy, f"{cand.assignment}: fused "
          f"Recall@20 {recall['fused']} does not repeat the search's "
          f"{cand.accuracy}")
    flips = q["fused"] != q["lut"]
    flip_share = float(flips.float().mean())
    check(flip_share <= MAX_FLIP_SHARE, f"{cand.assignment}: {flip_share:.3g}"
          f" of the decoder input codes differ between fused and lut")
    masked = torch.where(xv > 0, -torch.inf, s["lut"])
    top = torch.topk(masked, 21, dim=-1).values
    dist = (s["fused"] - s["lut"]).abs().amax(-1)
    near_tie = (top[:, 19] - top[:, 20]) <= 2 * dist
    excused = flips.any(-1) | near_tie
    hits = {k: user_hits(v, hv, xv) for k, v in s.items()}
    differ = hits["fused"] != hits["lut"]
    check(not bool((differ & ~excused).any()), f"{cand.assignment}: "
          f"{int((differ & ~excused).sum())} users' top-20 hits differ "
          "between fused and lut without a code flip or a near tie")
    return dict(assignment=[p.as_dict() for p in cand.assignment],
                recall_fused=recall["fused"], recall_lut=recall["lut"],
                users_near_tie=int(near_tie.sum()),
                users_with_code_flips=int(flips.any(-1).sum()),
                code_flip_share=flip_share,
                users_hits_differ=int(differ.sum()),
                max_abs_score_diff=float(dist.max()))


def tune_phase(timer, params, cfg, ds):
    """Phase 11. Returns the metrics, the ``kan_fused`` rows at every layer
    config the search deployed and the ``kan_fused`` launches of both
    searches."""
    dev = params["enc"]["coeffs"].device
    _, val_ds = cf_synth.split(ds)
    seen = {}
    res, search_s, n_dep, launches = counted_search(params, cfg, val_ds, seen)
    res2, search2_s, n_dep2, launches2 = counted_search(params, cfg, val_ds,
                                                        {})
    check(candidate_rows(res.evaluated) == candidate_rows(res2.evaluated)
          and candidate_rows(res.frontier.points())
          == candidate_rows(res2.frontier.points())
          and res.history == res2.history and n_dep == n_dep2,
          "two searches with one seed differ")
    lat = set(space.lattice(cfg.asp_enc, grids=TUNE_GRIDS))
    base_spec = cfg.kan_spec
    for c in res.evaluated:
        for pt in c.assignment:
            check(pt in lat and space.is_feasible(
                pt, n_bits=cfg.asp_enc.n_bits), f"{pt} is off the lattice "
                "or infeasible")
        cost = space.assignment_cost(space.assignment_spec(base_spec,
                                                           c.assignment))
        check((cost.area_mm2, cost.power_w, cost.latency_ns)
              == (c.area_mm2, c.power_w, c.latency_ns),
              f"{c.assignment}: the search's cost differs from the host's")
    b = res.baseline
    check(b.assignment == tuple(space.point_of(a) for a in base_spec.asp),
          f"the baseline {b.assignment} is not CF-KAN-1's own point")
    xv = torch.from_numpy(val_ds.observed).to(dev)
    hv = torch.from_numpy(val_ds.held_out).to(dev)
    front = res.frontier.points()
    cross = [lut_cross_check(params, cfg, c, xv, hv)
             for c in [b] + [c for c in front if c is not b]]
    best = res.best_sub8()
    dominating = [c for c in front if c.sub8 and c.area_mm2 < b.area_mm2
                  and c.power_w < b.power_w
                  and c.accuracy >= b.accuracy * (1 - ACC_LOSS_BUDGET)]
    out = dict(
        budget=TUNE_BUDGET, seed=TUNE_SEED, grids=list(TUNE_GRIDS),
        search_s=search_s, search_repeat_s=search2_s,
        candidates_deployed=n_dep,
        quick_screens=n_dep - len(res.evaluated),
        ms_per_candidate=1e3 * search_s / n_dep,
        launches=launches, baseline=b.as_dict(),
        frontier=[c.as_dict() for c in front],
        history=res.history, lut_cross_check=cross,
        best_sub8=None if best is None else dict(
            best.as_dict(), area_saving=1 - best.area_mm2 / b.area_mm2,
            power_saving=1 - best.power_w / b.power_w,
            accuracy_loss=max(0.0, 1 - best.accuracy / b.accuracy)),
        sub8_dominates_at_half_percent=bool(dominating))
    rows = []
    for key in sorted(seen):
        x, layer, asp = seen[key]
        i, o, g, ld, bits = key
        rows.append(check_kan_fused(
            timer, f"tune I={i} O={o} G={g} LD={ld} bits={bits} "
            f"B={x.shape[0]}", x, layer, asp))
        rows[-1]["on_path"] = False   # the line's ms stays per CF-KAN apply
    return out, rows, launches["kan_fused"] + launches2["kan_fused"]


def print_tune(out):
    def pts(c):
        return " ".join(f"(G={p['G']},LD={p['LD']},b={p['coeff_bits']})"
                        for p in c["assignment"])
    b = out["baseline"]
    print(f"phase 11 search: budget {out['budget']}, seed {out['seed']}, "
          f"grids {out['grids']} on fused: {out['search_s']:.2f} s "
          f"(repeat {out['search_repeat_s']:.2f} s, same candidates, scores, "
          f"costs and frontier), {out['candidates_deployed']} candidates "
          f"deployed ({out['budget']} full evaluations, "
          f"{out['quick_screens']} quick screens), "
          f"{out['ms_per_candidate']:.1f} ms per candidate; launches "
          f"{out['launches']}")
    print(f"phase 11 baseline {pts(b)}: Recall@20 {b['accuracy']:.6f}, area "
          f"{b['area_mm2']:.4f} mm^2, power {b['power_w']:.4e} W, latency "
          f"{b['latency_ns']:.2f} ns")
    print(f"phase 11 frontier ({len(out['frontier'])} points):")
    for c in out["frontier"]:
        print(f"  Recall@20 {c['accuracy']:.6f} area {c['area_mm2']:.4f} "
              f"mm^2 power {c['power_w']:.4e} W latency "
              f"{c['latency_ns']:.2f} ns {pts(c)}"
              + (" [sub-8]" if c["sub8"] else "") + f" {c['origin']}")
    s8 = out["best_sub8"]
    if s8 is None:
        print("phase 11 best sub-8 point: none on the frontier")
    else:
        print(f"phase 11 best sub-8 point {pts(s8)}: saves "
              f"{100 * s8['area_saving']:.1f}% area and "
              f"{100 * s8['power_saving']:.1f}% power at "
              f"{100 * s8['accuracy_loss']:.2f}% accuracy loss; a sub-8 "
              f"point dominates the baseline at <= "
              f"{100 * ACC_LOSS_BUDGET:.1f}% loss: "
              f"{out['sub8_dominates_at_half_percent']}")
    for r in out["lut_cross_check"]:
        print(f"phase 11 lut cross-check {pts(r)}: Recall@20 fused "
              f"{r['recall_fused']:.6f} lut {r['recall_lut']:.6f}; users "
              f"whose hits differ {r['users_hits_differ']}, near a tie "
              f"{r['users_near_tie']}, with a differing decoder code "
              f"{r['users_with_code_flips']} (share of codes "
              f"{r['code_flip_share']:.3g}); max|score diff| "
              f"{r['max_abs_score_diff']:.3g}")


# --- phase 12: recurrentgemma-2b at full width and depth ---------------------

def rgemma_phase(dev):
    """Phase 12: recurrentgemma-2b ``CONFIG``, all 26 layers, through phase
    8's path and f32 control."""
    cfg = recurrentgemma_2b.CONFIG.model
    data = lm_synth.batch_at(lm_synth.LMDataConfig(
        vocab=cfg.vocab, batch=LM_BATCH, seq_len=LM_PROMPT, seed=0), 0)
    prompt = torch.from_numpy(data["tokens"]).to(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_model(0, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tfm.count_params(params)
    check(n_params == RGEMMA_PARAMS, f"recurrentgemma-2b has {n_params:,} "
          f"parameters, not {RGEMMA_PARAMS:,}")
    mixers = [sp.mixer for sp in cfg.layer_specs()]
    print(f"phase 12 init: {cfg.name}, {cfg.n_layers} layers "
          f"({mixers.count('rglru')} rglru, {mixers.count('local')} local, "
          f"window {cfg.local_window}), {n_params:,} parameters "
          f"({4 * n_params / 1e9:.2f} GB f32; d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.resolved_head_dim}, "
          f"RG-LRU width {cfg.rglru_cfg.d_rnn}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, softcap {cfg.logits_softcap}), compute {cfg.dtype}, "
          f"params {cfg.param_dtype}, on the card in {init_s:.2f} s")
    metrics, launches_gen, launches_fwd = lm_main_path(params, cfg, prompt,
                                                       {})
    metrics["init_s"] = init_s
    toks = decode.generate(params, cfg, prompt, n_new=4)
    metrics["profile"] = serve_profile(params, cfg, prompt, toks)
    metrics["phase_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    metrics["card_gb"] = torch.cuda.get_device_properties(0).total_memory / 1e9
    print_profile("phase 12 recurrentgemma-2b", metrics["profile"],
                  metrics["decode_ms_median"])
    print("phase 12 recurrentgemma-2b: " + json.dumps(metrics))
    print(f"phase 12 recurrentgemma-2b: prefill {LM_BATCH}x{LM_PROMPT} "
          f"{metrics['prefill_s']:.3f} s, decode "
          f"{metrics['decode_ms_median']:.2f} ms per step of {LM_BATCH} "
          f"tokens ({metrics['decode_tokens_per_s']:.1f} tokens/s), generate "
          f"{LM_NEW} tokens {metrics['generate_s']:.3f} s, forward "
          f"T={metrics['forward_T']} {metrics['forward_s']:.3f} s, peak "
          f"{metrics['peak_gb']:.2f} GB to the bf16 forward, "
          f"{metrics['phase_peak_gb']:.2f} GB over the phase, of the card's "
          f"{metrics['card_gb']:.2f} GB; launches generate {launches_gen}, "
          f"forward {launches_fwd}")
    return metrics


# --- phase 13: the continuous-batching engine at full width -----------------

def tick_bytes(eng):
    """Bytes one fused decode tick moves through the engine's cache and
    weights, counted from the shapes: per full-attention layer, the K and V
    gathers through every slot's page table read and write n_slots x P
    pages each and attention reads the gathered rows again (3 passes);
    per recurrent layer, the step reads the state and writes a new one,
    and the masked write reads both and writes the rows back (5 passes);
    every weight read once. The one-token writes are left out."""
    cache = 0
    for blk, stage in zip(eng.cache, eng.stages):
        for i, sp in enumerate(stage.block):
            for leaf in blk[f"l{i}"].values():
                if sp.mixer == "attn":    # K or V [(layers,) pages, ...]
                    page = leaf.element_size() * leaf.numel() // leaf.shape[-4]
                    cache += 3 * page * eng.n_slots * eng.n_slot_pages
                else:
                    cache += 5 * leaf.element_size() * leaf.numel()
    weights = sum(t.element_size() * t.numel()
                  for t in tfm.tree_leaves(eng.params))
    return cache, weights


@contextlib.contextmanager
def engine_spies(engines, seen, on_chunk=None):
    """While active: ``seen["decode"]`` and ``seen["chunks"]`` count the
    fused ticks and prefill chunks of every engine in ``engines``,
    ``seen["peak_ref"]`` holds the largest page refcount of any engine after
    any of its ticks; ``on_chunk(slot, last, cache)`` runs after each
    chunk."""
    saved = [(eng._decode, eng.step) for eng in engines]
    chunk_fn = decode.prefill_chunk
    seen.update(decode=0, chunks=0, peak_ref=0)

    def counted_decode(fn):
        def wrapped(*args):
            seen["decode"] += 1
            return fn(*args)
        return wrapped

    def tracked_step(eng, fn):
        def wrapped():
            out = fn()
            seen["peak_ref"] = max(seen["peak_ref"],
                                   int(eng.alloc.refcount.max()))
            return out
        return wrapped

    def counted_chunk(params, cfg, cache, tokens, start, slot, pages_row,
                      **kw):
        seen["chunks"] += 1
        out = chunk_fn(params, cfg, cache, tokens, start, slot, pages_row,
                       **kw)
        if on_chunk is not None:
            on_chunk(slot, kw["last"], out[1])
        return out
    for eng, (decode_fn, step_fn) in zip(engines, saved):
        eng._decode = counted_decode(decode_fn)
        eng.step = tracked_step(eng, step_fn)
    decode.prefill_chunk = counted_chunk
    try:
        yield
    finally:
        for eng, (decode_fn, step_fn) in zip(engines, saved):
            eng._decode, eng.step = decode_fn, step_fn
        decode.prefill_chunk = chunk_fn


def device_busy_ms(prof):
    """The device's busy time in a ``torch.profiler`` trace: every kernel
    and copy, the spans' own device-side ranges left out."""
    from torch.autograd import DeviceType
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3


def tick_window(step, warm, n_ticks):
    """``step()`` ``warm`` times unprofiled, then ``n_ticks`` times under
    ``torch.profiler``: the device's busy ms per tick and its idle share
    of the window's host time (ending in a synchronize). Empty where the
    trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy = device_busy_ms(prof)
    if not busy:
        return {}
    return dict(ticks=n_ticks, device_ms_per_tick=busy / n_ticks,
                wall_ms_per_tick=wall_ms / n_ticks,
                idle_share=1 - busy / wall_ms)


def engine_profile(params, cfg, trace, eng_kw, warm=10, n_ticks=6, reps=5):
    """Device time of the engine from ``torch.profiler`` traces, on a fresh
    engine fed ``trace``: over ``n_ticks`` ticks after ``warm`` unprofiled
    ones, the device's busy time per tick (every kernel and copy) and its
    idle share of the window's host time (ending in a synchronize); then
    the first fused tick's and the first full non-first chunk's calls of
    those ticks repeated ``reps`` times each on the engine's cache (the
    engine is dropped after), for the device time per fused tick and per
    chunk.
    Empty where a trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    eng = Engine(params, cfg, **eng_kw)
    for r in trace:
        eng.submit(r)
    calls, saved = {}, (decode.decode_step, decode.prefill_chunk)

    def kept(name, fn, keep):
        def wrapped(*args, **kwargs):
            if name not in calls and keep(args, kwargs):
                calls[name] = (args, kwargs)
            return fn(*args, **kwargs)
        return wrapped
    decode.decode_step = kept("decode_tick", saved[0], lambda a, k: True)
    decode.prefill_chunk = kept(
        "prefill_chunk", saved[1], lambda a, k: not k["first"]
        and a[3].shape[1] == eng.chunk_tokens)
    try:
        out = tick_window(eng.step, warm, n_ticks)
    finally:
        decode.decode_step, decode.prefill_chunk = saved
    if not out:
        return {}
    for name, fn in (("decode_tick", saved[0]), ("prefill_chunk", saved[1])):
        if name not in calls:
            out[f"device_ms_per_{name}"] = None
            continue
        args, kwargs = calls[name]
        fn(*args, **kwargs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(*args, **kwargs)
            torch.cuda.synchronize()
            out[f"wall_ms_per_{name}"] = 1e3 * (time.perf_counter()
                                                - t0) / reps
        out[f"device_ms_per_{name}"] = device_busy_ms(prof) / reps
    return out


def print_engine(label, rep, prof, launches, extra=""):
    print(f"{label}: {rep['completed']} requests, {rep['ticks']} ticks, "
          f"{rep['tokens_per_s']} tokens/s, TTFT p50/p99 "
          f"{rep['ttft_s']['p50']}/{rep['ttft_s']['p99']} s, TPOT p50/p99 "
          f"{rep['tpot_s']['p50']}/{rep['tpot_s']['p99']} s, mean occupancy "
          f"{rep['mean_occupancy']}, slot reuse {rep['slot_reuse']}, peak "
          f"pages {rep['pages_in_use_peak']} of {rep['n_pages']}, prefix-hit "
          f"pages {rep['prefix_hit_pages']} of {rep['prefix_eligible_pages']}"
          f", chunks {rep['prefill_chunks']}; launches {launches}{extra}")
    if not prof:
        print(f"{label} profile: not measured (no device times in the "
              "trace)")
        return
    calls = "; ".join(
        f"{name}: device {prof[f'device_ms_per_{name}']:.4f} ms, host "
        f"{prof[f'wall_ms_per_{name}']:.4f} (synchronized)"
        if prof[f"device_ms_per_{name}"] is not None else f"{name}: none"
        for name in ("decode_tick", "prefill_chunk"))
    print(f"{label} profile ({prof['ticks']} ticks): device "
          f"{prof['device_ms_per_tick']:.4f} ms a tick of "
          f"{prof['wall_ms_per_tick']:.4f} (idle {prof['idle_share']:.3f}); "
          f"per call, repeated: {calls}")


def solo_forced(params, cfg, prompt, toks, extra=None):
    """The request alone (batch 1) through ``decode.prefill`` and
    ``decode_step`` on the card, fed the engine's tokens ``toks``: per
    step the solo argmax and its top-1 lead over top-2; the prefill's last
    logits (f32) and its cache. ``extra``: the request's frontend inputs,
    batch 1."""
    logits, cache = decode.prefill(params, cfg, {"tokens": prompt[None],
                                                 **(extra or {})},
                                   len(prompt) + len(toks), last_only=True)
    steps, first_cache = [logits[0, -1].float()], cache
    for i in range(len(toks) - 1):
        out, cache = decode.decode_step(
            params, cache, torch.tensor([[toks[i]]], device=prompt.device),
            len(prompt) + i, cfg)
        steps.append(out[0, 0].float())
    top2 = torch.topk(torch.stack(steps), 2, dim=-1).values
    leads = (top2[:, 0] - top2[:, 1]).tolist()
    argmax = torch.argmax(torch.stack(steps), dim=-1).tolist()
    return argmax, leads, steps[0], first_cache


def solo_agrees(label, rid, toks, argmax, leads, bar):
    """The engine's token at every step where the solo run's top-1 lead is
    over ``bar`` is the solo argmax (phase 8's rule, teacher-forced): then
    the two runs agree up to the first near tie, and at every clear step
    after it. Returns the steps compared."""
    clear = [i for i, lead in enumerate(leads) if lead > bar]
    bad = [i for i in clear if argmax[i] != toks[i]]
    check(not bad, f"{label}: request {rid} differs from its solo run at "
          f"clear steps {bad[:5]} (bar {bar:.3g})")
    return len(clear)


def until_tie(leads, bar):
    """The first step whose top-1 lead is within ``bar`` (or the length)."""
    return next((i for i, lead in enumerate(leads) if lead <= bar),
                len(leads))


def engine_kan_llm_phase(timer, dev):
    """Phase 13a. Returns the metrics, the ``kan_fused`` rows at the
    engine's tick and chunk shapes and the ``kan_fused`` launches of the
    fused run."""
    base = kan_llm.CONFIG.model
    params = tfm.init_model(0, base)
    trace = lambda: synth_trace(base.vocab, **ENGINE_KAN_TRACE)  # noqa: E731
    reqs = trace()
    eng_kw = dict(ENGINE_KAN, device=dev)
    asp_up, asp_down = base.kan_spec.asp
    out, toks_by, rows, leads_lut = {}, {}, [], {}
    launches_fused = 0
    for backend in ("fused", "lut"):
        cfg = dataclasses.replace(base, kan_backend=backend)
        eng = Engine(params, cfg, recorder=EngineRecorder(), **eng_kw)
        check(eng.share_ok and eng.chunk_tokens == ENGINE_KAN["page_size"],
              f"kan_llm engine: share_ok {eng.share_ok}, chunk "
              f"{eng.chunk_tokens}")
        # layer 0's artifact as the engine deployed it, and the first input
        # it hands kan_fused at the tick's rows and at a chunk's
        up, down = tfm.layer_of(eng.params["stages"][0], 0)["l0"][
            "kan"].layers
        seen, captured = {}, {}
        codes_of = {up.codes.data_ptr(): "up", down.codes.data_ptr(): "down"}
        fused_fn = ops.kan_spline_fused_deployed

        def spy(x, codes, scale, asp, hemi=None):
            name = codes_of.get(codes.data_ptr())
            x2 = x.reshape(-1, x.shape[-1])
            key = (x2.shape[0], x2.shape[1])
            if (name and key[0] in (ENGINE_KAN["n_slots"],
                                    ENGINE_KAN["page_size"])
                    and key not in captured):
                captured[key] = (name, x2.clone())
            return fused_fn(x, codes, scale, asp, hemi=hemi)
        if backend == "fused":
            ops.kan_spline_fused_deployed = spy
        try:
            with quantisation_poisoned(), engine_spies([eng], seen):
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                comps = eng.run(trace())
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                launches = ops.launch_counts()
        finally:
            ops.kan_spline_fused_deployed = fused_fn
        rep = eng.stats.report()
        per_call = 2 * base.n_layers      # up and down in every KAN-FFN
        expected = ({"kan_fused": per_call * (seen["decode"]
                                              + seen["chunks"])}
                    if backend == "fused" else {})
        check_launches(f"kan_llm engine {backend}", launches, expected)
        if backend == "fused":
            launches_fused = launches["kan_fused"]
        check(len(comps) == len(reqs) == rep["completed"],
              f"kan_llm engine {backend}: {len(comps)} of {len(reqs)} done")
        got = {c.rid: [int(t) for t in c.tokens] for c in comps}
        check(all(len(got[r.rid]) == r.max_new for r in reqs),
              f"kan_llm engine {backend}: a request stopped short")
        check(rep["slot_reuse"] > 1, f"kan_llm engine {backend}: no slot "
              "reuse")
        check(seen["peak_ref"] > 1 and rep["prefix_hit_pages"] > 0,
              f"kan_llm engine {backend}: no page shared (peak refcount "
              f"{seen['peak_ref']}, prefix hits {rep['prefix_hit_pages']})")
        check(seen["chunks"] == rep["prefill_chunks"],
              f"kan_llm engine {backend}: chunks counted twice differently")
        compared = 0
        with quantisation_poisoned():
            for r in reqs:
                prompt = torch.from_numpy(r.tokens.astype(np.int64)).to(dev)
                if backend == "fused":
                    # each request alone, on the card
                    argmax, leads, _, _ = solo_forced(eng.params, cfg,
                                                      prompt, got[r.rid])
                    compared += solo_agrees(f"kan_llm engine {backend}",
                                            r.rid, got[r.rid], argmax, leads,
                                            F32_PATH_BAR)
                else:
                    # lut's leads along its own tokens, for phase 10a's
                    # rule below (one teacher-forced forward a request)
                    full = torch.cat([prompt, torch.tensor(
                        got[r.rid][:-1], device=dev)])[None]
                    lf, _ = tfm.forward(eng.params, cfg, {"tokens": full})
                    top2 = torch.topk(lf[0, len(prompt) - 1:].float(), 2,
                                      dim=-1).values
                    leads_lut[r.rid] = (top2[:, 0] - top2[:, 1]).tolist()
        prof = engine_profile(eng.params, cfg, trace(), eng_kw)
        cache_b, weight_b = tick_bytes(eng)
        out[backend] = dict(report=rep, run_s=run_s, launches=launches,
                            decode_calls=seen["decode"],
                            chunk_calls=seen["chunks"],
                            peak_refcount=seen["peak_ref"],
                            solo_clear_steps_compared=compared, profile=prof,
                            tick_cache_bytes=cache_b,
                            tick_weight_bytes=weight_b)
        toks_by[backend] = got
        solo_note = (f", clear solo steps compared {compared}"
                     if backend == "fused" else "")
        print_engine(f"phase 13a kan_llm engine {backend}", rep, prof,
                     launches, f"; run {run_s:.3f} s{solo_note}, peak "
                     f"refcount {seen['peak_ref']}, a tick "
                     f"moves {cache_b / 1e6:.1f} MB of cache and "
                     f"{weight_b / 1e6:.1f} MB of weights")
        if backend == "fused":
            for (rows_n, i), (name, x) in sorted(captured.items()):
                layer = up if name == "up" else down
                what = "tick" if rows_n == ENGINE_KAN["n_slots"] else "chunk"
                rows.append(check_kan_fused(
                    timer, f"kan_llm engine {what} {name} [{rows_n}, {i}]",
                    x, layer, asp_up if name == "up" else asp_down))
                rows[-1]["on_path"] = False
            check(len(rows) == 4, f"kan_llm engine: kan_fused captured at "
                  f"{sorted(captured)}, not the tick's and chunk's shapes")
    # fused against lut, each request up to lut's first near tie
    got_f, got_l = toks_by["fused"], toks_by["lut"]
    compared = 0
    for r in reqs:
        cut = until_tie(leads_lut[r.rid], F32_PATH_BAR)
        check(got_f[r.rid][:cut] == got_l[r.rid][:cut],
              f"kan_llm engine: fused and lut differ for request {r.rid} "
              f"before lut's first near tie at step {cut}")
        compared += cut
    out["fused_vs_lut_steps_compared"] = compared
    t0 = time.perf_counter()
    ex = serve_kan_llm.main([])
    torch.cuda.synchronize()
    out["example"] = dict(report=ex, s=time.perf_counter() - t0)
    print(f"phase 13a fused vs lut: tokens equal through {compared} steps "
          f"(lut's first lead under {F32_PATH_BAR}); example twin: "
          f"{ex['completed']} requests in {out['example']['s']:.2f}"
          f" s")
    return out, rows, launches_fused


def engine_mamba2_phase(timer, dev):
    """Phase 13b. Returns the metrics, the ``ssd_scan`` row at the chunk's
    shape and the ``ssd_scan`` launches of the engine's run."""
    cfg = mamba2_1p3b.CONFIG.model
    params = tfm.init_model(0, cfg)
    trace = lambda: synth_trace(cfg.vocab, **ENGINE_MAMBA_TRACE)  # noqa
    reqs = trace()
    eng_kw = dict(ENGINE_MAMBA, device=dev)
    eng = Engine(params, cfg, recorder=EngineRecorder(), **eng_kw)
    chunk = eng.chunk_tokens
    check(chunk == math.lcm(ENGINE_MAMBA["page_size"], cfg.ssm_chunk)
          and not eng.share_ok, f"mamba2 engine: chunk {chunk}, share_ok "
          f"{eng.share_ok}")
    seen, states, scan_in = {}, {}, {}

    def on_chunk(slot, last, cache):
        if last:      # the slot's carried state, before its first tick
            states[eng.slot_req[slot].rid] = cache[0]["l0"]["state"][
                :, slot].clone()
    ssd_fn = ops.ssd_state

    def spy(x, dt, a, b_mat, c_mat, d_skip=None, *, chunk, init_state=None):
        if init_state is not None and not scan_in:
            scan_in.update({k: v.clone() for k, v in dict(
                x=x, dt=dt, a=a, B=b_mat, C=c_mat, d_skip=d_skip,
                init=init_state).items()})
        return ssd_fn(x, dt, a, b_mat, c_mat, d_skip, chunk=chunk,
                      init_state=init_state)
    ops.ssd_state = spy
    try:
        with engine_spies([eng], seen, on_chunk):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            comps = eng.run(trace())
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = ops.launch_counts()
            init_launches = ssd_kernels.ssd_scan.init_launches
    finally:
        ops.ssd_state = ssd_fn
    rep = eng.stats.report()
    n_chunks = [-(-len(r.tokens) // chunk) for r in reqs]
    check_launches("mamba2 engine", launches,
                   {"ssd_scan": sum(n_chunks) * cfg.n_layers})
    want_init = sum(c - 1 for c in n_chunks) * cfg.n_layers
    check(init_launches == want_init, f"mamba2 engine: ssd_scan launched "
          f"{init_launches} times with init_state, not {want_init}")
    check(len(comps) == len(reqs) == rep["completed"], f"mamba2 engine: "
          f"{len(comps)} of {len(reqs)} completed")
    got = {c.rid: [int(t) for t in c.tokens] for c in comps}
    check(all(len(got[r.rid]) == r.max_new for r in reqs),
          "mamba2 engine: a request stopped short")
    check(len(states) == len(reqs), "mamba2 engine: a carried state was not "
          "captured")
    # each request alone: its carried state against a solo whole-prompt
    # prefill, its tokens up to the first step whose lead is within the bar
    # on the logits. Phase 8's bf16 rule holds a bf16 path to the reach of
    # bf16 rounding (its distance from the f32 result on the same weights
    # and tokens); the engine's chunks (which also read a bf16 conv history
    # at each chunk boundary, as in JAX) and the solo run are two bf16
    # paths to one f32 result, so they are held to twice the reach
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    worst_state, compared = 0.0, 0
    for r in reqs:
        prompt = torch.from_numpy(r.tokens.astype(np.int64)).to(dev)
        argmax, leads, last, cache = solo_forced(params, cfg, prompt,
                                                 got[r.rid])
        logits32, cache32 = decode.prefill(params, cfg32,
                                           {"tokens": prompt[None]},
                                           len(prompt) + 1, last_only=True)
        solo = cache[0]["l0"]["state"][:, 0]
        reach = float((solo - cache32[0]["l0"]["state"][:, 0]).abs().max())
        err = float((states[r.rid] - solo).abs().max())
        check(err <= 2 * reach, f"mamba2 engine: request {r.rid}'s carried "
              f"state differs from its solo prefill by {err:.3g}, past twice "
              f"the bf16 reach {reach:.3g}")
        worst_state = max(worst_state, err / reach)
        compared += solo_agrees(
            "mamba2 engine", r.rid, got[r.rid], argmax, leads,
            2 * float((last - logits32[0, -1]).abs().max()))
        del cache, cache32
    row = check_ssd_scan(timer, f"engine chunk [1, {chunk}, "
                         f"{cfg.ssd_cfg.n_heads}, {cfg.ssm_head_dim}] "
                         "init_state", scan_in, chunk, init=scan_in["init"])
    prof = engine_profile(eng.params, cfg, trace(), eng_kw)
    cache_b, weight_b = tick_bytes(eng)
    out = dict(report=rep, run_s=run_s, launches=launches,
               init_launches=init_launches, decode_calls=seen["decode"],
               chunk_calls=seen["chunks"], state_err_over_reach=worst_state,
               solo_clear_steps_compared=compared, profile=prof,
               tick_cache_bytes=cache_b, tick_weight_bytes=weight_b,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print_engine("phase 13b mamba2-1.3b engine", rep, prof, launches,
                 f" (with init_state {init_launches} = (sum of chunks - 1) x"
                 f" {cfg.n_layers}); run {run_s:.3f} s, carried state / bf16 "
                 f"reach <= {worst_state:.3g}, clear solo steps compared "
                 f"{compared}, a tick moves {cache_b / 1e9:.2f} GB of cache "
                 f"and {weight_b / 1e9:.2f} GB of weights")
    return out, row, launches["ssd_scan"]


# --- phase 14: the router, the launcher's fleet path, mixtral-8x7b ----------

def pool_bytes(eng):
    """Bytes of an engine's cache: its page pools and per-slot rows."""
    return sum(t.element_size() * t.numel()
               for t in tfm.tree_leaves(eng.cache))


def tokens_until_tie(label, reqs, got, want, leads):
    """Each request's tokens equal ``want``'s up to the first step whose
    top-1 lead in ``leads`` is within ``F32_PATH_BAR`` (phase 10a's rule).
    Returns the steps compared and the requests equal throughout."""
    compared = identical = 0
    for r in reqs:
        cut = until_tie(leads[r.rid], F32_PATH_BAR)
        check(got[r.rid][:cut] == want[r.rid][:cut],
              f"{label}: request {r.rid} differs from the single engine "
              f"before its first near tie at step {cut}")
        compared += cut
        identical += got[r.rid] == want[r.rid]
    return compared, identical


def router_phase(timer, dev):
    """Phase 14a. Returns the metrics, the ``kan_fused`` rows at the tick's
    shape and the ``kan_fused`` launches of the three runs."""
    cfg = dataclasses.replace(kan_llm.CONFIG.model, kan_backend="fused")
    params = tfm.init_model(0, cfg)
    trace = lambda: synth_trace(cfg.vocab, **ROUTER_TRACE)  # noqa: E731
    reqs = trace()
    eng_kw = dict(ROUTER_ENGINE, device=dev)
    n_rep = ROUTER_REPLICAS
    # the single engine on the same trace: the reference for the fleets'
    # tokens and the one-engine throughput their scaling is measured on;
    # its deploy is the one every replica shares
    single = Engine(params, cfg, recorder=EngineRecorder(), **eng_kw)
    with quantisation_poisoned():
        comps = single.run(trace())
    torch.cuda.synchronize()
    srep = single.stats.report()
    check(len(comps) == len(reqs), f"router single engine: {len(comps)} of "
          f"{len(reqs)} completed")
    want = {c.rid: [int(t) for t in c.tokens] for c in comps}
    leads = {}
    with quantisation_poisoned():
        for r in reqs:
            prompt = torch.from_numpy(r.tokens.astype(np.int64)).to(dev)
            full = torch.cat([prompt, torch.tensor(want[r.rid][:-1],
                                                   device=dev)])[None]
            lf, _ = tfm.forward(single.params, cfg, {"tokens": full})
            top2 = torch.topk(lf[0, len(prompt) - 1:].float(), 2,
                              dim=-1).values
            leads[r.rid] = (top2[:, 0] - top2[:, 1]).tolist()
    single_tps = srep["tokens_per_s"]
    up, down = tfm.layer_of(single.params["stages"][0], 0)["l0"]["kan"].layers
    asp_up, asp_down = cfg.kan_spec.asp
    out = {"single": dict(report=srep)}
    rows, launches_all, captured = [], 0, {}
    codes_of = {up.codes.data_ptr(): "up", down.codes.data_ptr(): "down"}
    fused_fn = ops.kan_spline_fused_deployed

    def spy(x, codes, scale, asp, hemi=None):
        name = codes_of.get(codes.data_ptr())
        x2 = x.reshape(-1, x.shape[-1])
        if (name and x2.shape[0] == ROUTER_ENGINE["n_slots"]
                and name not in captured):
            captured[name] = x2.clone()
        return fused_fn(x, codes, scale, asp, hemi=hemi)

    def fleet(run):
        """The run's router over ``n_rep`` fresh replicas sharing the
        single engine's deploy, and its health monitor (or None)."""
        rec = EngineRecorder()
        router = Router([Engine(single.params, cfg,
                                recorder=rec.for_replica(i),
                                **eng_kw).adopt_compiled(single)
                         for i in range(n_rep)], recorder=rec)
        if run == "drain":
            router.schedule_drain(*ROUTER_DRAIN)
        if run != "health":
            return router, None
        mon = router.enable_health(slos=serve_launch.lenient_slos,
                                   **ROUTER_HEALTH)
        for i in range(n_rep):
            mon.attach_chip(i, ChipHealth(
                tile=tiles.TileConfig(array_size=64, tile_cols=16),
                drift=variation.DriftConfig(
                    rate=ROUTER_DRIFT[1] if i == ROUTER_DRIFT[0] else 0.0,
                    tau=ROUTER_DRIFT[2], seed=0),
                geometry=health.ProbeGeometry(layer_uids=(0, 1),
                                              tiles_per_layer=2),
                registry=rec.metrics, labels={"replica": str(i)}))
        return router, mon
    for run in ("plain", "drain", "health"):
        router, mon = fleet(run)
        replicas = router.replicas
        seen = {}
        if run == "plain":
            ops.kan_spline_fused_deployed = spy
        try:
            with quantisation_poisoned(), engine_spies(replicas, seen):
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                comps = router.run(trace())
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                launches = ops.launch_counts()
        finally:
            ops.kan_spline_fused_deployed = fused_fn
        rep = router.report()
        label = f"router {run}"
        check_launches(label, launches, {"kan_fused": 2 * cfg.n_layers * (
            seen["decode"] + seen["chunks"])})
        launches_all += launches["kan_fused"]
        got = {c.rid: [int(t) for t in c.tokens] for c in comps}
        check(len(comps) == len(reqs) == rep["completed"] and sorted(got)
              == sorted(r.rid for r in reqs), f"{label}: {len(comps)} of "
              f"{len(reqs)} completed, {rep['completed']} counted")
        check(all(len(got[r.rid]) == r.max_new for r in reqs),
              f"{label}: a request stopped short")
        check(sum(rep["routed"]) == len(reqs) + rep["requeued"],
              f"{label}: routed {rep['routed']} vs {len(reqs)} requests + "
              f"{rep['requeued']} requeued")
        check(min(rep["routed"]) > 0 and rep["affinity_hits"] > 0,
              f"{label}: routed {rep['routed']}, affinity hits "
              f"{rep['affinity_hits']}")
        for i, eng in enumerate(replicas):
            eng.alloc.check()
            check(eng.alloc.in_use == 0 and not eng.active.any(),
                  f"{label}: replica {i} holds pages or slots after the run")
        if run == "drain":
            tick, idx = ROUTER_DRAIN[1], ROUTER_DRAIN[0]
            check(rep["drains"] == 1 and rep["requeued"] > 0, f"{label}: "
                  f"{rep['drains']} drains, {rep['requeued']} requeued")
            late = [d for d in router.stats.dispatch_log
                    if d[2] == idx and d[0] >= tick]
            check(not late, f"{label}: {len(late)} dispatches to replica "
                  f"{idx} after its drain")
        if run == "health":
            drained = [e for e in mon.events if e["action"] == "drained"]
            check(rep["drained_for_health"] >= 1 and drained
                  and drained[0]["replica"] == ROUTER_DRIFT[0],
                  f"{label}: health events {mon.events}")
            check(not all(router.draining), f"{label}: every replica is "
                  "draining")
        compared, identical = tokens_until_tie(label, reqs, got, want, leads)
        if run == "plain":
            out["pool_bytes"] = [pool_bytes(e) for e in replicas]
        del router, replicas
        # the device's share of the run's ticks: a second fleet set up the
        # same way on the same trace, profiled over a window of its ticks
        # (the measured run stays unprofiled)
        prof_router, _ = fleet(run)
        for r in trace():
            prof_router.submit(r)
        with quantisation_poisoned():
            prof = tick_window(prof_router.step, *ROUTER_PROFILE)
        del prof_router
        fleet_sk = rep["fleet"]
        agg = rep["agg_tokens_per_s"]
        out[run] = dict(
            report={k: v for k, v in rep.items() if k != "per_replica"},
            run_s=run_s, launches=launches, decode_calls=seen["decode"],
            chunk_calls=seen["chunks"], steps_compared=compared,
            requests_identical=identical, profile=prof,
            scaling_efficiency=agg / (n_rep * single_tps),
            router_share=rep["router_s"] / rep["wall_s"],
            health_events=(mon.events if run == "health" else None))
        print(f"phase 14a {label}: {rep['completed']} requests over "
              f"{n_rep} replicas, ticks {rep['ticks']}, agg_tokens_per_s "
              f"{agg} (modeled: router_s + the slowest replica's busy_s), "
              f"scaling efficiency {out[run]['scaling_efficiency']:.3f} "
              f"against the single engine's {single_tps} tokens/s, router_s "
              f"{rep['router_s']} s = {out[run]['router_share']:.4f} of wall "
              f"{rep['wall_s']} s, busy_s {rep['busy_s']}, routed "
              f"{rep['routed']}, affinity hits {rep['affinity_hits']}, "
              f"fleet TTFT p50/p99 {fleet_sk['ttft_sketch']['p50']}/"
              f"{fleet_sk['ttft_sketch']['p99']} s, TPOT p50/p99 "
              f"{fleet_sk['tpot_sketch']['p50']}/"
              f"{fleet_sk['tpot_sketch']['p99']} "
              f"s, requeued {rep['requeued']}, drained "
              f"{rep['drains']} (for health {rep['drained_for_health']}); "
              f"launches {launches}; tokens equal to the single engine's "
              f"through {compared} steps, {identical} of {len(reqs)} "
              f"requests identical throughout; "
              + (f"device {prof['device_ms_per_tick']:.4f} ms a tick of "
                 f"{prof['wall_ms_per_tick']:.4f} (idle "
                 f"{prof['idle_share']:.3f}) over {prof['ticks']} ticks "
                 f"of a second fleet from tick {ROUTER_PROFILE[0]}"
                 if prof else "tick profile: not measured (no device "
                 "times in the trace)"))
        if run == "plain":
            out["param_bytes"] = sum(t.element_size() * t.numel() for t in
                                     tfm.tree_leaves(single.params))
            print(f"phase 14a pools: {out['pool_bytes']} bytes a replica "
                  f"(one deploy shared: {out['param_bytes']} bytes of "
                  "params)")
    check(sorted(captured) == ["down", "up"], f"router: kan_fused inputs "
          f"captured at the tick for {sorted(captured)}")
    for name, layer, asp in (("up", up, asp_up), ("down", down, asp_down)):
        x = captured[name]
        rows.append(check_kan_fused(
            timer, f"router tick {name} [{x.shape[0]}, {x.shape[1]}]", x,
            layer, asp))
        rows[-1]["on_path"] = False
    print(f"phase 14a single engine: {srep['completed']} requests, "
          f"{srep['ticks']} ticks, {single_tps} tokens/s, TTFT p50/p99 "
          f"{srep['ttft_s']['p50']}/{srep['ttft_s']['p99']} s, TPOT p50/p99 "
          f"{srep['tpot_s']['p50']}/{srep['tpot_s']['p99']} s")
    return out, rows, launches_all


def launcher_phase(timer, dev):
    """Phase 14b. Returns the metrics, the ``cim_mac_tiled`` and
    ``kan_basis`` rows by kernel (one per shape the run launched each at,
    in the tick and in prefills) and each kernel's launches in the
    launcher's run."""
    tiled_fn, basis_fn = ops.cim_mac_tiled, ops.kan_basis
    step_fn = decode.decode_step
    rows_n, state = LAUNCH_FLEET_SLOTS, {"tick": False}
    calls = {"tick": 0, "prefill": 0}
    basis_calls = {"tick": 0, "prefill": 0}
    captured = {}   # (codes, rows, where) -> the first launch's inputs
    basis_captured = {}   # (table, rows, I, where) -> the first input

    def in_tick(*args, **kw):
        state["tick"] = True
        try:
            return step_fn(*args, **kw)
        finally:
            state["tick"] = False

    def spy(v, w_codes, row_atten, **kw):
        where = "tick" if state["tick"] else "prefill"
        calls[where] += 1
        v2 = v.reshape(-1, v.shape[-1])
        key = (w_codes.data_ptr(), v2.shape[0], where)
        if key not in captured:
            captured[key] = (v2.clone(), w_codes, row_atten.clone(),
                             dict(kw))
        return tiled_fn(v, w_codes, row_atten, **kw)

    def basis_spy(x, hemi, asp):
        where = "tick" if state["tick"] else "prefill"
        basis_calls[where] += 1
        x2 = x.reshape(-1, x.shape[-1])
        key = (hemi.data_ptr(), x2.shape[0], x2.shape[1], where)
        if key not in basis_captured:
            basis_captured[key] = (x2.clone(), hemi, asp)
        return basis_fn(x, hemi, asp)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "metrics.json"
        ops.cim_mac_tiled, ops.kan_basis = spy, basis_spy
        decode.decode_step = in_tick
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rep = serve_launch.main(
                ["--arch", "kan_llm", "--kan-backend", "cim_tiled",
                 "--replicas", "2", "--drift-replica", "1", "--check",
                 "--slots", str(rows_n), "--requests", "32", "--stagger",
                 "1", "--metrics-out", str(path)])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = ops.launch_counts()
        finally:
            ops.cim_mac_tiled, ops.kan_basis = tiled_fn, basis_fn
            decode.decode_step = step_fn
        snap = json.loads(path.read_text())["metrics"]
    check(launches["cim_mac_tiled"] == calls["tick"] + calls["prefill"]
          and calls["tick"] > 0, f"launcher fleet: cim_mac_tiled launched "
          f"{launches} times, {calls} in ticks and prefills")
    check(launches["kan_basis"] == basis_calls["tick"]
          + basis_calls["prefill"] and basis_calls["tick"] > 0,
          f"launcher fleet: kan_basis launched {launches['kan_basis']} "
          f"times, {basis_calls} in ticks and prefills")
    check(launches["kan_fused"] == 0, f"launcher fleet: kan_fused launched "
          f"{launches['kan_fused']} times on cim_tiled")
    keys = list(snap)
    chip_keys = [k for k in keys if k.startswith("chip_")
                 and not k.startswith(("chip_layer_", "chip_canary",
                                       "chip_adc"))]
    layer_keys = [k for k in keys if k.startswith("chip_layer_")]
    canary = {i: [k for k in keys if k.startswith("chip_canary_rel_dev{")
                  and f'replica="{i}"' in k] for i in range(2)}
    check(len(chip_keys) >= 7 and layer_keys and all(canary.values()),
          f"launcher fleet: chip gauges {chip_keys}, layer gauges "
          f"{len(layer_keys)}, canary gauges {canary}")
    check(rep["drained_for_health"] >= 1, "launcher fleet: no health drain")
    tile = kan_llm.CONFIG.model.kan_spec.cim
    tile = (tile.tile if tile is not None else chip.ChipConfig().tile)
    # every (layer, rows) input the run gave the kernel, on its own
    # attenuation and gains, bit for bit; each shape timed once
    rows, timed = [], set()
    for (_, n, where), (v, w, att, kw) in captured.items():
        # ``rows_iterated`` is the stage counter (None untraced), not a
        # setting
        shown = {k: v for k, v in kw.items()
                 if k not in ("gain", "rows_iterated")}
        check(set(kw) <= {"gain", "array_size", "adc_bits", "in_scale",
                          "rows_iterated"}
              and (kw["array_size"], kw["adc_bits"], kw["in_scale"])
              == (tile.array_size, tile.adc_bits, tile.adc_in_scale),
              f"launcher fleet: the kernel's settings {shown} are not the "
              f"tile's {tile}")
        shape = (where, n, v.shape[1], w.shape[1])
        label = f"launcher {where} [{n}, {v.shape[1]}] -> {w.shape[1]}"
        if shape in timed:
            cim_tiled_held(label, v, w, kw.get("gain"), att, tile)
            continue
        timed.add(shape)
        rows.append(cim_tiled_row(timer, label, v, w, kw.get("gain"), tile,
                                  False, att=att))
    tick_shapes = sorted((r["R"], r["C"]) for r in rows
                         if r["shape"].startswith("launcher tick"))
    check(len(tick_shapes) == 2 and all(
        r["B"] == rows_n for r in rows if r["shape"].startswith(
            "launcher tick")), f"launcher fleet: tick shapes {tick_shapes}")
    # every (layer, rows) input the run gave ``kan_basis``, against the
    # plain basis bit for bit, twice; each shape timed once
    basis_rows, timed = [], set()
    for (_, n, i, where), (x, hemi, asp) in basis_captured.items():
        label = f"launcher {where} [{n}, {i}] G {asp.grid_size}"
        if (where, n, i, asp) in timed:
            kan_basis_held(label, x, hemi, asp)
            continue
        timed.add((where, n, i, asp))
        basis_rows.append(check_kan_basis(timer, label, x, hemi, asp,
                                          False))
    basis_ticks = sorted((r["B"], r["I"]) for r in basis_rows
                         if r["shape"].startswith("launcher tick"))
    check(len(basis_ticks) == 2 and all(b == rows_n for b, _ in basis_ticks),
          f"launcher fleet: kan_basis tick shapes {basis_ticks}")
    out = dict(report={k: v for k, v in rep.items() if k != "per_replica"},
               run_s=run_s, launches=launches, tick_launches=calls["tick"],
               prefill_launches=calls["prefill"],
               inputs_held=len(captured),
               shapes_timed=len(rows),
               basis_tick_launches=basis_calls["tick"],
               basis_prefill_launches=basis_calls["prefill"],
               basis_inputs_held=len(basis_captured),
               basis_shapes_timed=len(basis_rows),
               chip_gauges=len(chip_keys) + len(layer_keys),
               canary_gauges={i: len(c) for i, c in canary.items()})
    print(f"phase 14b launcher fleet (kan_llm on cim_tiled, 2 replicas, "
          f"drift on 1): --check passed in {run_s:.2f} s; cim_mac_tiled "
          f"launched {launches['cim_mac_tiled']} times, {calls['tick']} in "
          f"the tick at {rows_n} rows and {calls['prefill']} in "
          f"prefills; {len(captured)} distinct (layer, rows) inputs held bit "
          f"for bit, {len(rows)} shapes timed; kan_basis launched "
          f"{launches['kan_basis']} times, {basis_calls['tick']} in the "
          f"tick, {len(basis_captured)} distinct inputs held bit for bit, "
          f"{len(basis_rows)} shapes timed; {len(chip_keys)} chip and "
          f"{len(layer_keys)} chip_layer gauges, canary gauges per replica "
          f"{out['canary_gauges']}; drained for health "
          f"{rep['drained_for_health']}, requeued {rep['requeued']}")
    return (out, {"cim_mac_tiled": rows, "kan_basis": basis_rows},
            {k: launches[k] for k in ("cim_mac_tiled", "kan_basis")})


def mixtral_cfg(n_layers):
    return dataclasses.replace(mixtral_8x7b.CONFIG.model, n_layers=n_layers)


@contextlib.contextmanager
def peak_of(peaks, name):
    """``peaks[name]``: the most memory allocated on the card (GB) while
    the block ran."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9


class MoELog(list):
    """``moe_watch``'s record of MoE calls, in order; ``choices``: each
    layer's top-k experts per token over its calls."""
    choices = None


@contextlib.contextmanager
def moe_watch(n_layers, record=None):
    """While active, every ``apply_moe`` call appends to the yielded
    ``log`` its layer (the layers are called in turn), tokens T, the
    experts' slot counts (``bincount`` of the top-k choices), its
    ``moe_drop_frac`` and the router input's token alikeness
    (``|mean of the unit rows|^2``, the mean cosine over token pairs).
    With ``record`` None the top-k choices are made as always and each
    layer's are kept in ``log.choices``; given a record (another run's
    ``choices``), each layer's call takes the next rows of its record,
    with the weights from its own probabilities, so that paths on the same
    tokens route them to the same experts."""
    top_fn, apply_fn = moe_lib.top_k, moe_lib.apply_moe
    log, state = MoELog(), {"calls": 0, "idx": None}
    log.choices = [[] for _ in range(n_layers)]
    pos = [0] * n_layers

    def pick(probs, k):
        layer = state["calls"] % n_layers
        if record is None:
            vals, idx = top_fn(probs, k)
            log.choices[layer].append(idx)
        else:
            t = probs.shape[0]
            idx = record[layer][pos[layer]:pos[layer] + t]
            check(idx.shape[0] == t, f"moe replay: layer {layer} has no "
                  f"choices left for {t} tokens at {pos[layer]}")
            pos[layer] += t
            vals = probs.gather(-1, idx)
        state["idx"] = idx
        return vals, idx

    def watched(params, x, mcfg, **kw):
        y, aux = apply_fn(params, x, mcfg, **kw)
        u = torch.nn.functional.normalize(
            x.reshape(-1, x.shape[-1]).float(), dim=-1)
        log.append(dict(layer=state["calls"] % n_layers, T=u.shape[0],
                        counts=torch.bincount(state["idx"].reshape(-1),
                                              minlength=mcfg.n_experts),
                        drop=aux["moe_drop_frac"],
                        alike=(u.mean(0) ** 2).sum()))
        state["calls"] += 1
        return y, aux
    moe_lib.top_k, moe_lib.apply_moe = pick, watched
    try:
        yield log
    finally:
        moe_lib.top_k, moe_lib.apply_moe = top_fn, apply_fn
        log.choices = [torch.cat(c) if c else None for c in log.choices]


def check_drops(label, log, mcfg):
    """Each call's ``moe_drop_frac`` is the share of slots past capacity
    that its expert counts give, the capacity ``max(1, int(T * top_k *
    capacity_factor / E))`` worked out here; returns the largest
    difference (f32 rounding of the kept mean)."""
    worst = 0.0
    for c in log:
        t = c["T"]
        cap = max(1, int(t * mcfg.top_k * mcfg.capacity_factor
                         / mcfg.n_experts))
        kept = int(torch.clamp(c["counts"], max=cap).sum())
        want = 1.0 - kept / (t * mcfg.top_k)
        err = abs(float(c["drop"]) - want)
        check(err <= 2 ** -20, f"{label}: layer {c['layer']} at T {t} drops "
              f"{float(c['drop']):.7f} of its slots, its counts "
              f"{c['counts'].tolist()} at capacity {cap} give {want:.7f}")
        worst = max(worst, err)
    return worst


def replayed(params, cfg, prompt, toks, record):
    """One prompt's prefill (last logits) and, for ``toks`` [1, n], its
    n - 1 decode steps, on ``record``'s top-k choices; the drop fractions
    of the calls, in order."""
    s = prompt.shape[1]
    n = toks.shape[1] if toks is not None else 1
    with moe_watch(cfg.n_layers, record) as log:
        lp, cache = decode.prefill(params, cfg, {"tokens": prompt}, s + n,
                                   last_only=True)
        steps = []
        for i in range(n - 1):
            ld, cache = decode.decode_step(params, cache, toks[:, i:i + 1],
                                           s + i, cfg)
            steps.append(ld[:, 0])
    del cache
    return (lp[:, -1], torch.stack(steps, dim=1) if steps else None,
            [float(c["drop"]) for c in log])


def forward_routed(params, cfg, tokens, record=None):
    """``forward``'s logits over ``tokens``, timed, recording its top-k
    choices (``record`` None) or on ``record``'s. Returns the logits, the
    choices, the calls' drop fractions and the seconds."""
    with moe_watch(cfg.n_layers, record) as log:
        t0 = time.perf_counter()
        lf, _ = tfm.forward(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
    check(bool(torch.isfinite(lf).all()), f"{cfg.name} forward over "
          f"{tokens.shape[1]} tokens not finite")
    return lf, log.choices, [float(c["drop"]) for c in log], fwd_s


def mixtral_path(cfg, prompt, profile=False):
    """Phase 14c on ``cfg``: ``generate`` at the config's settings (both
    prompts routed together at capacity factor 1.25) with every MoE call's
    drop fraction held to its expert counts (``check_drops``); its prefill
    and decode steps timed (they must repeat generate); the ring cache;
    then each prompt alone through forward, prefill and decode on the top-k
    choices of forward's bf16 run, so that all paths route each token to
    the same experts: at capacity factor 1.25 the prefill's last logits and
    drop fractions against forward over the prompt (the same T, so the
    same capacity and the same slots dropped), and where nothing is
    dropped (capacity factor E / top_k) prefill and decode against forward
    over prompt and tokens; bf16 within twice the bf16 reach on those
    choices (phase 13b's rule for two bf16 paths), the f32 control within
    ``F32_PATH_BAR``. With ``profile``, a profiler breakdown of one prefill
    and three decode steps. Returns the metrics, with each part's peak
    memory."""
    peaks = {}
    with peak_of(peaks, "init"):
        params = tfm.init_model(0, cfg)
    n_params = tfm.count_params(params)
    want_n = tfm.count_params(tfm.init_model(0, cfg, device="meta"))
    check(n_params == want_n, f"mixtral at {cfg.n_layers} layers has "
          f"{n_params:,} parameters, not {want_n:,}")
    mcfg = cfg.moe_cfg
    with moe_watch(cfg.n_layers) as log, peak_of(peaks, "generate"):
        t0 = time.perf_counter()
        toks = decode.generate(params, cfg, prompt, n_new=LM_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
    b, s = prompt.shape
    check(toks.shape == (b, LM_NEW) and bool(((toks >= 0)
                                             & (toks < cfg.vocab)).all()),
          f"mixtral generate gave {tuple(toks.shape)} or tokens out of the "
          "vocabulary")
    check(len(log) == LM_NEW * cfg.n_layers, f"mixtral generate: "
          f"{len(log)} MoE calls, not {LM_NEW} x {cfg.n_layers}")
    drop_err = check_drops("mixtral generate", log, mcfg)
    drops = torch.tensor([float(c["drop"]) for c in log]).reshape(
        LM_NEW, cfg.n_layers)
    prefill_calls = log[:cfg.n_layers]
    with peak_of(peaks, "served_steps"):
        t0 = time.perf_counter()
        lp, cache = decode.prefill(params, cfg, {"tokens": prompt},
                                   s + LM_NEW, last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        step_ms, step_tok = [], []
        for i in range(LM_NEW - 1):
            t0 = time.perf_counter()
            ld, cache = decode.decode_step(params, cache, toks[:, i:i + 1],
                                           s + i, cfg)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            step_tok.append(torch.argmax(ld[:, 0], -1))
    check(torch.equal(torch.argmax(lp[:, -1], -1), toks[:, 0])
          and torch.equal(torch.stack(step_tok, 1), toks[:, 1:]),
          "mixtral: the timed prefill and decode steps do not repeat "
          "generate")
    del lp, ld, cache
    # the rolling cache: window slots, each written
    _, cache = decode.prefill(params, cfg, {"tokens": prompt[:1]},
                              s + LM_NEW, last_only=True)
    k_ring = cache[0]["l0"]["k"]
    ring = int(k_ring.shape[-3])
    written = bool((k_ring.abs().flatten(-2).amax(-1) > 0).all())
    check(ring == cfg.window and written, f"mixtral: the ring cache holds "
          f"{ring} slots (window {cfg.window}), every one written: "
          f"{written}")
    del cache, k_ring
    nd = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    agree, fwd_s = {}, []
    for i in range(b):
        p1, t1 = prompt[i:i + 1], toks[i:i + 1]
        full = torch.cat([p1, t1[:, :-1].to(p1.dtype)], dim=1)
        for tag, c, tokens, t_dec in (("cf1.25", cfg, p1, None),
                                      ("nodrop", nd, full, t1)):
            c32 = dataclasses.replace(c, dtype=torch.float32)
            with peak_of(peaks, f"bf16_{tag}_{i}"):
                lf, rec, drops_f, secs = forward_routed(params, c, tokens)
                lp, ld, drops_p = replayed(params, c, p1, t_dec, rec)
            fwd_s.append(secs)
            with peak_of(peaks, f"f32_{tag}_{i}"):
                lf32, _, _, _ = forward_routed(params, c32, tokens, rec)
                lp32, ld32, _ = replayed(params, c32, p1, t_dec, rec)
            reach = float((lf.float() - lf32).abs().max())
            label = f"{tag}_{i}"
            if t_dec is None:
                # the prompt's last position; the same T, so the same
                # capacity and, on the same choices, the same slots dropped
                check(drops_p == drops_f, f"mixtral {label}: prefill drops "
                      f"{drops_p}, forward {drops_f}")
                for name, a, bb, bar in (
                        ("f32", lp32, lf32[:, -1], F32_PATH_BAR),
                        ("bf16", lp, lf[:, -1], 2 * reach)):
                    err = float((a.float() - bb.float()).abs().max())
                    check(err <= bar, f"mixtral {name}_{label}: prefill vs "
                          f"forward logits differ by {err:.3g} > {bar:.3g}")
                    agree[f"{name}_{label}_prefill_vs_forward_max_abs"] = err
                    agree[f"{name}_{label}_bar"] = bar
                agree[f"{label}_drop_frac"] = drops_f
            else:
                agree.update(paths_agree(f"f32_{label}", lp32, ld32, lf32,
                                         F32_PATH_BAR))
                agree.update(paths_agree(f"bf16_{label}", lp, ld, lf,
                                         2 * reach))
            agree[f"bf16_{label}_reach"] = reach
            del lf, lf32, lp, lp32, ld, ld32, rec
    out = dict(
        layers=cfg.n_layers, params=n_params, generate_s=gen_s,
        prefill_s=prefill_s, decode_ms_median=float(np.median(step_ms)),
        decode_ms_all=[round(t, 3) for t in step_ms],
        forward_s_per_prompt=fwd_s, forward_T=s + LM_NEW - 1,
        drop_frac_prefill=[round(float(d), 6) for d in drops[0]],
        drop_vs_counts_max_abs=drop_err,
        expert_counts_prefill=[c["counts"].tolist() for c in prefill_calls],
        router_input_alike_prefill=[round(float(c["alike"]), 4)
                                    for c in prefill_calls],
        decode_steps_dropping=int((drops[1:] > 0).any(dim=1).sum()),
        decode_drop_frac_mean=float(drops[1:].mean()),
        ring_slots=ring, peaks_gb=peaks, peak_gb=max(peaks.values()),
        **agree)
    if profile:
        out["profile"] = serve_profile(params, cfg, prompt, toks)
    return out


def measured_cut(path_peaks, n_layers):
    """The deepest cut of a model's ``n_layers`` that fits: ``path_peaks(n)``
    runs the phase's path at ``n`` layers and returns each part's peak GB;
    at the ``CALIB`` depths these give each part's peak and its growth per
    layer, and the cut is the most layers whose every part's extrapolated
    peak stays under ``MEM_SHARE`` of the card. Returns (cut, predicted
    peak GB, the calibration peaks, the card's GB)."""
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    n0, n1 = CALIB
    calib = {}
    for n in CALIB:
        torch.cuda.empty_cache()
        calib[n] = path_peaks(n)
    slope = {k: (calib[n1][k] - calib[n0][k]) / (n1 - n0) for k in calib[n0]}

    def peak_at(n):
        return max(calib[n0][k] + slope[k] * (n - n0) for k in slope)
    cut = n_layers
    while cut > n1 and peak_at(cut) > MEM_SHARE * card_gb:
        cut -= 1
    torch.cuda.empty_cache()
    return cut, peak_at(cut), calib, card_gb


def mixtral_phase(dev):
    """Phase 14c: mixtral-8x7b at full width over the deepest cut of its
    32 layers that fits (``measured_cut``)."""
    data = lm_synth.batch_at(lm_synth.LMDataConfig(
        vocab=mixtral_8x7b.CONFIG.model.vocab, batch=MIXTRAL_BATCH,
        seq_len=MIXTRAL_PROMPT, seed=0), 0)
    prompt = torch.from_numpy(data["tokens"]).to(dev)
    cut, predicted, calib, card_gb = measured_cut(
        lambda n: mixtral_path(mixtral_cfg(n), prompt)["peaks_gb"],
        mixtral_8x7b.CONFIG.model.n_layers)
    n0, n1 = CALIB
    cfg = mixtral_cfg(cut)
    t0 = time.perf_counter()
    metrics = mixtral_path(cfg, prompt, profile=True)
    metrics.update(calibration_peaks_gb=calib, predicted_peak_gb=predicted,
                   card_gb=card_gb, path_s=time.perf_counter() - t0)
    print_profile("phase 14c mixtral-8x7b", metrics["profile"],
                  metrics["decode_ms_median"])
    shares = {}
    for what in ("prefill", "decode_step"):
        p = metrics["profile"].get(what)
        if p:
            shares[what] = {k: round(p["span_ms"].get(k, 0.0)
                                     / p["device_ms"], 4)
                            for k in ("moe_expert_products", "moe_dispatch",
                                      "moe_combine")}
    metrics["moe_device_shares"] = shares
    print(f"phase 14c mixtral-8x7b: {cut} of its "
          f"{mixtral_8x7b.CONFIG.model.n_layers} layers "
          f"({metrics['params']:,} parameters; d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads}, {cfg.n_experts} experts "
          f"top-{cfg.top_k}, d_ff {cfg.moe_d_ff}, window {cfg.window}, "
          f"capacity factor {cfg.capacity_factor}); largest part peak at "
          f"{n0} and {n1} layers {max(calib[n0].values()):.2f} and "
          f"{max(calib[n1].values()):.2f} GB, predicted at {cut} layers "
          f"{predicted:.2f}, measured {metrics['peak_gb']:.2f} GB of the "
          f"card's {card_gb:.2f}; prefill {MIXTRAL_BATCH}x{MIXTRAL_PROMPT} "
          f"{metrics['prefill_s']:.3f} s, decode "
          f"{metrics['decode_ms_median']:.2f} ms a step, forward "
          f"(one prompt) T={metrics['forward_T']} "
          f"{metrics['forward_s_per_prompt'][-1]:.3f} s; moe_drop_frac per "
          f"layer at prefill {metrics['drop_frac_prefill']} (held to the "
          f"expert counts within {metrics['drop_vs_counts_max_abs']:.3g} "
          f"at every call), slots per expert at prefill "
          f"{metrics['expert_counts_prefill']}, router inputs' mean cosine "
          f"{metrics['router_input_alike_prefill']}; decode steps dropping "
          f"a slot "
          f"{metrics['decode_steps_dropping']} of {LM_NEW - 1}; device "
          f"shares of the MoE parts {shares}")
    return metrics


# --- phase 15: whisper-base and internvl2-76b served; the LMs trained -------

def static_paths(params, cfg, prompt, extra, n_new):
    """Greedy ``n_new`` tokens through prefill and decode steps on the card
    (the frontend's inputs in ``extra``), then ``teacher_forced`` on them at
    the config's compute dtype and at f32: the f32 control within
    ``F32_PATH_BAR``, the bf16 paths within the reach of bf16 rounding (the
    largest distance between the bf16 and f32 forwards), phase 8's rule.
    Returns the metrics and the bf16 run's times."""
    s = prompt.shape[1]
    logits, cache = decode.prefill(params, cfg, {"tokens": prompt, **extra},
                                   s + n_new, last_only=True)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    toks = [tok]
    for i in range(n_new - 1):
        logits, cache = decode.decode_step(params, cache, tok, s + i, cfg)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        toks.append(tok)
    toks = torch.cat(toks, dim=1)
    del cache
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{cfg.name}: tokens out of the vocabulary")
    lp, ld, lf, times, _ = teacher_forced(params, cfg, prompt, toks, extra)
    check(torch.equal(torch.argmax(lp, -1), toks[:, 0])
          and torch.equal(torch.argmax(ld, -1), toks[:, 1:]),
          f"{cfg.name}: the timed prefill and decode do not repeat greedy")
    lp32, ld32, lf32, _, _ = teacher_forced(
        params, dataclasses.replace(cfg, dtype=torch.float32), prompt, toks,
        extra)
    metrics = paths_agree("f32", lp32, ld32, lf32, F32_PATH_BAR)
    reach = float((lf.float() - lf32).abs().max())
    del lp32, ld32, lf32
    metrics.update(paths_agree("bf16", lp, ld, lf, reach))
    return metrics, times


def whisper_serve_phase(dev):
    """Phase 15a. Returns the metrics."""
    cfg = whisper_base.CONFIG.model
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_model(0, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    lo, hi = WHISPER_PROMPTS
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab,
                                               int(rng.integers(lo, hi + 1))),
                    max_new=WHISPER_NEW, arrival=i // 2,
                    frames=torch.randn((WHISPER_FRAMES, cfg.d_model),
                                       generator=gen, device=dev))
            for i in range(WHISPER_REQUESTS)]
    eng_kw = dict(WHISPER_ENGINE, enc_len=WHISPER_FRAMES, device=dev)
    eng = Engine(params, cfg, recorder=EngineRecorder(), **eng_kw)
    check(eng.chunk_tokens is None and not eng.share_ok,
          "whisper engine: an enc-dec must prefill whole, unshared")
    for frames, what in ((reqs[0].frames[:-100], "frames length"),
                         (None, "no frames")):
        try:
            eng.submit(Request(rid="bad", tokens=reqs[0].tokens, max_new=2,
                               frames=frames))
        except ValueError as e:
            check(what in str(e), f"whisper engine: {e}")
        else:
            check(False, f"whisper engine took a request with {what}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    comps = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check_launches("whisper engine", launches, {})
    rep = eng.stats.report()
    got = {c.rid: [int(t) for t in c.tokens] for c in comps}
    check(len(comps) == len(reqs) and all(
        len(got[r.rid]) == r.max_new for r in reqs),
        "whisper engine: a request did not complete its budget")
    # each request alone, teacher-forced on the engine's tokens, within
    # twice the bf16 reach of its prefill (phase 13b's rule)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    compared, tied = 0, 0
    for r in reqs:
        prompt = torch.from_numpy(r.tokens.astype(np.int64)).to(dev)
        extra = {"frames": r.frames[None]}
        argmax, leads, last, _ = solo_forced(params, cfg, prompt,
                                             got[r.rid], extra)
        l32, _ = decode.prefill(params, cfg32, {"tokens": prompt[None],
                                                **extra},
                                len(prompt) + 1, last_only=True)
        bar = 2 * float((last - l32[0, -1]).abs().max())
        compared += solo_agrees("whisper engine", r.rid, got[r.rid], argmax,
                                leads, bar)
        tied += until_tie(leads, bar) < len(leads)
    # encode and prefill alone, batch 1, synchronized
    r0 = reqs[0]
    b0 = {"tokens": torch.from_numpy(r0.tokens.astype(np.int64)).to(dev)[None],
          "frames": r0.frames[None]}
    enc_ms, pre_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        tfm.encode(params, cfg, b0)
        torch.cuda.synchronize()
        enc_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        decode.prefill(params, cfg, b0, WHISPER_ENGINE["max_len"],
                       last_only=True)
        torch.cuda.synchronize()
        pre_ms.append(1e3 * (time.perf_counter() - t0))
    prof = engine_profile(params, cfg, reqs, eng_kw, warm=4, n_ticks=4)
    # the static f32 control on a batch of prompts and frames
    nb, ns, nn = WHISPER_STATIC
    prompt = torch.from_numpy(lm_synth.batch_at(lm_synth.LMDataConfig(
        vocab=cfg.vocab, batch=nb, seq_len=ns, seed=0), 0)["tokens"]).to(dev)
    extra = {"frames": torch.randn((nb, WHISPER_FRAMES, cfg.d_model),
                                   generator=gen, device=dev)}
    paths, times = static_paths(params, cfg, prompt, extra, nn)
    out = dict(report=rep, run_s=run_s, launches=launches,
               solo_clear_steps_compared=compared,
               requests_with_a_near_tie=tied,
               encode_ms_median=float(np.median(enc_ms)),
               prefill_ms_median=float(np.median(pre_ms)),
               decode_ms_per_tick=(prof.get("device_ms_per_decode_tick")
                                   if prof else None),
               decode_wall_ms_per_tick=(prof.get("wall_ms_per_decode_tick")
                                        if prof else None),
               static_decode_ms_median=float(np.median(times["step_ms"])),
               tokens_per_s=rep["tokens_per_s"], profile=prof,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, **paths)
    print_engine("phase 15a whisper-base engine", rep, prof, launches,
                 f"; run {run_s:.3f} s, clear solo steps compared {compared}"
                 f", encode (1 x {WHISPER_FRAMES} frames) "
                 f"{out['encode_ms_median']:.2f} ms, prefill with it "
                 f"{out['prefill_ms_median']:.2f} ms, static decode "
                 f"{out['static_decode_ms_median']:.2f} ms a step of {nb}, "
                 f"peak {out['peak_gb']:.2f} GB")
    return out


def vlm_path(cfg, prompt, vision):
    """Phase 15b on ``cfg``: init, the static paths (prefill and decode
    against forward, bf16 against the f32 control) with the patch
    embeddings over the first positions. Returns the metrics with each
    part's peak memory."""
    peaks = {}
    with peak_of(peaks, "init"):
        params = tfm.init_model(0, cfg)
    n = tfm.count_params(params)
    check(n == tfm.count_params(tfm.init_model(0, cfg, device="meta")),
          f"internvl2 at {cfg.n_layers} layers: {n:,} parameters")
    with peak_of(peaks, "paths"):
        metrics, times = static_paths(params, cfg, prompt,
                                      {"vision_embeds": vision}, VLM_NEW)
    # the patch embeddings reach the logits
    with torch.no_grad(), peak_of(peaks, "forward_without_vision"):
        plain = decode.prefill(params, cfg, {"tokens": prompt}, prompt.shape[1],
                               last_only=True)[0]
        seen = decode.prefill(params, cfg, {"tokens": prompt,
                                            "vision_embeds": vision},
                              prompt.shape[1], last_only=True)[0]
        check(not torch.equal(plain, seen), "internvl2: the vision "
              "embeddings do not change the logits")
    del params
    metrics.update(params=n, peaks_gb=peaks,
                   peak_gb=max(peaks.values()), prefill_s=times["prefill_s"],
                   decode_ms_median=float(np.median(times["step_ms"])),
                   forward_s=times["forward_s"], forward_T=times["forward_T"])
    return metrics


def internvl2_phase(dev):
    """Phase 15b: internvl2-76b at full width over the deepest cut of its 80
    layers that fits, measured as phase 14c's mixtral."""
    full = internvl2_76b.CONFIG.model
    n_full = tfm.count_params(tfm.init_model(0, full, device="meta"))
    check(n_full == INTERNVL2_PARAMS, f"internvl2-76b has {n_full:,} "
          f"parameters, not {INTERNVL2_PARAMS:,}")
    prompt = torch.from_numpy(lm_synth.batch_at(lm_synth.LMDataConfig(
        vocab=full.vocab, batch=VLM_BATCH, seq_len=VLM_PROMPT, seed=0),
        0)["tokens"]).to(dev)
    vision = torch.randn((VLM_BATCH, full.n_vision_patches, full.d_model),
                         generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    cut, predicted, calib, card_gb = measured_cut(
        lambda n: vlm_path(dataclasses.replace(full, n_layers=n), prompt,
                           vision)["peaks_gb"], full.n_layers)
    n0, n1 = CALIB
    cfg = dataclasses.replace(full, n_layers=cut)
    t0 = time.perf_counter()
    m = vlm_path(cfg, prompt, vision)
    m.update(cut=cut, full_params=n_full, calibration_peaks_gb=calib,
             predicted_peak_gb=predicted, card_gb=card_gb,
             path_s=time.perf_counter() - t0)
    check(m["peak_gb"] <= MEM_SHARE * card_gb, f"internvl2: peak "
          f"{m['peak_gb']:.2f} GB past {MEM_SHARE:.0%} of the card")
    print(f"phase 15b internvl2-76b: {cut} of its {full.n_layers} layers "
          f"({m['params']:,} of {n_full:,} parameters; d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.n_vision_patches} vision "
          f"patches); largest part peak at {n0} and {n1} layers "
          f"{max(calib[n0].values()):.2f} and {max(calib[n1].values()):.2f} "
          f"GB, predicted at {cut} {predicted:.2f}, measured "
          f"{m['peak_gb']:.2f} GB of {card_gb:.2f}; prefill "
          f"{VLM_BATCH}x{VLM_PROMPT} {m['prefill_s']:.3f} s, decode "
          f"{m['decode_ms_median']:.2f} ms a step, forward T="
          f"{m['forward_T']} {m['forward_s']:.3f} s; prefill/decode vs "
          f"forward bf16 {m['bf16_prefill_vs_forward_max_abs']:.3g}/"
          f"{m['bf16_decode_vs_forward_max_abs']:.3g} (reach "
          f"{m['bf16_bar']:.3g}), f32 {m['f32_prefill_vs_forward_max_abs']:.3g}"
          f"/{m['f32_decode_vs_forward_max_abs']:.3g}")
    return m


def train_timing(step, n_sync, n_window, n_prof):
    """``step()`` runs one training step. Milliseconds a step: the median
    of ``n_sync`` steps each ending in a synchronize (none: NaN, for the
    caller to fill) and the mean over a window of ``n_window`` steps with
    one synchronize at its end; then the
    device's busy time per step from a ``torch.profiler`` trace of
    ``n_prof`` steps and its idle share of each."""
    torch.cuda.synchronize()
    t0, ends = time.perf_counter(), []
    for _ in range(n_sync):
        step()
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    sync_ms = (float(np.median(np.diff([t0] + ends))) * 1e3 if n_sync
               else float("nan"))
    t0 = time.perf_counter()
    for _ in range(n_window):
        step()
    torch.cuda.synchronize()
    window_ms = 1e3 * (time.perf_counter() - t0) / n_window
    out = dict(step_ms_synchronized_median=sync_ms, step_ms_window=window_ms)
    prof = tick_window(step, 0, n_prof)
    if prof:
        busy = prof["device_ms_per_tick"]
        out.update(device_ms_per_step=busy,
                   profiled_wall_ms_per_step=prof["wall_ms_per_tick"],
                   idle_share_window=1 - busy / window_ms,
                   idle_share_synchronized=1 - busy / sync_ms)
    else:
        out["device_ms_per_step"] = None    # not measured
    return out


def stepper(params, cfg, opt, batch_at):
    """A ``train_timing`` step over ``make_train_step``, carrying its
    params and state; ``batch_at(i)`` gives step i's batch."""
    step_fn = make_train_step(cfg, opt, TrainConfig())
    st = {"p": params, "s": opt.init(params), "i": 0, "losses": []}

    def step():
        st["p"], st["s"], m = step_fn(st["p"], st["s"], batch_at(st["i"]))
        st["losses"].append(m["loss"])
        st["i"] += 1
    return step, st


@contextlib.contextmanager
def fused_calls(record):
    """While active, ``record["calls"]`` counts calls of
    ``ops.kan_spline_fused`` (the training forward's KAN layers) and
    ``record["inputs"]`` keeps the first (x as rows [N, I], coeffs, asp)
    per input shape."""
    fn = ops.kan_spline_fused
    record.setdefault("calls", 0)
    record.setdefault("inputs", {})

    def spy(x, coeffs, asp):
        record["calls"] += 1
        flat = x.detach().reshape(-1, x.shape[-1])
        key = tuple(flat.shape)
        if key not in record["inputs"]:
            record["inputs"][key] = (flat.clone(), coeffs.detach().clone(),
                                     asp)
        return fn(x, coeffs, asp)
    ops.kan_spline_fused = spy
    try:
        yield record
    finally:
        ops.kan_spline_fused = fn


def kan_calls_per_step(cfg):
    """``kan_spline_fused`` calls a training step makes, from the config:
    each KAN-FFN's spline layers once in the forward and, with remat, once
    more when the backward recomputes its block."""
    n_ffn = sum(sp.ffn == "kan" for sp in cfg.layer_specs())
    return n_ffn * cfg.kan_spec.n_layers * (2 if cfg.remat else 1)


KAN_REF = {}   # phase 15c.1's card gradients at step 0 and their reach


def grads_vs_cpu(params, cfg, batch):
    """One step's gradients on the card against the CPU's plain run on the
    same weights and batch, leaf by leaf. Both round in f32, in different
    orders, so every entry is held to ``tests/test_torch_train.py``'s bar
    (``atol 1e-5, rtol 1e-5``) plus twice the reach of f32 rounding on
    these weights and tokens, measured on the CPU alone: the largest
    distance, in the leaf, between the CPU's gradient and the same run
    with float64 weights and compute dtype (its KAN spline sums and the
    loss's softmax stay f32). Two f32 paths each within that reach of one
    result are within twice it of each other (phase 13b's rule). The
    card's gradients and each leaf's reach are kept in ``KAN_REF`` for
    phase 16a, which holds the mesh's step 0 to them."""
    _, _, g_card = value_and_grad(tfm.loss_fn, params, cfg, batch)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    _, _, g_cpu = value_and_grad(
        tfm.loss_fn, tfm.tree_map(lambda t: t.cpu(), params), cfg, cpu_batch)
    _, _, g_64 = value_and_grad(
        tfm.loss_fn, tfm.tree_map(lambda t: t.cpu().double(), params),
        dataclasses.replace(cfg, dtype=torch.float64), cpu_batch)
    n_past, worst_rel, worst_reach = 0, 0.0, 0.0
    KAN_REF.clear()
    KAN_REF.update(want=[], reach=[])
    for a, b, c in zip(tfm.tree_leaves(g_card), tfm.tree_leaves(g_cpu),
                       tfm.tree_leaves(g_64)):
        KAN_REF["want"].append(a.cpu())
        a, b = a.cpu().double(), b.double()
        reach = float((b - c).abs().max())
        KAN_REF["reach"].append(reach)
        scale = max(float(b.abs().max()), 1e-30)
        n_past += int(((a - b).abs() > GRAD_ATOL + GRAD_RTOL * b.abs()
                       + 2 * reach).sum())
        worst_rel = max(worst_rel, float((a - b).abs().max()) / scale)
        worst_reach = max(worst_reach, reach / scale)
    check(n_past == 0, f"{cfg.name}: card vs CPU gradients: {n_past} "
          f"entries past the bar, worst {worst_rel:.3g} of the leaf's "
          f"largest (f32 reach {worst_reach:.3g})")
    return dict(grad_entries_past_bar=n_past,
                grad_max_err_over_leaf_max=worst_rel,
                grad_f32_reach_over_leaf_max=worst_reach)


def kan_llm_training(timer, dev, ck):
    """Phase 15c.1: ``kan_llm`` on ``fused`` through ``launch.train`` in
    two runs (60 steps saving every 20, then resumed to 80), launch-counted
    against the calls the code makes; ``kan_fused`` at the training shapes
    against its plain version; one step's gradients against the CPU; the
    step times. Returns the metrics, the kernel rows and the launches."""
    cfg = dataclasses.replace(kan_llm.CONFIG.model, kan_backend="fused")
    kt = KAN_TRAIN
    argv = ["--arch", "kan_llm", "--kan-backend", "fused", "--batch",
            str(kt["batch"]), "--seq", str(kt["seq"]), "--ckpt-dir", ck,
            "--save-every", str(kt["save_every"]), "--log-every", "20"]
    torch.cuda.reset_peak_memory_stats()
    runs, launches, rec = [], 0, {}
    for steps in kt["steps"]:
        out = io.StringIO()
        ops.reset_launch_counts()
        with fused_calls(rec), contextlib.redirect_stdout(out):
            runs.append(train_launch.main(argv + ["--steps", str(steps)]))
        n = ops.launch_counts()
        print(out.getvalue(), end="")
        want = (steps - runs[-1]["start"]) * kan_calls_per_step(cfg)
        check(n["kan_fused"] == want and rec["calls"] - launches == want,
              f"kan_llm training: kan_fused launched {n['kan_fused']} times "
              f"in {steps - runs[-1]['start']} steps, not {want}")
        check_launches("kan_llm training", n, {"kan_fused": want})
        launches += n["kan_fused"]
    check("resumed from step 60" in out.getvalue() and runs[1]["start"] ==
          kt["steps"][0], "kan_llm training: run 2 did not resume at 60")
    losses = runs[0]["losses"] + runs[1]["losses"]
    check(len(losses) == kt["steps"][1] and all(np.isfinite(losses)),
          "kan_llm training: a loss is missing or not finite")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    check(last < first - 0.1, f"kan_llm training: loss {first:.4f} -> "
          f"{last:.4f} did not fall")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # kan_fused at the training shapes, as phase 3 holds it
    krows = []
    for shape, (x, coeffs, asp) in sorted(rec["inputs"].items()):
        codes, scale = quant.quantize_coeffs(coeffs, asp, axis=(0, 1))
        layer = types.SimpleNamespace(codes=codes.contiguous(), scale=scale,
                                      hemi=quant.hemi_for(asp, dev))
        r = check_kan_fused(timer, f"train [{shape[0]}, {shape[1]}] -> "
                            f"{codes.shape[-1]}", x, layer, asp)
        r["on_path"] = False
        krows.append(r)
    # one step's gradients, card against CPU, on the twin's weights at init
    dcfg = lm_synth.LMDataConfig(vocab=cfg.vocab, batch=kt["batch"],
                                 seq_len=kt["seq"])
    batch_at = lambda i: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                          for k, v in lm_synth.batch_at(dcfg, i).items()}
    params = tfm.init_model(0, cfg)
    grads = grads_vs_cpu(params, cfg, batch_at(0))
    opt = make_optimizer("adamw", warmup_cosine(3e-4, 10, kt["steps"][1]))
    step, st = stepper(params, cfg, opt, batch_at)
    ops.reset_launch_counts()
    timing = train_timing(step, *TRAIN_TIMING)
    n = ops.launch_counts()["kan_fused"]
    check(n == st["i"] * kan_calls_per_step(cfg), f"kan_llm timing: "
          f"kan_fused launched {n} times in {st['i']} steps")
    launches += n
    out = dict(losses_first_last=[losses[0], losses[-1]],
               loss_first10=first, loss_last10=last,
               resumed_at=runs[1]["start"], launches=launches,
               calls_per_step=kan_calls_per_step(cfg), peak_gb=peak,
               **grads, **timing)
    return out, krows, launches


def whisper_training(dev):
    """Phase 15c.2: whisper-base, 10 AdamW steps at lr 1e-3 on batches of
    8 x 1500 frames and 448 tokens (each step synchronized), then the
    window and the profile."""
    cfg = whisper_base.CONFIG.model
    wt = WHISPER_TRAIN
    dcfg = lm_synth.LMDataConfig(vocab=cfg.vocab, batch=wt["batch"],
                                 seq_len=wt["seq"])

    def batch_at(i):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in lm_synth.batch_at(dcfg, i).items()}
        b.update(train_launch.stub_inputs(cfg, wt["batch"], wt["frames"], i,
                                          dev))
        return b
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_model(0, cfg)
    opt = make_optimizer("adamw", lambda s: torch.tensor(wt["lr"]))
    step, st = stepper(params, cfg, opt, batch_at)
    ops.reset_launch_counts()
    timing = train_timing(step, wt["steps"], *TRAIN_TIMING[1:])
    check_launches("whisper training", ops.launch_counts(), {})
    losses = [float(v) for v in st["losses"][:wt["steps"]]]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.5,
          f"whisper training: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return dict(losses=losses, peak_gb=torch.cuda.max_memory_allocated()
                / 1e9, **timing)


def mamba2_training(timer, dev):
    """Phase 15c.3: mamba2-1.3b, all 48 layers, batches of 2 x 2048: every
    leaf's gradient finite and nonzero; layer 0's SSD gradients through the
    autograd Function against the plain chunked form's on the card, with
    the Function's backward time beside the kernel's forward; then 5 AdamW
    steps through ``launch.train`` (ssd_scan twice a layer a step: the
    forward and the block's recompute), the window and the profile.
    Returns the metrics, the ``ssd_scan`` row and its launches."""
    cfg = mamba2_1p3b.CONFIG.model
    mt = MAMBA_TRAIN
    dcfg = lm_synth.LMDataConfig(vocab=cfg.vocab, batch=mt["batch"],
                                 seq_len=mt["seq"])
    batch_at = lambda i: {k: torch.from_numpy(v).to(dev)  # noqa: E731
                          for k, v in lm_synth.batch_at(dcfg, i).items()}
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_model(0, cfg)
    ops.reset_launch_counts()
    loss, _, grads = value_and_grad(tfm.loss_fn, params, cfg, batch_at(0))
    n_grad = ops.launch_counts()["ssd_scan"]
    check(n_grad == 2 * cfg.n_layers, f"mamba2 gradients: ssd_scan launched "
          f"{n_grad} times, not {2 * cfg.n_layers}")
    dead = [i for i, g in enumerate(tfm.tree_leaves(grads))
            if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0]
    check(not dead and bool(torch.isfinite(loss)), f"mamba2 gradients: "
          f"leaves {dead} not finite or all zero")
    n_leaves = len(tfm.tree_leaves(grads))
    del grads
    # layer 0's scan through the Function against the plain form
    s = layer0_scan_inputs(params, cfg, batch_at(0)["tokens"])
    names = ("x", "dt", "a", "B", "C", "d_skip")
    gen = torch.Generator(device=dev).manual_seed(1)
    dy = torch.randn(s["x"].shape, generator=gen, device=dev)
    b, t, h, p = s["x"].shape
    ds = torch.randn((b, h, p, s["B"].shape[-1]), generator=gen, device=dev)

    def fn_grads(fn):
        leaves = [s[k].detach().clone().requires_grad_() for k in names]
        y, st_ = fn(*leaves, chunk=cfg.ssm_chunk)
        return torch.autograd.grad((y, st_), leaves, (dy, ds))
    got = fn_grads(ops.ssd_state)
    want = fn_grads(ref.ssd_chunked_ref)
    seq = fn_grads(lambda *a, chunk: ref.ssd_ref(*a))
    worst, worst_seq = 0.0, 0.0
    for k, g, w, q in zip(names, got, want, seq):
        check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
              f"mamba2 layer 0: d{k} not finite or zero")
        tol = SSD_ATOL + SSD_RTOL * w.abs()
        worst = max(worst, float(((g - w).abs() / tol).max()))
        worst_seq = max(worst_seq, float((g - q).abs().max())
                        / float(q.abs().max()))
    check(worst <= 1.0, f"mamba2 layer 0: Function gradients vs the plain "
          f"form's: max err/tol {worst:.3g}")
    check(worst_seq <= SSD_SEQ_GRAD_REL, f"mamba2 layer 0: Function "
          f"gradients vs the sequential scan's: {worst_seq:.3g} of a leaf's "
          f"largest")
    row = check_ssd_scan(timer, f"train [{b}, {t}, {h}, {p}]", s,
                         cfg.ssm_chunk)
    row["grad_vs_plain_err_over_tol"] = worst
    row["grad_vs_sequential_over_leaf_max"] = worst_seq
    fwd_bwd = timer.ms(lambda: fn_grads(ops.ssd_state), reps=3, warmup=1)
    row["function_forward_backward_ms"] = fwd_bwd
    row["function_backward_ms"] = fwd_bwd - row["ms"]
    row["plain_forward_backward_ms"] = timer.ms(
        lambda: fn_grads(ref.ssd_chunked_ref), reps=3, warmup=1)
    del s, got, want, seq, params
    torch.cuda.empty_cache()
    # 5 AdamW steps through the launcher, each synchronized by its log line
    out_io = io.StringIO()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(out_io):
        run = train_launch.main(["--arch", "mamba2_1p3b", "--steps",
                                 str(mt["steps"]), "--batch",
                                 str(mt["batch"]), "--seq", str(mt["seq"]),
                                 "--log-every", "1"])
    print(out_io.getvalue(), end="")
    n = ops.launch_counts()["ssd_scan"]
    check_launches("mamba2 training", ops.launch_counts(),
                   {"ssd_scan": 2 * cfg.n_layers * mt["steps"]})
    check(all(np.isfinite(run["losses"])), "mamba2 training: loss not finite")
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    params = tfm.init_model(0, cfg)
    opt = make_optimizer("adamw", warmup_cosine(3e-4, 10, 100))
    step, st = stepper(params, cfg, opt, batch_at)
    ops.reset_launch_counts()
    timing = train_timing(step, 0, *MAMBA_TIMING)
    n_t = ops.launch_counts()["ssd_scan"]
    check(n_t == 2 * cfg.n_layers * st["i"], f"mamba2 timing: ssd_scan "
          f"launched {n_t} times in {st['i']} steps")
    timing["step_ms_synchronized_median"] = 1e3 * float(
        np.median(run["step_s"][1:]))
    if timing["device_ms_per_step"]:
        timing["idle_share_synchronized"] = (
            1 - timing["device_ms_per_step"]
            / timing["step_ms_synchronized_median"])
    out = dict(losses=run["losses"], leaves_with_gradient=n_leaves,
               grad_vs_plain_err_over_tol=worst,
               grad_vs_sequential_over_leaf_max=worst_seq, peak_gb=peak,
               launches=n + n_grad + n_t, **timing)
    return out, row, n + n_grad + n_t


def training_phase(timer, dev):
    """Phase 15c. Returns the metrics, the kernel rows and the launches."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        kan, krows, kl = kan_llm_training(timer, dev, str(Path(tmp) / "ck"))
        kan["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    whisper = whisper_training(dev)
    whisper["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mamba, srow, sl = mamba2_training(timer, dev)
    mamba["phase_s"] = time.perf_counter() - t0
    for label, m in (("kan_llm (fused)", kan), ("whisper-base", whisper),
                     ("mamba2-1.3b", mamba)):
        dev_ms = m.get("device_ms_per_step")
        print(f"phase 15c {label}: {m['step_ms_synchronized_median']:.2f} ms "
              f"a step synchronized, {m['step_ms_window']:.2f} over the "
              f"window, device "
              + (f"{dev_ms:.2f} ms (idle {m['idle_share_window']:.3f} of the "
                 f"window, {m['idle_share_synchronized']:.3f} synchronized)"
                 if dev_ms else "not measured")
              + f", peak {m['peak_gb']:.2f} GB")
    return dict(kan_llm=kan, whisper=whisper, mamba2=mamba), krows, srow, \
        kl, sl


# --- phase 16: LM training sharded over a DeviceMesh of ranks on the card ---

MESH_BACKEND = "gloo"      # NCCL refuses two ranks on one card
MESH_KAN = dict(mesh=(2, 2), batch=16, seq=512, steps=4, resume_at=2)
MESH_MAMBA = dict(mesh=(1, 2), batch=2, seq=2048, steps=3, layers=3)
MESH_MIXTRAL = dict(mesh=(1, 2), layers=1, batch=2, seq=256)
MESH_LOSS_REL = 1e-4       # a mesh run's loss against the single card's
PSUM_SHAPE = (8, 4096)     # the reference's test: one row per rank
PSUM_REL = 0.02
SRC = Path(__file__).resolve().parent / "src"
# phase 17: serving under a mesh of gloo ranks sharing the card, through
# launch.serve --mesh-model 2: kan_llm on fused at full width on 2x2 with
# phase 13a's engine (16 slots, pages of 64, the 128-token common prefix,
# prompts up to 512 and 64 new tokens; 12 requests, the launcher's
# prompts of 256-512 and budgets of 32-64), mamba2-1.3b at full width on
# 1x2 with 13b's pages and chunks, computing in f32 so that its tokens can
# be held to F32_PATH_BAR (at bf16 twice the bf16 reach covers every
# step's lead); 2 requests of 384-768 tokens, 4-8 new, 1 slot so that
# --check sees a slot reused; then the dry run on the fake group: the
# reference's CI cell and one production cell
SERVE17_KAN = dict(mesh=(2, 2), requests=12, slots=16, page_size=64,
                   prompt_len=512, common_prefix=128, new_tokens=64)
SERVE17_MAMBA = dict(mesh=(1, 2), requests=2, slots=1, page_size=64,
                     prompt_len=768, common_prefix=0, new_tokens=8,
                     dtype=torch.float32)
SERVE17_PROFILE = (3, 4)   # unprofiled ticks, then profiled ticks
DRYRUN17 = (("mamba2_1p3b", "decode_32k", True, "4x2"),
            ("kan_llm", "decode_32k", False, ""))


def torchrun_start(n, args, log):
    """Start ``n`` ranks of ``args`` under ``torchrun --standalone`` (one
    process a rank, all on the card), its standard output to ``log`` and
    its errors to ``log`` + ``.err``; returns the run for ``torchrun_all``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), *args]
    # ranks sharing the card free and reuse memory in turns: expandable
    # segments let a rank hand back what it freed
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")]),
        PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    log = Path(log)
    with open(log, "w") as out, open(f"{log}.err", "w") as err:
        proc = subprocess.Popen(cmd, env=env, stdout=out, stderr=err)
    return dict(proc=proc, t0=time.perf_counter(), args=args, log=log)


def torchrun_all(runs, timeout=900):
    """Wait for every started run of ``runs`` (side by side); each one's
    seconds end at its own exit. A nonzero exit, or a run past ``timeout``
    seconds, fails the phase and stops the runs still going. Returns each
    run's (standard output, seconds)."""
    secs = {}
    try:
        while len(secs) < len(runs):
            for i, r in enumerate(runs):
                if i in secs:
                    continue
                rc = r["proc"].poll()
                took = time.perf_counter() - r["t0"]
                if rc is None:
                    check(took < timeout, f"torchrun {' '.join(r['args'][:3])}"
                          f": past {timeout} s")
                    continue
                secs[i] = took
                err = [ln for ln in Path(f"{r['log']}.err").read_text()
                       .splitlines() if "Error" in ln or "error:" in ln
                       or "Traceback" in ln][-12:]
                check(rc == 0, f"torchrun {' '.join(r['args'][:3])}: exit "
                      f"{rc}; " + " | ".join(err))
            time.sleep(0.2)
    except BaseException:
        torchrun_stop(runs)
        raise
    return [(r["log"].read_text(), secs[i]) for i, r in enumerate(runs)]


def torchrun_stop(runs):
    """Stop every run of ``runs`` still going (torchrun stops its ranks)."""
    for r in runs:
        if r["proc"].poll() is None:
            r["proc"].terminate()
            try:
                r["proc"].wait(60)
            except subprocess.TimeoutExpired:
                r["proc"].kill()
                r["proc"].wait()


def torchrun(n, args, log, timeout=900):
    """``n`` ranks of ``args`` under ``torchrun --standalone``, to their
    end; returns (standard output, seconds)."""
    return torchrun_all([torchrun_start(n, args, log)], timeout)[0]


def rank_tasks(tasks, out_dir, timeout=900):
    """``RANK_TASKS[name]`` on ``n`` ranks of this script for every (name,
    n) of ``tasks``, side by side (a torchrun each, all on the card);
    returns each task's (results in rank order, seconds)."""
    runs = [torchrun_start(n, [__file__, "--rank-task", name, "--out",
                               str(out_dir)], Path(out_dir) / f"{name}.log")
            for name, n in tasks]
    secs = [s for _, s in torchrun_all(runs, timeout)]
    return [([json.loads((Path(out_dir) / f"{name}.{r}.json").read_text())
              for r in range(n)], s) for (name, n), s in zip(tasks, secs)]


def mesh_step_metrics(step):
    """Two steps of a mesh run on this rank: the first timed (from and to
    a synchronize) with its collectives counted (calls and input bytes by
    op), the second under the profiler (the device's busy ms and its idle
    share of the timed step)."""
    cb = CollectiveBytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with cb:
        step()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    out = dict(step_ms_synchronized=ms, collective_calls=cb.calls,
               collective_bytes=cb.bytes, device_ms_per_step=None)
    prof = tick_window(step, 0, 1)
    if prof:
        out.update(device_ms_per_step=prof["device_ms_per_tick"],
                   profiled_wall_ms_per_step=prof["wall_ms_per_tick"],
                   idle_share=1 - prof["device_ms_per_tick"] / ms)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def gathered_vs(label, grads, want, reach):
    """Every DTensor leaf of ``grads`` gathered whole (a collective: every
    rank calls this) and, where ``want`` is given (rank 0), held to it
    leaf by leaf at ``GRAD_ATOL + GRAD_RTOL * |want|`` plus twice the
    leaf's ``reach``; returns the counts (rank 0) or {}."""
    n_past, worst, n, by_leaf = 0, 0.0, 0, []
    paths = list(ckpt_paths(grads))
    for i, g in enumerate(tfm.tree_leaves(grads)):
        full = shlib.full(g)
        if want is None:
            del full
            continue
        a, b = full.reshape(-1), want[i].reshape(-1)
        past, err, scale, x = 0, 0.0, 1e-30, None
        y = d = x
        for j in range(0, a.numel(), 1 << 26):   # on the card, in chunks
            x, y = a[j:j + (1 << 26)], b[j:j + (1 << 26)].to(a.device)
            d = (x - y).abs()
            past += int((d > GRAD_ATOL + GRAD_RTOL * y.abs()
                         + 2 * reach[i]).sum())
            err = max(err, float(d.max()))
            scale = max(scale, float(y.abs().max()))
        n += a.numel()
        del full, a, x, y, d
        n_past += past
        worst = max(worst, err / scale)
        by_leaf.append((past, err / scale, paths[i], err, reach[i], scale))
    if want is None:
        return {}
    top = sorted(by_leaf, reverse=True)[:3]
    check(n_past == 0, f"{label}: mesh vs single-card gradients: {n_past} "
          f"of {n} entries past the bar, worst {worst:.3g} of the leaf's "
          f"largest; leaves (past, err/largest, path, err, reach, largest) "
          f"{top}")
    return dict(grad_entries=n, grad_entries_past_bar=n_past,
                grad_max_err_over_leaf_max=worst,
                worst_leaves=[list(t) for t in top])


def ckpt_paths(tree):
    """The leaf paths of ``tree`` (the checkpoint's keys), in
    ``tfm.tree_leaves`` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            for p in ckpt_paths(v):
                yield f"{k}/{p}" if p else str(k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            for p in ckpt_paths(v):
                yield f"{i}/{p}" if p else str(i)
    else:
        yield ""


def grads_cpu(params, cfg, batch):
    """One step's gradients on this card, each leaf moved to the CPU."""
    _, _, g = value_and_grad(tfm.loss_fn, params, cfg, batch)
    out = [t.cpu() for t in tfm.tree_leaves(g)]
    del g
    return out


def mesh_batch(cfg, batch, seq, step, dev, mesh):
    dcfg = lm_synth.LMDataConfig(vocab=cfg.vocab, batch=batch, seq_len=seq)
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in lm_synth.batch_at(dcfg, step).items()}
    return b, train_launch.place_batch(b, mesh)


def psum_check(dev, world):
    """16d: ``psum_int8_error_feedback`` over every rank, one gradient row
    per rank (seeded, the same on every rank)."""
    r = dist.get_rank()
    rows = torch.randn((world,) + PSUM_SHAPE,
                       generator=torch.Generator().manual_seed(0))
    g = rows[r].to(dev)
    ef = torch.zeros(g.numel(), device=dev)
    compress.psum_int8_error_feedback({"w": g}, {"w": ef})   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg, new_ef = compress.psum_int8_error_feedback({"w": g}, {"w": ef})
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    avg, new_ef = avg["w"], new_ef["w"]
    codes, scale, _, n = compress.compress_leaf(g, ef)
    c_cpu, s_cpu, _, _ = compress.compress_leaf(g.cpu(), ef.cpu())
    check(torch.equal(codes.cpu(), c_cpu) and torch.equal(scale.cpu(), s_cpu),
          "psum: the card's int8 codes differ from the CPU's")
    deq = compress._dequantize(codes, scale, n)
    check(torch.equal(new_ef, g.reshape(-1) - deq), "psum: the residual is "
          "not what the rounding dropped")
    every = torch.empty((world,) + avg.shape, device=dev)
    dist.all_gather_into_tensor(every.reshape(-1, avg.shape[-1]),
                                avg.contiguous())
    check(all(torch.equal(every[i], every[0]) for i in range(world)),
          "psum: the ranks' means differ")
    want = rows.mean(0)
    rel = float((avg.cpu() - want).norm() / want.norm())
    check(rel < PSUM_REL, f"psum: mean off by {rel:.3g} relative")
    chunks = codes.shape[0]
    return dict(shape=list(PSUM_SHAPE), ranks=world, rel_err=rel, ms=ms,
                bytes_sent_per_rank=chunks * (compress._CHUNK + 4),
                bytes_f32_all_reduce_would_send=g.numel() * 4)


def kan16_task(dev, out_dir):
    """16a's gradients and 16d on the 2x2 mesh. Rank 0 holds the mesh's
    step-0 gradients to the single card's (written by the main process
    with their reach) and times ``kan_fused`` at the rank's shapes."""
    kt = MESH_KAN
    world = dist.get_world_size()
    mesh = meshlib.make_host_mesh(kt["mesh"][1], dev)
    res = {"psum": psum_check(dev, world)}
    cfg = dataclasses.replace(kan_llm.CONFIG.model, kan_backend="fused")
    params = tfm.init_model(0, cfg)
    ref_in = (torch.load(Path(out_dir) / "kan16_ref.pt")
              if dist.get_rank() == 0 else None)
    rec = {}
    with shlib.use_mesh(mesh):
        dp = shlib.distribute_tree(params, mesh, tfm.param_spec(cfg))
        _, batch = mesh_batch(cfg, kt["batch"], kt["seq"], 0, dev, mesh)
        ops.reset_launch_counts()
        with mesh_fused_calls(rec):
            _, _, g = value_and_grad(tfm.loss_fn, dp, cfg, batch)
        torch.cuda.synchronize()
        res["launches_grad"] = ops.launch_counts()["kan_fused"]
        check(res["launches_grad"] == kan_calls_per_step(cfg),
              f"kan_llm on the mesh: kan_fused launched "
              f"{res['launches_grad']} times in a step, not "
              f"{kan_calls_per_step(cfg)}")
        res["grads"] = gathered_vs("kan_llm 2x2", g,
                                   *(ref_in or (None, None)))
        del g
        opt = make_optimizer("adamw", warmup_cosine(3e-4, 10, kt["steps"]))
        step_fn = make_train_step(cfg, opt, TrainConfig())
        st = {"p": dp, "s": opt.init(dp), "i": 0}

        def step():
            b = mesh_batch(cfg, kt["batch"], kt["seq"], st["i"], dev,
                           mesh)[1]
            st["p"], st["s"], _ = step_fn(st["p"], st["s"], b)
            st["i"] += 1
        ops.reset_launch_counts()
        res["timing"] = mesh_step_metrics(step)
        res["launches_steps"] = ops.launch_counts()["kan_fused"]
        check(res["launches_steps"] == st["i"] * kan_calls_per_step(cfg),
              f"kan_llm mesh timing: kan_fused launched "
              f"{res['launches_steps']} times in {st['i']} steps")
    if dist.get_rank() == 0:
        res["rows"] = []
        for shape, (x, coeffs, asp) in sorted(rec.items()):
            codes, scale = quant.quantize_coeffs(coeffs, asp, axis=(0, 1))
            layer = types.SimpleNamespace(codes=codes.contiguous(),
                                          scale=scale,
                                          hemi=quant.hemi_for(asp, dev))
            r = check_kan_fused(Timer(dev), f"mesh rank [{shape[0]}, "
                                f"{shape[1]}] -> {codes.shape[-1]}", x,
                                layer, asp)
            r["on_path"] = False
            res["rows"].append(r)
    return res


@contextlib.contextmanager
def mesh_fused_calls(record):
    """While active, ``record`` keeps the first (rows [N, I] the rank's
    kernel sees, whole coefficients, asp) per input shape of
    ``ops.kan_spline_fused`` called on DTensors (x split by rows only, as
    the wrapper splits it; the redistribution and the gathering of the
    coefficients are collectives every rank makes)."""
    fn = ops.kan_spline_fused

    def spy(x, coeffs, asp):
        xl = x
        if shlib.is_dtensor(x):   # the rows the rank's kernel sees: whole I
            xl = x.redistribute(x.device_mesh, [
                p if p.is_shard() and p.dim % x.ndim < x.ndim - 1
                else Replicate() for p in x.placements]).to_local()
        key = (xl.numel() // xl.shape[-1], xl.shape[-1])
        if key not in record:
            c = shlib.full(coeffs)
            record[key] = (xl.detach().reshape(key).clone(),
                           c.detach().clone(), asp)
        return fn(x, coeffs, asp)
    ops.kan_spline_fused = spy
    try:
        yield record
    finally:
        ops.kan_spline_fused = fn


def reach_of(a, b):
    return [float((x - y).abs().max()) for x, y in zip(a, b)]


def mamba16_task(dev, out_dir):
    """16b on the 1x2 mesh: the layer cut from the combined peak of 2 and
    3 layers, rank 0's single-card gradients (bf16 and f32 compute, whose
    distance is the bf16 reach), the mesh's step-0 gradients held to them,
    3 AdamW steps, ``ssd_scan`` at the rank's shape."""
    mt = MESH_MAMBA
    mesh = meshlib.make_host_mesh(mt["mesh"][1], dev)
    full = mamba2_1p3b.CONFIG.model
    lead = dist.get_rank() == 0
    res = {}
    opt = make_optimizer("adamw", warmup_cosine(6e-4, 10, mt["steps"]))

    def mesh_peak(n):
        cfg = dataclasses.replace(full, n_layers=n)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with shlib.use_mesh(mesh):
            dp = shlib.distribute_tree(tfm.init_model(0, cfg), mesh,
                                       tfm.param_spec(cfg))
            b = mesh_batch(cfg, mt["batch"], mt["seq"], 0, dev, mesh)[1]
            make_train_step(cfg, opt, TrainConfig())(dp, opt.init(dp), b)
        torch.cuda.synchronize()
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, torch.cuda.max_memory_allocated() / 1e9)
        return sum(peaks)
    n0, n1 = CALIB
    calib = {n: mesh_peak(n) for n in (n0, n1)}
    card = torch.cuda.get_device_properties(dev).total_memory / 1e9
    per_layer = calib[n1] - calib[n0]
    fits = int((MEM_SHARE * card - calib[n0]) // max(per_layer, 1e-9)) + n0
    cut = min(full.n_layers, fits, mt["layers"])
    cfg = dataclasses.replace(full, n_layers=cut)
    res.update(calibration_gb=calib, layers=cut, card_gb=card,
               predicted_gb=calib[n0] + per_layer * (cut - n0))
    torch.cuda.empty_cache()
    params = tfm.init_model(0, cfg)
    b0, _ = mesh_batch(cfg, mt["batch"], mt["seq"], 0, dev, None)
    want = reach = None
    if lead:
        want = grads_cpu(params, cfg, b0)
        reach = reach_of(want, grads_cpu(params, dataclasses.replace(
            cfg, dtype=torch.float32), b0))
        s = layer0_scan_inputs(params, cfg, b0["tokens"])
        h = s["x"].shape[2] // mt["mesh"][1]
        half = {k: (v[:, :, :h].contiguous() if k in ("x", "dt") else
                    v[:h].contiguous() if k in ("a", "d_skip") else v)
                for k, v in s.items()}
        res["rows"] = [check_ssd_scan(Timer(dev), "mesh rank [{}, {}, {}, {}]"
                                      .format(*half["x"].shape), half,
                                      cfg.ssm_chunk)]
        del s, half
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with shlib.use_mesh(mesh):
        dp = shlib.distribute_tree(params, mesh, tfm.param_spec(cfg))
        del params
        torch.cuda.empty_cache()
        batch = mesh_batch(cfg, mt["batch"], mt["seq"], 0, dev, mesh)[1]
        # step 0 of the 3: its gradients are held to rank 0's, then
        # clipped and applied as ``make_train_step`` does
        ops.reset_launch_counts()
        loss, _, g = value_and_grad(tfm.loss_fn, dp, cfg, batch)
        torch.cuda.synchronize()
        res["launches_grad"] = ops.launch_counts()["ssd_scan"]
        check(res["launches_grad"] == 2 * cut, f"mamba2 on the mesh: "
              f"ssd_scan launched {res['launches_grad']} times, not "
              f"{2 * cut}")
        res["grads"] = gathered_vs("mamba2 1x2", g, want, reach)
        del want
        g, _ = clip_by_global_norm(g, TrainConfig().max_grad_norm)
        dp, state = opt.update(g, opt.init(dp), dp)
        del g
        step_fn = make_train_step(cfg, opt, TrainConfig())
        st = {"p": dp, "s": state, "i": 1,
              "losses": [float(loss.full_tensor()
                               if shlib.is_dtensor(loss) else loss)]}

        def step():
            b = mesh_batch(cfg, mt["batch"], mt["seq"], st["i"], dev,
                           mesh)[1]
            st["p"], st["s"], m = step_fn(st["p"], st["s"], b)
            st["losses"].append(float(m["loss"]))
            st["i"] += 1
        ops.reset_launch_counts()
        res["timing"] = mesh_step_metrics(step)
        res["launches_steps"] = ops.launch_counts()["ssd_scan"]
        res["steps"] = st["i"]
        res["losses"] = st["losses"]
        check(res["launches_steps"] == 2 * cut * (st["i"] - 1), f"mamba2 "
              f"mesh steps: ssd_scan launched {res['launches_steps']} times "
              f"in {st['i'] - 1} steps")
        check(all(np.isfinite(st["losses"])), "mamba2 mesh: a loss is not "
              "finite")
    return res


def single_moe(params, cfg):
    """``params`` packed for 2 model shards as the single card's tree
    (each MoE leaf [2, E/2, ...] viewed as [1, E, ...])."""
    def go(t, path=()):
        if isinstance(t, dict):
            return {k: go(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v, path) for v in t]
        if "moe" in path and path[-1] in ("wi", "wg", "wo"):
            lead = t.shape[:-4]
            return t.reshape(lead + (1, -1) + tuple(t.shape[-2:]))
        return t
    return go(params)


def first_moe(params, cfg):
    """Layer 0's MoE parameters (repeat 0 of a stacked stage)."""
    st = params["stages"][0]
    if tfm.stages_for(cfg)[0].repeats > 1:
        st = tfm.layer_of(st, 0)
    return st["l0"]["moe"]


def mixtral16_task(dev, out_dir):
    """16c on the 1x2 mesh (4 experts a rank): the expert-parallel path in
    ``forward`` and in one step's gradients, and the weights-stationary
    ``apply_moe`` on layer 0's MoE, each on rank 0's single-card run's
    top-k choices and held to that run within twice the bf16 reach (its
    bf16 against its f32 run on the same choices) plus ``F32_PATH_BAR``
    (two f32 paths summing in other orders); the gradients at
    ``GRAD_ATOL + GRAD_RTOL`` plus twice that reach, leaf by leaf. Every
    rank draws the whole tree from the seed and keeps its shard; only rank
    0 keeps the whole tree, for the single-card runs."""
    mx = MESH_MIXTRAL
    mesh = meshlib.make_host_mesh(mx["mesh"][1], dev)
    cfg = dataclasses.replace(mixtral_cfg(mx["layers"]), remat=False)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    lead = dist.get_rank() == 0
    torch.cuda.reset_peak_memory_stats()
    params = tfm.init_model(0, cfg, n_model=mx["mesh"][1])
    if not lead:
        dp = shlib.distribute_tree(params, mesh, tfm.param_spec(cfg))
        del params
        torch.cuda.empty_cache()
    b0, _ = mesh_batch(cfg, mx["batch"], mx["seq"], 0, dev, None)
    x = torch.randn((mx["batch"], mx["seq"], cfg.d_model),
                    generator=torch.Generator().manual_seed(3)).to(dev)
    res, box = {}, [None]
    want_g = reach_g = None
    if lead:
        one = single_moe(params, cfg)
        moe0 = first_moe(one, cfg)
        with torch.no_grad():
            with moe_watch(cfg.n_layers) as log:
                lf, _ = tfm.forward(one, cfg, b0)
            with moe_watch(cfg.n_layers, log.choices):
                lf32, _ = tfm.forward(one, c32, b0)
            with moe_watch(1) as wlog:
                ys, _ = moe_lib.apply_moe(moe0, x.to(cfg.dtype),
                                          cfg.moe_cfg)
            with moe_watch(1, wlog.choices):
                ys32, _ = moe_lib.apply_moe(moe0, x, cfg.moe_cfg)
        box = [([c.cpu() for c in log.choices], wlog.choices[0].cpu())]
        with moe_watch(cfg.n_layers, log.choices):
            want_g = grads_cpu(one, cfg, b0)
        with moe_watch(cfg.n_layers, log.choices):
            reach_g = reach_of(want_g, grads_cpu(one, c32, b0))
        del one, moe0
        dp = shlib.distribute_tree(params, mesh, tfm.param_spec(cfg))
        del params
        torch.cuda.empty_cache()
    dist.broadcast_object_list(box, src=0)
    choices = [c.to(dev) for c in box[0][0]]
    wch = [box[0][1].to(dev)]
    with shlib.use_mesh(mesh):
        batch = mesh_batch(cfg, mx["batch"], mx["seq"], 0, dev, mesh)[1]
        with torch.no_grad(), moe_watch(cfg.n_layers, choices):
            lm, _ = tfm.forward(dp, cfg, batch)
        lm = lm.full_tensor()
        with moe_watch(cfg.n_layers, choices):
            _, _, g = value_and_grad(tfm.loss_fn, dp, cfg, batch)
        res["grads"] = gathered_vs("mixtral 1x2 expert-parallel", g, want_g,
                                   reach_g)
        del g, want_g
        mp = first_moe(dp, cfg)
        dx = shlib.local_to_dtensor(x.to(cfg.dtype), mesh,
                                    (Replicate(), Replicate()))
        with torch.no_grad(), moe_watch(1, wch):
            ym, _ = moe_lib.apply_moe(mp, dx, cfg.moe_cfg,
                                      weights_stationary=True)
        ym = ym.full_tensor()
    if lead:
        reach_f = float((lf.float() - lf32.float()).abs().max())
        err_f = float((lm.float() - lf.float()).abs().max())
        check(err_f <= 2 * reach_f + F32_PATH_BAR, f"mixtral 1x2 forward: "
              f"mesh vs single card {err_f:.3g}, past twice the bf16 reach "
              f"{reach_f:.3g} + {F32_PATH_BAR}")
        reach_w = float((ys.float() - ys32.float()).abs().max())
        err_w = float((ym.float() - ys.float()).abs().max())
        check(err_w <= 2 * reach_w + F32_PATH_BAR, f"mixtral "
              f"weights-stationary: mesh vs single card {err_w:.3g}, past "
              f"twice the bf16 reach {reach_w:.3g} + {F32_PATH_BAR}")
        res.update(forward_err=err_f, forward_bf16_reach=reach_f,
                   stationary_err=err_w, stationary_bf16_reach=reach_w)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def serve17_argv(arch, backend, sv):
    """The launcher's command line of a phase-17 run (without the mesh
    flags), and the trace it serves."""
    argv = ["--arch", arch, "--requests", str(sv["requests"]), "--slots",
            str(sv["slots"]), "--page-size", str(sv["page_size"]),
            "--prompt-len", str(sv["prompt_len"]), "--common-prefix",
            str(sv["common_prefix"]), "--new-tokens", str(sv["new_tokens"]),
            "--stagger", "1", "--check", "--metrics-out", os.devnull]
    if backend:
        argv += ["--kan-backend", backend]
    return argv


def serve17_trace(vocab, sv):
    """The launcher's ``synth_trace`` for ``sv`` (seed 0)."""
    return synth_trace(vocab, sv["requests"], max_prompt=sv["prompt_len"],
                       min_prompt=max(2, sv["prompt_len"] // 2),
                       max_new=sv["new_tokens"],
                       min_new=max(2, sv["new_tokens"] // 2), stagger=1,
                       common_prefix=sv["common_prefix"], seed=0)


def serve17_task(dev, out_dir, arch, backend, sv, capture, states=None):
    """One rank of ``launch.serve --mesh-model``: its tokens, report and
    launches, the kernel calls it made (decode ticks and chunks counted
    through ``decode``), its peak memory; then, on the run's engine, a
    profiled window of ticks (device busy ms and idle share) and one tick's
    collectives through ``analysis``. ``capture(args)`` returns a key for
    a kernel call whose local inputs rank 0 keeps for its plain check.
    With ``states`` (a dict), each request's carried SSD state after its
    last prefill chunk, gathered whole, goes into it by request id."""
    runs, calls, kept = [], {"decode": 0, "chunks": 0}, {}
    run, saved = Engine.run, (decode.decode_step, decode.prefill_chunk)
    init, made = Engine.__init__, []

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    def spy_run(self, *a, **k):
        comps = run(self, *a, **k)
        runs.append((self, comps))
        return comps

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            out = fn(*a, **k)
            if states is not None and name == "chunks" and k["last"]:
                # (params, cfg, cache, tokens, start, slot, ...): every
                # rank gathers (a collective), rank 0 keeps
                eng = next(e for e in made if e.cache is a[2])
                state = shlib.full(out[1][0]["l0"]["state"])[:, a[5]]
                states[eng.slot_req[a[5]].rid] = state.clone()
            return out
        return wrapped
    kernel_fn, kernel_name = capture["fn"], capture["name"]
    original = getattr(ops, kernel_name)

    def spy_kernel(*a, **k):
        key = kernel_fn(a, k)
        if key is not None and key not in kept:
            kept[key] = tuple(t.clone() if isinstance(t, torch.Tensor)
                              else t for t in a) + (k,)
        return original(*a, **k)
    Engine.run, Engine.__init__ = spy_run, spy_init
    decode.decode_step = counted("decode", saved[0])
    decode.prefill_chunk = counted("chunks", saved[1])
    setattr(ops, kernel_name, spy_kernel)
    argv = serve17_argv(arch, backend, sv) + [
        "--mesh-model", str(sv["mesh"][1])]
    torch.cuda.reset_peak_memory_stats()
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rep = serve_launch.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        Engine.run, Engine.__init__ = run, init
        decode.decode_step, decode.prefill_chunk = saved
        setattr(ops, kernel_name, original)
    eng, comps = runs[-1]
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the same engine, every slot given a one-page prompt (the trace's
    # first 64 tokens) and 16 new tokens: a profiled window of decode
    # ticks, then one decode tick's collectives
    head = serve17_trace(eng.cfg.vocab, sv)[0].tokens[:eng.page_size]
    for i in range(eng.n_slots):
        eng.submit(Request(rid=f"profile{i}", tokens=head, max_new=16,
                           arrival=eng.tick_no))
    prof = tick_window(eng.step, *SERVE17_PROFILE)
    cb = CollectiveBytes()
    with cb:
        eng.step()
    torch.cuda.synchronize()
    return dict(tokens={c.rid: [int(t) for t in c.tokens] for c in comps},
                report={k: rep[k] for k in (
                    "completed", "tokens_per_s", "ttft_s", "tpot_s",
                    "slot_reuse", "evicted_eos", "prefill_chunks", "ticks",
                    "wall_s")},
                run_s=wall, launches=launches, calls=calls, peak_gb=peak,
                profile=prof, tick_collective_calls=cb.calls,
                tick_collective_input_bytes=cb.bytes,
                tick_traffic=cb.traffic(), kept=kept if meshlib.rank() == 0
                else {})


def kan17_task(dev, out_dir):
    """Phase 17a on one rank of 2x2; rank 0 holds ``kan_fused`` against its
    plain version at its tick and prefill-chunk inputs."""
    sv = SERVE17_KAN
    tick_rows = sv["slots"] // sv["mesh"][0]

    def key(a, k):
        x = a[0]
        rows = x.numel() // x.shape[-1]
        tick = x.dim() == 3 and x.shape[1] == 1
        if (tick and rows == tick_rows) or (not tick and rows ==
                                            sv["page_size"]):
            return (rows, x.shape[-1])
        return None
    res = serve17_task(dev, out_dir, "kan_llm", "fused", sv,
                       dict(name="kan_spline_fused_deployed", fn=key))
    rows = []
    timer = Timer(dev)
    asp_up, asp_down = kan_llm.CONFIG.model.kan_spec.asp
    for (n, i), (x, codes, scale, asp, kw) in sorted(res.pop("kept").items()):
        layer = types.SimpleNamespace(codes=codes, scale=scale,
                                      hemi=kw.get("hemi"))
        what = "tick" if n == tick_rows else "chunk"
        rows.append(check_kan_fused(
            timer, f"kan_llm 2x2 rank {what} {'up' if i == 256 else 'down'}"
            f" [{n}, {i}]", x.reshape(-1, i), layer, asp))
        rows[-1]["on_path"] = False
    res["rows"] = rows
    return res


def mamba17_task(dev, out_dir):
    """Phase 17b on one rank of 1x2, serving ``CONFIG`` in f32; rank 0
    holds ``ssd_scan`` against its plain versions at a carried-state chunk
    of its heads, and saves each request's carried state (all layers) to
    ``out_dir/mamba17.states.pt``."""
    sv = SERVE17_MAMBA

    def key(a, k):
        if isinstance(a[0], torch.Tensor) and not shlib.is_dtensor(a[0]) \
                and k.get("init_state") is not None:
            return "chunk"      # the first carried-state chunk
        return None
    full, states = mamba2_1p3b.CONFIG, {}
    mamba2_1p3b.CONFIG = dataclasses.replace(full, model=dataclasses.replace(
        full.model, dtype=sv["dtype"]))       # what the launcher reads
    try:
        res = serve17_task(dev, out_dir, "mamba2_1p3b", None, sv,
                           dict(name="ssd_state", fn=key), states)
    finally:
        mamba2_1p3b.CONFIG = full
    if meshlib.rank() == 0:
        torch.save({str(k): v.cpu() for k, v in states.items()},
                   Path(out_dir) / "mamba17.states.pt")
    rows = []
    timer = Timer(dev)
    for x, dt, a, b_mat, c_mat, d_skip, kw in res.pop("kept").values():
        s = dict(x=x, dt=dt, a=a, B=b_mat, C=c_mat, d_skip=d_skip)
        rows.append(check_ssd_scan(
            timer, f"mamba2 1x2 rank chunk {list(x.shape)}", s, kw["chunk"],
            init=kw["init_state"]))
    res["rows"] = rows
    return res


RANK_TASKS = {"kan16": kan16_task, "mamba16": mamba16_task,
              "mixtral16": mixtral16_task, "kan17": kan17_task,
              "mamba17": mamba17_task}


def rank_main() -> int:
    """One rank of a phase-16 task (``--rank-task NAME --out DIR``, under
    torchrun): its result as ``DIR/NAME.<rank>.json``."""
    argv = sys.argv
    name = argv[argv.index("--rank-task") + 1]
    out_dir = Path(argv[argv.index("--out") + 1])
    dev = torch.device("cuda")
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                          % torch.cuda.device_count())
    meshlib.init_process_group(MESH_BACKEND, cuda_gloo=True)
    res = RANK_TASKS[name](dev, out_dir)
    (out_dir / f"{name}.{meshlib.rank()}.json").write_text(
        json.dumps(res, default=float))
    meshlib.destroy()
    return 0


def kan16_launches(argv, kt, tmp):
    """16a's launcher on 2x2 (saving at ``resume_at``), then a second launch
    resuming from that checkpoint on 1x2; returns the second's standard
    output and the two runs' seconds."""
    mesh_args = ["-m", "repro_torch.launch.train", *argv, "--host-mesh",
                 "--model-parallel", "2", "--dist-backend", MESH_BACKEND]
    ck, ck2 = tmp / "ck", tmp / "ck2"
    _, s_a = torchrun(4, mesh_args + ["--ckpt-dir", str(ck), "--save-every",
                                      str(kt["resume_at"]), "--losses-out",
                                      str(tmp / "a")], tmp / "launch_2x2.log")
    name = f"step_{kt['resume_at']:08d}"
    ck2.mkdir()
    subprocess.run(["cp", "-r", str(ck / name), str(ck2 / name)], check=True)
    s_out, s_b = torchrun(2, mesh_args + ["--ckpt-dir", str(ck2),
                                          "--verify-restore", "--losses-out",
                                          str(tmp / "b")],
                          tmp / "launch_1x2.log")
    return s_out, s_a, s_b


def mesh_phase(dev):
    """Phase 16. Returns the metrics, the kernel rows (kan_fused, ssd_scan)
    and the launches summed over the ranks."""
    kt = MESH_KAN
    cfg = dataclasses.replace(kan_llm.CONFIG.model, kan_backend="fused")
    argv = ["--arch", "kan_llm", "--kan-backend", "fused", "--batch",
            str(kt["batch"]), "--seq", str(kt["seq"]), "--steps",
            str(kt["steps"]), "--log-every", "5"]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the single-card run of the same command, and its step-0 gradients
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            one = train_launch.main(argv)
        if not KAN_REF:   # phase 16 alone: 15c.1's step-0 reference
            b0 = mesh_batch(cfg, kt["batch"], kt["seq"], 0, dev, None)[0]
            grads_vs_cpu(tfm.init_model(0, cfg), cfg, b0)
        torch.save((KAN_REF["want"], KAN_REF["reach"]),
                   tmp / "kan16_ref.pt")
        torch.cuda.empty_cache()
        # 16a/16d on 2x2 (gradients, timing, psum) beside 16b on 1x2: the
        # ranks are host-bound, and side by side the two take about the
        # longer one's time
        (r_kan, out["kan16_s"]), (r_mamba, out["mamba16_s"]) = rank_tasks(
            [("kan16", 4), ("mamba16", 2)], tmp)
        # 16a: the launcher on 2x2, then resumed on 1x2 from its checkpoint,
        # beside 16c on 1x2 (stopped if the launcher fails)
        mix = torchrun_start(2, [__file__, "--rank-task", "mixtral16",
                                 "--out", str(tmp)], tmp / "mixtral16.log")
        try:
            s_out, s_a, s_b = kan16_launches(argv, kt, tmp)
        except BaseException:
            torchrun_stop([mix])
            raise
        out["mixtral16_s"] = torchrun_all([mix], 1200)[0][1]
        r_mix = [json.loads((tmp / f"mixtral16.{r}.json").read_text())
                 for r in range(2)]
        runs = {}
        for tag, n in (("a", 4), ("b", 2)):
            runs[tag] = [json.loads(Path(str(tmp / tag) + (
                f".rank{r}" if r else "")).read_text()) for r in range(n)]
    # 16a checks: every step's loss, the resume, the restored leaves, the
    # launches on every rank
    per_step = kan_calls_per_step(cfg)
    ref = one["losses"]
    a, b = runs["a"][0], runs["b"][0]
    check(b["start"] == kt["resume_at"] and len(a["losses"]) == kt["steps"]
          and len(b["losses"]) == kt["steps"] - kt["resume_at"],
          f"kan_llm mesh: runs of {len(a['losses'])} and "
          f"{len(b['losses'])} steps from {b['start']}")
    check("restored" in s_out and "bitwise equal" in s_out,
          "kan_llm 1x2: no bitwise check of the restored leaves")
    rel_a = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], ref))
    rel_b = max(abs(x - y) / abs(y) for x, y in zip(
        b["losses"], ref[kt["resume_at"]:]))
    check(max(rel_a, rel_b) <= MESH_LOSS_REL, f"kan_llm mesh losses vs the "
          f"single card: 2x2 {rel_a:.3g}, resumed 1x2 {rel_b:.3g} relative")
    for tag, steps in (("a", kt["steps"]),
                       ("b", kt["steps"] - kt["resume_at"])):
        for r, run in enumerate(runs[tag]):
            n = run["launches"]["kan_fused"]
            check(n == per_step * steps, f"kan_llm mesh run {tag} rank {r}: "
                  f"kan_fused launched {n} times in {steps} steps, not "
                  f"{per_step * steps}")
    launches = {"kan_fused": sum(
        run["launches"]["kan_fused"] for tag in runs for run in runs[tag])
        + sum(r["launches_grad"] + r["launches_steps"] for r in r_kan),
        "ssd_scan": sum(r["launches_grad"] + r["launches_steps"]
                        for r in r_mamba)}
    restored = re.search(r"restored (\d+) leaves", s_out)
    out.update(
        transport=f"{MESH_BACKEND} over host memory, ranks sharing one card "
                  f"(NCCL: one rank a card)",
        kan_llm=dict(
            mesh="2x2 then 1x2", losses_single=ref, losses_2x2=a["losses"],
            losses_1x2_resumed=b["losses"], loss_rel_2x2=rel_a,
            loss_rel_1x2=rel_b, restored_leaves=int(restored.group(1))
            if restored else None,
            step_ms_median_per_rank_2x2=[
                1e3 * float(np.median(r["step_s"][1:])) for r in runs["a"]],
            step_ms_median_per_rank_1x2=[
                1e3 * float(np.median(r["step_s"][1:])) for r in runs["b"]],
            step_ms_single=1e3 * float(np.median(one["step_s"][1:])),
            launches_per_rank_step=per_step, launcher_s=[s_a, s_b],
            grads=r_kan[0]["grads"],
            per_rank=[r["timing"] for r in r_kan]),
        psum=r_kan[0]["psum"],
        mamba2=dict({k: v for k, v in r_mamba[0].items()
                     if k not in ("rows", "timing")},
                    per_rank=[r["timing"] for r in r_mamba]),
        mixtral=dict(r_mix[0], peak_gb_per_rank=[r["peak_gb"]
                                                 for r in r_mix]))
    return out, r_kan[0]["rows"], r_mamba[0]["rows"], launches


def print_mesh(m):
    k = m["kan_llm"]
    print(f"phase 16 transport: {m['transport']}")
    for label, runs in (("16a kan_llm 2x2", k["per_rank"]),
                        ("16b mamba2-1.3b 1x2", m["mamba2"]["per_rank"])):
        for r, t in enumerate(runs):
            dev_ms = t.get("device_ms_per_step")
            print(f"phase {label} rank {r}: "
                  f"{t['step_ms_synchronized']:.1f} ms a step "
                  f"synchronized, device "
                  + (f"{dev_ms:.1f} ms (idle {t['idle_share']:.3f})"
                     if dev_ms else "not measured")
                  + f", peak {t['peak_gb']:.2f} GB, collectives a step "
                  f"{t['collective_calls']} moving {t['collective_bytes']} "
                  f"input bytes")
    print(f"phase 16a kan_llm: losses vs single card 2x2 "
          f"{k['loss_rel_2x2']:.3g}, resumed 1x2 {k['loss_rel_1x2']:.3g} "
          f"relative; step ms per rank 2x2 {k['step_ms_median_per_rank_2x2']}"
          f", 1x2 {k['step_ms_median_per_rank_1x2']}, single card "
          f"{k['step_ms_single']:.1f}; restored {k['restored_leaves']} "
          f"leaves bitwise; gradients {k['grads']}")
    print(f"phase 16b mamba2-1.3b: {m['mamba2']['layers']} layers (peaks "
          f"of both ranks at 2 and 3 layers {m['mamba2']['calibration_gb']}"
          f" GB, predicted {m['mamba2']['predicted_gb']:.2f} of "
          f"{m['mamba2']['card_gb']:.2f}); gradients "
          f"{m['mamba2']['grads']}; losses {m['mamba2']['losses']}")
    print(f"phase 16c mixtral-8x7b 1x2: {m['mixtral']}")
    print(f"phase 16d psum_int8_error_feedback: {m['psum']}")


def serve_mesh_phase(dev):
    """Phase 17. Returns the metrics, the kernel rows (kan_fused at a
    2x2 rank's tick and chunk, ssd_scan at a 1x2 rank's chunk) and the
    launches summed over the ranks."""
    out, rows, launches = {}, {}, {}
    # 17c: the dry run on torch's fake group, in a process of its own (the
    # fake group is the process's); it needs no card, so it runs on the
    # host while 17a and 17b serve, and is stopped if they fail
    script = ("import json, sys, time\n"
              "from repro_torch.launch import dryrun\n"
              "t0 = time.perf_counter()\n"
              "cells = json.loads(sys.argv[1])\n"
              "recs = [dryrun.run_cell(a, s, smoke=sm, mesh_spec=m, "
              "save=False) for a, s, sm, m in cells]\n"
              "print(json.dumps([time.perf_counter() - t0, recs]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")]))
    dry = subprocess.Popen([sys.executable, "-c", script,
                            json.dumps(DRYRUN17)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        serve_mesh_runs(dev, out, rows, launches)
    except BaseException:
        dry.kill()
        dry.communicate()
        raise
    stdout, stderr = dry.communicate(timeout=600)
    check(dry.returncode == 0, f"phase 17c dry run: exit "
          f"{dry.returncode}: {stderr[-2000:]}")
    dry_s, recs = json.loads(stdout.strip().splitlines()[-1])
    for rec in recs:
        check(rec.get("ok"), f"phase 17c dry run {rec['arch']} x "
              f"{rec['shape']} on {rec['mesh']}: {rec.get('error')}")
    out["17c"] = dict(s=dry_s, torch=torch.__version__, cells=recs)
    return out, rows, launches


def serve_mesh_runs(dev, out, rows, launches):
    """Phase 17a and 17b, their ranks side by side (host-bound, so the two
    take about the longer one's time): their metrics into ``out``, the
    kernel rows into ``rows`` and the launches summed over the ranks into
    ``launches``."""
    fams = (("17a", "kan17", "kan_llm", "fused", SERVE17_KAN, "kan_fused"),
            ("17b", "mamba17", "mamba2_1p3b", None, SERVE17_MAMBA,
             "ssd_scan"))
    with tempfile.TemporaryDirectory() as tmp:
        done = rank_tasks([(f[1], f[4]["mesh"][0] * f[4]["mesh"][1])
                           for f in fams], tmp, timeout=600)
        path = Path(tmp) / "mamba17.states.pt"
        saved = torch.load(path) if path.exists() else None
    for (tag, task, arch, backend, sv, kname), (res, wall) in zip(fams,
                                                                 done):
        states = saved if task == "mamba17" else None
        toks = res[0]["tokens"]
        for r, rk in enumerate(res):
            check(rk["tokens"] == toks, f"phase {tag}: rank {r}'s tokens "
                  "differ from rank 0's")
            per_call = (2 * kan_llm.CONFIG.model.n_layers if kname ==
                        "kan_fused" else None)
            got = rk["launches"][kname]
            if per_call is not None:
                want = per_call * (rk["calls"]["decode"]
                                   + rk["calls"]["chunks"])
                check(got == want, f"phase {tag} rank {r}: kan_fused "
                      f"launched {got} times in {rk['calls']}, not {want}")
            else:
                # every chunk runs the scan in each of the 48 layers
                want = mamba2_1p3b.CONFIG.model.n_layers * rk["calls"][
                    "chunks"]
                check(got == want, f"phase {tag} rank {r}: ssd_scan "
                      f"launched {got} times in {rk['calls']} chunks, not "
                      f"{want}")
            check(got > 0, f"phase {tag} rank {r}: {kname} not launched")
        # rank 0 kept a kernel input at each shape it holds to the plain
        # version: kan_fused's tick and chunk, up and down; one ssd_scan chunk
        want_rows = 4 if kname == "kan_fused" else 1
        check(len(res[0]["rows"]) == want_rows, f"phase {tag}: rank 0 kept "
              f"{len(res[0]['rows'])} {kname} inputs, not {want_rows}")
        # the single card's solo runs of the same requests (13a's and 13b's
        # rule): equal up to the first near tie, at every clear step after,
        # at F32_PATH_BAR (both families are served in f32); 13b's check of
        # each request's carried state against its solo prefill, within
        # twice the bf16 reach (the bf16 prefill's distance from it)
        cfg = mamba2_1p3b.CONFIG.model if backend is None else \
            dataclasses.replace(kan_llm.CONFIG.model, kan_backend=backend)
        cfg16 = cfg
        cfg = dataclasses.replace(cfg, dtype=sv.get("dtype", cfg.dtype))
        check(cfg.dtype == torch.float32, f"phase {tag}: served in "
              f"{cfg.dtype}, not f32")
        params = Engine(tfm.init_model(0, cfg), cfg, n_slots=1,
                        max_len=sv["common_prefix"] + sv["prompt_len"]
                        + sv["new_tokens"], device=dev).params
        compared, worst_state = 0, None
        check(states is not None or kname != "ssd_scan", f"phase {tag}: "
              "the carried states were not saved")
        reqs = serve17_trace(cfg.vocab, sv)
        check(sorted(int(k) for k in toks) == [r.rid for r in reqs],
              f"phase {tag}: completions {sorted(toks)}")
        with quantisation_poisoned():
            for r in reqs:
                got = toks[str(r.rid)]
                prompt = torch.from_numpy(r.tokens.astype(np.int64)).to(dev)
                argmax, leads, _, cache = solo_forced(params, cfg, prompt,
                                                      got)
                compared += solo_agrees(f"phase {tag}", r.rid, got, argmax,
                                        leads, F32_PATH_BAR)
                if states is None:
                    continue
                check(str(r.rid) in states, f"phase {tag}: request {r.rid}'s "
                      "carried state was not captured")
                _, cache16 = decode.prefill(
                    params, cfg16, {"tokens": prompt[None]}, len(prompt) + 1,
                    last_only=True)
                solo = cache[0]["l0"]["state"][:, 0]
                reach = float((cache16[0]["l0"]["state"][:, 0].float()
                               - solo).abs().max())
                err = float((states[str(r.rid)].to(dev) - solo).abs().max())
                check(err <= 2 * reach, f"phase {tag}: request {r.rid}'s "
                      f"carried state differs from its solo prefill by "
                      f"{err:.3g}, past twice the bf16 reach {reach:.3g}")
                worst_state = max(worst_state or 0.0, err / reach)
                del cache, cache16
        check(compared > 0, f"phase {tag}: no clear step was compared with "
              "the single card")
        del params
        torch.cuda.empty_cache()
        rows[kname] = res[0]["rows"]
        launches[kname] = sum(rk["launches"][kname] for rk in res)
        out[tag] = dict(
            arch=arch, backend=backend, mesh="x".join(map(str, sv["mesh"])),
            requests=sv["requests"], wall_s=wall,
            solo_clear_steps_compared=compared,
            state_err_over_bf16_reach=worst_state,
            per_rank=[{k: v for k, v in rk.items()
                       if k not in ("tokens", "rows")} for rk in res])


def print_serve_mesh(m, smi):
    """Phase 17's lines, each number beside the card's name and power
    limit."""
    for tag in ("17a", "17b"):
        r = m[tag]
        for i, rk in enumerate(r["per_rank"]):
            rep, prof = rk["report"], rk["profile"]
            busy = (f"{prof['device_ms_per_tick']:.2f} ms of "
                    f"{prof['wall_ms_per_tick']:.1f} (idle "
                    f"{prof['idle_share']:.3f})" if prof else "not measured")
            print(f"phase {tag} {r['arch']} {r['backend'] or ''} "
                  f"{r['mesh']} rank {i} [{smi}]: {rep['tokens_per_s']} "
                  f"tokens/s, TTFT p50 {rep['ttft_s'].get('p50')} s, TPOT "
                  f"p50 {rep['tpot_s'].get('p50')} s; a profiled tick's "
                  f"device {busy}; peak {rk['peak_gb']:.2f} GB; one tick's "
                  f"collectives {rk['tick_collective_calls']}, input bytes "
                  f"{rk['tick_collective_input_bytes']}, ring bytes moved "
                  f"{rk['tick_traffic']['total']:.0f}; launches "
                  f"{rk['launches']} in {rk['calls']}")
        state = r["state_err_over_bf16_reach"]
        print(f"phase {tag} [{smi}]: {r['requests']} requests in "
              f"{r['wall_s']:.1f} s (torchrun included, 17a and 17b side by "
              f"side); tokens equal on "
              f"every rank and to the single card's f32 solo runs at "
              f"{r['solo_clear_steps_compared']} clear steps"
              + ("" if state is None else f"; carried state / bf16 reach <= "
                 f"{state:.3g}"))
    for rec in m["17c"]["cells"]:
        mem = rec["memory"]
        print(f"phase 17c dry run (torch {m['17c']['torch']}) {rec['arch']} "
              f"x {rec['shape']} on {rec['mesh']} ({rec['devices']} fake "
              f"ranks): ok; rank 0 holds params {mem['param_bytes']} B, "
              f"cache {mem['cache_bytes']} B, batch {mem['batch_bytes']} B, "
              f"peak {mem['peak_bytes']} B (with the step's live op "
              f"outputs); flops "
              f"{rec['flops']:.4g}, bytes accessed "
              f"{rec['bytes_accessed']:.4g}; collectives "
              f"{rec['collective_calls']}, ring bytes moved "
              f"{rec['collective_traffic']['total']:.0f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} card(s))")
    print(f"nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{build.library_path().name}")

    # model, artifact and data of the main path (set-up)
    cfg = cf_kan_1.MODEL
    cfg_fused = dataclasses.replace(cfg, backend="fused")
    asp_e, asp_d = cfg.asp_enc, cfg.asp_dec
    params = cf_kan.init(0, cfg)
    t0 = time.perf_counter()
    ds = cf_synth.generate(n_users=N_USERS, n_items=cfg.n_items, seed=0)
    x_all = torch.from_numpy(ds.observed).to(dev)
    held = torch.from_numpy(ds.held_out).to(dev)
    print(f"data: {N_USERS} users x {cfg.n_items} items in "
          f"{time.perf_counter() - t0:.1f} s; params {cfg.n_params:,}")

    # 3. kernels against their plain versions at the main path's shapes
    timer = Timer(dev)
    art = cf_kan.deploy(params, cfg_fused)
    enc, dec = art.layers
    xe = kan.bound_input(x_all[:BATCH], asp_e)
    h = (ref.kan_spline_ref(xe, enc.codes, enc.scale.reshape(-1), asp_e,
                            enc.hemi)
         + kan.base_branch(xe, enc.w_base, "relu"))
    xd = kan.bound_input(h, asp_d)
    stats_3 = cf_kan.collect_layer_stats(
        params, [x_all[:BATCH], x_all[BATCH:2 * BATCH]], cfg_fused)
    rows = {"kan_fused": [check_kan_fused(timer, "enc", xe, enc, asp_e),
                          check_kan_fused(timer, "dec", xd, dec, asp_d)],
            "cim_mac": [], "cim_mac_tiled": [],
            "kan_basis": kan_basis_rows(timer, xe, xd, enc, dec)}
    for uid, (label, x, layer, asp) in enumerate((("enc", xe, enc, asp_e),
                                                  ("dec", xd, dec, asp_d))):
        wl = cim.quantize_wl(quant.quantized_basis(x, layer.hemi, asp)
                             .reshape(x.shape[0], -1), 8)
        w = layer.codes.reshape(wl.shape[1], -1)
        for a in ARRAY_SIZES:
            rows["cim_mac"].append(
                check_cim_mac(timer, f"{label} As={a}", wl, w, a))
            rows["cim_mac_tiled"].append(check_cim_mac_tiled(
                timer, f"{label} As={a}", wl, layer.codes, uid, a))
        # KAN-SAM placement from the main path's Phase-A stats, and (for
        # the encoder) WL values with no zero, where every row is live
        crit = kan_sam.criticality(stats_3[label], layer.codes).reshape(-1)
        rows["cim_mac_tiled"].append(check_cim_mac_tiled(
            timer, f"{label} As={SERVE_AS} KAN-SAM", wl, layer.codes, uid,
            SERVE_AS, crit=crit, on_path=False))
        if label == "enc":
            gen = torch.Generator(device=dev).manual_seed(0)
            dense = cim.quantize_wl(1 / 255 + (1 - 1 / 255) * torch.rand(
                wl.shape, generator=gen, device=dev), 8)
            check(bool((dense > 0).all()), "dense WL values hold a zero")
            rows["cim_mac"].append(check_cim_mac(
                timer, f"{label} As={SERVE_AS} dense", dense, w, SERVE_AS,
                on_path=False))
            rows["cim_mac_tiled"].append(check_cim_mac_tiled(
                timer, f"{label} As={SERVE_AS} dense", dense, layer.codes,
                uid, SERVE_AS, on_path=False))
            del dense
    del stats_3
    for kname, krows in rows.items():
        for r in krows:
            listed = (f", rows iterated {r['rows_iterated']:.4f}"
                      if "rows_iterated" in r else "")
            print(f"kernel {kname} {r['shape']}: max|err| "
                  f"{r['max_abs_err']:.3g}, {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']}{listed})")

    # 4a. the main path through fused and cim, with the launch counts
    # zeroed just before and read just after
    ccfg = cim.CIMConfig(array_size=SERVE_AS, gamma0=GAMMA0)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats = cf_kan.collect_layer_stats(
        params, [x_all[:BATCH], x_all[BATCH:2 * BATCH]], cfg_fused)
    deployed = {"fused": cf_kan.deploy(params, cfg_fused),
                "cim_uniform": cf_kan.deploy(params, cfg, cim_cfg=ccfg),
                "cim_sam": cf_kan.deploy(params, cfg, cim_cfg=ccfg,
                                         use_sam=True, stats=stats)}
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    served = {k: serve(d, x_all) for k, d in deployed.items()}
    launches_a = ops.launch_counts()
    print(f"main path (a): stats + 3 deploys {deploy_s:.2f} s; launches "
          f"{launches_a}")

    # 4b. the main path through cim_tiled, uniform and KAN-SAM, from the
    # same stats, with the launch counts zeroed just before and read after
    tcfg = chip_cfg(SERVE_AS)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tiled = {"cim_tiled_uniform": kan.deploy(params, cfg.kan_spec.with_backend(
                 "cim_tiled", cim=tcfg)),
             "cim_tiled_sam": kan.deploy(params, cfg.kan_spec.with_backend(
                 "cim_tiled", cim=tcfg, use_sam=True), stats=stats)}
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    served.update({k: serve(d, x_all) for k, d in tiled.items()})
    launches_b = ops.launch_counts()
    print(f"main path (b): 2 deploys {deploy_s:.2f} s; launches "
          f"{launches_b}")
    launches = {"kan_fused": launches_a["kan_fused"],
                "cim_mac": launches_a["cim_mac"],
                "cim_mac_tiled": launches_b["cim_mac_tiled"],
                "kan_basis": launches_a["kan_basis"] + launches_b["kan_basis"]}
    for kname in launches:
        check(launches[kname] > 0, f"{kname} was not launched on the path")
    for k, d in tiled.items():
        rep = chip.chip_report(d)
        print(f"chip report {k}: tiles allocated {rep['tiles_allocated']}, "
              f"used {rep['tiles_used']}, utilization "
              f"{rep['utilization']:.4f}, area {rep['area_mm2']:.2f} mm^2, "
              f"layers " + ", ".join(
                  f"{n}: grid {l['grid']} rows placed {l['rows_placed']} of "
                  f"{l['rows']}" for n, l in rep["layers"].items()))

    dep_lut = cf_kan.deploy(params, cfg)
    s_lut, _ = serve(dep_lut, x_all)
    s_fused = served["fused"][0]
    metrics = {}
    for k, (s, times) in {**served, "lut": (s_lut, [])}.items():
        metrics[k] = (float(cf_kan.recall_at_k(s, held, x_all)),
                      float(cf_kan.ndcg_at_k(s, held, x_all)))
        batch_ms = (f"; per batch of {BATCH}: median "
                    f"{np.median(times):.2f} ms, all "
                    f"{[round(t, 2) for t in times]}" if times else "")
        print(f"serve {k}: Recall@20 {metrics[k][0]:.6f} NDCG@20 "
              f"{metrics[k][1]:.6f}{batch_ms}")
    q = {k: quant.quantize_input(kan.bound_input(
        kan.apply(enc_only(d), x_all), asp_d), asp_d)
        for k, d in (("fused", deployed["fused"]), ("lut", dep_lut))}
    flip = float((q["fused"] != q["lut"]).float().mean())
    print(f"fused vs lut: max|score err| "
          f"{float((s_fused - s_lut).abs().max()):.3g}, mean rel "
          f"{rel_err(s_fused, s_lut):.3g}, decoder-input codes differing "
          f"{flip:.3g}")
    for kind in ("cim", "cim_tiled"):
        print(f"{kind} vs fused: mean rel score err uniform "
              f"{rel_err(served[kind + '_uniform'][0], s_fused):.4f}, SAM "
              f"{rel_err(served[kind + '_sam'][0], s_fused):.4f}")
    check(flip <= 1e-3, f"fused vs lut: {flip:.3g} decoder codes differ")
    for i, what in enumerate(("Recall@20", "NDCG@20")):
        d = abs(metrics["fused"][i] - metrics["lut"][i])
        check(d <= METRIC_TOL, f"fused vs lut {what} differ by {d:.3g}")

    # 5. small-input references (card against CPU)
    worst = small_reference(dev)
    print(f"small reference, card vs CPU max|err|: {worst}")
    for lcfg, backend in ((mamba2_1p3b.SMOKE.model, None),
                          (kan_llm.SMOKE.model, "lut_int8"),
                          (kan_llm.SMOKE.model, "fused"),
                          (mistral_nemo_12b.SMOKE.model, None)):
        worst_lm, roots, n_codes = small_lm_reference(dev, lcfg, backend)
        print(f"small LM reference ({lcfg.name} SMOKE"
              + (f" on {backend}" if backend else "")
              + f", {lcfg.dtype}), card vs CPU max|err|: {worst_lm:.3g}; "
              f"independent KAN input codes differing between the devices: "
              f"{roots} of {n_codes}; generate tokens checked")

    # 6. Fig. 18 on the kernel path
    fig18(dev)

    # the LM main path's model and prompts (set-up)
    lcfg = mamba2_1p3b.CONFIG.model
    data = lm_synth.batch_at(lm_synth.LMDataConfig(
        vocab=lcfg.vocab, batch=LM_BATCH, seq_len=LM_PROMPT, seed=0), 0)
    prompt = torch.from_numpy(data["tokens"]).to(dev)
    t0 = time.perf_counter()
    lparams = tfm.init_model(0, lcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tfm.count_params(lparams)
    check(n_params == MAMBA2_PARAMS, f"mamba2-1.3b has {n_params:,} "
          f"parameters, not {MAMBA2_PARAMS:,}")
    print(f"LM init: {lcfg.name}, {n_params:,} parameters ({lcfg.n_layers} "
          f"layers, d_model {lcfg.d_model}, {lcfg.ssd_cfg.n_heads} heads of "
          f"{lcfg.ssm_head_dim}, N {lcfg.ssm_state}, chunk {lcfg.ssm_chunk}),"
          f" compute {lcfg.dtype}, params {lcfg.param_dtype}, on the card "
          f"in {init_s:.2f} s")

    # 7. ssd_scan against its plain versions on layer 0's inputs
    rows["ssd_scan"] = ssd_phase(timer, lparams, lcfg, prompt)
    for r in rows["ssd_scan"]:
        print(f"kernel ssd_scan {r['shape']}: max|err| vs plain y "
              f"{r['y_vs_plain_max_abs_err']:.3g} state "
              f"{r['state_vs_plain_max_abs_err']:.3g}, vs ssd_ref y "
              f"{r['y_vs_ssd_ref_max_abs_err']:.3g} state "
              f"{r['state_vs_ssd_ref_max_abs_err']:.3g}; err/tolerance vs "
              f"plain y {r['y_vs_plain_err_over_tol']:.3g} state "
              f"{r['state_vs_plain_err_over_tol']:.3g}, vs ssd_ref y "
              f"{r['y_vs_ssd_ref_err_over_tol']:.3g} state "
              f"{r['state_vs_ssd_ref_err_over_tol']:.3g} (share past the "
              f"JAX bar alone: y {r['y_vs_plain_over_jax_bar']:.3g}); "
              f"{r['ms']:.4f} ms, {r['tflops']:.2f} TFLOP/s (plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}, 3xTF32 bound {r['bound_tf32_ms']:.4f}"
              + (f", at mma.sync's rate {r['mma_sync_ms']:.4f}"
                 if "mma_sync_ms" in r else "") + ")")
    torch.cuda.empty_cache()

    # 8. the LM main path at full width, launch-counted
    lm_metrics, launches_gen, launches_fwd = lm_main_path(
        lparams, lcfg, prompt, {"ssd_scan": lcfg.n_layers})
    launches["ssd_scan"] = launches_gen["ssd_scan"] + launches_fwd["ssd_scan"]
    print(f"LM main path: launches generate {launches_gen}, forward "
          f"{launches_fwd}")
    print("LM main path: " + json.dumps(lm_metrics))
    print(f"LM main path: init {init_s:.2f} s, prefill "
          f"{LM_BATCH}x{LM_PROMPT} {lm_metrics['prefill_s']:.3f} s, decode "
          f"{lm_metrics['decode_ms_median']:.2f} ms per step of {LM_BATCH} "
          f"tokens ({lm_metrics['decode_tokens_per_s']:.1f} tokens/s), generate "
          f"{LM_NEW} tokens {lm_metrics['generate_s']:.3f} s "
          f"({lm_metrics['generate_tokens_per_s']:.1f} tokens/s), forward "
          f"T={lm_metrics['forward_T']} {lm_metrics['forward_s']:.3f} s, peak "
          f"{lm_metrics['peak_gb']:.2f} GB")
    check(launches["ssd_scan"] > 0, "ssd_scan was not launched on the path")

    # ssd_scan's five CUDA kernels on the prefill's shape, from a profiler
    # trace taken after the timed paths, which its tracing could slow
    scan_in = layer0_scan_inputs(lparams, lcfg, prompt)
    stage = ssd_stage_ms([scan_in[k] for k in ("x", "dt", "a", "B", "C",
                                               "d_skip")],
                         lcfg.ssd_cfg.chunk, None)
    rows["ssd_scan"][0]["stage_ms"] = stage
    print("kernel ssd_scan stages at the prefill's shape (device ms per "
          "call, profiler): " + (json.dumps(stage) if stage else
                                 "not measured (no device times in the "
                                 "trace)"))

    # 9. training at full width, then evaluation on the trained weights
    del lparams, prompt, scan_in
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train9, krows9, launches_train, launches_eval, trained = train_phase(
        timer, params, cfg_fused, ds, art)
    rows["kan_fused"].extend(krows9)
    launches["kan_fused"] += (launches_train["kan_fused"]
                              + launches_eval["kan_fused"])
    launches["cim_mac"] += launches_eval["cim_mac"]
    print("phase 9: " + json.dumps({k: v for k, v in train9.items()
                                    if k != "step_ms_all"}))
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")

    # 10. the KAN-FFN LLM on three backends, then mistral-nemo-12b
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kan10, krows10, launches10 = kan_llm_phase(timer, dev)
    rows["kan_fused"].extend(krows10)
    launches["kan_fused"] += launches10
    for r in krows10:
        print(f"kernel kan_fused {r['shape']}: max|err| {r['max_abs_err']:.3g}"
              f", err/sum|terms| {r['max_err_over_sum_abs_terms']:.3g}, "
              f"{r['ms']:.4f} ms, device {r['device_ms']:.4f}, host "
              f"{r['host_ms']:.4f} (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']})")
    print("phase 10a: " + json.dumps(kan10))
    print(f"phase 10a: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mistral_phase(dev)
    print(f"phase 10b: {time.perf_counter() - t0:.1f} s")

    # 11. the co-design tuner on the trained CF-KAN-1, launch-counted
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tune11, krows11, launches11 = tune_phase(timer, trained, cfg_fused, ds)
    rows["kan_fused"].extend(krows11)
    launches["kan_fused"] += launches11
    print_tune(tune11)
    for r in krows11:
        print(f"kernel kan_fused {r['shape']}: max|err| {r['max_abs_err']:.3g}"
              f", err/sum|terms| {r['max_err_over_sum_abs_terms']:.3g}, "
              f"{r['ms']:.4f} ms, device {r['device_ms']:.4f}, host "
              f"{r['host_ms']:.4f} (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']})")
    print("phase 11: " + json.dumps(tune11))
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")

    # 12. recurrentgemma-2b at full width and depth
    del trained
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rgemma_phase(dev)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")

    # 13. the continuous-batching engine: kan_llm on fused and lut, then
    # mamba2-1.3b, each run launch-counted
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng13a, krows13, launches13a = engine_kan_llm_phase(timer, dev)
    rows["kan_fused"].extend(krows13)
    launches["kan_fused"] += launches13a
    for r in krows13:
        print(f"kernel kan_fused {r['shape']}: max|err| {r['max_abs_err']:.3g}"
              f", err/sum|terms| {r['max_err_over_sum_abs_terms']:.3g}, "
              f"{r['ms']:.4f} ms, device {r['device_ms']:.4f}, host "
              f"{r['host_ms']:.4f} (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']})")
    print("phase 13a: " + json.dumps(eng13a))
    print(f"phase 13a: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng13b, srow13, launches13b = engine_mamba2_phase(timer, dev)
    rows["ssd_scan"].append(srow13)
    launches["ssd_scan"] += launches13b
    print(f"kernel ssd_scan {srow13['shape']}: max|err| vs plain y "
          f"{srow13['y_vs_plain_max_abs_err']:.3g} state "
          f"{srow13['state_vs_plain_max_abs_err']:.3g}; err/tolerance vs "
          f"plain y {srow13['y_vs_plain_err_over_tol']:.3g} state "
          f"{srow13['state_vs_plain_err_over_tol']:.3g}, vs ssd_ref y "
          f"{srow13['y_vs_ssd_ref_err_over_tol']:.3g} state "
          f"{srow13['state_vs_ssd_ref_err_over_tol']:.3g}; "
          f"{srow13['ms']:.4f} ms (plain {srow13['plain_ms']:.4f}, bound "
          f"{srow13['bound_ms']:.4f} by {srow13['bound_by']}, 3xTF32 bound "
          f"{srow13['bound_tf32_ms']:.4f})")
    print("phase 13b: " + json.dumps(eng13b))
    print(f"phase 13b: {time.perf_counter() - t0:.1f} s")

    # 14. the router over kan_llm on fused (plain, drain, health-drain), the
    # launcher's fleet path on cim_tiled, mixtral-8x7b over a measured cut
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r14a, krows14, launches14a = router_phase(timer, dev)
    rows["kan_fused"].extend(krows14)
    launches["kan_fused"] += launches14a
    print("phase 14a: " + json.dumps(r14a))
    print(f"phase 14a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    r14b, rows14b, launches14b = launcher_phase(timer, dev)
    for k, krows in rows14b.items():
        rows[k].extend(krows)
        launches[k] += launches14b[k]
    print("phase 14b: " + json.dumps(r14b))
    print(f"phase 14b: {time.perf_counter() - t0:.1f} s")
    for kname, r in ([("kan_fused", r) for r in krows14]
                     + [(k, r) for k, krows in rows14b.items()
                        for r in krows]):
        print(f"kernel {kname} "
              f"{r['shape']}: max|err| {r['max_abs_err']:.3g}, "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']})")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r14c = mixtral_phase(dev)
    print("phase 14c: " + json.dumps(r14c))
    print(f"phase 14c: {time.perf_counter() - t0:.1f} s")

    # 15. whisper-base served through the engine, internvl2-76b over a
    # measured cut, and kan_llm, whisper-base and mamba2-1.3b trained, each
    # run launch-counted
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    w15a = whisper_serve_phase(dev)
    print("phase 15a: " + json.dumps(w15a))
    print(f"phase 15a: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    v15b = internvl2_phase(dev)
    print("phase 15b: " + json.dumps(v15b))
    print(f"phase 15b: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    t15c, krows15, srow15, kl15, sl15 = training_phase(timer, dev)
    rows["kan_fused"].extend(krows15)
    rows["ssd_scan"].append(srow15)
    launches["kan_fused"] += kl15
    launches["ssd_scan"] += sl15
    for r in krows15:
        print(f"kernel kan_fused {r['shape']}: max|err| {r['max_abs_err']:.3g}"
              f", err/sum|terms| {r['max_err_over_sum_abs_terms']:.3g}, "
              f"{r['ms']:.4f} ms, device {r['device_ms']:.4f}, host "
              f"{r['host_ms']:.4f} (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']})")
    print(f"kernel ssd_scan {srow15['shape']}: max|err| vs plain y "
          f"{srow15['y_vs_plain_max_abs_err']:.3g}; err/tolerance vs plain y "
          f"{srow15['y_vs_plain_err_over_tol']:.3g} state "
          f"{srow15['state_vs_plain_err_over_tol']:.3g}; gradients through "
          f"the Function vs the plain form's err/tolerance "
          f"{srow15['grad_vs_plain_err_over_tol']:.3g}, vs the sequential "
          f"scan's {srow15['grad_vs_sequential_over_leaf_max']:.3g} of a "
          f"leaf's largest; forward "
          f"{srow15['ms']:.4f} ms, the Function's backward "
          f"{srow15['function_backward_ms']:.4f} ms (forward + backward "
          f"{srow15['function_forward_backward_ms']:.4f}; the plain form's "
          f"{srow15['plain_forward_backward_ms']:.4f}), plain forward "
          f"{srow15['plain_ms']:.4f}, bound {srow15['bound_ms']:.4f} by "
          f"{srow15['bound_by']}")
    print("phase 15c: " + json.dumps(t15c))
    print(f"phase 15c: {time.perf_counter() - t0:.1f} s")

    # 16. LM training sharded over a DeviceMesh of ranks on the card:
    # kan_llm 2x2 (and resumed on 1x2), mamba2-1.3b 1x2, mixtral 1x2, the
    # int8 all-reduce; every rank's launches counted
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m16, krows16, srows16, launches16 = mesh_phase(dev)
    rows["kan_fused"].extend(krows16)
    rows["ssd_scan"].extend(srows16)
    for k, n in launches16.items():
        check(n > 0, f"phase 16: {k} was not launched on any rank")
        launches[k] += n
    print_mesh(m16)
    for r in krows16:
        print(f"kernel kan_fused {r['shape']}: max|err| {r['max_abs_err']:.3g}"
              f", err/sum|terms| {r['max_err_over_sum_abs_terms']:.3g}, "
              f"{r['ms']:.4f} ms, device {r['device_ms']:.4f}, host "
              f"{r['host_ms']:.4f} (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']})")
    for r in srows16:
        print(f"kernel ssd_scan {r['shape']}: max|err| vs plain y "
              f"{r['y_vs_plain_max_abs_err']:.3g}; err/tolerance vs plain y "
              f"{r['y_vs_plain_err_over_tol']:.3g} state "
              f"{r['state_vs_plain_err_over_tol']:.3g}; {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}, 3xTF32 bound {r['bound_tf32_ms']:.4f})")
    print("phase 16: " + json.dumps(m16, default=float))
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")

    # 17. serving under a mesh of ranks on the card (kan_llm fused 2x2,
    # mamba2-1.3b 1x2, every rank's launches counted), then the dry run
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m17, rows17, launches17 = serve_mesh_phase(dev)
    for k, krows in rows17.items():
        rows[k].extend(krows)
        launches[k] += launches17[k]
    print_serve_mesh(m17, smi)
    for r in rows17["kan_fused"]:
        print(f"kernel kan_fused {r['shape']} [{smi}]: max|err| "
              f"{r['max_abs_err']:.3g}, err/sum|terms| "
              f"{r['max_err_over_sum_abs_terms']:.3g}, {r['ms']:.4f} ms, "
              f"device {r['device_ms']:.4f}, host {r['host_ms']:.4f} (plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} by {r['bound_by']})")
    for r in rows17["ssd_scan"]:
        print(f"kernel ssd_scan {r['shape']} [{smi}]: max|err| vs plain y "
              f"{r['y_vs_plain_max_abs_err']:.3g}; err/tolerance vs plain y "
              f"{r['y_vs_plain_err_over_tol']:.3g} state "
              f"{r['state_vs_plain_err_over_tol']:.3g}; {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']}, 3xTF32 bound {r['bound_tf32_ms']:.4f})")
    print("phase 17: " + json.dumps(m17, default=float))
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")

    # result lines
    kernels = []
    for kname, krows in rows.items():
        # one apply (the enc and dec shapes) / one ssd_scan launch at the
        # prefill's shape
        on_path = [r for r in krows if r.get(
            "on_path", r.get("array_size", SERVE_AS) == SERVE_AS)]
        ms = sum(r["ms"] for r in on_path)
        bound_ms = sum(r["bound_ms"] for r in on_path)
        by = max(on_path, key=lambda r: r["bound_ms"])["bound_by"]
        lib = (None if any(r["library_ms"] is None for r in on_path)
               else sum(r["library_ms"] for r in on_path))
        kernels.append(dict(
            name=kname, route="cuda", source=SOURCES[kname][0],
            replaces=SOURCES[kname][1], launches=launches[kname],
            max_abs_err=max(r["max_abs_err"] for r in krows), ms=ms,
            plain_ms=sum(r["plain_ms"] for r in on_path), bound_ms=bound_ms,
            bound_by=by, library_ms=lib, per_shape=krows))
        for extra in ("bound_f32_ms", "bound_tf32_ms"):
            if all(extra in r for r in on_path):
                kernels[-1][extra] = sum(r[extra] for r in on_path)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main() if "--rank-task" in sys.argv else main())
