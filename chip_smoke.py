#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py --rows   # the build and the row kernels at the
                                   # sparse path's rows, with the sweep
    python3 chip_smoke.py --sharded  # the build and the sharded engine
    python3 chip_smoke.py --swa-digests  # swa_decode's digests (phase 3)
    python3 chip_smoke.py --family-training  # the build and phase 5c
    python3 chip_smoke.py --model-axis  # the build and phase 5d
    python3 chip_smoke.py --model-axis-faults  # 5d's loss and logits gaps,
                                               # faults planted, and the
                                               # bf16 drift at P = 2

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device: the card's name and power limit, the four kernels' build from
   ``src/repro_torch/kernels/csrc`` and its time;
2. the LGC kernels against their plain torch versions on the card, bitwise,
   at D in {63, 100_003, 28_311_552} and C in {1, 3} with a dropped channel:
   maxabs, histogram, sparsify_ef (and u == g + e'), lgc_compress_hist;
   lgc_compress_hist at the simulator's D (7,850 and 206,922) with its
   budget and all 8 received patterns of its 3 channels;
   then maxabs and histogram at sizes around a block's and the grid's pass,
   at pointer offsets 0-3, on zeros, -0.0 and a NaN (histogram also +-inf,
   a constant vector, exact bin edges k/256, and a maximum that is NaN or
   0), ten launches in a row, and a histogram launch right after one with a
   larger grid; then every LGC kernel (and ``sum_maxabs``) on inputs scaled
   by 1e-39, 1e-37, 1e-36 and 1e-30, all, partly or not subnormal, bitwise
   equal to the plain versions that flush subnormals as the JAX reference;
   then the (M, D) row forms (``sum_maxabs_rows``, ``histogram_rows``,
   ``sparsify_ef_rows``, ``lgc_compress_hist_rows``) at (3, 7,850),
   (8, 206,922), (2, 28,311,552) and (3, 7), rows on and off a 16-byte
   boundary, each row seeing all 8 received patterns of 3 channels: bitwise
   equal to the plain row versions and to M flat launches, row by row, and
   at the subnormal scales; then the segmented forms (``maxabs_segments``,
   ``histogram_segments``) at the layer slices of cnn_mnist (M=8), lr_mnist
   (M=3) and rnn_shakespeare (M=8) and on an edge battery (one-float
   slices, an all-zero slice, slices at every offset mod 4 floats, a NaN,
   a +inf, subnormals): one launch each, bitwise equal to the plain
   segmented versions and to a flat launch on every (row, slice), the
   per-layer candidate mask bitwise its plain version, and unchanged after
   ten launches of a larger grid;
3. ``swa_decode`` against its plain version on the card, f32 (rtol = atol =
   2e-5) and bf16 (1e-2), at TestSWADecode's shapes, the GQA serve shape
   (B=8, H=12, Kv=2, W=4096, Dh=128), W=4160 and the families' decode
   shapes (B=8, H=Kv=16, W=4096, Dh=128: olmoe; B=8, H=Kv=32, W=4096,
   Dh=64: zamba2), the vlm and audio ones (B=8, H=Kv=32, W=4096, Dh=96:
   phi-3-vision; B=8, H=Kv=12, W=1,500, Dh=64: whisper's cross-attention
   over its encoder slots), Dh 96 under GQA (B=2, H=16, Kv=2, W=300) and
   A15's configs' decode shapes at Dh 128 (B=8, H=32, Kv=2: glm4-9b, REP
   16; B=8, H=36, Kv=4: starcoder2-7b, REP 9; B=4, H=56, Kv=8: yi-34b, REP
   7; B=8, H=48, Kv=8: grok-1-314b, REP 6; W=4096),
   with lengths 1, W/2+3 and W; slots past the length filled with +-1e9
   must leave the output alone;
   B=1 (many splits), W=16, REP=16 and W=1,500 (Dh 64 and 96) at lengths
   on either side of each tile and split edge; two launches bitwise equal,
   also after a launch with more groups; at Dh 32 / 64 / 128 the outputs
   on fixed inputs (``swa_digests``) bitwise those of the kernel before
   Dh 96 was added (``SWA_DIGESTS``, made on the same card type, torch
   and nvcc); then its partial form (``swa_decode_partial``: the f32
   output with m and l, for a rank's shard of the cache's slots) at a
   rank's shard of the serve cache (B=8, H=12, Kv=2, W=2,048, Dh=128), at
   the shards phase 5d's serving job runs (W=520 and W=512), at Dh 64, at
   Dh 96 under GQA, at zamba2-1.2b's shard in phase 5d (e) (B=8,
   H=Kv=32, W=520, Dh=64) and at olmoe-1b-7b's and phi-3-vision-4.2b's in
   (f) (B=8, H=Kv=16, W=520, Dh=128; B=8, H=Kv=32, W=520, Dh=96) and
   whisper-small's in (g) (B=8, H=Kv=12, W=128, Dh=64), with
   rows of W, W/2+3, 1 and 0 valid slots: its
   output cast to q's dtype bitwise ``swa_decode``'s, (out, m, l) against
   the plain partial version; and the serve shape and phase 5d's two
   caches cut into two halves as ``layers.attention_decode`` cuts them,
   the kernel's and the plain version's states merged
   (``ref.merge_decode_partials``) within the tolerance of ``swa_decode``
   over the whole window; and ``layers.attention_decode_heads`` (a rank's
   query heads over their heads of a cache every rank holds whole:
   whisper-small's cross cache under P = 2, B=8, H=12, W=1,500, Dh=64)
   one ``swa_decode`` launch a call, each rank within the tolerance of
   the plain version and of ``swa_decode`` on its contiguous heads, every
   slot valid and at mixed lengths;
3b. threefry_normal, the weights' draw, bitwise its plain version on the
   card at one layer of yi-34b's ``w_up`` and glm4-9b's ``embed`` (bf16),
   olmoe's router (f32) and an odd length;
4. a small f32 trainer on the card, kernel backend against the plain backend
   (every leaf through the kernels), to the CPU tests' tolerances;
5. the training path: ``make_task("qwen2_100m", preset="full")`` at full
   width (128,419,584 parameters, bf16, drawn with the ported threefry)
   with ``aggregate="dense_masked"`` and the CUDA kernels, 3 sync rounds of
   2 FL devices, each leaf compressed once over both devices' rows; each
   LGC row counter must be 3 rounds x 8 leaves = 24, the flat counters and
   swa_decode's 0; then the same 3 rounds from the same state through the
   flat kernels device by device (``rows=False``, 48 launches each) must
   give bitwise the same params and error memory; device 0's inputs of the
   largest leaf's first call in round 2 are kept (a copy taken by wrapping
   the step's ``lgc_compress_hist_rows``) for phase 9;
   then the same task under ``gilbert_flaky``: 3 rounds whose (M, C)
   delivery masks come from the scenario's chains and dropout on the host
   (at least one 0 among them), the row counters 24 and the flat ones 0,
   params and error memory bitwise equal to the device-by-device flat
   path (``rows=False``) from the same state;
   then (phase 5b) the same task with its default ``sparse_gather``: 3
   rounds through the ``maxabs`` and ``histogram`` row kernels (24
   launches each over every leaf's model-dim rows, every other kernel 0),
   params and error memory bitwise equal to the plain backend's from the
   same state; its device-steps/s beside ``dense_masked``'s, the analytic
   wire bytes (51,367,680 against 513,678,336) and peak memory; the
   maxabs and histogram row kernels (``sum_maxabs_rows``, ``maxabs_rows``,
   ``histogram_rows`` and ``steps._row_stats``, one launch each at any
   height) bitwise their plain versions and timed at the sparse path's
   rows ((6,144, 9,216), (64,000, 768), (96,000, 768) and (151,936,
   1,536)) beside ``vector_norm(u, inf, dim=1)`` and the unfused add;
   the sweep of their two forms (short: a warp a row; wide: a row on each
   ``blockIdx.y``) at 256 MB of rows of n in {68, 768, 1,536, 3,072,
   9,216, 65,536}, both forms bitwise equal (``--rows`` runs only these
   and the build); the selection's ms at the largest leaf; ``bucket_sparse`` for 3
   rounds (no kernel); a checkpoint of the sparse run's state (bf16
   params, (2, ...) f32 error memory, round counter) restored to the card
   bitwise, with bytes and seconds; and ``repro_torch.launch.train`` in
   process at full width in ``sync`` (AdamW with the clip) and
   ``lgc_sparse``, each returning (its loss fell) with its seconds, the
   driver's ``lgc_sparse`` selecting over whole leaves as the reference's
   driver does, and once more under the task's per-row rule for its time;
5c. the families' training: one LGC round (``dense_masked``, M = 2,
   H = 2, every leaf through the row kernels, a dropped channel) of the
   olmoe, mamba2, zamba2, phi-3-vision and whisper smoke configs in f32,
   card against CPU within the CPU tests' tolerances; then each at its
   published width in bf16 for 4 rounds through the LGC row kernels
   (``dense_masked``, H = 2; mamba2-370m, zamba2-1.2b, phi-3-vision-4.2b
   and whisper-small through ``repro_torch.launch.train.main``, olmoe-1b-7b
   at 4 of its 16 layers through the step functions): the loss finite and
   falling, each row kernel launched once a round for each of the 10 / 6 /
   14 / 10 / 20 leaves of at least 1e5 floats, no flat kernel and no plain
   compression of such a leaf; round 2's rows of each arch's largest leaf
   (up to phi-3-vision's 805,306,368-float ``w_down``) bitwise the plain
   row versions through all three kernels; host ms a round, device busy ms
   and idle share (round 4 under torch.profiler), peak memory (one
   ``family_training`` JSON line); A15's configs the same way: the smoke
   round of glm4, starcoder2, yi and grok-1 (SGD momentum), then glm4-9b
   (M = 2), starcoder2-7b (M = 2) and yi-34b (M = 1) at 4 layers through
   the step functions, 9 / 8 / 9 kernel-sized leaves (glm4's 620,756,992-
   float ``embed`` the largest leaf);
5d. the model axis (tensor parallelism, ``--model-axis`` runs only the
   build and this phase): two gloo ranks share the card (``mesh.spawn``;
   their body is ``model_axis_rank``).  (a) At each of the 100M task's
   8 kernel-sized leaves at full width, M = 2, random (e, delta) from a
   seeded CPU generator and a dropped channel: each rank's split pipeline
   (``sum_maxabs_rows`` on its shard, MAX over the model group,
   ``histogram_rows`` under the global maxima, SUM of the counts, the
   whole leaf's budgets, ``sparsify_ef_rows``) bitwise its block of the
   unsharded ``lgc_compress_hist_rows`` on the card and of the plain split
   pipeline, and the step's compression under ``dense_masked`` and
   ``sparse_gather`` bitwise the unsharded step's; (b) the full-width 100M
   task at ``model_axis=2`` (M = 2, H = 2, seq 64) for 4 rounds of each of
   ``dense_masked`` and ``sparse_gather``, each from the same draw as a
   P = 1 run of the same aggregate here: both ranks' losses bit-equal and
   falling, every round's within ``MODEL_AXIS_LOSS_ATOL`` of P = 1's (set
   from sound and planted-fault readings: ``--model-axis-faults``), each
   row kernel 8 a round a rank (``sparsify_ef_rows`` 0 under
   ``sparse_gather``) and no flat launch; per round and rank the round ms
   beside P = 1's (rounds 1-3 without syncs), the ms inside the model
   group's collectives (round 4, each collective waiting for the card
   before and after) and the launches; (d) serving under the model axis
   in the same ranks (``model_axis_serve``): qwen2-1.5b at full width,
   each rank with its shards of seed 0's draw, 8 prompts of 1,000 tokens,
   40 greedy steps over a full cache of 1,040 slots and over a 1,024-slot
   ring that wraps at step 24, both split 520 / 512 slots a rank; rank 0
   runs P = 1 from the whole draw alone on the card (timed) and hands its
   tokens to rank 1, then both runs at P = 2 with every step fed P = 1's
   token: every step's logits within ``MODEL_AXIS_LOGITS_MEAN_ATOL`` /
   ``MODEL_AXIS_LOGITS_ATOL`` of P = 1's in the mean / max (set from sound
   and planted-fault readings: ``--model-axis-faults``),
   ``swa_decode_partial`` launched 28 a step and nothing else, both
   ranks' logits bitwise equal; then the full-cache run through
   ``serve_decode.serve(..., mesh=)``, greedy on its own tokens: at least
   ``MODEL_AXIS_TOKEN_SHARE`` of them P = 1's, each at most
   ``MODEL_AXIS_TOKEN_MARGIN`` below P = 1's greedy logit at its history
   (P = 1 fed the free run's tokens), the ranks' tokens equal; prefill s,
   decode ms a step (beside P = 1's), collectives a step and the host ms
   blocked in them; (e) the ssm and hybrid families in the same ranks
   (``model_axis_family``): mamba2-370m and zamba2-1.2b at full width and
   depth, each from seed 0's draw, rank 0 first alone at P = 1 and then
   both ranks at P = 2 on their shards: 2 LGC rounds in f32
   (``dense_masked``, M = 2, H = 2, batch 4 x 128; every round's loss
   within ``MODEL_AXIS_SSM_LOSS_ATOL`` of P = 1's, both ranks' losses
   bit-equal and falling, each row kernel 6 / 14 a round a rank and no
   flat launch; round ms, collectives and host ms blocked in them), then
   in bf16 ``serve_decode.serve(..., mesh=)`` on 8 x 128 tokens, 2 steps
   (the ranks' tokens bitwise equal), and 8 prompts of 1,024 tokens into
   a 1,040-slot cache and 8 steps fed P = 1's tokens (every step's
   logits within ``MODEL_AXIS_SSM_LOGITS_MEAN_ATOL`` / ``_ATOL`` of
   P = 1's, both ranks' bitwise equal, ``swa_decode_partial`` 7 a step at
   zamba2 and nothing else, a rank's conv channels, heads and slots its
   ``cache_specs`` block; prefill s, decode ms a step beside P = 1's,
   collectives a step and the host ms blocked in them; P = 1 and P = 2's
   gaps to P = 1 in f32 fed the same tokens, a yardstick); the
   limits set from sound and planted-fault readings
   (``--model-axis-faults``: the gated norm's sum left local, the
   split-use gradients left unsummed, the prefill writing the next rank's
   conv tail); (f) the moe and vlm families the same way
   (``model_axis_family``, as (e)): olmoe-1b-7b (expert-parallel, 32 of
   its 64 experts a rank) and phi-3-vision-4.2b (``vis_proj``'s columns
   gathered) at full width, 3 LGC rounds in f32 at 2 / 4 of their 16 / 32
   layers (phi-3-vision's 576 patches before the 128 tokens), each row
   kernel 10 a round a rank; serving in bf16 at full depth, 1,024
   positions a prompt (phi-3-vision: 576 patches and 448 tokens) into
   1,040 slots and 8 fed steps, ``swa_decode_partial`` 16 / 32 a step
   at Dh 128 / 96, ``serve_decode.serve(mesh=)`` on 128 tokens; limits
   ``MODEL_AXIS_MOE_VLM_*`` from ``--model-axis-faults`` (the router's
   gradient unsummed, the load-balance loss's gradient counted on every
   rank, each rank combining the next rank's expert block,
   ``vis_proj``'s columns gathered in the reverse order), which also
   reads the bf16 drift at P = 2 of mamba2-370m and qwen2-100m (one
   forward and backward against P = 1 and against f32; no limit);
   (g) the audio family the same way: whisper-small at full width and
   depth (12 encoder blocks over 1,500 frames, 12 decoder blocks with
   cross-attention), 3 LGC rounds in f32 over the driver's zero frames,
   each row kernel 20 a round a rank; serving in bf16, 8 x 192 tokens and
   1,500 frames drawn from one seed on both ranks into 256 slots, 8 fed
   steps, ``swa_decode_partial`` (the rank's 128 self-attention slots) and
   ``swa_decode`` (the rank's 6 of the 12 heads of each block's
   1,500-slot cross cache, ``layers.attention_decode_heads``) 12 each a
   step, both ranks' cross caches bitwise equal, then
   ``serve_decode.serve(mesh=)`` on 128 tokens; limits
   ``MODEL_AXIS_AUDIO_*`` from ``--model-axis-faults`` (the encoder
   output's gradient left unsummed, the cross ``wo`` output left unsummed,
   the decode's query heads over the next rank's heads of the cross
   cache); (c) ``repro_torch.launch.train
   --model-parallel 2 --devices 2 --mode sync`` for 3 steps (it spawns its
   own two ranks), its loss falling; one ``model_axis`` JSON line;
6. a small f32 serve (qwen2-smoke), card against CPU with the same weights:
   8-token prefill into a 16-slot ring, 24 greedy steps past the wrap; the
   logits agree at rtol = atol = 1e-5 and the tokens are equal; then the
   same for the moe, ssm and hybrid smoke configs (olmoe, mamba2, zamba2:
   a 16-token prefill into a 24-slot ring, 16 steps) and the vlm and audio
   ones (phi3v-smoke: 16 patch embeddings and 8 tokens, whisper-small-smoke:
   64 encoder frames and 16 tokens; 24-slot ring, 16 steps; the caches,
   whisper's cross K/V included, within 1e-5), swa_decode launched steps x
   attention sites times (whisper: self- and cross-attention a block); and
   A15's four smoke configs (a 16-token prefill into a 24-slot ring, 16
   steps);
7. the serving path: qwen2-1.5b at full width (1,543,910,912 parameters,
   bf16), 8 prompts of 4,000 tokens prefilled into the 4,096-slot ring of
   ``cfg.window``, then 160 greedy steps (positions 4000-4159, the ring
   wraps at 4096); swa_decode must launch 160 x 28 = 4,480 times and the
   LGC kernels none;
7b. the moe, ssm and hybrid families at full width in bf16 with weights
   drawn on the card (olmoe-1b-7b 6,919,620,608 parameters, mamba2-370m
   420,136,448, zamba2-1.2b 1,170,473,856), 8 prompts of 4,096 tokens into
   a 4,096-slot ring and 64 greedy steps past its wrap: swa_decode launched
   16 x 64, 0 and 7 x 64 times, no other kernel; for each (and for phase
   7) the draw's seconds (threefry_normal launched once a layer of every
   drawn leaf, nothing else launched by the draw), prefill ms and prompt
   tokens/s, decode ms/step beside the step's bytes bound, peak memory,
   finite logits (one ``families`` JSON line);
7c. the vlm and audio families at full width in bf16 with weights and
   modality stubs drawn on the card: phi-3-vision-4.2b (3,825,404,928
   parameters) with 8 x 576 patch embeddings and 3,520 tokens filling a
   4,096-slot ring, then 64 greedy steps past its wrap (swa_decode 32 a
   step, at Dh 96); whisper-small (304,508,928) with 8 x 1,500 frames
   through the encoder and 192 tokens into a 256-slot ring, then 240 steps
   (24 a step: 12 self- and 12 cross-attention over the 1,500 slots); then
   16 more steps of each under torch.profiler, to position 448 for whisper,
   its decoder's ceiling; one ``modalities`` JSON line: prefill s, decode
   ms/step beside the step's bytes bound (the encoder, ``vis_proj`` and
   the cross K/V projections are not read by a decode step, ``dec_pos``
   one row; whisper's cross cache is), swa_decode launches a step, peak
   memory and the device's idle share;
7d. A15's configs at full width in bf16 with weights drawn on the card:
   glm4-9b (10 of 40 layers, 3,281,126,400 parameters; swa_decode at
   REP 16) and starcoder2-7b (8 of 32, 2,189,812,736; REP 9) at batch 8
   over 4,096-token prompts and 64 steps past the 4,096-slot ring's wrap,
   yi-34b (30 of 60 layers,
   17,653,214,208; REP 7; leaves of up to 4.4 G elements, past 2**32) at
   batch 4 over 4,000 tokens and 160 steps,
   grok-1-314b at 2 of its 64 layers
   (11,450,578,944; REP 6; the gated experts' prefill buffer (8, 10,240,
   6,144)) as glm4; then 8 steps of each under torch.profiler; swa_decode
   launched sites x steps times and nothing else; one ``configs`` JSON
   line as 7c's;
8. (in a spawned process of its own, started before 5c and joined after
   7d: ``start_phase8``) the simulator: the threefry PRNG on the card
   (``split``, ``fold_in``,
   ``stream_key``, raw bits, ``randint``, ``uniform``, ``normal``,
   ``truncated_normal``, the batched ``stream_keys`` and the row samplers)
   bitwise equal to the CPU's; then both engines with ``backend="cuda"`` on
   the card against the same run on the CPU (the kernels' plain versions):
   ``lr_mnist`` at the quickstart's defaults (M=3, n_train 3000, 60
   rounds, H=4, eval every 20) in modes lgc and fedavg, and ``cnn_mnist`` at
   the factory's (n_train 6000, batch 64) with M=8, 20 rounds, H=4 in modes
   lgc and topk; then, in mode lgc, ``cnn_mnist`` (M=8, 12 rounds) under
   ``gilbert_flaky`` and ``rnn_shakespeare`` at the factory's defaults
   (M=8, sequences of 48, 2,000 windows per device, D = 83,955; 12
   rounds) under ``mobile_noniid``, where at least one sync must have
   lost a channel or the whole device; ``step`` and ``uplink_mb`` equal,
   losses within 1e-3 and accuracy counts within 1e-3 of the eval
   predictions (1e-2 under a dynamic scenario, with the CPU's loop
   against batched engine logged as the yardstick of summation order);
   in the card runs every sync's (g, e')
   bitwise equal to the plain pipeline on the same card tensors
   (``lgc_compress_hist`` and ``lgc_compress_hist_rows`` wrapped); the loop
   engine launches each flat LGC kernel once per device and sync (45 for lr
   lgc, 0 for fedavg, 40 for each cnn mode, 24 for each scenario run),
   the batched engine each row kernel once per sync boundary (15, 0, 5,
   5, 3, 3) and no flat kernel, with
   torch's sync debug mode raising on any host sync inside a window;
   swa_decode never; then a second card run of each engine, not checked
   per sync, for the host ms per round (the run's time over its rounds) and
   device-steps/s, in the same call;
   then the per-layer budgets: ``cnn_mnist`` (M=8, 12 rounds, lgc) under
   ``size_prop`` and ``divergence`` on both engines, card against CPU,
   every sync's candidate mask and (g, e') bitwise the plain segmented
   pipeline on the same card tensors, launches per sync boundary (batched:
   1 of each segmented kernel and of each row kernel) or per syncing device
   (loop: the same, on one row), and
   ``uniform`` bitwise ``global`` on the exact backend on the card; then
   the servers: ``lr_mnist`` (M=8, 20 rounds, every 4th device 3x slower)
   under mean, diloco and semi_sync (``staleness_cap=2``) on both engines,
   card against CPU with ``server_wall_s`` equal, semi_sync's wall below
   the mean's; then the learning-based control on the card: ``lr_mnist``
   (M=3, 3,000 samples, 60 rounds) under a shared-space ``FleetDDPG`` and
   ``cnn_mnist`` (M=8, the factory's samples, 24 rounds) on
   ``hetero_fleet`` under a per_device fleet (h at most 4, compute prior
   1.5), pipelined with ``max_gap=4``, replay batches of 4, on both
   engines: every sync bitwise the plain pipeline with each row's own
   budgets, the flat LGC kernels once per device sync (loop) or the row
   kernels once per boundary (batched), every device trained, every
   decision within ``1 <= h <= min(max_gap, battery cap)`` and its
   budget, the spend audit (``core.audit``) exact; the fleet's host ms per
   boundary (act, reward eval, observe + train), pipelined against
   blocking windows and device-steps/s beside the fixed controller's, in
   the same call; a ``FleetDDPG(3)`` bitwise its agent list on the card
   (both engines); the card's fleet against the CPU's in lockstep (re-
   loaded each boundary; raw actions and one-step nets within rtol 1e-4);
   the reference's scripted per_device decisions on ``lr_mnist`` (M=8)
   under ``static`` and ``gilbert_flaky``, card against CPU with spend and
   decisions equal, pipelined == blocking asdict-equal on the card;
   then the population layer (N = 100,000 devices, cohorts of M = 64,
   H = 4, lgc): the reference bench's configuration (the synthetic
   population task, 12 rounds) with the dense, int8 and server EF stores
   on the batched engine and the dense store on the loop engine, and
   ``lr_mnist`` with the dense store (3.14 GB resident on the card; its
   bytes and ``torch.cuda.max_memory_allocated`` printed) and the int8
   store, 8 rounds; each card run against the same run on the CPU
   (cohorts and participation equal, History within 1e-3), every sync
   bitwise the plain row pipeline, no host sync inside a window, each row
   kernel once per window (batched) or once per cohort row (loop);
   then the sharded engine (``engine="sharded"``, one ``sharded`` JSON
   line): cnn_mnist (M=8, 20 rounds, lgc) on a one-rank NCCL mesh in this
   process under gather (bitwise the batched engine, the same launches)
   and psum (loss and uplink within 1e-4), and two gloo ranks sharing the
   card (``mesh.spawn``) running lr_mnist M=8 (lgc, topk, lgc_q8, gaps
   2 + m mod 5, semi_sync under both reduces, a per_device DDPG fleet on
   hetero_fleet) and a population (lr_mnist, N = 100,000, M = 64, dense
   store, 3 windows), each against the unsharded engine on the card and
   every rank's row kernel calls bitwise their plain versions; host ms
   per window beside the unsharded engine's; a rank that fails or a
   collective that hangs ends the run non-zero;
9. the ``kernels`` line: each kernel's time beside its plain version, its
   bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s) and one
   PyTorch call as a yardstick.  ``ms`` is the median of single calls
   between two CUDA events (host code included); ``device_ms`` is the
   device time per call, events around 100 back-to-back calls that a sleep
   kernel queues up (for the kernel and the library call alike); the LGC
   kernels at the largest leaf, at ``embed`` and at the simulator's flat
   vectors (``at_cnn_mnist``, D = 206,922; ``at_lr_mnist``, D = 7,850; there
   maxabs is ``sum_maxabs``, as the simulator calls it) with their launches
   per simulator run (``launches_simulator``, the DDPG runs included) and
   per population run (``launches_population``) and per sharded run
   (``launches_sharded``: world 1 by reduce, world 2 summed over the
   ranks), the
   histogram also on the main path's real u of round 2 (``at_main_path_u``)
   and on a constant
   vector (``at_one_bin``), ``sum_maxabs`` against the add and maxabs apart
   (``at_sum`` of maxabs), and each LGC kernel's row form at (3, 7,850),
   (8, 206,922), (8, 83,955) and (2, 28,311,552) (``rows``: the paths'
   launches of it,
   its times, the plain row version, M flat launches and, for maxabs,
   ``vector_norm(u, inf, dim=1)``, for histogram M ``histc`` calls);
   maxabs and histogram also at the sparse path's rows of phase 5b
   (``at_sparse_gather_rows``, each with the form that ran, ``maxabs_rows``
   beside ``vector_norm``) and the sweep of their two row forms
   (``row_form_sweep``);
   the segmented forms at the three models' (M, D) beside the M x L
   ``amax`` / ``histc`` calls they replace and one ``segment_reduce(|u|,
   "max")``, their ``launches`` from the batched per-layer CNN run under
   ``size_prop``; swa_decode at the GQA serve
   shape in bf16 with every slot valid, its inputs rotated over four copies
   so that each call finds them outside the L2 cache, as a decode step does,
   and so at the families' two shapes (``at_families``, with the families'
   launches in ``launches_families``) and at phi-3-vision's and whisper's
   cross-attention shapes (``at_modalities``, ``launches_modalities``)
   and at A15's configs' decode shapes (``at_configs``,
   ``launches_configs``); threefry_normal, the weights' draw (not the port
   of a TPU kernel), at one layer of yi-34b's ``w_up`` in bf16 beside its
   plain version (no library call draws the same numbers), its
   ``launches`` those of phase 7's draw and ``launches_families``,
   ``launches_modalities`` and ``launches_configs`` those of 7b-7d; the
   LGC kernels' launches on each rank of phase 5d
   (``launches_model_axis``); ``swa_decode_partial`` (a form of
   ``swa_decode``) at a rank's shard of the serve cache (B=8, H=12, Kv=2,
   W=2,048, Dh=128, bf16) beside ``swa_decode`` at that shape, its
   ``launches`` those of rank 0's free run in phase 5d (d) and
   ``launches_model_axis_serve`` those of its fed runs, and at zamba2's
   shard (B=8, H=Kv=32, W=520, Dh=64, ``at_zamba2_shard``) with phase 5d
   (e)'s launches (``launches_model_axis_ssm_serve``), at olmoe-1b-7b's
   and phi-3-vision-4.2b's shards (``at_olmoe_shard``, ``at_phi3v_shard``)
   with (f)'s (``launches_model_axis_moe_vlm_serve``), at
   whisper-small's shard (B=8, H=Kv=12, W=128, Dh=64,
   ``at_whisper_shard``) with (g)'s (``launches_model_axis_audio_serve``);
   ``swa_decode`` over a rank's 6 heads of whisper-small's cross cache
   (``at_whisper_cross_heads``: the (16, 6, 6, 1500, 64) launch of
   ``attention_decode_heads``, half its rows empty, beside SDPA over the
   strided heads and the copy design's time) with (g)'s launches
   (``launches_model_axis_audio_serve``); the LGC kernels' launches on
   each rank in phase 5d (e), (f) and (g) (``launches_model_axis_ssm``,
   ``launches_model_axis_moe_vlm``, ``launches_model_axis_audio``);
10. the last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 rate outside the tensor cores
LARGEST_LEAF = 28_311_552        # blocks/mlp/w_* of qwen2_100m: 12 x 768 x 3072
EMBED = 24_576_000               # embed of qwen2_100m: 32000 x 768
N_KERNEL_LEAVES = 8
ROUNDS, M_DEVICES = 3, 2
LGC_KERNELS = ("maxabs", "histogram", "sparsify_ef")
# the serving path: qwen2-1.5b, 8 prompts of 4000 tokens, a 4096-slot ring
SERVE_ARCH, SERVE_PARAMS = "qwen2-1.5b", 1_543_910_912
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 4000, 160
SWA_SERVE_SHAPE = (8, 12, 2, 4096, 128)          # (B, H, Kv, W, Dh)
# the families' decode shapes: olmoe-1b-7b (REP 1, Dh 128) and zamba2-1.2b
# (REP 1, Dh 64) at batch 8 over a 4096-slot ring
SWA_FAMILY_SHAPES = {"olmoe-1b-7b": (8, 16, 16, 4096, 128),
                     "zamba2-1.2b": (8, 32, 32, 4096, 64)}
# the vlm and audio decode shapes: phi-3-vision-4.2b's (Dh 96) and
# whisper-small's cross-attention over its 1,500 encoder slots (the last
# 64-slot tile partial: 1,500 = 23 x 64 + 28)
SWA_MODALITY_SHAPES = {"phi-3-vision-4.2b": (8, 32, 32, 4096, 96),
                       "whisper-small": (8, 12, 12, 1500, 64)}
# A15's configs' decode shapes, all at Dh 128 over a 4,096-slot ring:
# glm4-9b REP 16 (two groups of 8 query heads a KV head), starcoder2-7b REP
# 9 (a group of 8 and one of 1), yi-34b REP 7 (batch 4), grok-1-314b REP 6
SWA_CONFIG_SHAPES = {"glm4-9b": (8, 32, 2, 4096, 128),
                     "starcoder2-7b": (8, 36, 4, 4096, 128),
                     "yi-34b": (4, 56, 8, 4096, 128),
                     "grok-1-314b": (8, 48, 8, 4096, 128)}
SWA_SHAPES = [(2, 4, 4, 512, 64), (1, 8, 8, 1024, 128), (4, 2, 2, 256, 32),
              SWA_SERVE_SHAPE, (8, 12, 2, 4160, 128),
              *SWA_FAMILY_SHAPES.values(), *SWA_MODALITY_SHAPES.values(),
              (2, 16, 2, 300, 96), *SWA_CONFIG_SHAPES.values()]
# the kernel's outputs at Dh 32 / 64 / 128 on fixed inputs, one digest a
# shape (``swa_digests``), from the kernel before Dh 96 was added.  They
# hold only where they were made (``SWA_DIGESTS_MADE_ON``): the card's SM
# count picks the splits, torch's CPU generator draws the inputs and nvcc
# compiles the sums.  ``python3 chip_smoke.py --swa-digests`` prints them
# for the kernel of the checkout it runs in.
SWA_DIGESTS_MADE_ON = {"sms": 132, "torch": "2.11.0+cu128", "nvcc": "12.9"}
SWA_DIGESTS = {
    "1,12,12,1500,64": "c9ad53c49ee42287", "1,12,2,4096,128": "45664d52ca1829d0",
    "1,16,1,4160,32": "0b0ede76e1860bc7", "1,8,8,1024,128": "965d42550c28330f",
    "2,4,2,16,64": "f4d945a508609613", "2,4,4,512,64": "2d886be3223d5c03",
    "4,2,2,256,32": "fc122e7887f491cf", "8,12,12,1500,64": "7f48f2ded5c32189",
    "8,12,2,4096,128": "09598b2080849a87", "8,12,2,4160,128": "df68e3efdcf3d7ce",
    "8,16,16,4096,128": "4231f81ceae9b9b4", "8,32,32,4096,64": "11731bc3e3fbc395",
    # A15's configs' decode shapes, made from the same kernel (and equal to
    # the digests that the current kernel gives)
    "4,56,8,4096,128": "6eb317030220454c", "8,32,2,4096,128": "c9af3467381df167",
    "8,36,4,4096,128": "c32dffa9cd7a1b07", "8,48,8,4096,128": "a5f5fd18efbf831b"}
# the moe, ssm and hybrid serving paths at full width: (arch, params by
# shape); batch 8, 4,096-token prompts (a multiple of the SSD chunk, 128)
# into a 4,096-slot ring, then 64 greedy steps past its wrap
FAMILIES = {"olmoe-1b-7b": 6_919_620_608, "mamba2-370m": 420_136_448,
            "zamba2-1.2b": 1_170_473_856}
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN = 8, 4096, 64
SWA_EDGE_SHAPES = [(1, 12, 2, 4096, 128), (2, 4, 2, 16, 64),
                   (1, 16, 1, 4160, 32), (1, 12, 12, 1500, 64),
                   (1, 16, 1, 1500, 96)]
# the vlm and audio serving paths at full width: (params by shape, batch,
# prompt tokens, greedy steps, ring slots); phi-3-vision's 576 patch
# positions and 3,520 tokens fill its 4,096-slot ring, whisper stays within
# its decoder's 448 positions (192 + 240 steps + 16 profiled)
MODALITIES = {"phi-3-vision-4.2b": (3_825_404_928, 8, 3_520, 64, 4_096),
              "whisper-small": (304_508_928, 8, 192, 240, 256)}
MODALITY_PROFILE_STEPS = 16
# A15's configs at full width: (layers served, params by shape at that
# depth, batch, prompt tokens, greedy steps) into a 4,096-slot ring, then
# CONFIG_PROFILE_STEPS more under the profiler; grok-1-314b at 2 of its 64
# layers (316 G parameters do not fit one card); glm4-9b and
# starcoder2-7b at a quarter of their depth (10 of 40, 8 of 32 layers) and
# yi-34b at half (30 of 60), which keeps the whole script inside its time
# limit; yi-34b (32.9 GiB of weights at 30 layers, leaves of up to 4.4 G
# elements, past 2**32) at batch 4 and 4,000 prompt tokens, 160 steps past
# the wrap
CONFIGS = {"glm4-9b": (10, 3_281_126_400, 8, 4_096, 64),
           "starcoder2-7b": (8, 2_189_812_736, 8, 4_096, 64),
           "yi-34b": (30, 17_653_214_208, 4, 4_000, 160),
           "grok-1-314b": (2, 11_450_578_944, 8, 4_096, 64)}
CONFIG_PROFILE_STEPS = 8
# the simulator: lr_mnist at the quickstart's defaults and cnn_mnist at the
# task factory's (n_train 6000, batch 64) with 8 devices; (task, M, n_train,
# rounds, eval_every, modes)
# and, under dynamic scenarios, cnn_mnist and rnn_shakespeare (n_train None:
# the factory's default); (task, M, n_train, rounds, eval_every, modes,
# scenario)
SIM_H = 4
SIM_RUNS = [("lr_mnist", 3, 3000, 60, 20, ("lgc", "fedavg"), "static"),
            ("cnn_mnist", 8, 6000, 20, 10, ("lgc", "topk"), "static"),
            ("cnn_mnist", 8, 6000, 12, 6, ("lgc",), "gilbert_flaky"),
            ("rnn_shakespeare", 8, None, 12, 6, ("lgc",), "mobile_noniid")]
LR_D, CNN_D, RNN_D = 7_850, 206_922, 83_955
# card against CPU under a dynamic scenario: 12 rounds stop in the steep
# part of training, where dropped channels leave more mass near the layer
# thresholds and summation order alone moves the loss by about 1e-3 (the
# phase logs the CPU's loop against batched engine as the yardstick); the
# syncs themselves are held bitwise
SCENARIO_HIST_TOL = 1e-2
ENGINES = ("loop", "batched")
ROW_KERNELS = {"maxabs": "maxabs_rows", "histogram": "histogram_rows",
               "sparsify_ef": "sparsify_ef_rows"}
# (M, D) of the row forms on the paths: the lr, cnn and rnn simulator runs
# and the largest leaf of the training path
ROW_SHAPES = [(3, LR_D), (8, CNN_D), (8, RNN_D), (M_DEVICES, LARGEST_LEAF)]
# (M x R, n) rows of the sparse path (each leaf's model-dim view): the
# largest leaf's and embed's at M = 2, embed's at M = 3 and qwen2-1.5b's
# embed (151,936 x 1,536) on one device, the last two above 65,535 rows
SPARSE_ROW_SHAPES = [(M_DEVICES * 3_072, LARGEST_LEAF // 3_072),
                     (M_DEVICES * 32_000, 768), (3 * 32_000, 768),
                     (151_936, 1_536)]
# the crossover sweep of the two row forms: rows of n floats, 256 MB of u
SWEEP_NS = (68, 768, 1_536, 3_072, 9_216, 65_536)
SWEEP_FLOATS = 1 << 26

# the weights' draw kernel against its plain version: (shape, dtype, std)
# of one layer of yi-34b's w_up (timed), glm4-9b's embed, olmoe's f32
# router and an odd length
THREEFRY_CASES = [((7_168, 20_480), "bfloat16", 7_168 ** -0.5),
                  ((151_552, 4_096), "bfloat16", 0.02),
                  ((2_048, 64), "float32", 2_048 ** -0.5),
                  ((4_097, 3), "float32", 1.0)]
# operations an element of the draw, counted from its source: threefry's
# 2 + 20 x 3 (add, rotate, xor) + 5 x 3 key injections and its output xor,
# the uniform's 5, erf_inv's ~33 over the log1p branch taken, the scales
# and the cast; counted at the f32 rate
THREEFRY_OPS = 120

# the segmented forms (per-layer budgets): the simulator's models
# with their device counts, the per-layer runs (cnn_mnist, M=8, 12 rounds
# under each policy) and the server runs (lr_mnist, M=8, every 4th device
# 3x slower, 20 rounds, as the reference's tests/test_server.py:36-37)
SEGMENT_MODELS = (("cnn_mnist", 8), ("lr_mnist", 3), ("rnn_shakespeare", 8))
SEGMENT_KERNELS = {
    "maxabs_segments": ("maxabs", "src/repro_torch/kernels/csrc/maxabs.cu",
                        "src/repro/kernels/topk_threshold.py:32"),
    "histogram_segments": ("histogram",
                           "src/repro_torch/kernels/csrc/histogram.cu",
                           "src/repro/kernels/topk_threshold.py:42"),
}
PER_LAYER_POLICIES = ("size_prop", "divergence")
PER_LAYER_RUN = ("cnn_mnist", 8, 6000, 12, 6)   # task, M, n_train, rounds, eval
SERVER_RUN = ("lr_mnist", 8, 1500, 20, 10)
SERVER_AGGS = ("diloco", "semi_sync")
# one-float slices, slices starting at every offset mod 4 floats, slices
# around one block's pass (4,096 floats) and a long one
EDGE_SIZES = [1, 1, 1, 2, 3, 4095, 4097, 63, 1, 8192, 5, 200_003]

# the population layer: N devices, M-device cohorts; (config, store,
# engine, rounds): the reference bench's configuration
# (benchmarks/bench_population.py:29-38) with each store, and lr_mnist with
# the dense store (N x 7,850 x 4 B = 3.14 GB on the card) and int8
POP_N, POP_M = 100_000, 64
POP_RUNS = [("population", "dense", "batched", 12),
            ("population", "int8", "batched", 12),
            ("population", "server", "batched", 12),
            ("population", "dense", "loop", 12),
            ("lr_mnist", "dense", "batched", 8),
            ("lr_mnist", "int8", "batched", 8)]

TPU_KERNELS = {
    "maxabs": ("src/repro_torch/kernels/csrc/maxabs.cu",
               "src/repro/kernels/topk_threshold.py:32"),
    "histogram": ("src/repro_torch/kernels/csrc/histogram.cu",
                  "src/repro/kernels/topk_threshold.py:42"),
    "sparsify_ef": ("src/repro_torch/kernels/csrc/sparsify_ef.cu",
                    "src/repro/kernels/layered_sparsify.py:32"),
    "swa_decode": ("src/repro_torch/kernels/csrc/swa_decode.cu",
                   "src/repro/kernels/swa_attention.py:23"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke: {what}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(gen, errs: dict) -> None:
    import torch
    from repro_torch.kernels import (histogram, lgc_compress_hist, maxabs,
                                     ref, sparsify_ef)
    for n in (63, 100_003, LARGEST_LEAF):
        x = torch.randn(n, generator=gen, device="cuda") * 1e-3
        e = torch.randn(n, generator=gen, device="cuda") * 1e-4
        u = e + x
        views = [("aligned", u), ("offset", u[1:])] if n > 63 else [("", u)]
        for tag, v in views:
            m = maxabs(v)
            m_ref = ref.hist_maxabs(v).reshape(1, 1)
            check(bits_equal(m, m_ref), f"maxabs D={n} {tag}")
            errs["maxabs"] = max(errs["maxabs"], max_abs_err(m, m_ref))
            check_histogram(v, m, f"D={n} {tag}", errs)
        m = maxabs(u)
        counts = histogram(u, m)
        for recv_list in ([1], [0], [1, 0, 1]):
            c_n = len(recv_list)
            recv = torch.tensor(recv_list, dtype=torch.int32, device="cuda")
            k0 = max(1, n // 100)
            cum = torch.tensor([k0 * (i + 1) for i in range(c_n)],
                               dtype=torch.int32, device="cuda")
            thr = ref.hist_thresholds(counts, m, cum)
            g, e_new = sparsify_ef(e, x, thr, recv)
            g_ref, e_ref = ref.hist_layered_sparsify(e + x, thr, recv)
            check(bits_equal(g, g_ref) and bits_equal(e_new, e_ref),
                  f"sparsify_ef D={n} recv={recv_list}")
            check(bits_equal(g + e_new, u), f"u == g + e' D={n}")
            errs["sparsify_ef"] = max(errs["sparsify_ef"],
                                      max_abs_err(g, g_ref),
                                      max_abs_err(e_new, e_ref))
            g2, e2 = lgc_compress_hist(e, x, cum, recv)
            g2_ref, e2_ref = ref.hist_lgc_compress(e, x, cum, recv)
            check(bits_equal(g2, g2_ref) and bits_equal(e2, e2_ref),
                  f"lgc_compress_hist D={n} recv={recv_list}")
            sent = int((g2 != 0).sum())
            log(f"kernels D={n} C={c_n} recv={recv_list}: bitwise equal to "
                f"the plain versions, {sent} coordinates sent")
    torch.cuda.synchronize()
    # maxabs at the edges of a block's pass (4,096 floats) and of the full
    # grid's, at pointer offsets 0-3, and on special values
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid_pass = sms * 8 * 256 * 4 * 4
    sizes = [1, 2, 3, 63, 4095, 4096, 4097, 1_000_003, grid_pass - 1,
             grid_pass, grid_pass + 1, 2 * grid_pass + 3]
    for n in sizes:
        base = torch.randn(n + 3, generator=gen, device="cuda")
        for off in range(4):
            v = base[off:off + n]
            check(bits_equal(maxabs(v), ref.hist_maxabs(v).reshape(1, 1)),
                  f"maxabs D={n} offset {off}")
    z = torch.zeros(100_003, device="cuda")
    specials = {"zeros": z, "-0.0": torch.full_like(z, -0.0),
                "NaN": z.clone().index_fill_(0, torch.tensor(
                    [77_777], device="cuda"), float("nan"))}
    for tag, v in specials.items():
        check(bits_equal(maxabs(v), ref.hist_maxabs(v).reshape(1, 1)),
              f"maxabs {tag}")
    big = torch.randn(LARGEST_LEAF, generator=gen, device="cuda")
    want = ref.hist_maxabs(big).reshape(1, 1)
    outs = [maxabs(big) for _ in range(10)]
    check(all(bits_equal(o, want) for o in outs),
          "maxabs: ten launches in a row")
    torch.cuda.synchronize()
    log(f"maxabs: bitwise equal to the plain version at D in {sizes}, "
        f"offsets 0-3, all zeros, -0.0, a NaN, and ten launches in a row")
    phase_simulator_sizes(gen, errs)
    phase_histogram_edges(gen, errs)
    phase_subnormals(errs)
    phase_rows(gen, errs)


def phase_simulator_sizes(gen, errs: dict) -> None:
    """lgc_compress_hist at the simulator's flat sizes (lr and cnn) with
    its budget (5% of D split 1/2, 1/4, 1/4) and every received pattern of
    its 3 channels, bitwise equal to the plain pipeline."""
    import itertools
    import torch
    from repro_torch.core.fl import baseline_ks
    from repro_torch.kernels import lgc_compress_hist, ref
    for n in (LR_D, CNN_D):
        x = torch.randn(n, generator=gen, device="cuda") * 1e-3
        e = torch.randn(n, generator=gen, device="cuda") * 1e-4
        cum = torch.tensor(list(itertools.accumulate(baseline_ks(n))),
                           dtype=torch.int32, device="cuda")
        for recv_list in itertools.product((0, 1), repeat=3):
            recv = torch.tensor(recv_list, dtype=torch.int32, device="cuda")
            g, e_new = lgc_compress_hist(e, x, cum, recv)
            g_ref, e_ref = ref.hist_lgc_compress(e, x, cum, recv)
            check(bits_equal(g, g_ref) and bits_equal(e_new, e_ref),
                  f"lgc_compress_hist D={n} recv={list(recv_list)}")
            check(bits_equal(g + e_new, ref.ftz_add(e, x)),
                  f"u == g + e' D={n} recv={list(recv_list)}")
            errs["sparsify_ef"] = max(errs["sparsify_ef"],
                                      max_abs_err(g, g_ref),
                                      max_abs_err(e_new, e_ref))
    torch.cuda.synchronize()
    log(f"kernels at the simulator's D in {(LR_D, CNN_D)}, its budget and "
        f"all 8 received patterns of 3 channels: bitwise equal to the "
        f"plain versions")


def check_histogram(v, m, what: str, errs: dict) -> None:
    from repro_torch.kernels import histogram, ref
    c = histogram(v, m)
    c_ref = ref.hist_counts(v, m)
    check(bits_equal(c, c_ref) and int(c.sum()) == v.numel(),
          f"histogram {what}")
    errs["histogram"] = max(errs["histogram"], max_abs_err(c, c_ref))


def phase_histogram_edges(gen, errs: dict) -> None:
    """histogram at the edges of a block's pass (4,096 floats) and of the
    full grid's, at pointer offsets 0-3, on special values, a constant
    vector and exact bin edges; ten launches in a row, and a launch right
    after one with a larger grid (the last block must have emptied the
    accumulator and reset the counter)."""
    import torch
    from repro_torch.kernels import histogram, maxabs, ref
    from repro_torch.kernels.topk_threshold import histogram_grid
    grid_pass = histogram_grid(1 << 40, torch.device("cuda")) * 256 * 4 * 4
    sizes = [1, 2, 3, 63, 4095, 4096, 4097, 1_000_003, grid_pass - 1,
             grid_pass, grid_pass + 1, 2 * grid_pass + 3]
    for n in sizes:
        base = torch.randn(n + 3, generator=gen, device="cuda")
        for off in range(4):
            v = base[off:off + n]
            check_histogram(v, maxabs(v), f"D={n} offset {off}", errs)
    g = torch.randn(100_003, generator=gen, device="cuda")
    m_g = g.abs().max().reshape(1, 1)
    z = torch.zeros_like(g)
    one = torch.ones((1, 1), device="cuda")
    k = torch.arange(257, device="cuda", dtype=torch.float32) / 256
    at = torch.tensor([77_777], device="cuda")
    specials = {
        "zeros": (z, maxabs(z)), "-0.0": (torch.full_like(z, -0.0), maxabs(z)),
        "NaN": (g.clone().index_fill_(0, at, float("nan")), m_g),
        "+inf": (g.clone().index_fill_(0, at, float("inf")), m_g),
        "-inf": (g.clone().index_fill_(0, at, float("-inf")), m_g),
        "constant": (torch.full((LARGEST_LEAF,), -0.5, device="cuda"),
                     one / 2),
        "bin edges k/256": (torch.cat([k, -k]).repeat(1000), one),
        "m NaN": (g, torch.full((1, 1), float("nan"), device="cuda")),
        "m 0": (g, one * 0)}
    for tag, (v, m) in specials.items():
        check_histogram(v, m, tag, errs)
    big = torch.randn(3 * grid_pass + 7, generator=gen, device="cuda")
    small = torch.randn(5000, generator=gen, device="cuda")
    m_big, m_small = maxabs(big), maxabs(small)
    outs = [histogram(big, m_big) for _ in range(10)]
    after_big = histogram(small, m_small)
    want_big = ref.hist_counts(big, m_big)
    check(all(bits_equal(o, want_big) for o in outs),
          "histogram: ten launches in a row")
    check(bits_equal(after_big, ref.hist_counts(small, m_small)),
          "histogram: a launch after one with a larger grid")
    torch.cuda.synchronize()
    log(f"histogram: bitwise equal to the plain version, sums equal to D, at "
        f"D in {sizes}, offsets 0-3, on {', '.join(specials)}; ten launches "
        f"in a row, and a launch after one with a larger grid")


SUBNORMAL_SCALES = (1e-39, 1e-37, 1e-36, 1e-30)


def phase_subnormals(errs: dict) -> None:
    """Each LGC kernel at scales where its inputs are all, partly or not
    subnormal: bitwise equal to its plain version, which flushes f32
    subnormals as the JAX reference does."""
    import numpy as np
    import torch
    from repro_torch.kernels import (histogram, lgc_compress_hist, maxabs,
                                     ref, sparsify_ef, sum_maxabs)
    cum = torch.tensor([40, 120], dtype=torch.int32, device="cuda")
    recv = torch.tensor([1, 0], dtype=torch.int32, device="cuda")
    sent = {}
    for scale in SUBNORMAL_SCALES:
        rng = np.random.default_rng(0)
        e, d = (torch.from_numpy((rng.standard_normal(4096) * scale).astype(
            np.float32)).cuda() for _ in range(2))
        m = maxabs(e)
        check(bits_equal(m, ref.hist_maxabs(e).reshape(1, 1)),
              f"maxabs at scale {scale}")
        check_histogram(e, m, f"at scale {scale}", errs)
        u, m_u = sum_maxabs(e, d)
        u_ref = ref.ftz_add(e, d)
        check(bits_equal(u, u_ref) and bits_equal(
            m_u, ref.hist_maxabs(u_ref).reshape(1, 1)),
            f"sum_maxabs at scale {scale}")
        thr = ref.hist_thresholds(histogram(u, m_u), m_u, cum)
        for got, want in zip(sparsify_ef(e, d, thr, recv),
                             ref.hist_layered_sparsify(u_ref, thr, recv)):
            check(bits_equal(got, want), f"sparsify_ef at scale {scale}")
        g, e_new = lgc_compress_hist(e, d, cum, recv)
        g_ref, e_ref = ref.hist_lgc_compress(e, d, cum, recv)
        check(bits_equal(g, g_ref) and bits_equal(e_new, e_ref),
              f"lgc_compress_hist at scale {scale}")
        sent[scale] = int((g != 0).sum())
    torch.cuda.synchronize()
    log(f"subnormals: maxabs, sum_maxabs, histogram, sparsify_ef and "
        f"lgc_compress_hist bitwise equal to the plain versions at scales "
        f"{SUBNORMAL_SCALES}; coordinates sent {sent}")


RECEIVED_PATTERNS = list(itertools.product((1, 0), repeat=3))


def row_inputs(gen, m: int, n: int, offset: int = 0, scale: float = 1.0):
    """e, x (M, D) on the card (e's rows start ``offset`` floats off a
    16-byte boundary), row 1 all zeros, and the simulator's budget."""
    import itertools
    import torch
    from repro_torch.core.fl import baseline_ks
    e = (torch.randn(m * n + offset, generator=gen, device="cuda")[offset:]
         .view(m, n) * (1e-4 * scale))
    x = torch.randn((m, n), generator=gen, device="cuda") * (1e-3 * scale)
    if m > 1:
        e[1] = 0.0
        x[1] = 0.0
    cum = torch.tensor(list(itertools.accumulate(baseline_ks(n))),
                       dtype=torch.int32, device="cuda").expand(m, 3)
    return e, x, cum.contiguous()


def check_rows(e, x, cum, recv, what: str, errs: dict) -> int:
    """Each row kernel, one launch over all rows, bitwise equal to its
    plain row version and to the flat kernel on every row; returns the
    coordinates sent."""
    import torch
    from repro_torch.kernels import (histogram, histogram_rows,
                                     lgc_compress_hist,
                                     lgc_compress_hist_rows, ref,
                                     sparsify_ef, sparsify_ef_rows,
                                     sum_maxabs, sum_maxabs_rows,
                                     thresholds_from_counts)
    u, m = sum_maxabs_rows(e, x)
    u_ref = ref.ftz_add(e, x)
    check(bits_equal(u, u_ref) and bits_equal(m, ref.hist_maxabs_rows(u_ref)),
          f"sum_maxabs_rows {what}")
    counts = histogram_rows(u, m)
    check(bits_equal(counts, ref.hist_counts_rows(u_ref, m))
          and bool((counts.sum(1) == e.shape[1]).all()),
          f"histogram_rows {what}")
    thr = thresholds_from_counts(counts, m, cum)
    g, e_new = sparsify_ef_rows(e, x, thr, recv)
    g_ref, e_ref = ref.hist_layered_sparsify_rows(u_ref, thr, recv)
    # u == g + e' by value: a flushed u of -0.0 gives g = +0.0, e' = -0.0
    check(bits_equal(g, g_ref) and bits_equal(e_new, e_ref)
          and torch.equal(g + e_new, u_ref), f"sparsify_ef_rows {what}")
    gp, ep = lgc_compress_hist_rows(e, x, cum, recv)
    check(bits_equal(gp, g) and bits_equal(ep, e_new),
          f"lgc_compress_hist_rows {what}")
    for r in range(e.shape[0]):
        er = e[r].contiguous()
        u1, m1 = sum_maxabs(er, x[r])
        check(bits_equal(u1, u[r]) and bits_equal(m1.reshape(()), m[r]),
              f"sum_maxabs row {r} {what}")
        check(bits_equal(histogram(u1, m1), counts[r]),
              f"histogram row {r} {what}")
        g1, e1 = sparsify_ef(er, x[r], thr[r], recv[r])
        check(bits_equal(g1, g[r]) and bits_equal(e1, e_new[r]),
              f"sparsify_ef row {r} {what}")
        g2, e2 = lgc_compress_hist(er, x[r], cum[r], recv[r])
        check(bits_equal(g2, g[r]) and bits_equal(e2, e_new[r]),
              f"lgc_compress_hist row {r} {what}")
    errs["maxabs"] = max(errs["maxabs"], max_abs_err(m, ref.hist_maxabs_rows(
        u_ref)))
    errs["histogram"] = max(errs["histogram"], max_abs_err(
        counts, ref.hist_counts_rows(u_ref, m)))
    errs["sparsify_ef"] = max(errs["sparsify_ef"], max_abs_err(g, g_ref),
                              max_abs_err(e_new, e_ref))
    return int((g != 0).sum())


def phase_rows(gen, errs: dict) -> None:
    """The (M, D) row forms at the paths' shapes and an odd D below 8, rows
    on and off a 16-byte boundary, each row through all 8 received
    patterns; then at the subnormal scales."""
    import torch
    pats = torch.tensor(RECEIVED_PATTERNS, dtype=torch.int32, device="cuda")
    for m, n in ROW_SHAPES + [(3, 7)]:
        for offset in (0, 1):
            e, x, cum = row_inputs(gen, m, n, offset)
            sent = []
            for p in range(len(RECEIVED_PATTERNS)):
                recv = pats[(torch.arange(m, device="cuda") + p)
                            % len(RECEIVED_PATTERNS)]
                sent.append(check_rows(e, x, cum, recv,
                                       f"(M, D)=({m}, {n}) offset {offset} "
                                       f"pattern {p}", errs))
        torch.cuda.synchronize()
        log(f"row kernels (M, D)=({m}, {n}), offsets 0 and 1, all 8 "
            f"received patterns on every row: bitwise equal to the plain "
            f"row versions and to {m} flat launches row by row; "
            f"coordinates sent {sent}")
    for scale in SUBNORMAL_SCALES:
        e, x, cum = row_inputs(gen, 3, 4096, 1, scale / 1e-3)
        check_rows(e, x, cum, pats[:3], f"at scale {scale}", errs)
    torch.cuda.synchronize()
    log(f"row kernels at scales {SUBNORMAL_SCALES}: bitwise equal to the "
        f"plain row versions and the flat kernels")
    phase_segments(gen, errs)


def model_edges(task_name: str) -> list[int]:
    """The L + 1 edges of a simulator model's layer slices, in the order
    of ``flatten_tree``."""
    from repro_torch.core import prng
    from repro_torch.core.compressor import tree_layer_slices
    from repro_torch.models.paper_models import make_task
    task = make_task(task_name, m_devices=1, n_train=100)
    return [0] + [hi for _, _, hi in
                  tree_layer_slices(task.init(prng.PRNGKey(0)))]


def segment_inputs(gen, m: int, edges: list[int]):
    """(M, D) Gaussian rows at the simulator's scale, slice 1 of row 1
    all zeros (a zero bias, as at round 0)."""
    import torch
    u = torch.randn((m, edges[-1]), generator=gen, device="cuda") * 1e-3
    u[1 % m, edges[1]:edges[2]] = 0.0
    return u


def segment_battery(gen):
    """Rows over EDGE_SIZES: row 0 Gaussian; row 1 with an all-zero
    slice, a NaN, a +inf and an all-subnormal slice; row 2 at 1e-38
    (partly subnormal); row 3 all zeros."""
    import torch
    edges = [0, *itertools.accumulate(EDGE_SIZES)]
    u = torch.randn((4, edges[-1]), generator=gen, device="cuda") * 1e-3
    u[1, edges[3]:edges[4]] = 0.0
    u[1, edges[6] + 5] = float("nan")
    u[1, edges[7] + 2] = float("inf")
    u[1, edges[8]:edges[9]] = 1e-40
    u[2] *= 1e-35
    u[3] = 0.0
    return u, edges


def phase_segments(gen, errs: dict) -> None:
    """The segmented kernels at the simulator's models' slices (cnn M=8,
    lr M=3, rnn M=8) and on the edge battery: one launch each, bitwise the
    plain segmented versions and M x L flat launches, their counts summing
    to the slice lengths; the candidate mask bitwise its plain version;
    ten launches in a row and a launch after a larger one unchanged."""
    import torch
    from repro_torch.kernels import (LAUNCHES, SegmentTable, histogram,
                                     histogram_segments, maxabs,
                                     maxabs_segments,
                                     per_layer_candidates_hist_rows, ref,
                                     reset_launch_counts)
    cases = [(f"{name} M={m}", segment_inputs(gen, m, model_edges(name)),
              model_edges(name)) for name, m in SEGMENT_MODELS]
    cases.append(("edge battery M=4", *segment_battery(gen)))
    results = {}
    for tag, u, edges in cases:
        table = SegmentTable(edges, "cuda")
        reset_launch_counts()
        mx = maxabs_segments(u, table)
        counts = histogram_segments(u, mx, table)
        check((LAUNCHES["maxabs_segments"],
               LAUNCHES["histogram_segments"]) == (1, 1),
              f"segments {tag}: launches {LAUNCHES}")
        mx_ref = ref.hist_maxabs_segments(u, edges)
        counts_ref = ref.hist_counts_segments(u, mx, edges)
        check(bits_equal(mx, mx_ref), f"maxabs_segments {tag}")
        check(bits_equal(counts, counts_ref), f"histogram_segments {tag}")
        errs["maxabs_segments"] = max(errs["maxabs_segments"],
                                      max_abs_err(mx.nan_to_num(),
                                                  mx_ref.nan_to_num()))
        errs["histogram_segments"] = max(errs["histogram_segments"],
                                         max_abs_err(counts, counts_ref))
        lengths = torch.tensor([hi - lo for lo, hi in
                                zip(edges[:-1], edges[1:])], device="cuda")
        check(bool((counts.sum(2) == lengths).all()),
              f"histogram_segments {tag}: counts do not sum to the slices")
        for r in range(u.shape[0]):
            for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
                seg = u[r, lo:hi].contiguous()
                m_i = mx[r, i].reshape(1, 1)
                check(bits_equal(m_i, maxabs(seg))
                      and bits_equal(counts[r, i], histogram(seg, m_i)),
                      f"segments {tag}: row {r} slice {i} differs from a "
                      f"flat launch on it")
        budgets = torch.randint(0, 40, mx.shape, generator=gen,
                                device="cuda", dtype=torch.int32)
        mask = per_layer_candidates_hist_rows(u, table, budgets)
        check(bits_equal(mask, ref.hist_candidates_segments(u, edges,
                                                            budgets)),
              f"per_layer_candidates_hist_rows {tag}")
        results[tag] = (u, table, mx, counts)
        log(f"segments {tag}: L={len(edges) - 1}, D={edges[-1]:,}, "
            f"{table.n_blocks} blocks a row; maxabs_segments and "
            f"histogram_segments in one launch each, bitwise equal to the "
            f"plain segmented versions and to {u.shape[0] * (len(edges) - 1)}"
            f" flat launches; candidate mask bitwise its plain version")
    u, table, mx, counts = results["lr_mnist M=3"]
    big = results["cnn_mnist M=8"]
    for _ in range(10):
        histogram_segments(big[0], maxabs_segments(big[0], big[1]), big[1])
    mx2 = maxabs_segments(u, table)
    check(bits_equal(mx2, mx)
          and bits_equal(histogram_segments(u, mx2, table), counts),
          "segments: a launch after ten larger ones differs")
    torch.cuda.synchronize()
    log("segments: ten launches in a row and a launch after a larger one "
        "give the same bits (counters and accumulators left at zero)")


# ---------------------------------------------------------------------------
# phase 3: swa_decode against its plain version
# ---------------------------------------------------------------------------

SWA_TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def swa_inputs(gen, shape, dtype):
    """q, k, v of ``shape``: normal draws from ``gen`` on its device, in
    ``dtype`` on the card."""
    import torch
    b, h, kv, w, dh = shape
    return tuple(torch.randn(s, generator=gen, device=gen.device).to(
        dtype).to("cuda") for s in ((b, h, dh), (b, kv, w, dh),
                                    (b, kv, w, dh)))


def swa_digests() -> dict[str, str]:
    """swa_decode's outputs at the Dh 32 / 64 / 128 shapes of phase 3, in
    f32 and bf16 at lengths 1, W/2 + 3 and W, on inputs drawn on the CPU
    from a generator seeded by the shape: for each shape the sha256 (16
    hex digits) of its six cases' sha256s (16 hex digits of the output's
    bytes each), joined in the order of their keys."""
    import hashlib
    import torch
    from repro_torch.kernels import swa_decode
    out = {}
    for shape in sorted({s for s in SWA_SHAPES + SWA_EDGE_SHAPES
                         if s[4] != 96}):
        b, w = shape[0], shape[3]
        seed = sum(x * 31 ** i for i, x in enumerate(shape))
        cases = {}
        for dtype, view in ((torch.float32, torch.int32),
                            (torch.bfloat16, torch.int16)):
            q, k, v = swa_inputs(torch.Generator().manual_seed(seed), shape,
                                 dtype)
            for n in (1, w // 2 + 3, w):
                ln = torch.full((b,), n, dtype=torch.int32, device="cuda")
                raw = swa_decode(q, k, v, ln).cpu().view(view).numpy()
                cases[f"{str(dtype)[6:]} {n}"] = hashlib.sha256(
                    raw.tobytes()).hexdigest()[:16]
        out[",".join(map(str, shape))] = hashlib.sha256("".join(
            cases[c] for c in sorted(cases)).encode()).hexdigest()[:16]
    return out


def swa_digests_made_on() -> dict:
    """What ``SWA_DIGESTS`` depend on besides the kernel: the card's SM
    count, torch's version and nvcc's release."""
    import subprocess
    import torch
    from repro_torch.kernels import _build
    ver = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return {"sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "torch": torch.__version__,
            "nvcc": ver.split("release ")[1].split(",")[0]}


def phase_swa(gen, errs: dict) -> None:
    import torch
    from repro_torch.kernels import ref, swa_decode
    for dtype in (torch.float32, torch.bfloat16):
        tol = SWA_TOL[str(dtype).split(".")[1]]
        for shape in SWA_SHAPES:
            b, w = shape[0], shape[3]
            q, k, v = swa_inputs(gen, shape, dtype)
            worst = 0.0
            for n in (1, w // 2 + 3, w):
                ln = torch.full((b,), n, dtype=torch.int32, device="cuda")
                got = swa_decode(q, k, v, ln)
                want = ref.swa_decode_ref(q, k, v, ln)
                ok = torch.isclose(got.float(), want.float(), rtol=tol,
                                   atol=tol).all()
                check(bool(ok) and got.dtype == dtype,
                      f"swa_decode {shape} {dtype} length {n}")
                worst = max(worst, max_abs_err(got, want))
            errs["swa_decode"] = max(errs["swa_decode"], worst)
            log(f"swa_decode (B,H,Kv,W,Dh)={shape} {dtype}: within "
                f"rtol=atol={tol} of the plain version at lengths 1, "
                f"{w // 2 + 3}, {w}; max abs err {worst:.3e}")
    # slots past the length must not reach the output
    q, k, v = swa_inputs(gen, (2, 4, 2, 256, 64), torch.float32)
    ln = torch.tensor([100, 0], dtype=torch.int32, device="cuda")
    out1 = swa_decode(q, k, v, ln)
    k[:, :, 100:] = 1e9
    v[:, :, 100:] = -1e9
    out2 = swa_decode(q, k, v, ln)
    check(torch.equal(out1, out2) and not bool(out1[1].any()),
          "swa_decode read slots past the length")
    log("swa_decode: +-1e9 past the length leaves the output bitwise "
        "unchanged; length 0 gives zeros")
    # many splits of one tile (B=1), one partial tile (W=16), two query-head
    # groups (REP=16): lengths on either side of each tile and split edge
    from repro_torch.kernels.swa_attention import _MAX_REP, _num_splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t = ref.SWA_TILE
    for shape in SWA_EDGE_SHAPES:
        b, h, kv, w, dh = shape
        sl = ref.swa_split_len(w, _num_splits(
            b * kv * -(-(h // kv) // _MAX_REP), w, sms))
        lengths = sorted({n for n in (1, t - 1, t, t + 1, sl - 1, sl, sl + 1,
                                      w - 1, w) if 1 <= n <= w})
        for dtype in (torch.float32, torch.bfloat16):
            tol = SWA_TOL[str(dtype).split(".")[1]]
            q, k, v = swa_inputs(gen, shape, dtype)
            for n in lengths:
                ln = torch.full((b,), n, dtype=torch.int32, device="cuda")
                got = swa_decode(q, k, v, ln)
                want = ref.swa_decode_ref(q, k, v, ln)
                check(bool(torch.isclose(got.float(), want.float(), rtol=tol,
                                         atol=tol).all()),
                      f"swa_decode {shape} {dtype} length {n}")
                errs["swa_decode"] = max(errs["swa_decode"],
                                         max_abs_err(got, want))
        log(f"swa_decode {shape}: split length {sl}, within tolerance at "
            f"lengths {lengths} in f32 and bf16")
    # the same bits on every launch, also right after a launch with more
    # groups (whose last blocks must have reset their counters)
    inputs = {shape: swa_inputs(gen, shape, torch.bfloat16)
              for shape in (SWA_SERVE_SHAPE, (64, 16, 8, 256, 64))}
    first = {}
    for shape in (SWA_SERVE_SHAPE, (64, 16, 8, 256, 64), SWA_SERVE_SHAPE):
        q, k, v = inputs[shape]
        ln = torch.full((shape[0],), shape[3] - 3, dtype=torch.int32,
                        device="cuda")
        out1, out2 = swa_decode(q, k, v, ln), swa_decode(q, k, v, ln)
        check(torch.equal(out1, out2), f"swa_decode {shape} not deterministic")
        check(torch.equal(first.setdefault(shape, out1), out1),
              f"swa_decode {shape} changed after a launch with more groups")
    log("swa_decode: two launches bitwise equal, and unchanged after a "
        "launch with 512 groups")
    made_on = swa_digests_made_on()
    got = swa_digests()
    check(made_on == SWA_DIGESTS_MADE_ON and set(got) == set(SWA_DIGESTS),
          f"SWA_DIGESTS were made on {SWA_DIGESTS_MADE_ON} for "
          f"{len(SWA_DIGESTS)} shapes, this run is on {made_on} with "
          f"{len(got)}: they hold only where they were made.  Make them "
          "anew from the kernel they guard: unpack its commit with git "
          "archive under build/, copy this chip_smoke.py into it, run "
          "`python3 chip_smoke.py --swa-digests` there and set "
          "SWA_DIGESTS_MADE_ON and SWA_DIGESTS to what it prints")
    check(got == SWA_DIGESTS, "swa_decode at Dh 32 / 64 / 128 differs from "
          "the kernel before Dh 96 at "
          f"{sorted(k for k in got if got[k] != SWA_DIGESTS[k])}")
    log(f"swa_decode: Dh 32 / 64 / 128 outputs bitwise the earlier kernel's "
        f"at {len(got)} shapes x 2 dtypes x 3 lengths")
    torch.cuda.synchronize()


# swa_decode's partial form at a rank's shard of the serve cache (4,096
# slots over two ranks; the first is the kernels line's timing shape), at
# the shards phase 5d's serving job runs (its 1,040-slot cache and its
# 1,024-slot ring over two ranks), at Dh 64 and at Dh 96 under GQA, and at
# zamba2-1.2b's shard in phase 5d (e) (its 1,040-slot K/V sites over two
# ranks: REP 1, Dh 64), olmoe-1b-7b's and phi-3-vision-4.2b's in (f)
# (REP 1 at Dh 128 and at Dh 96, the partial form's first Dh 96 launches
# on a path) and whisper-small's in (g) (its 256-slot self-attention
# cache over two ranks: REP 1, Dh 64); the last four are the kernels
# line's ``at_*_shard``
SWA_PARTIAL_SHARDS = {"zamba2-1.2b": (8, 32, 32, 520, 64),
                      "olmoe-1b-7b": (8, 16, 16, 520, 128),
                      "phi-3-vision-4.2b": (8, 32, 32, 520, 96),
                      "whisper-small": (8, 12, 12, 128, 64)}
SWA_PARTIAL_SHAPES = [(8, 12, 2, 2048, 128), (8, 12, 2, 520, 128),
                      (8, 12, 2, 512, 128), (2, 8, 2, 520, 64),
                      (2, 16, 2, 300, 96), *SWA_PARTIAL_SHARDS.values()]
# whole caches split in two halves and merged: the serve shape and phase
# 5d's two caches
SWA_MERGE_SHAPES = [SWA_SERVE_SHAPE, (8, 12, 2, 1040, 128),
                    (8, 12, 2, 1024, 128)]
# m and l of the partial form against its plain version: the logits' f32
# sums run in another order (bf16: the products on the tensor cores)
SWA_STATE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def phase_swa_partial(gen, errs: dict) -> None:
    """Phase 3: ``swa_decode_partial`` (a rank's shard of the cache under
    the model axis) cast to q's dtype is ``swa_decode`` bit for bit on the
    card, with rows of W, W/2 + 3, 1 and 0 valid slots; its (out, m, l)
    against the plain partial version; and at the serve shape split into
    two halves as ``layers.attention_decode`` splits it (and at phase 5d's
    caches, SWA_MERGE_SHAPES), the kernel's and the plain version's states
    merged (``ref.merge_decode_partials``) against ``swa_decode`` over the
    whole window, within SWA_TOL."""
    import torch
    from repro_torch.kernels import ref, swa_decode, swa_decode_partial
    for shape in SWA_PARTIAL_SHAPES:
        b, h, kv, w, dh = shape
        ns = [w, w // 2 + 3, 1, 0]
        ln = torch.tensor([ns[i % 4] for i in range(b)], dtype=torch.int32,
                          device="cuda")
        empty = ln == 0
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, k, v = swa_inputs(gen, shape, dtype)
            out, m, l_sum = swa_decode_partial(q, k, v, ln)
            check(out.dtype == torch.float32 and bits_equal(
                out.to(dtype), swa_decode(q, k, v, ln)),
                f"swa_decode_partial {shape} {name}: not swa_decode's bits")
            r_out, r_m, r_l = ref.swa_decode_partial_ref(q, k, v, ln)
            tol, stol = SWA_TOL[name], SWA_STATE_TOL[name]
            check(bool(torch.isclose(out, r_out, rtol=tol, atol=tol).all())
                  and bool(torch.isclose(m[~empty], r_m[~empty], rtol=stol,
                                         atol=stol).all())
                  and bool(torch.isclose(l_sum, r_l, rtol=stol,
                                         atol=stol).all())
                  and bool(torch.isneginf(m[empty]).all())
                  and not bool(l_sum[empty].any() or out[empty].any()),
                  f"swa_decode_partial {shape} {name} against its plain "
                  f"version")
            errs["swa_decode_partial"] = max(errs["swa_decode_partial"],
                                             max_abs_err(out, r_out))
        log(f"swa_decode_partial (B,H,Kv,W,Dh)={shape}: f32 output cast to "
            f"q's dtype bitwise swa_decode's in f32 and bf16 at lengths "
            f"{ns} (0: m = -inf, l = 0, zeros); out, m and l within "
            f"{SWA_TOL} / {SWA_STATE_TOL} of the plain version")
    for shape in SWA_MERGE_SHAPES:
        w = shape[3]
        half = w // 2
        ln = torch.tensor([w, w - 5, half + 1, half, 700, 1, 0, half + 1],
                          dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            q, k, v = swa_inputs(gen, shape, dtype)
            shards = [(k[:, :, r * half:(r + 1) * half].contiguous(),
                       v[:, :, r * half:(r + 1) * half].contiguous(),
                       torch.clamp(ln - r * half, 0, half).to(torch.int32))
                      for r in range(2)]
            want = swa_decode(q, k, v, ln)
            for tag, fn in (("kernel", swa_decode_partial),
                            ("plain", ref.swa_decode_partial_ref)):
                states = [fn(q, *sh) for sh in shards]
                got = ref.merge_decode_partials(
                    *(torch.stack(t) for t in zip(*states)), dtype)
                tol = SWA_TOL[name]
                check(bool(torch.isclose(got.float(), want.float(),
                                         rtol=tol, atol=tol).all()),
                      f"two {tag} shards of {shape} {name} merged: "
                      f"{max_abs_err(got, want):.3e} from swa_decode")
                log(f"swa_decode_partial: two {tag} shards of {shape} "
                    f"{name} (lengths {ln.tolist()}) merged within "
                    f"rtol=atol={tol} of swa_decode over the whole window; "
                    f"max abs err {max_abs_err(got, want):.3e}")
    torch.cuda.synchronize()


# whisper-small's cross cache under a model axis of 2 (phase 5d (g)):
# (B, P, H, W, Dh); a rank attends with its 6 query heads over their heads
# of the whole 1,500-slot cache (``layers.attention_decode_heads``)
SWA_CROSS_HEADS = (8, 2, 12, 1500, 64)


class _HeadsMesh:
    """What ``layers.attention_decode_heads`` reads of a mesh."""

    def __init__(self, model_size: int, model_rank: int):
        self.model_size, self.model_rank = model_size, model_rank


def cross_heads_inputs(gen, dtype, lengths=None):
    """q (B, 1, H / P, Dh) of each rank and the whole cross cache (B, H, W,
    Dh) as ``layers.KVCache`` with ``lengths`` (every slot valid: W)."""
    import torch
    from repro_torch.models.layers import KVCache
    b, p, h, w, dh = SWA_CROSS_HEADS
    q, k, v = swa_inputs(gen, (b, h, h, w, dh), dtype)
    ln = (torch.full((b,), w, dtype=torch.int32, device="cuda")
          if lengths is None else lengths)
    return ([q.view(b, p, h // p, dh)[:, r, None].contiguous()
             for r in range(p)], KVCache(k, v, ln))


def phase_swa_cross_heads(gen, errs: dict) -> None:
    """Phase 3: ``layers.attention_decode_heads`` at whisper-small's cross
    cache under P = 2 (SWA_CROSS_HEADS), f32 and bf16, every slot valid
    and at mixed lengths: one ``swa_decode`` launch a call, each rank's
    output within SWA_TOL of the plain version on its contiguous block of
    heads and of ``swa_decode`` on that block."""
    import torch
    from repro_torch.kernels import LAUNCHES, ref, swa_decode
    from repro_torch.models.layers import attention_decode_heads
    b, p, h, w, dh = SWA_CROSS_HEADS
    mixed = torch.tensor([w, w - 7, 1, 0, 700, w // 2, 3, w],
                         dtype=torch.int32, device="cuda")[:b]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = SWA_TOL[name]
        for ln in (None, mixed):
            qs, cache = cross_heads_inputs(gen, dtype, ln)
            for r, q in enumerate(qs):
                before = LAUNCHES["swa_decode"]
                got = attention_decode_heads(q, cache, _HeadsMesh(p, r))[:, 0]
                check(LAUNCHES["swa_decode"] - before == 1,
                      f"attention_decode_heads: "
                      f"{LAUNCHES['swa_decode'] - before} launches")
                heads = slice(r * h // p, (r + 1) * h // p)
                kb = cache.k[:, heads].contiguous()
                vb = cache.v[:, heads].contiguous()
                for tag, want in (
                        ("plain", ref.swa_decode_ref(q[:, 0], kb, vb,
                                                     cache.length)),
                        ("swa_decode on the block",
                         swa_decode(q[:, 0].contiguous(), kb, vb,
                                    cache.length))):
                    check(got.dtype == dtype and bool(torch.isclose(
                        got.float(), want.float(), rtol=tol,
                        atol=tol).all()),
                        f"attention_decode_heads {SWA_CROSS_HEADS} {name} "
                        f"rank {r} against the {tag}: "
                        f"{max_abs_err(got, want):.3e}")
                errs["swa_decode"] = max(errs["swa_decode"], max_abs_err(
                    got, ref.swa_decode_ref(q[:, 0], kb, vb, cache.length)))
        log(f"attention_decode_heads (B,P,H,W,Dh)={SWA_CROSS_HEADS} {name}: "
            f"one swa_decode launch a call over a (B P, H / P, W, Dh) view "
            f"of the whole cache, each rank within rtol=atol={tol} of the "
            f"plain version and of swa_decode on its contiguous heads, "
            f"every slot valid and at lengths {mixed.tolist()}")
    torch.cuda.synchronize()


def time_swa_cross_heads(gen) -> dict:
    """``attention_decode_heads``'s launch at whisper-small's cross cache
    under P = 2 in bf16, every slot valid, rank 0: ``swa_decode`` on the
    (B P, H / P, W, Dh) view of the whole cache whose other rank's rows
    have length 0, each call on the next of four input copies.  Its plain
    version on the same inputs; the library call is
    scaled_dot_product_attention over the rank's heads (a strided view of
    the same cache); the bound counts the bytes the rank's rows need (its
    heads' K and V, q, the output).  ``copy_design_device_ms``: the other
    design, the rank's heads copied contiguous and ``swa_decode`` on them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.device import device_ms
    from repro_torch.kernels import ref, swa_decode
    b, p, h, w, dh = SWA_CROSS_HEADS
    hl = h // p
    sets = [cross_heads_inputs(gen, torch.bfloat16) for _ in range(4)]
    ln = torch.tensor([w, 0] * b, dtype=torch.int32, device="cuda")
    view = [(torch.cat([q, torch.zeros_like(q)], 1).view(b * p, hl, dh),
             c.k.view(b * p, hl, w, dh), c.v.view(b * p, hl, w, dh))
            for (q, _), c in sets]
    heads = [(qs[0][:, 0], c.k.view(b, p, hl, w, dh)[:, 0],
              c.v.view(b, p, hl, w, dh)[:, 0]) for qs, c in sets]
    full = torch.full((b,), w, dtype=torch.int32, device="cuda")

    def rotate(f, inputs):
        it = iter(range(1 << 30))
        return lambda: f(*inputs[next(it) % len(inputs)])
    kern = rotate(lambda q, k, v: swa_decode(q, k, v, ln), view)
    plain = rotate(lambda q, k, v: ref.swa_decode_ref(q, k, v, ln), view)
    lib = rotate(lambda q, k, v: F.scaled_dot_product_attention(
        q[:, :, None], k, v), heads)
    copy = rotate(lambda q, k, v: swa_decode(q, k.contiguous(),
                                             v.contiguous(), full), heads)
    n_bytes = 2 * b * hl * w * dh * 2 + 2 * (b * hl * dh * 2) + 4 * b * p
    n_ops = 4 * b * hl * w * dh
    bnd, by = bound_ms(n_bytes, n_ops)
    row = {"shape": list(SWA_CROSS_HEADS), "launch_shape": [b * p, hl, hl,
                                                            w, dh],
           "dtype": "bfloat16", "ms": time_ms(kern),
           "plain_ms": time_ms(plain), "library_ms": time_ms(lib),
           "device_ms": device_ms(kern), "library_device_ms": device_ms(lib),
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes,
           "copy_design_device_ms": device_ms(copy)}
    log(f"timing swa_decode over a rank's heads of the cross cache "
        f"(B,P,H,W,Dh)={SWA_CROSS_HEADS} bf16 (launched at "
        f"{row['launch_shape']}, the other rank's rows empty): kernel {row['ms']:.5f} ms one "
        f"call, {row['device_ms']:.5f} ms device; plain {row['plain_ms']:.5f}"
        f" ms; library {row['library_ms']:.5f} ms one call, "
        f"{row['library_device_ms']:.5f} ms device; bound {bnd:.5f} ms ({by},"
        f" {n_bytes:,} B); the copy design (heads copied, then swa_decode) "
        f"{row['copy_design_device_ms']:.5f} ms device")
    return row


# ---------------------------------------------------------------------------
# phase 4: small trainer, kernel backend against the plain backend
# ---------------------------------------------------------------------------

def phase_threefry(errs: dict) -> None:
    """Phase 3b: the threefry_normal kernel bitwise its plain version on
    the card at ``THREEFRY_CASES``."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels import ref, threefry_normal
    keys = prng.split(prng.PRNGKey(0), len(THREEFRY_CASES))
    for key, (shape, dt, std) in zip(keys, THREEFRY_CASES):
        dtype = getattr(torch, dt)
        got = threefry_normal(torch.empty(shape, dtype=dtype, device="cuda"),
                              key, std)
        want = ref.threefry_normal_ref(key, shape, std, dtype, "cuda")
        ib = torch.int16 if dtype == torch.bfloat16 else torch.int32
        off = int((got.view(ib) != want.view(ib)).sum())
        check(off == 0, f"threefry_normal {shape} {dt}: {off} elements "
              f"differ from the plain version")
        errs["threefry_normal"] = max(errs["threefry_normal"],
                                      max_abs_err(got, want))
        del got, want
    log(f"threefry_normal: bitwise the plain version on the card at "
        f"{[(list(c[0]), c[1]) for c in THREEFRY_CASES]}")


def phase_small_trainer() -> None:
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.paper_models import make_task
    arch = dataclasses.replace(get_smoke_config("qwen2-100m"),
                               dtype=torch.float32)
    runs = {}
    for backend in ("exact", "cuda"):
        t = make_task("qwen2_100m", m_devices=2, arch=arch,
                      aggregate="dense_masked", sparsity=(0.05, 0.1, 0.1),
                      backend=backend, pallas_min_elems=1, seq=32,
                      device="cuda")
        out = t.run(3)
        runs[backend] = (out["losses"], t._built["params"], t._built["ef"])
    (l0, p0, e0), (l1, p1, e1) = runs["exact"], runs["cuda"]
    check(all(math.isclose(a, b, rel_tol=1e-5) for a, b in zip(l0, l1)),
          f"small trainer losses {l0} vs {l1}")
    worst, bitwise = 0.0, True
    for tree0, tree1 in ((p0, p1), (e0, e1)):
        for k in tree0:
            a, b = tree0[k], tree1[k]
            bitwise &= bits_equal(a, b)
            off = ~torch.isclose(b, a, rtol=1e-5, atol=1e-6)
            worst = max(worst, float(off.float().mean()))
    check(worst <= 1e-3, f"small trainer: {worst:.2%} of a leaf differs")
    log(f"small f32 trainer on the card (smoke config, 3 rounds, M=2, every "
        f"leaf through the kernels): losses {l1} match the plain backend; "
        f"params and EF bitwise equal: {bitwise}; worst leaf share off "
        f"tolerance {worst:.2e}")


# ---------------------------------------------------------------------------
# phase 5: the training path at full width
# ---------------------------------------------------------------------------

def main_path_task(scenario: str = "static"):
    from repro_torch.models.paper_models import make_task
    return make_task("qwen2_100m", m_devices=M_DEVICES, preset="full",
                     aggregate="dense_masked", backend="cuda",
                     scenario=scenario)


def phase_main_path() -> tuple[dict, object, float]:
    """Returns the launch counts, u = e + delta of device 0's largest leaf
    in round 2 and the run's device-steps/s."""
    import torch
    from repro_torch.kernels import LAUNCHES, ref, reset_launch_counts
    from repro_torch.launch.bench_histogram import capture_leaf_inputs
    from repro_torch.launch.steps import make_lgc_train_step
    from repro_torch.models import transformer as tf
    task = main_path_task()
    n_params = task.param_count()
    check(n_params == 128_419_584, f"param_count {n_params}")
    t0 = time.perf_counter()
    b = task.build()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kernel_leaves = [k for k, v in b["params"].items()
                     if v.numel() >= task.step_cfg.pallas_min_elems]
    check(len(kernel_leaves) == N_KERNEL_LEAVES, f"kernel leaves "
          f"{kernel_leaves}")
    # the same start for the device-by-device check below
    flat_task = main_path_task()
    fb = flat_task.build(params={k: v.clone() for k, v in
                                 b["params"].items()})
    fb["step"] = make_lgc_train_step(flat_task.arch, M_DEVICES,
                                     flat_task.step_cfg, rows=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    # keep device 0's (e, delta) of the largest leaf's first call in round 2
    with capture_leaf_inputs(LARGEST_LEAF, N_KERNEL_LEAVES) as kept:
        out = task.run(ROUNDS)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = out["losses"]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    params, ef = b["params"], b["ef"]
    shapes = {k: v.shape for k, v in
              tf.init_params(task.arch, device="meta").items()}
    for k, v in params.items():
        check(v.dtype == torch.bfloat16 and bool(torch.isfinite(v).all()),
              f"param {k}")
        check(ef[k].shape == (M_DEVICES,) + tuple(shapes[k])
              and bool(torch.isfinite(ef[k]).all()), f"ef {k}")
    want = ROUNDS * N_KERNEL_LEAVES
    for name, rows_name in ROW_KERNELS.items():
        check(counts[rows_name] == want, f"{rows_name} launched "
              f"{counts[rows_name]} times on the training path, expected "
              f"{want}")
        check(counts[name] == 0, f"{name} launched {counts[name]} times on "
              f"the training path, expected 0 (the row form carries it)")
    check(counts["swa_decode"] == 0, f"swa_decode launched "
          f"{counts['swa_decode']} times on the training path, expected 0")
    # the same rounds device by device through the flat kernels
    reset_launch_counts()
    flat_task.run(ROUNDS)
    torch.cuda.synchronize()
    flat_counts = dict(LAUNCHES)
    for k in params:
        check(bits_equal(fb["params"][k].view(torch.int16),
                         params[k].view(torch.int16)),
              f"param {k}: the row path and the flat path differ")
        check(bits_equal(fb["ef"][k], ef[k]),
              f"ef {k}: the row path and the flat path differ")
    check(all(flat_counts[n] == M_DEVICES * want for n in LGC_KERNELS),
          f"flat path launches {flat_counts}")
    log(f"main path: qwen2_100m full width, {n_params:,} params (bf16, "
        f"drawn on the card in {init_s:.2f} s), M={M_DEVICES}, "
        f"H={task.step_cfg.local_steps}, sparsity {task.step_cfg.sparsity}, "
        f"seq {task.seq}, {ROUNDS} rounds")
    log(f"main path: losses {losses}")
    log(f"main path: wire bytes/round/device "
        f"{out['wire_bytes_per_round_per_device']:,}; device-steps/s "
        f"{out['device_steps_per_s']:.3f} (rounds 2-{ROUNDS}); peak device "
        f"memory {peak_gib:.2f} GiB")
    log(f"main path: kernel launches {counts} (want {want} for each LGC "
        f"row kernel, 0 for the flat ones and swa_decode)")
    log(f"main path: params and error memory after {ROUNDS} rounds bitwise "
        f"equal to the device-by-device flat path (launches {flat_counts})")
    del flat_task, fb
    (e, delta), = kept
    return counts, ref.ftz_add(e, delta), out["device_steps_per_s"]


def phase_main_path_scenario(smi: str) -> dict:
    """The training path under gilbert_flaky: 3 rounds with the scenario's
    delivery masks, at least one 0 among them, params and error memory
    bitwise equal to the device-by-device flat path from the same state.
    Returns the launch counts."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.steps import make_lgc_train_step
    task = main_path_task("gilbert_flaky")
    b = task.build()
    flat_task = main_path_task("gilbert_flaky")
    fb = flat_task.build(params={k: v.clone() for k, v in
                                 b["params"].items()})
    fb["step"] = make_lgc_train_step(flat_task.arch, M_DEVICES,
                                     flat_task.step_cfg, rows=False)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = task.run(ROUNDS)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    losses = out["losses"]
    check(all(math.isfinite(x) for x in losses),
          f"gilbert_flaky losses {losses}")
    masks = torch.stack(task.masks)
    check(masks.shape == (ROUNDS, M_DEVICES, task.step_cfg.n_channels)
          and bool((masks == 0).any()),
          f"gilbert_flaky masks {masks.tolist()}: no channel dropped")
    want = ROUNDS * N_KERNEL_LEAVES
    for name, rows_name in ROW_KERNELS.items():
        check(counts[rows_name] == want and counts[name] == 0,
              f"gilbert_flaky training launches {counts}, expected {want} "
              f"for each row kernel and 0 for the flat ones")
    check(counts["swa_decode"] == 0, "gilbert_flaky: swa_decode launched")
    reset_launch_counts()
    flat_task.run(ROUNDS)
    torch.cuda.synchronize()
    flat_counts = dict(LAUNCHES)
    check(all(bool(torch.equal(a, c)) for a, c in zip(flat_task.masks,
                                                       task.masks)),
          "gilbert_flaky: the two runs drew different masks")
    for k in b["params"]:
        check(bits_equal(fb["params"][k].view(torch.int16),
                         b["params"][k].view(torch.int16)),
              f"gilbert_flaky param {k}: the row path and the flat path "
              f"differ")
        check(bits_equal(fb["ef"][k], b["ef"][k]),
              f"gilbert_flaky ef {k}: the row path and the flat path differ")
    check(all(flat_counts[n] == M_DEVICES * want for n in LGC_KERNELS),
          f"gilbert_flaky flat path launches {flat_counts}")
    log(f"main path under gilbert_flaky: masks by round {masks.tolist()} "
        f"({int((masks == 0).sum())} of {masks.numel()} channel-rounds "
        f"dropped); losses {losses}; device-steps/s "
        f"{out['device_steps_per_s']:.3f} (rounds 2-{ROUNDS}); {smi}")
    log(f"main path under gilbert_flaky: kernel launches {counts}; params "
        f"and error memory bitwise equal to the device-by-device flat path "
        f"(launches {flat_counts})")
    return counts


# ---------------------------------------------------------------------------
# phase 5b: the sparse uplinks, checkpoints and the train driver
# ---------------------------------------------------------------------------

# the driver at full width: (mode, extra flags); the AdamW run warms its
# learning rate up over 100 steps, so it takes a larger peak rate
DRIVER_RUNS = (("sync", ["--steps", "12", "--lr", "1e-2"]),
               ("lgc_sparse", ["--devices", "2", "--steps", "6",
                               "--lr", "5e-2"]))
SPARSE_WIRE, DENSE_WIRE = 51_367_680, 513_678_336


def sparse_task(aggregate: str | None = None, backend: str = "cuda"):
    """The full-width 100M task with the factory's default aggregate
    (``sparse_gather``) unless another is named."""
    from repro_torch.models.paper_models import make_task
    kw = {} if aggregate is None else {"aggregate": aggregate}
    return make_task("qwen2_100m", m_devices=M_DEVICES, preset="full",
                     backend=backend, **kw)


def phase_sparse_uplinks(smi: str, dense_steps_per_s: float) -> dict:
    """``sparse_gather`` (the task's default) at full width through the
    maxabs and histogram row kernels, bitwise the plain backend from the
    same state; ``bucket_sparse``; the selection's cost; a checkpoint
    round trip; the train driver in ``sync`` and ``lgc_sparse``.  Returns
    the sparse run's launch counts, with the selection's and the row
    kernels' times under "timing"."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    t_phase = time.perf_counter()
    task = sparse_task()
    check(task.step_cfg.aggregate == "sparse_gather",
          f"the task's default aggregate is {task.step_cfg.aggregate}")
    b = task.build()
    plain = sparse_task(backend="exact")
    pb = plain.build(params={k: v.clone() for k, v in b["params"].items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = task.run(ROUNDS)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = out["losses"]
    check(all(math.isfinite(x) for x in losses), f"sparse losses {losses}")
    want = ROUNDS * N_KERNEL_LEAVES
    check(counts["maxabs_rows"] == want and counts["histogram_rows"] == want,
          f"sparse_gather launches {counts}, expected {want} for the maxabs "
          f"and histogram row kernels")
    check(all(v == 0 for k, v in counts.items()
              if k not in ("maxabs_rows", "histogram_rows")),
          f"sparse_gather launched another kernel: {counts}")
    reset_launch_counts()
    plain.run(ROUNDS)
    torch.cuda.synchronize()
    check(not any(LAUNCHES.values()), f"the plain run launched {LAUNCHES}")
    for k in b["params"]:
        check(bits_equal(pb["params"][k].view(torch.int16),
                         b["params"][k].view(torch.int16)),
              f"sparse_gather param {k}: kernels and plain versions differ")
        check(bits_equal(pb["ef"][k], b["ef"][k]),
              f"sparse_gather ef {k}: kernels and plain versions differ")
    wire = out["wire_bytes_per_round_per_device"]
    check((wire, sparse_task("dense_masked").wire_bytes_per_round())
          == (SPARSE_WIRE, DENSE_WIRE), f"wire bytes {wire}")
    log(f"sparse_gather: qwen2_100m full width, M={M_DEVICES}, "
        f"{ROUNDS} rounds; losses {losses}; device-steps/s "
        f"{out['device_steps_per_s']:.3f} (rounds 2-{ROUNDS}) against "
        f"dense_masked's {dense_steps_per_s:.3f} in this call; wire "
        f"bytes/round/device {wire:,} against dense_masked's "
        f"{DENSE_WIRE:,}; peak device memory {peak_gib:.2f} GiB; {smi}")
    log(f"sparse_gather: kernel launches {counts}; params and error memory "
        f"bitwise equal to the plain backend's from the same state")
    counts["timing"] = time_sparse_selection(task)
    del plain, pb

    bucket = sparse_task("bucket_sparse")
    bucket.build(params={k: v.clone() for k, v in b["params"].items()})
    reset_launch_counts()
    bout = bucket.run(ROUNDS)
    torch.cuda.synchronize()
    check(all(math.isfinite(x) for x in bout["losses"]),
          f"bucket_sparse losses {bout['losses']}")
    check(not any(LAUNCHES.values()),
          f"bucket_sparse launched a kernel: {LAUNCHES}")
    log(f"bucket_sparse: losses {bout['losses']}; device-steps/s "
        f"{bout['device_steps_per_s']:.3f} (rounds 2-{ROUNDS}); no LGC "
        f"kernel launched")
    del bucket

    phase_checkpoint(b)
    del task, b
    torch.cuda.empty_cache()
    phase_driver()
    log(f"phase 5b (sparse uplinks, selection timing, checkpoint, driver): "
        f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def time_sparse_selection(task) -> dict:
    """ms of one leaf's sparse compression (the largest leaf's model-dim
    view at M=2) in each mode, against its statistics alone and against
    the dense path's ``lgc_compress_hist_rows`` of the same leaf."""
    import torch
    from repro_torch.kernels import lgc_compress_hist_rows
    from repro_torch.launch import steps
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, cols = 3072, LARGEST_LEAF // 3072      # w_gate: (12, 768, 3072)
    d = torch.randn(M_DEVICES, rows, cols, generator=gen, device="cuda")
    e = torch.randn(M_DEVICES, rows, cols, generator=gen, device="cuda")
    d, e = d * 1e-3, e * 1e-4
    sp = task.step_cfg.sparsity
    recv = torch.ones((M_DEVICES, len(sp)), dtype=torch.int32, device="cuda")
    cum = steps._leaf_cum_ks(cols, sp, "cuda")
    cum_flat = steps._leaf_cum_ks(LARGEST_LEAF, sp, "cuda").expand(
        M_DEVICES, -1)
    e2, d2 = e.reshape(-1, cols), d.reshape(-1, cols)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")     # no host sync in a leaf
    try:
        steps._compress_leaf_sparse(e, d, sp, recv, kernels=True, cum_ks=cum)
        steps._compress_leaf_bucket(e, d, sp, recv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # one call between two events: its enqueue (about 5 ms of host for
    # some 60 launches) stays ahead of its device time
    out = {
        "sparse_compress_ms": time_ms(lambda: steps._compress_leaf_sparse(
            e, d, sp, recv, kernels=True, cum_ks=cum)),
        "bucket_compress_ms": time_ms(lambda: steps._compress_leaf_bucket(
            e, d, sp, recv)),
        "row_stats_ms": time_ms(lambda: steps._row_stats(e2, d2)),
        "dense_compress_ms": time_ms(
            lambda: lgc_compress_hist_rows(e.reshape(M_DEVICES, -1),
                                           d.reshape(M_DEVICES, -1),
                                           cum_flat, recv)),
        "shape": [M_DEVICES, rows, cols]}
    del e, d, e2, d2
    out["rows"] = time_sparse_rows(gen)
    out["sweep"] = sweep_row_forms(gen)
    log(f"sparse selection at the largest leaf's view {out['shape']} (no "
        f"host sync in either sparse mode), ms of one call: sparse_gather "
        f"{out['sparse_compress_ms']:.3f} (the row kernels' statistics "
        f"{out['row_stats_ms']:.3f}), bucket_sparse "
        f"{out['bucket_compress_ms']:.3f}, against dense_masked's "
        f"lgc_compress_hist_rows {out['dense_compress_ms']:.3f}")
    return out


def time_sparse_rows(gen, shapes=None) -> dict:
    """``sum_maxabs_rows``, ``maxabs_rows`` and ``histogram_rows`` at the
    sparse path's (M x R, n) rows (``SPARSE_ROW_SHAPES``): bitwise their
    plain row versions, then timed beside them, ``sum_maxabs_rows`` also
    beside the unfused add and ``vector_norm(u, inf, dim=1)``,
    ``maxabs_rows`` beside ``vector_norm`` alone; and ``steps._row_stats``
    (both kernels, as the path calls them) with its launches.  Returns
    {kernel: {"RxN": row}}; each row names the form that ran."""
    import torch
    from repro_torch.device import device_ms
    from repro_torch.kernels import (LAUNCHES, histogram_rows, ref,
                                     reset_launch_counts, sum_maxabs_rows)
    from repro_torch.kernels import topk_threshold as tt
    from repro_torch.launch import steps
    inf = float("inf")
    out: dict = {"maxabs": {}, "histogram": {}}
    for r, n in shapes or SPARSE_ROW_SHAPES:
        x = torch.randn(r, n, generator=gen, device="cuda") * 1e-3
        e = torch.randn(r, n, generator=gen, device="cuda") * 1e-4
        u_ref = ref.ftz_add(e, x)
        mx_ref = ref.hist_maxabs_rows(u_ref)
        counts_ref = ref.hist_counts_rows(u_ref, mx_ref)
        reset_launch_counts()
        u, mx, counts = steps._row_stats(e, x)
        stats_launches = (LAUNCHES["maxabs_rows"], LAUNCHES["histogram_rows"])
        check(bits_equal(u, u_ref) and bits_equal(mx, mx_ref)
              and bits_equal(counts, counts_ref),
              f"_row_stats differs from the plain row versions at the "
              f"sparse path's ({r}, {n})")
        check(stats_launches == (1, 1),
              f"_row_stats at ({r}, {n}) launched {stats_launches}")
        stats_ms = device_ms(lambda: steps._row_stats(e, x))
        log(f"timing _row_stats (R, n)=({r}, {n}): {stats_launches[0]} "
            f"maxabs_rows and {stats_launches[1]} histogram_rows launches, "
            f"{stats_ms:.5f} ms device")
        sms = tt._sm_count(u.device)
        form = tt.row_form(r, n, sms, "maxabs")[0]
        hist_form = tt.row_form(r, n, sms, "histogram")[0]
        check(bits_equal(tt.maxabs_rows(u), mx_ref),
              f"maxabs_rows differs from its plain version at ({r}, {n})")
        rn = r * n
        row = time_row(n, lambda: sum_maxabs_rows(e, x),
                       lambda: ref.hist_maxabs_rows(ref.ftz_add(e, x)),
                       lambda: torch.linalg.vector_norm(u, inf, dim=1),
                       12 * rn + 4 * r, 2 * rn)
        row |= {"shape": [r, n], "form": form, "call": "sum_maxabs_rows",
                "unfused_device_ms": device_ms(
                    lambda: torch.linalg.vector_norm(torch.add(e, x), inf,
                                                     dim=1)),
                "row_stats_device_ms": stats_ms,
                "row_stats_launches": list(stats_launches)}
        log_row("sum_maxabs_rows", f"(R, n)=({r}, {n}), sparse_gather, "
                f"{form} form", row)
        log(f"timing torch.add then vector_norm(inf, dim=1) at ({r}, {n}): "
            f"{row['unfused_device_ms']:.5f} ms device")
        alone = time_row(n, lambda: tt.maxabs_rows(u),
                         lambda: ref.hist_maxabs_rows(u),
                         lambda: torch.linalg.vector_norm(u, inf, dim=1),
                         4 * rn + 4 * r, rn)
        row["maxabs_rows"] = alone
        log_row("maxabs_rows", f"(R, n)=({r}, {n}), {form} form", alone)
        out["maxabs"][f"{r}x{n}"] = row
        hist = time_row(n, lambda: histogram_rows(u, mx),
                        lambda: ref.hist_counts_rows(u, mx), None,
                        4 * rn + 4 * r + 4 * 256 * r, 3 * rn)
        hist |= {"shape": [r, n], "form": hist_form}
        out["histogram"][f"{r}x{n}"] = hist
        log_row("histogram_rows", f"(R, n)=({r}, {n}), sparse_gather, "
                f"{hist_form} form", hist)
        del x, e, u, u_ref, mx, counts
    torch.cuda.empty_cache()
    return out


def sweep_row_forms(gen) -> dict:
    """The crossover of the two row forms: at each n of ``SWEEP_NS``,
    ``SWEEP_FLOATS`` // n rows, ``sum_maxabs_rows``, ``maxabs_rows`` and
    ``histogram_rows`` in the short and the wide form (the wide one in
    launches of at most 65,535 rows), the two forms bitwise equal, each
    timed by ``device_ms``.  Returns {n: {kernel: {form: ms}}}."""
    import torch
    from repro_torch.device import device_ms
    from repro_torch.kernels import topk_threshold as tt
    out: dict = {}
    for n in SWEEP_NS:
        r = SWEEP_FLOATS // n
        x = torch.randn(r, n, generator=gen, device="cuda") * 1e-3
        e = torch.randn(r, n, generator=gen, device="cuda") * 1e-4
        u = torch.empty_like(e)
        mx = torch.empty(r, device="cuda")
        spans = [(i, min(i + 65_535, r)) for i in range(0, r, 65_535)]

        def launches(form):
            parts = [(0, r)] if form == "short" else spans
            return {
                "sum_maxabs_rows": lambda: [tt._maxabs_rows_launch(
                    e[i:j], x[i:j], u[i:j], form) for i, j in parts],
                "maxabs_rows": lambda: [tt._maxabs_rows_launch(
                    u[i:j], None, None, form) for i, j in parts],
                "histogram_rows": lambda: [tt._histogram_rows_launch(
                    u[i:j], mx[i:j], form) for i, j in parts]}
        got = {}
        for form in ("short", "wide"):
            u.zero_()
            fns = launches(form)
            mx.copy_(torch.cat(fns["sum_maxabs_rows"]()))
            got[form] = (u.clone(), mx.clone(),
                         torch.cat(fns["maxabs_rows"]()),
                         torch.cat(fns["histogram_rows"]()))
        check(all(bits_equal(a, b) for a, b in zip(got["short"],
                                                   got["wide"])),
              f"the short and wide row forms differ at ({r}, {n})")
        row = {"rows": r, "n": n,
               "picked": tt.row_form(r, n, tt._sm_count(x.device),
                                     "maxabs")[0],
               "picked_histogram": tt.row_form(r, n, tt._sm_count(x.device),
                                               "histogram")[0],
               "wide_launches": len(spans)}
        for form in ("short", "wide"):
            for name, fn in launches(form).items():
                # 20 calls: the wide form's 16 launches a call at n = 68
                # would fill the card's launch queue behind the hold at 100
                row.setdefault(name, {})[form] = device_ms(fn, reps=20)
        out[n] = row
        log(f"sweep (R, n)=({r}, {n}), ms device short / wide "
            f"({len(spans)} wide launches): " + "; ".join(
                f"{k} {row[k]['short']:.5f} / {row[k]['wide']:.5f}"
                for k in ("sum_maxabs_rows", "maxabs_rows",
                          "histogram_rows"))
            + f"; row_form picks {row['picked']} (maxabs), "
              f"{row['picked_histogram']} (histogram)")
        del x, e, u, mx, got
    torch.cuda.empty_cache()
    return out


def phase_checkpoint(b: dict) -> None:
    """The sparse run's bf16 params, stacked (M, ...) f32 error memory and
    round counter saved and restored bitwise, with bytes and seconds."""
    import shutil
    import torch
    from repro_torch.checkpoint import restore, save_checkpoint
    path = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    state = {"params": b["params"], "ef": b["ef"], "round": ROUNDS}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_dir = pathlib.Path(save_checkpoint(str(path), ROUNDS, state))
    save_s = time.perf_counter() - t0
    n_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    like = {"params": {k: torch.zeros_like(v) for k, v in
                       b["params"].items()},
            "ef": {k: torch.zeros_like(v) for k, v in b["ef"].items()},
            "round": 0}
    t0 = time.perf_counter()
    back, step = restore(str(path), like)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    shutil.rmtree(path, ignore_errors=True)
    check(step == ROUNDS and back["round"] == ROUNDS,
          f"checkpoint step {step}")
    for part in ("params", "ef"):
        for k, v in state[part].items():
            w = back[part][k]
            check(w.device == v.device and bits_equal(
                w.view(torch.int16) if w.dtype == torch.bfloat16 else w,
                v.view(torch.int16) if v.dtype == torch.bfloat16 else v),
                f"checkpoint {part} {k} did not round-trip")
    log(f"checkpoint: {n_bytes:,} B in {len(state['params'])} + "
        f"{len(state['ef'])} + 1 leaves saved in {save_s:.2f} s, restored "
        f"to the card bitwise in {load_s:.2f} s")


def phase_driver() -> None:
    """``python -m repro_torch.launch.train`` in process at full width on
    qwen2-100m, in ``sync`` (AdamW with the clip) and ``lgc_sparse``; each
    returns (its loss fell) instead of exiting 1.  The driver's
    ``lgc_sparse`` selects over each leaf as one row, as the reference's
    driver does; it runs once more with the 100M task's per-row rule
    (``steps.leaf_model_axis``, the driver's selection before that was
    repaired), for its time beside the new one."""
    import functools
    from repro_torch.launch import steps, train
    runs = [(mode, extra, None) for mode, extra in DRIVER_RUNS] + [
        ("lgc_sparse", dict(DRIVER_RUNS)["lgc_sparse"], steps.leaf_model_axis)]
    orig = train.make_lgc_train_step
    for mode, extra, rule in runs:
        argv = ["--arch", "qwen2-100m", "--mode", mode, "--log-every", "3",
                *extra]
        if rule is not None:
            train.make_lgc_train_step = functools.partial(orig,
                                                          model_axis=rule)
        t0 = time.perf_counter()
        try:
            losses = train.main(argv)
        except SystemExit as exc:
            raise AssertionError(f"chip_smoke: train {' '.join(argv)} "
                                 f"exited {exc.code}") from exc
        finally:
            train.make_lgc_train_step = orig
        how = "" if rule is None else " with the task's per-row selection"
        log(f"driver: train {' '.join(argv)}{how}: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}")


# ---------------------------------------------------------------------------
# phase 5d: the model axis on two gloo ranks sharing the card
# ---------------------------------------------------------------------------

MODEL_AXIS = 2
MODEL_AXIS_TIMEOUT_S = 300.0
MODEL_AXIS_AGGREGATES = ("dense_masked", "sparse_gather")
# rounds after the ROUNDS timed ones whose collectives each wait for the
# card before and after (``parallel.STATS["sync"]``): their ms inside the
# collectives are the collectives' own, their round ms carry two host
# waits a collective, so the timed rounds run without them
MODEL_AXIS_SYNCED_ROUNDS = 1
# Every round's loss at P = 2 against P = 1 from the same draw (bf16):
# |L(P=2) - L(P=1)| <= MODEL_AXIS_LOSS_ATOL.  Set from readings on the
# H100 (PERF.md §6, PR 28): sound runs differ by at most ~6e-4 over 4
# rounds (each row-parallel product's partial outputs are rounded to bf16
# before the SUM, so the trajectories drift apart slowly); planted faults
# (``--model-axis-faults``) move a round's loss by far more.
MODEL_AXIS_LOSS_ATOL = 5e-3
MODEL_AXIS_FAULTS = ("kv_pairing", "qkv_bias_dropped", "mlp_no_reduce")
MODEL_AXIS_DRIVER = ["--arch", "qwen2-100m", "--mode", "sync",
                     "--model-parallel", "2", "--devices", "2", "--steps",
                     "3", "--lr", "1e-1", "--log-every", "1"]


def model_axis_task(aggregate: str, model_axis: int = 1):
    """The full-width 100M task of phase 5 under ``aggregate``, at
    ``model_axis`` inside that many ranks: seed 0's draw either way."""
    from repro_torch.models.paper_models import make_task
    return make_task("qwen2_100m", m_devices=M_DEVICES, preset="full",
                     aggregate=aggregate, backend="cuda", scenario="static",
                     model_axis=model_axis)


def plant_model_axis_fault(name: str):
    """Put fault ``name`` into this rank's forward; returns its undo.
    ``kv_pairing``: each local query head reads the wrong local kv head
    (``repeat`` for ``repeat_interleave``); ``qkv_bias_dropped``: no
    ``bq`` / ``bk`` / ``bv``; ``mlp_no_reduce``: the MLP's partial
    outputs are never summed over the ranks."""
    from repro_torch import parallel
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    if name == "kv_pairing":
        def new(k, n):
            return k.repeat(1, 1, n // k.shape[2], 1)
        attr = "_expand_kv"
    elif name == "qkv_bias_dropped":            # zeroed, so still a leaf
        orig = tf.qkv_project

        def new(x, p, n_h, n_kv, hd, bias):
            return orig(x, {k: v * 0 if k[0] == "b" else v
                            for k, v in p.items()}, n_h, n_kv, hd, bias)
        attr = "qkv_project"
    elif name == "mlp_no_reduce":
        def new(x, bp, cfg, mesh=None):
            h = layers.apply_norm(x, bp["norm2"], cfg.norm)
            return x + layers.mlp_forward(parallel.copy_to_model(mesh, h),
                                          bp["mlp"], cfg.mlp), None
        attr = "_ffn"
    else:
        raise ValueError(f"no fault {name!r}")
    old = getattr(tf, attr)
    setattr(tf, attr, new)
    return lambda: setattr(tf, attr, old)


# The serving job of phase 5d (ROADMAP A12b): qwen2-1.5b at full width on
# each rank's shards (``sharding_rules.param_specs`` of seed 0's draw), 8
# prompts of 1,000 tokens and 40 greedy steps over a full cache of 1,040
# slots, then over a 1,024-slot ring that wraps at step 24 (slot 0's owner
# goes from rank 1's positions to rank 0's); both caches split on their
# slots, 520 / 512 a rank
MODEL_AXIS_SERVE = {"arch": "qwen2-1.5b", "batch": 8, "prompt": 1000,
                    "steps": 40, "window": 1024}
# Every step's logits at P = 2, fed P = 1's tokens, against P = 1 from the
# same draw (bf16), over the (8, 151,936) f32 logits of the prefill and of
# each step: the mean of |logits(P=2) - logits(P=1)| <=
# MODEL_AXIS_LOGITS_MEAN_ATOL and its max <= MODEL_AXIS_LOGITS_ATOL.  Set
# from readings on the H100 (PERF.md §6; ``--model-axis-faults``):
# sound runs 0.01187-0.01225 mean, 0.070-0.095 max a step (each
# row-parallel product's partials are rounded to bf16 before the sum);
# the planted faults' worst step: ``length_uncut`` 0.0170 / 0.0226 mean
# (ring / full cache; 0.121 / 0.156 max), ``cache_write_rank0`` 0.114 /
# 0.163 mean (1.18 / 1.25 max), ``partial_dropped`` 0.44 mean (3.4-3.5
# max).  The mean separates all three; the max bounds a gross error in a
# few rows.
MODEL_AXIS_LOGITS_MEAN_ATOL = 0.015
MODEL_AXIS_LOGITS_ATOL = 0.3
# The share of the free-running P = 2 run's greedy tokens (serve_decode.
# serve) equal to P = 1's, from the same readings: a row keeps P = 1's
# tokens until its first flipped argmax (5% of the fed runs' row-steps,
# where the top two logits are within the drift), then follows its own.
# Sound 0.4848 (rows first differ at steps 4-18, one never); faults
# 0.5396 (``length_uncut``), 0.3140 (``cache_write_rank0``), 0.1555
# (``partial_dropped``): a floor against gross faults only; the margin
# below and the fed runs' logits limits catch the rest.
MODEL_AXIS_TOKEN_SHARE = 0.25
# The free run's greedy tokens against P = 1 at the same histories (P = 1
# fed the free run's tokens): each token's margin max(logits) -
# logits[token] under P = 1's logits, the most over the (8, 41) row-steps
# at most MODEL_AXIS_TOKEN_MARGIN.  A sound token is P = 2's argmax, so
# its margin is at most twice the logits gap at that history (0.19 by the
# fed runs' 0.095).  Readings on the H100 (``--model-axis-faults``):
# sound 0.0469 (mean 0.00105); ``cache_write_rank0`` 0.500 and
# ``partial_dropped`` 2.508 fail it; ``length_uncut`` 0.0625 (mean
# 0.00157) passes, as it does the share: the fed runs' mean limit is what
# catches that fault.
MODEL_AXIS_TOKEN_MARGIN = 0.19
MODEL_AXIS_SERVE_FAULTS = ("cache_write_rank0", "partial_dropped",
                           "length_uncut")


def plant_serve_fault(name: str):
    """Put serving fault ``name`` into this rank's decode; returns its
    undo.  ``cache_write_rank0``: rank 0 writes every token's K/V (at the
    slot's place in its block) and the owner never does;
    ``partial_dropped``: the last rank's softmax state is emptied before
    the merge; ``length_uncut``: each rank attends with the whole cache's
    length (the kernel clamps it to the rank's slots) instead of its own."""
    import torch
    from repro_torch.kernels import swa_decode_partial
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    if name == "cache_write_rank0":
        orig, mod, attr = tf.cache_update, tf, "cache_update"

        def new(cache, k_new, v_new, pos, window=0, *, mesh=None):
            if mesh is None:
                return orig(cache, k_new, v_new, pos, window)
            s_loc = cache.k.shape[2]
            slots = s_loc * mesh.model_size
            slot = pos % slots if window else pos
            if 0 <= slot < slots and mesh.model_rank == 0:
                cache.k[:, :, slot % s_loc] = k_new[:, 0].to(cache.k.dtype)
                cache.v[:, :, slot % s_loc] = v_new[:, 0].to(cache.v.dtype)
            return layers.KVCache(cache.k, cache.v, torch.full(
                (cache.k.shape[0],), min(pos + 1, slots), dtype=torch.int32,
                device=cache.k.device))
    elif name == "partial_dropped":
        orig, mod, attr = (layers.merge_rank_partials, layers,
                           "merge_rank_partials")

        def new(mesh, out, m, l_sum, dtype):
            if mesh.model_rank == mesh.model_size - 1:
                m = torch.full_like(m, float("-inf"))
                l_sum = torch.zeros_like(l_sum)
            return orig(mesh, out, m, l_sum, dtype)
    elif name == "length_uncut":
        orig, mod, attr = tf.attention_decode, tf, "attention_decode"

        def new(q, cache, n_heads, *, mesh=None):
            if mesh is None:
                return orig(q, cache, n_heads)
            b, _, h, hd = q.shape
            out, m, l_sum = swa_decode_partial(q[:, 0].contiguous(), cache.k,
                                               cache.v, cache.length)
            return layers.merge_rank_partials(
                mesh, out, m, l_sum, q.dtype).reshape(b, 1, h, hd)
    else:
        raise ValueError(f"no serving fault {name!r}")
    setattr(mod, attr, new)
    return lambda: setattr(mod, attr, orig)


def mark() -> tuple:
    """After the card's queued work: the host clock, and the model axis's
    collectives so far and the seconds inside them."""
    import torch
    from repro_torch import parallel
    torch.cuda.synchronize()
    return (time.perf_counter(), parallel.STATS["calls"],
            parallel.STATS["seconds"])


def digest(ts) -> str:
    """sha256 of the bits of the tensors ``ts`` (4-byte elements), so that
    ranks' results can be held bit-equal without sending them."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def model_axis_serve(job: dict, mesh) -> dict:
    """The serving job on this rank (MODEL_AXIS_SERVE): seed 0's draw of
    qwen2-1.5b whole (P = 1) and this rank's shards of it.  Rank 0 alone
    runs P = 1 (warmed up, then timed) over the full cache and the ring,
    and hands its tokens to the other ranks; a short P = 2 serve warms up
    (the collectives' host buffers, cuBLAS at the shards' shapes); then
    for each of ``faults`` (None: sound) both runs again at P = 2, each
    step fed P = 1's token, with every step's logits gap to P = 1 (rank
    0) and the launches, and with ``free`` the full-cache run once more at
    P = 2 through ``serve_decode.serve``, greedy on its own tokens: the
    share of them equal to P = 1's, the timings, and (rank 0) P = 1 fed
    the free run's tokens, for each step's margin max(logits) -
    logits[token] of the free run's token under P = 1's logits at the same
    history.  sha256 digests of the P = 2 logits and tokens let the caller
    hold the ranks bit-equal."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import sharding_rules as rules
    from repro_torch.launch.serve_decode import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tf
    spec = MODEL_AXIS_SERVE
    cfg = get_config(spec["arch"])
    b, prompt, steps = spec["batch"], spec["prompt"], spec["steps"]
    lead = mesh.model_rank == 0
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0)
    shards = rules.shard_tree(params, rules.param_specs(cfg, params, mesh),
                              mesh)
    if not lead:
        del params
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                            device="cuda")
    torch.cuda.synchronize()
    out: dict = {"draw_s": time.perf_counter() - t0, "rank": mesh.rank,
                 "runs": {}, "p1": {}}
    runs = {"full": (0, prompt + steps), "ring": (spec["window"],
                                                  spec["window"])}

    def p1_run(window: int, slots: int, feed=None) -> tuple:
        """P = 1 on rank 0: the prefill and ``steps`` greedy steps (fed
        ``feed``'s tokens when given); tokens, logits and the timings."""
        m0 = mark()
        logits, cache = make_prefill_step(cfg, slots)(params,
                                                      {"tokens": prompts})
        m1 = mark()
        step = make_serve_step(cfg, window, return_logits=True)
        toks = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
        seen = [logits]
        for i in range(steps):
            fed = toks[-1] if feed is None else feed[:, i:i + 1]
            tok, cache, logits = step(params, fed, cache)
            toks.append(tok)
            seen.append(logits)
        m2 = mark()
        return toks, seen, {"prefill_s": m1[0] - m0[0],
                            "decode_ms": (m2[0] - m1[0]) / steps * 1e3}

    p1 = {}
    tokens = torch.zeros((len(runs), b, steps + 1), dtype=torch.int32)
    if lead:
        serve(params, cfg, prompts[:, :128], 2, cache_len=130)
        for i, (name, (window, slots)) in enumerate(runs.items()):
            toks, want, out["p1"][name] = p1_run(window, slots)
            p1[name] = want
            tokens[i] = torch.cat(toks, 1).cpu()
    dist.broadcast(tokens, 0, group=mesh.model_group)
    p1_tokens = {name: tokens[i].cuda() for i, name in enumerate(runs)}
    serve(shards, cfg, prompts[:, :128], 2, cache_len=130, mesh=mesh)
    out["free"] = {}

    for fault in job.get("faults", [None]):
        undo = plant_serve_fault(fault) if fault else None
        try:
            for name, (window, slots) in runs.items():
                toks = p1_tokens[name]
                reset_launch_counts()
                m0 = mark()
                logits, cache = make_prefill_step(cfg, slots, mesh=mesh)(
                    shards, {"tokens": prompts})
                m1 = mark()
                step = make_serve_step(cfg, window, mesh=mesh,
                                       return_logits=True)
                got = [logits]
                for i in range(steps):        # fed P = 1's tokens
                    _, cache, logits = step(shards, toks[:, i:i + 1], cache)
                    got.append(logits)
                m2 = mark()
                row = {
                    "fault": fault, "run": name, "slots": cache["slots"],
                    "local_slots": cache["kv"]["k"].shape[3],
                    "pos": cache["pos"], "launches": dict(LAUNCHES),
                    "digest": digest(got), "prefill_s": m1[0] - m0[0],
                    "prefill_collectives": m1[1] - m0[1],
                    "decode_ms": (m2[0] - m1[0]) / steps * 1e3,
                    "collectives_per_step": (m2[1] - m1[1]) / steps,
                    "collective_ms_per_step": (m2[2] - m1[2]) / steps * 1e3}
                if lead:
                    want = p1[name]
                    row |= {
                        "logits_gaps": [float((g - w).abs().max())
                                        for g, w in zip(got, want)],
                        "mean_gaps": [float((g - w).abs().mean())
                                      for g, w in zip(got, want)],
                        "argmax_agree": [
                            float((g.argmax(-1) == w.argmax(-1)).float()
                                  .mean()) for g, w in zip(got, want)]}
                out["runs"][f"{fault or 'sound'} {name}"] = row
                del cache, got
            if job.get("free"):
                reset_launch_counts()
                m0 = mark()
                r = serve(shards, cfg, prompts, steps,
                          cache_len=prompt + steps, mesh=mesh)
                m1 = mark()
                want = p1_tokens["full"]
                free = {
                    "launches": dict(LAUNCHES), "pos": r["pos"],
                    "slots": r["cache_slots"], "prefill_s": r["prefill_s"],
                    "decode_ms": r["decode_ms_per_step"],
                    "logits_finite": r["logits_finite"],
                    "token_share": float((r["tokens"] == want).float()
                                         .mean()),
                    "first_differing_step": [
                        next((i for i in range(want.shape[1])
                              if r["tokens"][row, i] != want[row, i]), None)
                        for row in range(b)],
                    "digest": digest([r["tokens"]]),
                    "seconds": m1[0] - m0[0], "collectives": m1[1] - m0[1],
                    "collective_ms": (m1[2] - m0[2]) * 1e3}
                if lead:
                    _, seen, _ = p1_run(0, prompt + steps, r["tokens"])
                    margins = [
                        (lg.amax(-1) - lg.gather(
                            -1, r["tokens"][:, i:i + 1].long())[:, 0])
                        for i, lg in enumerate(seen)]
                    free["margins"] = [float(mg.max()) for mg in margins]
                    free["mean_margin"] = float(torch.stack(margins).mean())
                out["free"][fault or "sound"] = free
                del r
        finally:
            if undo is not None:
                undo()
    torch.cuda.empty_cache()
    return out


def model_axis_compress(aggregate: str, mesh) -> dict:
    """(a) on this rank: at each kernel-sized leaf of the full-width 100M
    task, M = 2, random (e, delta) from a CPU generator seeded by the
    leaf's index and one dropped channel, the split pipeline (row kernels
    and plain versions) and the step's compression of the rank's block
    against the unsharded ones on the whole leaf."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import lgc_compress_hist_rows
    from repro_torch.launch import sharding_rules as rules
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    cfg = get_config("qwen2-100m")
    shapes = tf.init_params(cfg, device="meta")
    specs = rules.param_specs(cfg, shapes, mesh)
    step_cfg = steps.LGCStepConfig(aggregate=aggregate, backend="cuda")
    whole_fn, split_fn = (steps.make_lgc_compress(
        cfg, M_DEVICES, step_cfg, model_axis=steps.leaf_model_axis, mesh=m)
        for m in (None, mesh))
    recv = torch.ones((M_DEVICES, step_cfg.n_channels), dtype=torch.int32,
                      device="cuda")
    recv[-1, -1] = 0
    out = {}
    names = [k for k, v in shapes.items()
             if v.numel() >= steps.PALLAS_MIN_ELEMS]
    for i, k in enumerate(names):
        shape, spec = tuple(shapes[k].shape), specs[k]
        ef_spec = (None, *spec)
        gen = torch.Generator().manual_seed(28_000 + i)
        e = (torch.randn((M_DEVICES, *shape), generator=gen) * 0.01).cuda()
        d = (torch.randn((M_DEVICES, *shape), generator=gen) * 0.1).cuda()
        e_blk, d_blk = (rules.shard(t, ef_spec, mesh) for t in (e, d))
        local = tuple(e_blk.shape[1:])

        def block(t, lead=()):
            return rules.shard(t.reshape(*lead, *shape),
                               ef_spec if lead else spec, mesh)
        row = {"split": rules.is_sharded(spec, mesh.shape)}
        if aggregate == "dense_masked":
            cum = steps._leaf_cum_ks(math.prod(shape), step_cfg.sparsity,
                                     "cuda").expand(M_DEVICES, -1)
            want = [block(t, (M_DEVICES,)) for t in lgc_compress_hist_rows(
                e.reshape(M_DEVICES, -1), d.reshape(M_DEVICES, -1), cum,
                recv)]
            got = [steps.split_compress_rows(
                e_blk.reshape(M_DEVICES, -1), d_blk.reshape(M_DEVICES, -1),
                cum, recv, mesh, kern) for kern in (True, False)]
            row["pipeline_bitwise"] = all(bits_equal(a.reshape(b.shape), b)
                                          for a, b in zip(got[0], want))
            row["plain_bitwise"] = all(bits_equal(a, b)
                                       for a, b in zip(*got))
        g_w, e_w = whole_fn(k, shape, e.reshape(M_DEVICES, -1),
                            d.reshape(M_DEVICES, -1), recv)
        g_s, e_s = split_fn(k, local, e_blk.reshape(M_DEVICES, -1),
                            d_blk.reshape(M_DEVICES, -1), recv)
        row["step_bitwise"] = (
            bits_equal(g_s.reshape(local), block(g_w))
            and bits_equal(e_s.reshape(M_DEVICES, *local),
                           block(e_w, (M_DEVICES,))))
        out[k] = row
    return out


def model_axis_run(job: dict, mesh) -> dict:
    """(b) on this rank: the task at ``model_axis`` = P for ROUNDS timed
    rounds and ``synced`` more whose collectives wait for the card, with
    fault ``fault`` planted; per round the launches, the collectives'
    count, bytes and ms (host ms blocked in them in the timed rounds)."""
    import torch
    from repro_torch import parallel
    from repro_torch.kernels import LAUNCHES
    undo = (plant_model_axis_fault(job["fault"]) if job.get("fault")
            else None)
    try:
        task = model_axis_task(job["aggregate"], mesh.model_size)
        task.build()
        torch.cuda.synchronize()
        per_round: list = []
        kernels = (*ROW_KERNELS.values(), *LGC_KERNELS)

        def stats() -> dict:
            return {"launches": {k: LAUNCHES[k] for k in kernels},
                    "calls": parallel.STATS["calls"],
                    "bytes": parallel.STATS["bytes"],
                    "s": parallel.STATS["seconds"]}
        mark = stats()

        def on_round(i: int, loss: float) -> None:
            now = stats()
            per_round.append({
                "synced": parallel.STATS["sync"],
                "launches": {k: now["launches"][k] - mark["launches"][k]
                             for k in kernels},
                "collectives": now["calls"] - mark["calls"],
                "collective_bytes": now["bytes"] - mark["bytes"],
                "collective_ms": (now["s"] - mark["s"]) * 1e3})
            mark.update(now)
            parallel.STATS["sync"] = i + 1 >= ROUNDS
        run = task.run(ROUNDS + job.get("synced", 0), on_round=on_round)
    finally:
        parallel.STATS["sync"] = False
        if undo is not None:
            undo()
    return {"losses": run["losses"], "round_ms": run["round_ms"],
            "per_round": per_round, "rank": mesh.rank}


def model_axis_rank(jobs: list) -> dict:
    """Each rank's body under ``mesh.spawn``: the (1, P) mesh over the
    ranks present on the card, then every job (``compress``, ``run``,
    ``serve`` or ``family``) with its seconds."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = dist.get_world_size()
    mesh = make_host_mesh(world, model=world, device="cuda")
    results = {}
    for job in jobs:
        t0 = time.perf_counter()
        if job["kind"] == "compress":
            results[job["name"]] = model_axis_compress(job["aggregate"], mesh)
        elif job["kind"] == "serve":
            results[job["name"]] = model_axis_serve(job, mesh)
        elif job["kind"] == "family":
            results[job["name"]] = model_axis_family(job, mesh)
        elif job["kind"] == "drift":
            results[job["name"]] = axis_drift(job["arch"], mesh)
        else:
            results[job["name"]] = model_axis_run(job, mesh)
        results[job["name"]]["seconds"] = time.perf_counter() - t0
    return {"rank": mesh.rank, "transport": mesh.transport,
            "results": results}


def model_axis_p1(rounds: int) -> dict:
    """aggregate -> the P = 1 run's losses and round ms (rounds on the
    host, no collectives) from the same draw."""
    import torch
    out = {}
    for agg in MODEL_AXIS_AGGREGATES:
        task = model_axis_task(agg)
        run = task.run(rounds)
        check(run["losses"][-1] < run["losses"][0],
              f"model axis: P = 1 {agg} losses {run['losses']}")
        out[agg] = {"losses": run["losses"], "round_ms": run["round_ms"]}
        del task
        torch.cuda.empty_cache()
    return out


def loss_gaps(a: list, b: list) -> list:
    return [abs(x - y) for x, y in zip(a, b)]


def phase_model_axis(smi: str) -> dict:
    """Phase 5d (module docstring).  Returns the ``model_axis`` line."""
    import faulthandler
    from repro_torch.launch import train
    from repro_torch.launch.mesh import spawn
    t_phase = time.perf_counter()
    faulthandler.dump_traceback_later(3 * MODEL_AXIS_TIMEOUT_S, exit=True)
    rounds = ROUNDS + MODEL_AXIS_SYNCED_ROUNDS
    one = model_axis_p1(rounds)
    jobs = [dict(name=f"compress {agg}", kind="compress", aggregate=agg)
            for agg in MODEL_AXIS_AGGREGATES]
    jobs += [dict(name=f"run {agg}", kind="run", aggregate=agg,
                  synced=MODEL_AXIS_SYNCED_ROUNDS)
             for agg in MODEL_AXIS_AGGREGATES]
    jobs.append(dict(name="serve", kind="serve", faults=[None], free=True))
    jobs += [j for part in MODEL_AXIS_PART_KEYS
             for j in family_axis_jobs(part)]
    t0 = time.perf_counter()
    ranks = spawn(model_axis_rank, MODEL_AXIS, "gloo", args=(jobs,),
                  timeout=MODEL_AXIS_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    check({r["transport"] for r in ranks} == {"gloo"},
          f"model axis: transports {[r['transport'] for r in ranks]}")
    out: dict = {"card": smi, "ranks": MODEL_AXIS, "transport": "gloo",
                 "spawn_s": spawn_s, "p1": one,
                 "loss_atol": MODEL_AXIS_LOSS_ATOL}
    # (a) the split pipeline and the step's compression, leaf by leaf
    for agg in MODEL_AXIS_AGGREGATES:
        for r in ranks:
            rows = {k: v for k, v in r["results"][f"compress {agg}"].items()
                    if k != "seconds"}
            check(len(rows) == N_KERNEL_LEAVES and all(
                v["split"] for v in rows.values()),
                f"model axis (a) {agg} rank {r['rank']}: leaves {rows}")
            for leaf, v in rows.items():
                want = ("pipeline_bitwise", "plain_bitwise", "step_bitwise"
                        ) if agg == "dense_masked" else ("step_bitwise",)
                check(all(v[k] for k in want), f"model axis (a) {agg} "
                      f"rank {r['rank']} {leaf}: {v}")
        log(f"model axis (a) {agg}: the {N_KERNEL_LEAVES} kernel-sized "
            f"leaves at full width (M = {M_DEVICES}) split over 2 ranks, "
            f"each rank bitwise its block of the unsharded "
            + ("lgc_compress_hist_rows, of the plain split pipeline and "
               "of the unsharded step" if agg == "dense_masked"
               else "step"))
    # (b) the task at model_axis=2
    launches: dict = {}
    tasks: dict = {}
    for agg in MODEL_AXIS_AGGREGATES:
        r0, r1 = (r["results"][f"run {agg}"] for r in ranks)
        losses, p1 = r0["losses"], one[agg]
        check(losses == r1["losses"], f"model axis (b) {agg}: rank "
              f"losses {losses} and {r1['losses']}")
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0], f"model axis (b) {agg}: losses "
              f"{losses} do not fall")
        gaps = loss_gaps(losses, p1["losses"])
        check(len(gaps) == rounds and max(gaps) <= MODEL_AXIS_LOSS_ATOL,
              f"model axis (b) {agg}: losses {losses} against "
              f"{p1['losses']} at P = 1 (allowed {MODEL_AXIS_LOSS_ATOL})")
        want = {"maxabs_rows": N_KERNEL_LEAVES,
                "histogram_rows": N_KERNEL_LEAVES,
                "sparsify_ef_rows": N_KERNEL_LEAVES
                if agg == "dense_masked" else 0,
                "maxabs": 0, "histogram": 0, "sparsify_ef": 0}
        for r in (r0, r1):
            for i, pr in enumerate(r["per_round"]):
                check(pr["launches"] == want, f"model axis (b) {agg} rank "
                      f"{r['rank']} round {i + 1}: launches "
                      f"{pr['launches']}, expected {want}")
        for name, rn in ROW_KERNELS.items():
            launches.setdefault(name, {})[agg] = [
                sum(pr["launches"][rn] for pr in r["per_round"])
                for r in (r0, r1)]
        tasks[agg] = {
            "losses": losses, "loss_gaps_to_p1": gaps,
            "round_ms": r0["round_ms"],
            "synced": [pr["synced"] for pr in r0["per_round"]],
            "collective_ms": [[pr["collective_ms"] for pr in r["per_round"]]
                              for r in (r0, r1)],
            "collectives": [pr["collectives"] for pr in r0["per_round"]],
            "collective_bytes": [pr["collective_bytes"]
                                 for pr in r0["per_round"]],
            "seconds": [r0["seconds"], r1["seconds"]]}
        for r in (r0, r1):
            for i, pr in enumerate(r["per_round"]):
                what = ("ms inside" if pr["synced"]
                        else "host ms blocked in (no syncs)")
                log(f"model axis (b) {agg} rank {r['rank']} round {i + 1}"
                    f"{' (synced)' if pr['synced'] else ''}: "
                    f"{r['round_ms'][i]:.1f} ms (slowest rank; P = 1 "
                    f"{p1['round_ms'][i]:.1f}), {pr['collective_ms']:.1f} "
                    f"{what} {pr['collectives']} collectives "
                    f"({pr['collective_bytes']:,} B), launches "
                    f"{pr['launches']}")
        log(f"model axis (b) {agg}: losses {losses} (both ranks), P = 1 "
            f"{p1['losses']}, gaps {[f'{g:.3e}' for g in gaps]} (allowed "
            f"{MODEL_AXIS_LOSS_ATOL}); {smi}")
    out["tasks"] = tasks
    out["launches"] = launches
    out["serve"] = check_model_axis_serve([r["results"]["serve"]
                                           for r in ranks], smi)
    for part, key in MODEL_AXIS_PART_KEYS.items():
        out[key] = check_model_axis_part(ranks, smi, part)
    # (c) the driver spawns its own two ranks
    t0 = time.perf_counter()
    try:
        driver = train.main(MODEL_AXIS_DRIVER)
    except SystemExit as exc:
        raise AssertionError(f"chip_smoke: train "
                             f"{' '.join(MODEL_AXIS_DRIVER)} exited "
                             f"{exc.code}") from exc
    out["driver"] = {"losses": driver, "seconds": time.perf_counter() - t0}
    log(f"model axis (c): train {' '.join(MODEL_AXIS_DRIVER)}: exit 0 in "
        f"{out['driver']['seconds']:.1f} s, loss {driver[0]:.4f} -> "
        f"{driver[-1]:.4f}")
    faulthandler.cancel_dump_traceback_later()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"model axis phase: {out['seconds']:.1f} s")
    print(json.dumps({"model_axis": out}), flush=True)
    return out


def check_model_axis_serve(ranks: list, smi: str) -> dict:
    """(d) of phase 5d: the serving job's results on both ranks (the
    sound fed runs and the free run) against MODEL_AXIS_LOGITS_ATOL and
    MODEL_AXIS_TOKEN_SHARE, the launches and the ranks' bits; returns the
    ``serve`` part of the ``model_axis`` line."""
    spec = MODEL_AXIS_SERVE
    steps, prompt = spec["steps"], spec["prompt"]
    layers = 28                                   # qwen2-1.5b's
    want = {"swa_decode_partial": layers * steps}
    r0, r1 = ranks
    out = {"spec": spec, "logits_atol": MODEL_AXIS_LOGITS_ATOL,
           "logits_mean_atol": MODEL_AXIS_LOGITS_MEAN_ATOL,
           "token_share_min": MODEL_AXIS_TOKEN_SHARE,
           "token_margin_max": MODEL_AXIS_TOKEN_MARGIN,
           "draw_s": [r["draw_s"] for r in ranks],
           "seconds": [r["seconds"] for r in ranks], "runs": {}}
    for key, a in r0["runs"].items():
        b_ = r1["runs"][key]
        check(a["digest"] == b_["digest"], f"model axis (d) {key}: the "
              f"ranks' logits differ ({a['digest']}, {b_['digest']})")
        slots = prompt + steps if a["run"] == "full" else spec["window"]
        check(a["slots"] == slots and a["local_slots"] == slots // 2
              and a["pos"] == prompt + steps,
              f"model axis (d) {key}: slots {a['slots']} "
              f"({a['local_slots']} a rank), pos {a['pos']}")
        for r in (a, b_):
            nonzero = {k: v for k, v in r["launches"].items() if v}
            check(nonzero == want, f"model axis (d) {key}: launches "
                  f"{nonzero}, expected {want}")
        worst, worst_mean = max(a["logits_gaps"]), max(a["mean_gaps"])
        check(worst_mean <= MODEL_AXIS_LOGITS_MEAN_ATOL
              and worst <= MODEL_AXIS_LOGITS_ATOL, f"model axis (d) {key}: "
              f"logits {worst_mean:.4e} from P = 1's in the mean, "
              f"{worst:.4e} at most (allowed {MODEL_AXIS_LOGITS_MEAN_ATOL}, "
              f"{MODEL_AXIS_LOGITS_ATOL}); mean gaps {a['mean_gaps']}, "
              f"max gaps {a['logits_gaps']}")
        out["runs"][key] = {k: a[k] for k in (
            "logits_gaps", "mean_gaps", "argmax_agree", "prefill_s",
            "prefill_collectives", "decode_ms", "collectives_per_step",
            "collective_ms_per_step")} | {
            "decode_ms_rank1": b_["decode_ms"], "launches": want}
        log(f"model axis (d) serve {key}: {slots} slots ({slots // 2} a "
            f"rank), {steps} steps fed P = 1's tokens: logits gap to P = 1 "
            f"a step at most {worst_mean:.4e} in the mean and {worst:.4e} "
            f"in the max (allowed {MODEL_AXIS_LOGITS_MEAN_ATOL}, "
            f"{MODEL_AXIS_LOGITS_ATOL}), argmax agreeing "
            f"{min(a['argmax_agree']):.4f}-{max(a['argmax_agree']):.4f} a "
            f"step; ranks bitwise equal; prefill {a['prefill_s']:.3f} s "
            f"({a['prefill_collectives']} collectives), decode "
            f"{a['decode_ms']:.2f} ms a step (rank 1 {b_['decode_ms']:.2f}), "
            f"{a['collectives_per_step']:.1f}"
            f" collectives a step, {a['collective_ms_per_step']:.2f} host ms "
            f"blocked in them a step (no syncs); launches {want}")
    f0, f1 = r0["free"]["sound"], r1["free"]["sound"]
    check(f0["digest"] == f1["digest"], "model axis (d) free run: the "
          "ranks' tokens differ")
    for r in (f0, f1):
        nonzero = {k: v for k, v in r["launches"].items() if v}
        check(nonzero == want, f"model axis (d) free run: launches "
              f"{nonzero}, expected {want}")
    check(f0["logits_finite"] and f0["pos"] == prompt + steps
          and f0["slots"] == prompt + steps, f"model axis (d) free run: "
          f"pos {f0['pos']}, slots {f0['slots']}, finite "
          f"{f0['logits_finite']}")
    check(f0["token_share"] >= MODEL_AXIS_TOKEN_SHARE, f"model axis (d) "
          f"free run: {f0['token_share']:.4f} of its tokens are P = 1's "
          f"(at least {MODEL_AXIS_TOKEN_SHARE}); first differing steps "
          f"{f0['first_differing_step']}")
    margin = max(f0["margins"])
    check(margin <= MODEL_AXIS_TOKEN_MARGIN, f"model axis (d) free run: a "
          f"token {margin:.4e} below P = 1's greedy logit at its history "
          f"(at most {MODEL_AXIS_TOKEN_MARGIN}); margins a step "
          f"{f0['margins']}")
    collectives = f0["collectives"]
    out["free"] = {k: f0[k] for k in (
        "prefill_s", "decode_ms", "token_share", "first_differing_step",
        "margins", "mean_margin", "seconds", "collectives",
        "collective_ms")} | {
        "decode_ms_rank1": f1["decode_ms"], "launches": f0["launches"]}
    out["p1"] = r0["p1"]
    log(f"model axis (d) serve free run (serve_decode.serve, mesh of 2): "
        f"{prompt} tokens x {spec['batch']} prefilled in "
        f"{f0['prefill_s']:.3f} s, {steps} greedy steps at "
        f"{f0['decode_ms']:.2f} ms a step (rank 1 {f1['decode_ms']:.2f}), "
        f"{collectives} collectives in all, {f0['collective_ms']:.1f} host "
        f"ms blocked in them; {f0['token_share']:.4f} of its tokens are "
        f"P = 1's (at least {MODEL_AXIS_TOKEN_SHARE}; first differing "
        f"steps by row {f0['first_differing_step']}); each token at most "
        f"{margin:.4e} below P = 1's greedy logit at its history (mean "
        f"{f0['mean_margin']:.4e}; at most {MODEL_AXIS_TOKEN_MARGIN}); "
        f"ranks bitwise equal; swa_decode_partial "
        f"{f0['launches']['swa_decode_partial']} launches; {smi}")
    for name, t in r0["p1"].items():
        two = out["runs"][f"sound {name}"]
        log(f"model axis (d) serve {name} at P = 1 (rank 0 alone on the "
            f"card, the whole draw): prefill {t['prefill_s']:.3f} s, decode "
            f"{t['decode_ms']:.2f} ms a step; P = 2 fed the same tokens "
            f"(two ranks sharing the card): prefill "
            f"{two['prefill_s']:.3f} s, decode {two['decode_ms']:.2f} ms a "
            f"step, {two['decode_ms'] / t['decode_ms']:.2f}x P = 1's; {smi}")
    log(f"model axis (d) serving job: {r0['seconds']:.1f} s on rank 0 "
        f"({r0['draw_s']:.1f} s of it the draw)")
    return out


# ---------------------------------------------------------------------------
# phase 5d (e) and (f): the ssm and hybrid families, then the moe and vlm
# families, under the model axis (A12c)
# ---------------------------------------------------------------------------

MODEL_AXIS_SSM_ARCHS = ("mamba2-370m", "zamba2-1.2b")
# arch -> (FL devices M, batch, sequence, local learning rate, rounds):
# LGC rounds (dense_masked, H = 2, the CUDA kernels) at full width and
# depth in f32, P = 1 on rank 0 alone, then P = 2, from seed 0's draw and
# the same batches.  f32, not the configs' bf16: in bf16 these rounds
# amplify the rounding of the row-parallel partial sums into loss gaps of
# up to 0.17 by round 3, as large as a planted fault's (PERF.md §6),
# and no limit tells them apart.  Both run 2 rounds (time)
MODEL_AXIS_SSM_TRAIN = {"mamba2-370m": (2, 4, 128, 2e-2, 2),
                        "zamba2-1.2b": (2, 4, 128, 3e-2, 2)}
# serving at full width and depth in bf16: 8 prompts of 1,024 positions (a
# multiple of the 128-token SSD chunk) into a 1,040-slot cache (520 a
# rank of zamba2's K/V sites), 8 steps at P = 2 fed P = 1's greedy
# tokens (cut for time: the limits hold each step);
# before them serve_decode.serve(..., mesh=) on 128 of the prompts'
# tokens, 2 steps (the entry point, and the warm-up)
MODEL_AXIS_SSM_SERVE = {"batch": 8, "prompt": 1024, "slots": 1040,
                        "steps": 8, "entry_prompt": 128, "entry_steps": 2}
# Each round's loss at P = 2 against P = 1 (f32): |L(P=2) - L(P=1)| <=
# MODEL_AXIS_SSM_FIRST_ROUND_ATOL in round 1, whose losses come before any
# compression (the forward, the backward with the split-use SUM and a
# local SGD step), and <= MODEL_AXIS_SSM_LOSS_ATOL after it, where a
# coordinate that the two runs' roundings put on either side of an LGC
# bin edge changes layer (a gross check).  Every step's logits (the
# prefill's first) at P = 2, fed P = 1's tokens, against P = 1's (bf16):
# the mean of |gap| <= MODEL_AXIS_SSM_LOGITS_MEAN_ATOL, its max <=
# MODEL_AXIS_SSM_LOGITS_ATOL.  Set from readings on the H100
# (``--model-axis-faults``; PERF.md §6): training's sound round 1
# 9.5e-7 (mamba2) / 1.9e-6 (zamba2), later rounds up to 2.0e-4 / 3.7e-3
# (mamba2) and 5.7e-6 (zamba2); round 1 with ``split_use_unsummed``
# 1.8e-3 / 1.6e-4, with ``norm_sum_local`` 6.9e-2 / 1.7e-3; later rounds
# 7.8e-3-0.15 with either.  Serving's sound runs 0.0612-0.0688 (mamba2)
# and 0.0523-0.0561 (zamba2) mean a step, 0.31-0.44 max (bf16 P = 1 is
# itself 0.086 / 0.069 mean from P = 1 in f32, P = 2 0.088 / 0.071);
# ``norm_sum_local`` 0.39-0.65 mean (2.55-4.02 max),
# ``conv_tail_wrong_rank`` 1.08-1.12 mean at its first step (6.9-7.1
# max; decaying to 0.14-0.48 by step 16).
MODEL_AXIS_SSM_FIRST_ROUND_ATOL = 2e-5
MODEL_AXIS_SSM_LOSS_ATOL = 1e-2
MODEL_AXIS_SSM_LOGITS_MEAN_ATOL = 0.12
MODEL_AXIS_SSM_LOGITS_ATOL = 1.0
# fault -> the archs and paths it touches: the gated norm's sum of
# squares left on the rank (no SUM over the model group), the split-use
# SSD leaves' gradients left unsummed, the prefill writing the next
# rank's block of the conv tail
MODEL_AXIS_SSM_FAULTS = {
    "norm_sum_local": (MODEL_AXIS_SSM_ARCHS, ("train", "serve")),
    "split_use_unsummed": (MODEL_AXIS_SSM_ARCHS, ("train",)),
    "conv_tail_wrong_rank": (MODEL_AXIS_SSM_ARCHS, ("serve",))}

MODEL_AXIS_MOE_VLM_ARCHS = ("olmoe-1b-7b", "phi-3-vision-4.2b")
# (f): as (e)'s, in f32 (under bf16 a router flip sends a token to
# another expert, and the gap would hide a planted fault), at
# MODEL_AXIS_TRAIN_LAYERS of the configs' depth: olmoe-1b-7b at 2 of its
# 16 layers (its P = 1 step at 4 layers peaked at 56.45 GiB in bf16, and
# f32 doubles the weights), phi-3-vision-4.2b at 4 of its 32 with its 576
# patches before the 128 tokens
MODEL_AXIS_MOE_VLM_TRAIN = {"olmoe-1b-7b": (2, 4, 128, 2e-2, 3),
                            "phi-3-vision-4.2b": (2, 4, 128, 2e-2, 3)}
MODEL_AXIS_TRAIN_LAYERS = {"olmoe-1b-7b": 2, "phi-3-vision-4.2b": 4}
# serving at full depth in bf16 as (e)'s: 1,024 positions a prompt
# (phi-3-vision: its 576 patches and 448 tokens), 1,040 slots, 8 fed
# steps; the entry run on 128 tokens (after the patches)
MODEL_AXIS_MOE_VLM_SERVE = MODEL_AXIS_SSM_SERVE
# (f)'s limits, as (e)'s.  Set from readings on the H100
# (``--model-axis-faults``; PERF.md §6): training's sound rounds 9.5e-7,
# 9.5e-7, 0 (olmoe) and 9.5e-7, 0, 3.8e-6 (phi-3-vision); round 1 with
# ``aux_every_rank`` 1.4e-3, ``router_unsummed`` 2.6e-3,
# ``expert_block_next_rank`` 1.1e-2, ``vis_columns_reversed`` 5.8e-2, and
# 5.3e-4-4.2e-2 in the later rounds.  Serving's sound runs 0.022-0.052
# (olmoe) and 0.024-0.025 (phi-3-vision) mean a step, 0.14-0.45 max (bf16
# P = 1 is itself 0.050 / 0.029 mean from P = 1 in f32);
# ``expert_block_next_rank`` 0.48 mean (2.9-3.3 max),
# ``vis_columns_reversed`` 1.11 mean (6.1-6.9 max).
MODEL_AXIS_MOE_VLM_FIRST_ROUND_ATOL = 2e-5
MODEL_AXIS_MOE_VLM_LOSS_ATOL = 1e-3
MODEL_AXIS_MOE_VLM_LOGITS_MEAN_ATOL = 0.12
MODEL_AXIS_MOE_VLM_LOGITS_ATOL = 1.0
# fault -> the archs and paths it touches: the router's gradient left
# unsummed, the load-balance loss's gradient counted on every rank, each
# rank gathering and combining the next rank's block of the experts' slots
# (with its own experts' weights), ``vis_proj``'s column blocks gathered
# in the reverse rank order
MODEL_AXIS_MOE_VLM_FAULTS = {
    "router_unsummed": (("olmoe-1b-7b",), ("train",)),
    "aux_every_rank": (("olmoe-1b-7b",), ("train",)),
    "expert_block_next_rank": (("olmoe-1b-7b",), ("train", "serve")),
    "vis_columns_reversed": (("phi-3-vision-4.2b",), ("train", "serve"))}
MODEL_AXIS_AUDIO_ARCHS = ("whisper-small",)
# (g): as (f)'s, in f32 at full depth (12 encoder blocks over the
# driver's 1,500 zero frames, 12 decoder blocks, 128 tokens)
MODEL_AXIS_AUDIO_TRAIN = {"whisper-small": (2, 4, 128, 2e-2, 3)}
# serving in bf16 at full depth: 8 prompts of 192 tokens (whisper's
# decoder ceiling is 448) and 1,500 frames drawn from the same seed on
# both ranks, a 256-slot cache (128 a rank), 8 fed steps; the entry run on
# 128 tokens.  A step launches swa_decode_partial on the rank's slots of
# each block's self-attention cache and swa_decode on the rank's 6 of the
# 12 heads of its 1,500-slot cross cache
MODEL_AXIS_AUDIO_SERVE = {"batch": 8, "prompt": 192, "slots": 256,
                          "steps": 8, "entry_prompt": 128, "entry_steps": 2}
# (g)'s limits, as (e)'s and (f)'s.  Set from readings on the H100
# (``--model-axis-faults``; PERF.md §6): training's sound rounds 0, 0,
# 1.9e-6; ``enc_unsummed`` 3.7e-2, 5.1e-2, 4.1e-2, ``cross_wo_unsummed``
# 8.2e-2, 4.7e-2, 4.3e-2.  Serving's sound run 0.0076-0.0080 mean a step,
# 0.055 max (bf16 P = 1 is itself 0.0083 mean from P = 1 in f32);
# ``cross_wo_unsummed`` 0.43-0.59 mean (2.3-3.4 max),
# ``cross_heads_next_rank`` 0.73 mean (4.0-4.1 max) from the first step
MODEL_AXIS_AUDIO_FIRST_ROUND_ATOL = 2e-5
MODEL_AXIS_AUDIO_LOSS_ATOL = 1e-3
MODEL_AXIS_AUDIO_LOGITS_MEAN_ATOL = 0.04
MODEL_AXIS_AUDIO_LOGITS_ATOL = 0.4
# fault -> the archs and paths it touches: the encoder output's gradient
# left each rank's own heads' part (no copy_to_model), the cross ``wo``
# output left unsummed, the decode step's query heads attending over the
# next rank's heads of the cross cache
MODEL_AXIS_AUDIO_FAULTS = {
    "enc_unsummed": (MODEL_AXIS_AUDIO_ARCHS, ("train",)),
    "cross_wo_unsummed": (MODEL_AXIS_AUDIO_ARCHS, ("train", "serve")),
    "cross_heads_next_rank": (MODEL_AXIS_AUDIO_ARCHS, ("serve",))}
# part -> its archs, runs, limits and faults
MODEL_AXIS_PARTS = {
    "e": {"what": "the ssm and hybrid families",
          "archs": MODEL_AXIS_SSM_ARCHS, "train": MODEL_AXIS_SSM_TRAIN,
          "serve": MODEL_AXIS_SSM_SERVE,
          "first_round_atol": MODEL_AXIS_SSM_FIRST_ROUND_ATOL,
          "loss_atol": MODEL_AXIS_SSM_LOSS_ATOL,
          "logits_mean_atol": MODEL_AXIS_SSM_LOGITS_MEAN_ATOL,
          "logits_atol": MODEL_AXIS_SSM_LOGITS_ATOL,
          "faults": MODEL_AXIS_SSM_FAULTS},
    "f": {"what": "the moe and vlm families",
          "archs": MODEL_AXIS_MOE_VLM_ARCHS,
          "train": MODEL_AXIS_MOE_VLM_TRAIN,
          "serve": MODEL_AXIS_MOE_VLM_SERVE,
          "first_round_atol": MODEL_AXIS_MOE_VLM_FIRST_ROUND_ATOL,
          "loss_atol": MODEL_AXIS_MOE_VLM_LOSS_ATOL,
          "logits_mean_atol": MODEL_AXIS_MOE_VLM_LOGITS_MEAN_ATOL,
          "logits_atol": MODEL_AXIS_MOE_VLM_LOGITS_ATOL,
          "faults": MODEL_AXIS_MOE_VLM_FAULTS},
    "g": {"what": "the audio family",
          "archs": MODEL_AXIS_AUDIO_ARCHS, "train": MODEL_AXIS_AUDIO_TRAIN,
          "serve": MODEL_AXIS_AUDIO_SERVE,
          "first_round_atol": MODEL_AXIS_AUDIO_FIRST_ROUND_ATOL,
          "loss_atol": MODEL_AXIS_AUDIO_LOSS_ATOL,
          "logits_mean_atol": MODEL_AXIS_AUDIO_LOGITS_MEAN_ATOL,
          "logits_atol": MODEL_AXIS_AUDIO_LOGITS_ATOL,
          "faults": MODEL_AXIS_AUDIO_FAULTS}}
#: part -> its key in the ``model_axis`` line
MODEL_AXIS_PART_KEYS = {"e": "ssm", "f": "moe_vlm", "g": "audio"}
MODEL_AXIS_ARCH_PART = {arch: part for part, spec in MODEL_AXIS_PARTS.items()
                        for arch in spec["archs"]}


class _RankAs:
    """``mesh`` with another ``model_rank``: what a rank that takes itself
    for another sees."""

    def __init__(self, mesh, rank: int):
        self._mesh, self.model_rank = mesh, rank

    def __getattr__(self, name):
        return getattr(self._mesh, name)


def plant_axis_fault(name: str):
    """Put fault ``name`` (MODEL_AXIS_SSM_FAULTS, MODEL_AXIS_MOE_VLM_FAULTS,
    MODEL_AXIS_AUDIO_FAULTS) into this rank; returns its undo."""
    import torch
    from repro_torch import parallel
    from repro_torch.models import layers
    from repro_torch.models import moe
    from repro_torch.models import ssd
    from repro_torch.models import transformer as tf
    if name == "norm_sum_local":
        mod, attr = parallel, "sum_over_model"

        def new(mesh, x):
            return x
    elif name in ("split_use_unsummed", "router_unsummed"):
        mod, attr = tf, "sum_split_use_grads"

        def new(cfg, grads, mesh):
            return grads
    elif name == "conv_tail_wrong_rank":
        mod, attr = tf, "_ssm_layer_prefill"

        def new(x, bp, cfg, ssm_cache, layer, mesh=None):
            h = layers.apply_norm(x, bp["norm1"], cfg.norm)
            y, h_final, tail = ssd.ssm_block(h, bp["ssm"], cfg, mesh)
            conv = ssm_cache["conv"]
            w = conv.shape[-1]
            r = (mesh.model_rank + 1) % mesh.model_size
            conv[layer] = tail[..., r * w:(r + 1) * w]
            ssm_cache["state"][layer] = h_final
            return x + y
    elif name == "aux_every_rank":
        mod, attr = parallel, "count_once"

        def new(mesh, x):
            return x
    elif name == "expert_block_next_rank":
        mod, attr = moe, "moe_forward"
        old_forward = moe.moe_forward

        def new(x, p, *, mesh=None, **kw):
            if parallel.model_size(mesh) > 1:
                mesh = _RankAs(mesh, (mesh.model_rank + 1) % mesh.model_size)
            return old_forward(x, p, mesh=mesh, **kw)
    elif name == "enc_unsummed":
        mod, attr = tf, "_encode"

        def new(params, cfg, frames, mesh=None):
            enc = frames.to(cfg.dtype) + params["enc_pos"][
                None, :frames.shape[1]]
            positions = torch.arange(enc.shape[1], device=enc.device)
            for bp in tf.layer_params(params, "enc_blocks"):
                enc, _ = tf._attn_block_train(enc, bp, cfg, positions,
                                              causal=False, mesh=mesh)
            return layers.apply_norm(enc, tf.subtree(params, "enc_norm"),
                                     cfg.norm)
    elif name == "cross_wo_unsummed":
        mod, attr = tf, "_cross_train"

        def new(x, bp, cfg, enc, mesh=None):
            b, s, _ = x.shape
            n_h, n_kv = layers.local_heads(cfg.n_heads, cfg.n_kv_heads,
                                           parallel.model_size(mesh))
            h = parallel.copy_to_model(
                mesh, layers.apply_norm(x, bp["norm_x"], cfg.norm))
            q = (h @ bp["cross"]["wq"]).reshape(b, s, n_h, cfg.hd)
            ck, cv = tf._cross_kv(enc, bp["cross"], cfg, n_h, n_kv)
            att = layers.attention_train(q, ck, cv, causal=False,
                                         q_chunk=cfg.attn_q_chunk)
            return x + att.reshape(b, s, -1) @ bp["cross"]["wo"], ck, cv
    elif name == "cross_heads_next_rank":
        mod, attr = tf, "attention_decode_heads"

        def new(q, cache, mesh):
            return layers.attention_decode_heads(q, cache, _RankAs(
                mesh, (mesh.model_rank + 1) % mesh.model_size))
    elif name == "vis_columns_reversed":
        mod, attr = parallel, "gather_to_model"
        old_gather = parallel.gather_to_model

        def new(mesh, x):
            whole = old_gather(mesh, x)
            return torch.cat(whole.chunk(parallel.model_size(mesh), -1)[::-1],
                             -1)
    else:
        raise ValueError(f"no model-axis fault {name!r}")
    old = getattr(mod, attr)
    setattr(mod, attr, new)
    return lambda: setattr(mod, attr, old)


def axis_train(cfg, mesh, lead: bool, p1: bool) -> dict:
    """(e), (f) and (g) training on this rank, in f32 (each part's
    ``train``, at MODEL_AXIS_TRAIN_LAYERS): with ``p1`` rank
    0 first runs the rounds at P = 1 alone from the whole draw; then both
    ranks at P = 2 from their shards of it.  Per round the host ms, each
    LGC kernel's launches, the collectives and the host ms blocked in
    them."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch import parallel
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import sharding_rules as rules
    from repro_torch.launch import steps
    from repro_torch.launch.train import modality_prefix
    from repro_torch.models import transformer as tf
    m, batch, seq, lr, rounds = MODEL_AXIS_PARTS[MODEL_AXIS_ARCH_PART[
        cfg.name]]["train"][cfg.name]
    cfg = dataclasses.replace(cfg, dtype=torch.float32, n_layers=(
        MODEL_AXIS_TRAIN_LAYERS.get(cfg.name, cfg.n_layers)))
    pipe = TokenPipeline(cfg.vocab_size, seq, batch)
    pipe.next_batch()
    batches = [pipe.next_batch() for _ in range(rounds)]
    prefix = modality_prefix(cfg, batch, "cuda")
    step_cfg = steps.LGCStepConfig(local_steps=2, local_lr=lr,
                                   aggregate="dense_masked", backend="cuda")
    kernels = (*ROW_KERNELS.values(), *LGC_KERNELS)
    torch.cuda.reset_peak_memory_stats()

    def run(params, mesh_) -> dict:
        step = steps.make_lgc_train_step(cfg, m, step_cfg, donate=True,
                                         mesh=mesh_)
        ef = steps.init_ef_tree(params, m)
        out = {"losses": [], "round_ms": [], "launches": [],
               "collectives": [], "collective_ms": []}
        for x, y in batches:
            b = {"tokens": torch.from_numpy(x).to("cuda", torch.long),
                 "labels": torch.from_numpy(y).to("cuda", torch.long)}
            if prefix is not None:
                b["prefix"] = prefix
            torch.cuda.synchronize()
            before = (dict(LAUNCHES), parallel.STATS["calls"],
                      parallel.STATS["seconds"], time.perf_counter())
            params, ef, loss = step(params, ef, b)
            out["losses"].append(float(loss))
            out["round_ms"].append((time.perf_counter() - before[3]) * 1e3)
            out["launches"].append({k: LAUNCHES[k] - before[0][k]
                                    for k in kernels})
            out["collectives"].append(parallel.STATS["calls"] - before[1])
            out["collective_ms"].append(
                (parallel.STATS["seconds"] - before[2]) * 1e3)
        del params, ef
        torch.cuda.empty_cache()
        return out

    res: dict = {}
    if p1 and lead:
        res["p1"] = run(tf.init_params(cfg, seed=0), None)
    dist.barrier(group=mesh.model_group)
    params = tf.init_params(cfg, seed=0)
    shards = rules.shard_tree(params, rules.param_specs(cfg, params, mesh),
                              mesh)
    del params
    res["p2"] = run(shards, mesh)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


# arch -> (P = 1's greedy tokens, on every rank; its logits a step, on
# rank 0; P = 1's in f32 fed the same tokens, on rank 0): the sound job's,
# which the fault jobs on the same ranks feed
_AXIS_P1: dict = {}


def axis_serve(cfg, mesh, lead: bool, p1: bool) -> dict:
    """(e), (f) and (g) serving on this rank: with ``p1`` rank 0 serves at
    P = 1 alone (warmed up, then timed), then the same in f32 fed the same
    tokens (a yardstick: how far bf16 itself is from f32), and hands its
    greedy tokens to the other rank; then both run
    ``serve_decode.serve(..., mesh=)`` on the prompts' first tokens (the
    entry point and the warm-up), prefill at P = 2 and run the steps fed
    P = 1's tokens (every step's logits gap to P = 1 and to f32 on rank 0,
    the launches, the collectives and the host ms blocked in them).  The
    vlm's prompts are its patch embeddings (drawn on the card) and the
    tokens after them; the audio family's are 1,500 frames (drawn on the
    card from the same seed on both ranks, which take no positions) and
    the tokens."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import sharding_rules as rules
    from repro_torch.launch.serve_decode import serve, stub_prefix
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tf
    spec = MODEL_AXIS_PARTS[MODEL_AXIS_ARCH_PART[cfg.name]]["serve"]
    b, slots, n = spec["batch"], spec["slots"], spec["steps"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    prefix = stub_prefix(cfg, b, gen, torch.device("cuda"))
    patches = cfg.n_prefix_tokens if cfg.arch_type == "vlm" else 0
    prompts = torch.randint(0, cfg.vocab_size, (b, spec["prompt"] - patches),
                            generator=gen, device="cuda")
    pre = {} if prefix is None else {"prefix": prefix}

    def fed(params, mesh_, feed) -> tuple:
        """Prefill and ``n`` steps (fed ``feed``'s tokens, or greedy):
        the logits a step, the tokens and the timings."""
        reset_launch_counts()
        m0 = mark()
        logits, cache = make_prefill_step(cfg, slots, mesh=mesh_)(
            params, {"tokens": prompts, **pre})
        m1 = mark()
        step = make_serve_step(cfg, 0, mesh=mesh_, return_logits=True)
        toks, seen = [torch.argmax(logits, -1).to(torch.int32)[:, None]], [
            logits]
        for i in range(n):
            fed_tok = toks[-1] if feed is None else feed[:, i:i + 1]
            tok, cache, logits = step(params, fed_tok, cache)
            toks.append(tok)
            seen.append(logits)
        m2 = mark()
        ssm = cache.get("ssm", {})
        return seen, torch.cat(toks, 1), {
            "prefill_s": m1[0] - m0[0], "prefill_collectives": m1[1] - m0[1],
            "prefill_collective_ms": (m1[2] - m0[2]) * 1e3,
            "decode_ms": (m2[0] - m1[0]) / n * 1e3,
            "collectives_per_step": (m2[1] - m1[1]) / n,
            "collective_ms_per_step": (m2[2] - m1[2]) / n * 1e3,
            "launches": {k: v for k, v in LAUNCHES.items() if v},
            "pos": cache["pos"], "slots": cache.get("slots"),
            "local_conv": (ssm["conv"].shape[-1] if ssm else None),
            "local_heads": (ssm["state"].shape[2] if ssm else None),
            "local_slots": (cache["kv"]["k"].shape[3] if "kv" in cache
                            else None),
            "cross_digest": (digest([cache["cross_k"], cache["cross_v"]])
                             if "cross_k" in cache else None)}

    def gaps(got, ref) -> dict:
        return {"logits_gaps": [float((g - w).abs().max())
                                for g, w in zip(got, ref)],
                "mean_gaps": [float((g - w).abs().mean())
                              for g, w in zip(got, ref)]}

    out: dict = {}
    short, n_short = spec["entry_prompt"], spec["entry_steps"]
    if p1:
        tokens = torch.zeros((b, n + 1), dtype=torch.int32)
        f32 = None
        if lead:
            params = tf.init_params(cfg, seed=0)
            serve(params, cfg, prompts[:, :short], n_short, prefix=prefix,
                  cache_len=short + patches + n_short)
            want, toks, out["p1"] = fed(params, None, None)
            tokens = toks.cpu()
            del params
            cfg, bf16 = dataclasses.replace(cfg, dtype=torch.float32), cfg
            params = tf.init_params(cfg, seed=0)
            f32, _, _ = fed(params, None, toks)
            out["p1"]["to_f32"] = gaps(want, f32)
            del params
            cfg = bf16
        dist.broadcast(tokens, 0, group=mesh.model_group)
        _AXIS_P1[cfg.name] = (tokens.cuda(), want if lead else None, f32)
    feed, want, f32 = _AXIS_P1[cfg.name]
    params = tf.init_params(cfg, seed=0)
    shards = rules.shard_tree(params, rules.param_specs(cfg, params, mesh),
                              mesh)
    del params
    reset_launch_counts()
    m0 = mark()
    r = serve(shards, cfg, prompts[:, :short], n_short, prefix=prefix,
              cache_len=short + patches + n_short, mesh=mesh)
    m1 = mark()
    out["entry"] = {
        "launches": {k: v for k, v in LAUNCHES.items() if v},
        "pos": r["pos"], "slots": r["cache_slots"],
        "logits_finite": r["logits_finite"], "digest": digest([r["tokens"]]),
        "seconds": m1[0] - m0[0], "collectives": m1[1] - m0[1]}
    del r
    got, _, out["p2"] = fed(shards, mesh, feed)
    out["p2"]["digest"] = digest(got)
    out["p2"]["finite"] = all(bool(torch.isfinite(g).all()) for g in got)
    if lead:
        out["p2"] |= gaps(got, want) | {
            "to_f32": gaps(got, f32),
            "argmax_agree": [float((g.argmax(-1) == w.argmax(-1)).float()
                                   .mean()) for g, w in zip(got, want)]}
    del got
    torch.cuda.empty_cache()
    return out


def model_axis_family(job: dict, mesh) -> dict:
    """(e) or (f) on this rank: ``job["arch"]``'s training and serving
    (``job["paths"]``) at full width, with fault ``job["fault"]`` planted
    and, with ``job["p1"]``, P = 1 on rank 0 to compare with."""
    from repro_torch.configs import get_config
    cfg = get_config(job["arch"])
    lead = mesh.model_rank == 0
    undo = plant_axis_fault(job["fault"]) if job.get("fault") else None
    out: dict = {"rank": mesh.rank}
    try:
        t0 = time.perf_counter()
        if "train" in job["paths"]:
            out["train"] = axis_train(cfg, mesh, lead, job["p1"])
        out["train_s"] = time.perf_counter() - t0
        if "serve" in job["paths"]:
            out["serve"] = axis_serve(cfg, mesh, lead, job["p1"])
        out["serve_s"] = time.perf_counter() - t0 - out["train_s"]
    finally:
        if undo is not None:
            undo()
    return out


def family_axis_jobs(part: str, faults: bool = False) -> list:
    """Phase 5d (``part`` e or f)'s jobs: each arch sound with P = 1 to
    compare with and, with ``faults``, each of the part's faults on its
    archs and paths."""
    spec = MODEL_AXIS_PARTS[part]
    jobs = []
    for arch in spec["archs"]:
        jobs.append(dict(name=f"{part} {arch}", kind="family", arch=arch,
                         paths=("train", "serve"), p1=True))
        if faults:
            jobs += [dict(name=f"{part} {arch} {f}", kind="family",
                          arch=arch, paths=paths, p1=False, fault=f)
                     for f, (archs, paths) in spec["faults"].items()
                     if arch in archs]
    return jobs


def axis_gaps(sound: dict, run: dict) -> dict:
    """A run's loss gaps to P = 1 a round and its logits gaps (max and
    mean) to P = 1 a step, from rank 0's results (``sound`` holds
    P = 1's)."""
    out = {}
    if "train" in run:
        out["loss_gaps"] = loss_gaps(run["train"]["p2"]["losses"],
                                     sound["train"]["p1"]["losses"])
    if "serve" in run:
        s = run["serve"]["p2"]
        out["logits_gaps"], out["mean_gaps"] = (s["logits_gaps"],
                                                s["mean_gaps"])
    return out


def axis_serve_launches(cfg, steps: int) -> dict:
    """The kernels' launches on a rank in ``steps`` decode steps at P = 2
    over a K/V cache split on its slots: ``swa_decode_partial`` at every
    self-attention site, and the audio decoder's ``swa_decode`` over the
    rank's heads of each block's cross cache."""
    if cfg.arch_type == "audio":
        return {"swa_decode_partial": cfg.n_layers * steps,
                "swa_decode": cfg.n_layers * steps}
    sites = attention_sites(cfg)
    return {"swa_decode_partial": sites * steps} if sites else {}


def axis_serve_launch_rows(model_axis: dict, kernel: str,
                           keys=tuple(MODEL_AXIS_PART_KEYS.values())
                           ) -> dict:
    """``launches_model_axis_<key>_serve`` for each part ``key`` of the
    ``model_axis`` line: ``kernel``'s launches on rank 0 in each arch's
    fed run and its ``serve_decode.serve(mesh=)`` run."""
    return {f"launches_model_axis_{key}_serve": {
        arch: {"fed": a["serve"]["launches"].get(kernel, 0),
               "entry": a["entry"]["launches"].get(kernel, 0)}
        for arch, a in model_axis[key].items()
        if isinstance(a, dict) and "serve" in a} for key in keys}


def check_model_axis_part(ranks: list, smi: str, part: str) -> dict:
    """(e), (f) or (g) of phase 5d: both ranks' results for each arch
    against the part's limits, the launches and the ranks' bits; returns
    the part's entry of the ``model_axis`` line (MODEL_AXIS_PART_KEYS)."""
    from repro_torch.configs import get_config
    p = MODEL_AXIS_PARTS[part]
    first, lim, mean_lim, max_lim = (p["first_round_atol"], p["loss_atol"],
                                     p["logits_mean_atol"], p["logits_atol"])
    spec = p["serve"]
    out: dict = {"first_round_atol": first, "loss_atol": lim,
                 "logits_atol": max_lim, "logits_mean_atol": mean_lim,
                 "train": p["train"], "serve": spec}
    tag = f"model axis ({part})"
    for arch in p["archs"]:
        cfg = get_config(arch)
        r0, r1 = (r["results"][f"{part} {arch}"] for r in ranks)
        t0, t1 = r0["train"], r1["train"]
        p1, p2 = t0["p1"], t0["p2"]
        losses = p2["losses"]
        check(losses == t1["p2"]["losses"], f"{tag} {arch}: rank "
              f"losses {losses} and {t1['p2']['losses']}")
        check(all(math.isfinite(x) for x in losses + p1["losses"])
              and losses[-1] < losses[0] and p1["losses"][-1]
              < p1["losses"][0], f"{tag} {arch}: losses {losses}, "
              f"P = 1 {p1['losses']} do not fall")
        gaps = loss_gaps(losses, p1["losses"])
        check(gaps[0] <= first and max(gaps) <= lim, f"{tag} {arch}: "
              f"losses {losses} against {p1['losses']} at P = 1 (allowed "
              f"{first} in round 1, {lim} after)")
        leaves = FAMILY_KERNEL_LEAVES[arch]
        want = {"maxabs_rows": leaves, "histogram_rows": leaves,
                "sparsify_ef_rows": leaves, "maxabs": 0, "histogram": 0,
                "sparsify_ef": 0}
        for r in (t0, t1):
            for run in (r["p2"],) + ((r["p1"],) if "p1" in r else ()):
                for i, got in enumerate(run["launches"]):
                    check(got == want, f"{tag} {arch} round {i + 1}: "
                          f"launches {got}, expected {want}")
        s0, s1 = r0["serve"], r1["serve"]
        f0 = s0["p2"]
        check(f0["digest"] == s1["p2"]["digest"] and f0["finite"]
              and f0["cross_digest"] == s1["p2"]["cross_digest"],
              f"{tag} {arch}: the ranks' logits (or cross caches) differ "
              f"or are not finite")
        sites = attention_sites(cfg)
        want_serve = axis_serve_launches(cfg, spec["steps"])
        for s in (s0, s1):
            check(s["p2"]["launches"] == want_serve, f"{tag} {arch}"
                  f" serve: launches {s['p2']['launches']}, expected "
                  f"{want_serve}")
        ssd = cfg.arch_type in ("ssm", "hybrid")
        c = cfg.d_inner + 2 * cfg.ssm_state
        check(f0["pos"] == spec["prompt"] + spec["steps"]
              and f0["local_conv"] == (c // 2 if ssd else None)
              and f0["local_heads"] == (cfg.ssm_heads // 2 if ssd else None)
              and f0["local_slots"] == (spec["slots"] // 2 if sites
                                        else None),
              f"{tag} {arch} serve: pos {f0['pos']}, a rank's "
              f"conv {f0['local_conv']}, heads {f0['local_heads']}, slots "
              f"{f0['local_slots']}")
        worst, worst_mean = max(f0["logits_gaps"]), max(f0["mean_gaps"])
        check(worst <= max_lim and worst_mean <= mean_lim,
              f"{tag} {arch} serve: logits {worst_mean:.4e} from P = 1's in "
              f"the mean, {worst:.4e} at most (allowed {mean_lim}, "
              f"{max_lim}); mean gaps {f0['mean_gaps']}")
        rec = {"train": {"losses": losses, "p1_losses": p1["losses"],
                         "loss_gaps": gaps, "round_ms": p2["round_ms"],
                         "round_ms_rank1": t1["p2"]["round_ms"],
                         "p1_round_ms": p1["round_ms"],
                         "collectives": p2["collectives"],
                         "collective_ms": p2["collective_ms"],
                         "launches_per_round": p2["launches"][0],
                         "peak_gib": [t0["peak_gib"], t1["peak_gib"]]},
               # each row kernel's launches over the P = 2 rounds, a rank
               "launches_rows": {rn: [sum(x[rn] for x in r["p2"]["launches"])
                                      for r in (t0, t1)]
                                 for rn in ROW_KERNELS.values()},
               "serve": {k: f0[k] for k in (
                   "logits_gaps", "mean_gaps", "argmax_agree", "to_f32",
                   "prefill_s", "prefill_collectives",
                   "prefill_collective_ms", "decode_ms",
                   "collectives_per_step", "collective_ms_per_step",
                   "launches")}
               | {"decode_ms_rank1": s1["p2"]["decode_ms"],
                  "p1": s0["p1"]},
               "seconds": [r0["seconds"], r1["seconds"]],
               "train_s": r0["train_s"], "serve_s": r0["serve_s"]}
        e0, e1 = s0["entry"], s1["entry"]
        short, n_short = spec["entry_prompt"], spec["entry_steps"]
        patches = cfg.n_prefix_tokens if cfg.arch_type == "vlm" else 0
        want_entry = axis_serve_launches(cfg, n_short)
        check(e0["digest"] == e1["digest"] and e0["logits_finite"]
              and e0["launches"] == e1["launches"] == want_entry
              and e0["pos"] == short + patches + n_short
              and e0["slots"] == (short + patches + n_short if sites
                                  else None),
              f"{tag} {arch} serve_decode.serve(mesh=): {e0}, rank 1 {e1}")
        rec["entry"] = e0
        out[arch] = rec
        m, batch, seq = p["train"][arch][:3]
        depth = MODEL_AXIS_TRAIN_LAYERS.get(arch, cfg.n_layers)
        frames = (f" (the encoder's {cfg.encoder_layers} blocks over "
                  f"{cfg.encoder_seq} zero frames)"
                  if cfg.arch_type == "audio" else "")
        log(f"{tag} {arch} training at P = 2 in f32 ({depth} of "
            f"{cfg.n_layers} layers, M = {m}, H = 2, dense_masked, {batch} x "
            f"{seq} tokens{f' after {patches} patches' if patches else ''}): "
            f"losses {losses} (both ranks), P = 1 {p1['losses']}, gaps "
            f"{[f'{g:.3e}' for g in gaps]} (allowed {first} in round 1, "
            f"{lim} after){frames}; round ms {p2['round_ms']} (P = 1 "
            f"{p1['round_ms']}); {p2['collectives']} collectives a round, "
            f"{[f'{x:.1f}' for x in p2['collective_ms']]} host ms blocked "
            f"in them; LGC launches a round a rank {p2['launches'][0]}; "
            f"peak {t0['peak_gib']:.2f} / {t1['peak_gib']:.2f} GiB; {smi}")
        log(f"{tag} {arch} serving at P = 2, {spec['batch']} x "
            f"{spec['prompt']} positions into {spec['slots']} slots, "
            f"{spec['steps']} steps fed P = 1's tokens: logits gap a step at "
            f"most {worst_mean:.4e} in the mean and {worst:.4e} in the max "
            f"(allowed {mean_lim}, {max_lim}), argmax agreeing "
            f"{min(f0['argmax_agree']):.4f}-{max(f0['argmax_agree']):.4f}; "
            f"prefill {f0['prefill_s']:.3f} s ({f0['prefill_collectives']} "
            f"collectives, {f0['prefill_collective_ms']:.1f} ms blocked), "
            f"decode {f0['decode_ms']:.2f} ms a step (rank 1 "
            f"{s1['p2']['decode_ms']:.2f}; P = 1 {s0['p1']['decode_ms']:.2f}, "
            f"prefill {s0['p1']['prefill_s']:.3f} s), "
            f"{f0['collectives_per_step']:.1f} collectives a step, "
            f"{f0['collective_ms_per_step']:.2f} host ms blocked in them; "
            f"launches {f0['launches']}; ranks bitwise equal; {smi}")
        yard = s0["p1"]["to_f32"]
        log(f"{tag} {arch} serving, the f32 yardstick (P = 1 in f32 fed the "
            f"same tokens): bf16 P = 1 at most {max(yard['mean_gaps']):.4e} "
            f"mean / {max(yard['logits_gaps']):.4e} max a step from it, bf16 "
            f"P = 2 {max(f0['to_f32']['mean_gaps']):.4e} / "
            f"{max(f0['to_f32']['logits_gaps']):.4e}")
        log(f"{tag} {arch} serve_decode.serve(mesh=) at full width on "
            f"{short} tokens x {spec['batch']}, {n_short} steps: "
            f"{e0['seconds']:.2f} s, {e0['collectives']} collectives, "
            f"launches {e0['launches']}; ranks' tokens bitwise equal")
        log(f"{tag} {arch}: {r0['seconds']:.1f} s on rank 0 (training "
            f"{r0['train_s']:.1f}, serving {r0['serve_s']:.1f})")
    return out


# The bf16 drift of the model axis (``--model-axis-faults``): the SSD
# family (mamba2-370m) beside the dense one (the 100M task's qwen2-100m),
# at full width and depth, one lm_loss and its gradient on the first local
# step's batch of a round (DRIFT_BATCH x DRIFT_SEQ tokens), before any SGD
# step or compression: bf16 at P = 2 against bf16 at P = 1, and bf16 at
# P = 1 against f32 at P = 1 (bf16's own yardstick), from seed 0's draw
DRIFT_ARCHS = ("mamba2-370m", "qwen2-100m")
DRIFT_BATCH, DRIFT_SEQ = 2, 128


def axis_drift(arch: str, mesh) -> dict:
    """The drift readings on this rank: rank 0 alone takes the loss and
    gradients at P = 1 in bf16 and in f32, then both ranks at P = 2 in
    bf16 from their shards, gathered whole; rank 0 returns each leaf's
    relative gaps (the norm of the difference over the norm of the
    reference, and its max |.| over the reference's) and the loss gaps."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch import parallel
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import sharding_rules as rules
    from repro_torch.models import transformer as tf
    cfg = get_config(arch)
    pipe = TokenPipeline(cfg.vocab_size, DRIFT_SEQ, DRIFT_BATCH)
    pipe.next_batch()
    x, y = pipe.next_batch()
    batch = {"tokens": torch.from_numpy(x).to("cuda", torch.long),
             "labels": torch.from_numpy(y).to("cuda", torch.long)}

    def loss_grads(cfg_, params, mesh_) -> tuple:
        names = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        with torch.enable_grad():
            loss = tf.lm_loss(dict(zip(names, leaves)), cfg_, batch,
                              mesh=mesh_)
            grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        return float(loss), tf.sum_split_use_grads(cfg_, grads, mesh_)

    def gaps(got: dict, ref: dict) -> dict:
        out = {}
        for k, r in ref.items():
            r, g = r.float(), got[k].float()
            out[k] = {"norm": float((g - r).norm() / r.norm()),
                      "max": float((g - r).abs().max() / r.abs().max())}
        return out

    lead = mesh.model_rank == 0
    res: dict = {"arch": arch}
    if lead:
        l16, g16 = loss_grads(cfg, tf.init_params(cfg, seed=0), None)
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        l32, g32 = loss_grads(f32, tf.init_params(f32, seed=0), None)
        res["yardstick"] = {"loss": abs(l16 - l32), "grads": gaps(g16, g32)}
        del g32
        torch.cuda.empty_cache()
    dist.barrier(group=mesh.model_group)
    params = tf.init_params(cfg, seed=0)
    specs = rules.param_specs(cfg, params, mesh)
    shards = rules.shard_tree(params, specs, mesh)
    del params
    l2, g2 = loss_grads(cfg, shards, mesh)
    g2 = {k: parallel.gather_model(mesh, g, specs[k]) for k, g in g2.items()}
    if lead:
        res["p2"] = {"loss": abs(l2 - l16), "grads": gaps(g2, g16)}
        res["losses"] = {"p1_bf16": l16, "p1_f32": l32, "p2_bf16": l2}
    del g2, shards
    torch.cuda.empty_cache()
    return res


def check_drift(ranks: list, smi: str) -> dict:
    """The drift readings' lines (no limit: a measurement)."""
    out = {}
    for arch in DRIFT_ARCHS:
        r = ranks[0]["results"][f"drift {arch}"]
        row = {"losses": r["losses"]}
        for key in ("p2", "yardstick"):
            g = r[key]["grads"]
            worst = max(g, key=lambda k: g[k]["norm"])
            row[key] = {"loss_gap": r[key]["loss"],
                        "grad_norm_gap_max": g[worst]["norm"],
                        "grad_norm_gap_leaf": worst,
                        "grad_norm_gap_median": statistics.median(
                            v["norm"] for v in g.values()),
                        "grad_max_gap_max": max(v["max"] for v in g.values())}
        out[arch] = row | {"grads": {k: [r["p2"]["grads"][k]["norm"],
                                         r["yardstick"]["grads"][k]["norm"]]
                                     for k in r["p2"]["grads"]}}
        for key, what in (("p2", "bf16 P = 2 against bf16 P = 1"),
                          ("yardstick", "bf16 P = 1 against f32 P = 1")):
            v = row[key]
            log(f"bf16 drift {arch}, {what} (one lm_loss on "
                f"{DRIFT_BATCH} x {DRIFT_SEQ} tokens, full width and depth): "
                f"loss gap {v['loss_gap']:.4e}; gradient |diff| / |ref| a "
                f"leaf median {v['grad_norm_gap_median']:.4e}, at most "
                f"{v['grad_norm_gap_max']:.4e} ({v['grad_norm_gap_leaf']}); "
                f"max |diff| / max |ref| at most {v['grad_max_gap_max']:.4e}"
                f"; {smi}")
        log(f"bf16 drift {arch}: losses {r['losses']}")
    return out


def model_axis_faults(smi: str) -> dict:
    """``--model-axis-faults``: the readings behind MODEL_AXIS_LOSS_ATOL.
    The task at P = 2 under ``dense_masked`` for ROUNDS rounds, sound and
    with each of MODEL_AXIS_FAULTS planted in both ranks, against P = 1
    from the same draw: each round's loss gap; the serving job and parts
    (e) and (f) the same way with their faults (the readings behind their
    limits), and (g); and the bf16 drift at P = 2 (DRIFT_ARCHS)."""
    from repro_torch.launch.mesh import spawn
    one = model_axis_p1(ROUNDS)["dense_masked"]["losses"]
    jobs = [dict(name=f or "sound", kind="run", aggregate="dense_masked",
                 fault=f) for f in (None, *MODEL_AXIS_FAULTS)]
    jobs.append(dict(name="serve", kind="serve",
                     faults=[None, *MODEL_AXIS_SERVE_FAULTS], free=True))
    jobs += [j for part in MODEL_AXIS_PART_KEYS
             for j in family_axis_jobs(part, faults=True)]
    jobs += [dict(name=f"drift {arch}", kind="drift", arch=arch)
             for arch in DRIFT_ARCHS]
    ranks = spawn(model_axis_rank, MODEL_AXIS, "gloo", args=(jobs,),
                  timeout=3 * MODEL_AXIS_TIMEOUT_S)
    out = {"card": smi, "p1": one, "loss_atol": MODEL_AXIS_LOSS_ATOL}
    for job in [j for j in jobs if j["kind"] == "run"]:
        losses = ranks[0]["results"][job["name"]]["losses"]
        out[job["name"]] = {"losses": losses, "gaps": loss_gaps(losses, one)}
        log(f"model axis fault {job['name']}: losses {losses}, gaps "
            f"{[f'{g:.3e}' for g in out[job['name']]['gaps']]} against "
            f"P = 1 {one}; {smi}")
    serve = ranks[0]["results"]["serve"]
    out["serve"] = {"logits_atol": MODEL_AXIS_LOGITS_ATOL,
                    "logits_mean_atol": MODEL_AXIS_LOGITS_MEAN_ATOL,
                    "token_share_min": MODEL_AXIS_TOKEN_SHARE,
                    "token_margin_max": MODEL_AXIS_TOKEN_MARGIN,
                    "seconds": serve["seconds"]}
    for key, r in serve["runs"].items():
        out["serve"][key] = {k: r[k] for k in (
            "logits_gaps", "mean_gaps", "argmax_agree", "decode_ms",
            "prefill_s", "collective_ms_per_step")}
        log(f"model axis serving fault {key}: logits gaps to P = 1 a step "
            f"(the prefill's first) max {max(r['logits_gaps']):.4e}, mean "
            f"abs up to {max(r['mean_gaps']):.4e} (allowed "
            f"{MODEL_AXIS_LOGITS_ATOL}, {MODEL_AXIS_LOGITS_MEAN_ATOL}), "
            f"argmax agreeing {min(r['argmax_agree']):.4f}-"
            f"{max(r['argmax_agree']):.4f}; decode {r['decode_ms']:.2f} ms "
            f"a step; mean gaps {[f'{g:.3e}' for g in r['mean_gaps']]}; "
            f"{smi}")
    for key, f in serve["free"].items():
        out["serve"][f"{key} free"] = {k: f[k] for k in (
            "token_share", "first_differing_step", "margins", "mean_margin",
            "decode_ms")}
        log(f"model axis serving fault {key}, free run: {f['token_share']:.4f}"
            f" of its tokens are P = 1's (at least {MODEL_AXIS_TOKEN_SHARE}); "
            f"first differing steps {f['first_differing_step']}; tokens at "
            f"most {max(f['margins']):.4e} below P = 1's greedy logit at "
            f"their history (mean {f['mean_margin']:.4e}; at most "
            f"{MODEL_AXIS_TOKEN_MARGIN}), margins a step "
            f"{[f'{m:.3e}' for m in f['margins']]}; decode "
            f"{f['decode_ms']:.2f} ms a step; {smi}")
    out["serve"]["p1"] = serve["p1"]
    for part, key in MODEL_AXIS_PART_KEYS.items():
        p = MODEL_AXIS_PARTS[part]
        out[key] = {k: p[k] for k in ("first_round_atol", "loss_atol",
                                      "logits_atol", "logits_mean_atol")}
        for arch in p["archs"]:
            sound = ranks[0]["results"][f"{part} {arch}"]
            for job in [j for j in jobs if j["kind"] == "family"
                        and j["name"].startswith(f"{part} {arch}")]:
                fault = job.get("fault") or "sound"
                g = axis_gaps(sound, ranks[0]["results"][job["name"]])
                out[key][f"{arch} {fault}"] = g
                log(f"model axis ({part}) {arch} {fault}: loss gaps to "
                    f"P = 1 a round "
                    f"{[f'{x:.3e}' for x in g.get('loss_gaps', [])]} "
                    f"(allowed {p['first_round_atol']} in round 1, "
                    f"{p['loss_atol']} after); logits gaps a step max "
                    f"{max(g['logits_gaps']) if 'logits_gaps' in g else None}"
                    f", mean up to "
                    f"{max(g['mean_gaps']) if 'mean_gaps' in g else None} "
                    f"(allowed {p['logits_atol']}, {p['logits_mean_atol']}); "
                    f"mean gaps "
                    f"{[f'{x:.3e}' for x in g.get('mean_gaps', [])]}; {smi}")
    out["bf16_drift"] = check_drift(ranks, smi)
    print(json.dumps({"model_axis_faults": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5c: the families' training at full width
# ---------------------------------------------------------------------------

# arch -> (FL devices M, batch, sequence, local learning rate): LGC rounds
# (dense_masked, H = 2, the CUDA kernels) at the published widths; olmoe,
# glm4, starcoder2 and yi at 4 layers (TRAIN_LAYERS: olmoe's full depth
# needs ~111 GB in this step, and each of its expert leaves would hold
# 2**31 floats; the dense three take ~17 B a parameter at M = 1 and ~32 at
# M = 2 with their activations).  Sized so that the (8 + 8M) bytes a
# parameter of the step, plus activations, fit on 80 GB.  grok-1 trains
# only at its smoke size: one of its layers with the embedding and head is
# 6.53 G parameters, ~102 GiB at M = 1.
FAMILY_TRAIN = {"olmoe-1b-7b": (2, 8, 128, 2e-2),
                "mamba2-370m": (2, 8, 256, 5e-2),
                "zamba2-1.2b": (2, 8, 256, 3e-2),
                "phi-3-vision-4.2b": (1, 4, 64, 2e-2),
                "whisper-small": (2, 4, 128, 3e-2),
                "glm4-9b": (2, 8, 128, 2e-2),
                "starcoder2-7b": (2, 8, 128, 5e-3),
                "yi-34b": (1, 4, 128, 2e-2)}
TRAIN_LAYERS = {"olmoe-1b-7b": 4, "glm4-9b": 4, "starcoder2-7b": 4,
                "yi-34b": 4}
# the smoke rounds, card against CPU: every family and config
FAMILY_SMOKE = (*FAMILY_TRAIN, "grok-1-314b")
# params by shape (at TRAIN_LAYERS) and the leaves of >= PALLAS_MIN_ELEMS
# floats, each compressed by one launch of each LGC row kernel a round
FAMILY_TRAIN_PARAMS = {"olmoe-1b-7b": 1_884_833_792,
                       "mamba2-370m": 420_136_448,
                       "zamba2-1.2b": 1_170_473_856,
                       "phi-3-vision-4.2b": 3_825_404_928,
                       "whisper-small": 304_508_928,
                       "glm4-9b": 2_057_361_408,
                       "starcoder2-7b": 1_321_403_392,
                       "yi-34b": 3_148_938_240}
FAMILY_KERNEL_LEAVES = {"olmoe-1b-7b": 10, "mamba2-370m": 6,
                        "zamba2-1.2b": 14, "phi-3-vision-4.2b": 10,
                        "whisper-small": 20, "glm4-9b": 9,
                        "starcoder2-7b": 8, "yi-34b": 9}
# round 1 warms up, round 2 keeps its largest leaf's (e, delta) on the
# host, round 3 is timed, round 4 runs under torch.profiler
FAMILY_TRAIN_ROUNDS, CAPTURE_ROUND, TIMED_ROUND, PROFILED_ROUND = 4, 1, 2, 3
# the smoke check, card against CPU: the CPU tests' tolerances
# (tests/test_torch_family_training.py), a coordinate next to a bin edge
# may flip layer (0.1% of a leaf)
FAMILY_SMOKE_TOL = {"rtol": 1e-5, "atol": 1e-6, "ssd_atol": 1e-5,
                    "flips": 1e-3}


def family_train_config(arch: str):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in TRAIN_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS[arch])
    return cfg


def profile_summary(prof, wall_ms: float) -> dict:
    """Busy ms (the union of the card's kernel intervals), idle share and
    kernels by group of one profiled round."""
    import torch
    from repro_torch.device import kernel_group, union_us
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group: dict = {}
    for e in kernels:
        g = kernel_group(e.name)
        by_group[g] = by_group.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels]) / 1e3
    return {"profiled_round_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": len(kernels),
            "kernel_ms_by_group": dict(sorted(by_group.items()))}


@contextlib.contextmanager
def instrumented_lgc_rounds(capture_n: int, capture_from: int):
    """Wraps the LGC step that ``steps.make_lgc_train_step`` (and the train
    driver's import of it) makes: each round's host ms (to the card's end)
    and launches by kernel, round ``PROFILED_ROUND`` under torch.profiler
    (the card's kernels only); and times the weights' draw.
    Keeps a host copy of the (e, delta) rows of the first call of
    ``lgc_compress_hist_rows`` on a ``capture_n``-float leaf at or after
    call ``capture_from``, and counts plain compressions of kernel-sized
    leaves (``_compress_leaf_dense`` at or above ``pallas_min_elems``).
    Yields the record."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tf
    rec: dict = {"rounds": [], "kept": [], "plain_kernel_leaves": 0,
                 "profile": None, "draw_s": 0.0}
    orig = (steps.make_lgc_train_step, steps.lgc_compress_hist_rows,
            steps._compress_leaf_dense, tf.init_params)
    calls = itertools.count()

    def init_params(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig[3](*args, **kw)
        torch.cuda.synchronize()
        rec["draw_s"] += time.perf_counter() - t0
        return out

    def rows(e, delta, cum_ks, received):
        # pageable copies: freed pinned memory stays cached in the process
        # (up to 10.4 GB a family), pageable memory goes back to the host
        if (next(calls) >= capture_from and e.shape[1] == capture_n
                and not rec["kept"]):
            rec["kept"].append((e.cpu(), delta.cpu()))
        return orig[1](e, delta, cum_ks, received)

    def dense(e, delta, sparsity, recv, **kw):
        rec["plain_kernel_leaves"] += delta.numel() >= kw["pallas_min_elems"]
        return orig[2](e, delta, sparsity, recv, **kw)

    def make(*args, **kw):
        step = orig[0](*args, **kw)

        def timed(params, ef, batch, received=None):
            before = dict(LAUNCHES)
            profiled = len(rec["rounds"]) == PROFILED_ROUND
            acts = [torch.profiler.ProfilerActivity.CUDA]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (torch.profiler.profile(activities=acts) if profiled
                  else contextlib.nullcontext()) as prof:
                out = step(params, ef, batch, received)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rec["rounds"].append({"host_ms": ms, "launches": {
                k: LAUNCHES[k] - before[k] for k in LAUNCHES}})
            if profiled:
                rec["profile"] = profile_summary(prof, ms)
            return out
        return timed

    steps.make_lgc_train_step = train.make_lgc_train_step = make
    steps.lgc_compress_hist_rows, steps._compress_leaf_dense = rows, dense
    tf.init_params = init_params
    try:
        yield rec
    finally:
        steps.make_lgc_train_step = train.make_lgc_train_step = orig[0]
        steps.lgc_compress_hist_rows, steps._compress_leaf_dense = orig[1:3]
        tf.init_params = orig[3]


def step_train_rounds(cfg, m: int, batch: int, seq: int, lr: float
                      ) -> list[float]:
    """The driver's ``--mode lgc`` loop through the step functions, for a
    config the driver cannot name (a depth cut: ``TRAIN_LAYERS``)."""
    import torch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    params = tf.init_params(cfg, seed=0)
    pipe = TokenPipeline(cfg.vocab_size, seq, batch)
    pipe.next_batch()
    step = steps.make_lgc_train_step(cfg, m, steps.LGCStepConfig(
        local_steps=2, local_lr=lr, aggregate="dense_masked",
        backend="cuda"), donate=True)
    ef = steps.init_ef_tree(params, m)
    losses = []
    for _ in range(FAMILY_TRAIN_ROUNDS):
        x, y = pipe.next_batch()
        params, ef, loss = step(params, ef, {
            "tokens": torch.from_numpy(x).to("cuda", torch.long),
            "labels": torch.from_numpy(y).to("cuda", torch.long)})
        losses.append(float(loss))
    check(losses[-1] < losses[0],
          f"{cfg.name} ({cfg.n_layers} layers): loss did not fall {losses}")
    return losses


def check_leaf_rows(e, x, cum, recv, what: str, errs: dict) -> None:
    """The three LGC row kernels on one leaf's (M, n) rows, bitwise their
    plain row versions, with no more than a few copies of the rows alive
    (the longest leaves are 805M floats)."""
    import torch
    from repro_torch.kernels import (histogram_rows, ref, sparsify_ef_rows,
                                     sum_maxabs_rows, thresholds_from_counts)
    u, m = sum_maxabs_rows(e, x)
    u_ref = ref.ftz_add(e, x)
    check(bits_equal(u, u_ref) and bits_equal(m, ref.hist_maxabs_rows(
        u_ref)), f"sum_maxabs_rows {what}")
    del u_ref
    counts = histogram_rows(u, m)
    counts_ref = ref.hist_counts_rows(u, m)
    check(bits_equal(counts, counts_ref)
          and bool((counts.sum(1) == e.shape[1]).all()),
          f"histogram_rows {what}")
    thr = thresholds_from_counts(counts, m, cum)
    g, e_new = sparsify_ef_rows(e, x, thr, recv)
    g_ref, e_ref = ref.hist_layered_sparsify_rows(u, thr, recv)
    check(bits_equal(g, g_ref) and bits_equal(e_new, e_ref),
          f"sparsify_ef_rows {what}")
    errs["histogram"] = max(errs["histogram"],
                            max_abs_err(counts, counts_ref))
    errs["sparsify_ef"] = max(errs["sparsify_ef"], max_abs_err(g, g_ref),
                              max_abs_err(e_new, e_ref))
    del u, g, e_new, g_ref, e_ref
    torch.cuda.empty_cache()


def family_train(arch: str, smi: str, errs: dict) -> dict:
    """One family's LGC rounds at full width (the train driver, or the step
    functions for a depth cut), instrumented; then its largest leaf's
    round-2 rows through the kernels against the plain versions."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tf
    m, batch, seq, lr = FAMILY_TRAIN[arch]
    cfg = family_train_config(arch)
    shapes = tf.init_params(cfg, device="meta")
    n_params = sum(v.numel() for v in shapes.values())
    check(n_params == FAMILY_TRAIN_PARAMS[arch],
          f"{arch} training params {n_params:,}")
    big = [k for k, v in shapes.items() if v.numel() >= steps.PALLAS_MIN_ELEMS]
    n_leaves = FAMILY_KERNEL_LEAVES[arch]
    check(len(big) == n_leaves, f"{arch}: kernel-sized leaves {big}")
    largest = max(shapes, key=lambda k: shapes[k].numel())
    n_big = shapes[largest].numel()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with instrumented_lgc_rounds(n_big, CAPTURE_ROUND * n_leaves) as rec:
        if arch in TRAIN_LAYERS:
            losses = step_train_rounds(cfg, m, batch, seq, lr)
            how = (f"step functions, {cfg.n_layers} of "
                   f"{get_config(arch).n_layers} layers")
        else:
            argv = ["--arch", arch, "--mode", "lgc", "--devices", str(m),
                    "--batch", str(batch), "--seq", str(seq),
                    "--steps", str(FAMILY_TRAIN_ROUNDS), "--lr", str(lr),
                    "--local-steps", "2", "--log-every", "1"]
            try:
                losses = train.main(argv)
            except SystemExit as exc:
                raise AssertionError(f"chip_smoke: train {' '.join(argv)} "
                                     f"exited {exc.code}") from exc
            how = "train " + " ".join(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{arch}: losses {losses}")
    rounds = rec["rounds"]
    check(len(rounds) == FAMILY_TRAIN_ROUNDS, f"{arch}: {len(rounds)} rounds")
    for i, r in enumerate(rounds):
        for name, c in r["launches"].items():
            want = n_leaves if name in ROW_KERNELS.values() else 0
            check(c == want, f"{arch} round {i + 1}: {name} launched {c} "
                  f"times, expected {want}")
    check(rec["plain_kernel_leaves"] == 0,
          f"{arch}: {rec['plain_kernel_leaves']} kernel-sized leaves went "
          f"through the plain versions on the card")
    prof = rec["profile"]
    (e_host, d_host), = rec["kept"]
    e, x = e_host.cuda(), d_host.cuda()
    del rec["kept"], e_host, d_host
    cum = steps._leaf_cum_ks(n_big, steps.LGCStepConfig().sparsity,
                             "cuda").expand(m, -1).contiguous()
    recv = torch.ones((m, 3), dtype=torch.int32, device="cuda")
    check_leaf_rows(e, x, cum, recv, f"{arch} {largest} ({m}, {n_big:,}) "
                    f"round {CAPTURE_ROUND + 1}", errs)
    del e, x
    torch.cuda.empty_cache()
    timed = rounds[TIMED_ROUND]["host_ms"]
    row = {"how": how, "params": n_params, "m": m, "batch": batch,
           "seq": seq, "local_steps": 2, "lr": lr, "losses": losses,
           "run_s": run_s, "draw_s": rec["draw_s"],
           "host_ms_by_round": [r["host_ms"] for r in rounds],
           "host_ms_per_round": timed,
           "device_steps_per_s": m * 2 / (timed / 1e3),
           "launches": {k: sum(r["launches"][k] for r in rounds)
                        for k in rounds[0]["launches"]},
           "kernel_leaves": n_leaves, "largest_leaf": [largest, n_big],
           "peak_mem_gib": peak_gib, "card": smi} | {
        "device_busy_ms": prof["device_busy_ms"],
        "device_idle_share_profiled": prof["device_idle_share"],
        "device_idle_share": 1.0 - prof["device_busy_ms"] / timed,
        "profile": prof}
    log(f"train 5c: {arch}: {how}: {n_params:,} params, M={m}, batch "
        f"{batch}, seq {seq}, H=2, lr {lr}; losses {losses}; {run_s:.1f} s "
        f"(the weights' draw {rec['draw_s']:.1f} s)")
    log(f"train 5c: {arch}: host ms by round {row['host_ms_by_round']} "
        f"(round {CAPTURE_ROUND + 1} copies its largest leaf's rows to the "
        f"host, round {PROFILED_ROUND + 1} is profiled); device busy "
        f"{prof['device_busy_ms']:.3f} ms of round {PROFILED_ROUND + 1}, "
        f"idle share {row['device_idle_share']:.3f} against round "
        f"{TIMED_ROUND + 1} "
        f"({prof['device_idle_share']:.3f} profiled); kernels by group "
        f"{prof['kernel_ms_by_group']}; peak {peak_gib:.2f} GiB; {smi}")
    log(f"train 5c: {arch}: each LGC row kernel launched {n_leaves} times a "
        f"round, no flat kernel, no plain compression of a kernel-sized "
        f"leaf; {largest} ({m} x {n_big:,}) of round {CAPTURE_ROUND + 1} "
        f"bitwise the plain "
        f"row versions through all three kernels")
    return row


def family_train_smoke(arch: str) -> None:
    """One LGC round of the smoke config in f32, M = 2, H = 2, every leaf
    through the row kernels, a dropped channel: card against CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (4, 32))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, 1))}
    prefix = train.modality_prefix(cfg, 4, "cpu")
    if prefix is not None:
        batch["prefix"] = torch.from_numpy(rng.standard_normal(
            tuple(prefix.shape)).astype(np.float32))
    params = tf.init_params(cfg, seed=0, device="cpu")
    ef = {k: torch.from_numpy((rng.standard_normal((2,) + tuple(v.shape))
                               * 1e-5).astype(np.float32))
          for k, v in params.items()}
    received = torch.tensor([[1, 1, 1], [1, 0, 1]], dtype=torch.int32)
    step = steps.make_lgc_train_step(cfg, 2, steps.LGCStepConfig(
        local_steps=2, local_lr=3e-3, sparsity=(0.05, 0.1, 0.1),
        backend="cuda", pallas_min_elems=1))
    want = step(params, ef, batch, received)
    reset_launch_counts()
    on_card = [{k: v.cuda() for k, v in t.items()}
               for t in (params, ef, batch)]
    got = step(*on_card, received.cuda())
    torch.cuda.synchronize()
    tol = FAMILY_SMOKE_TOL
    atol = tol["ssd_atol"] if cfg.arch_type in ("ssm", "hybrid") \
        else tol["atol"]
    check(abs(float(got[2]) - float(want[2])) <= tol["rtol"] * abs(float(
        want[2])), f"{arch} smoke round: loss {float(got[2])} on the card, "
          f"{float(want[2])} on the CPU")
    worst = 0.0
    for part in (0, 1):
        for k, w in want[part].items():
            off = ~torch.isclose(got[part][k].cpu(), w, rtol=tol["rtol"],
                                 atol=atol)
            worst = max(worst, float(off.float().mean()))
            check(float(off.float().mean()) <= tol["flips"],
                  f"{arch} smoke round: {('params', 'ef')[part]} {k}: "
                  f"{int(off.sum())} of {off.numel()} coordinates differ")
    check(all(LAUNCHES[k] == len(params) for k in ROW_KERNELS.values()),
          f"{arch} smoke round launches {LAUNCHES}")
    log(f"train 5c: {arch} smoke (f32, TF32 off) one LGC round card against "
        f"CPU: loss {float(got[2]):.7f} / {float(want[2]):.7f}, params and "
        f"error memory within rtol {tol['rtol']} / atol {atol} (largest "
        f"share of a leaf off: {worst:.2e}); {len(params)} row launches each")


def phase_family_training(smi: str, errs: dict) -> dict:
    """Phase 5c: each family's and config's smoke config card against CPU,
    then each but grok-1 at full width; one ``family_training`` JSON
    line."""
    import torch
    t0 = time.perf_counter()
    for arch in FAMILY_SMOKE:
        family_train_smoke(arch)
    log(f"phase 5c: smoke rounds {time.perf_counter() - t0:.1f} s")
    # the profiler's first start in a process takes seconds: not in a round
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    log(f"phase 5c: the profiler started at {time.perf_counter() - t0:.1f} s")
    out = {arch: family_train(arch, smi, errs) for arch in FAMILY_TRAIN}
    print(json.dumps({"family_training": out}), flush=True)
    log(f"phase 5c (the families' training at full width): "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 6: small serves, card against CPU
# ---------------------------------------------------------------------------

def attention_sites(cfg) -> int:
    """swa_decode launches a decode step makes: one per attention block
    (the hybrid's shared block once per site, ceil(L / attn_every); the
    audio decoder's blocks two each, self- and cross-attention)."""
    if cfg.arch_type == "ssm":
        return 0
    if cfg.arch_type == "hybrid":
        return -(-cfg.n_layers // cfg.attn_every)
    if cfg.arch_type == "audio":
        return 2 * cfg.n_layers
    return cfg.n_layers


def small_serve(arch: str, prompt: int, window: int, steps: int) -> None:
    """The arch's smoke config in f32, card against CPU with the same
    weights: a ``prompt``-token prefill into a ``window``-slot ring, then
    ``steps`` greedy steps past the wrap (a vlm or audio prompt with its
    modality stub); the logits agree at rtol = atol = 1e-5, the tokens are
    equal, the K/V caches (whisper's cross K/V too) agree at 1e-5 and
    swa_decode launched steps x sites times on the card."""
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve_decode import stub_prefix
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = tf.init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt), generator=g)
    batch = {"tokens": prompts}
    prefix = stub_prefix(cfg, 2, g, torch.device("cpu"))
    if prefix is not None:
        batch["prefix"] = prefix
    runs = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        reset_launch_counts()
        logits, cache = make_prefill_step(cfg, window, device=dev)(p, batch)
        step = make_serve_step(cfg, window, device=dev, return_logits=True)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out = [(logits.cpu(), tok.cpu())]
        for _ in range(steps):
            tok, cache, logits = step(p, tok, cache)
            out.append((logits.cpu(), tok.cpu()))
        runs[dev] = (out, cache["pos"], dict(LAUNCHES), cache)
    worst = 0.0
    for i, ((lc, tc), (lg, tg)) in enumerate(zip(runs["cpu"][0],
                                                 runs["cuda"][0])):
        check(bool(torch.isclose(lg, lc, rtol=1e-5, atol=1e-5).all()),
              f"small serve {cfg.name} step {i}: card and CPU logits differ "
              f"by {max_abs_err(lg, lc):.3e}")
        check(torch.equal(tg, tc),
              f"small serve {cfg.name} step {i}: tokens differ")
        worst = max(worst, max_abs_err(lg, lc))
    check(runs["cuda"][1] == tf.prompt_positions(cfg, batch) + steps,
          f"small serve {cfg.name} pos")
    c_cpu, c_gpu = runs["cpu"][3], runs["cuda"][3]
    pairs = [(c_gpu["kv"][n], c_cpu["kv"][n]) for n in ("k", "v")
             if "kv" in c_cpu] + [(c_gpu[n], c_cpu[n])
                                  for n in ("cross_k", "cross_v") if n in c_cpu]
    for got, want in pairs:
        check(bool(torch.isclose(got.cpu(), want, rtol=1e-5, atol=1e-5).all()),
              f"small serve {cfg.name}: card and CPU caches differ by "
              f"{max_abs_err(got.cpu(), want):.3e}")
    counts = runs["cuda"][2]
    want = steps * attention_sites(cfg)
    check(counts["swa_decode"] == want, f"small serve {cfg.name}: "
          f"swa_decode launched {counts['swa_decode']} times, expected "
          f"{want}")
    check(sum(runs["cpu"][2].values()) == 0, "a CPU serve launched a kernel")
    log(f"small f32 serve ({cfg.name}, prefill {prompt}, ring {window}, "
        f"{steps} steps to pos {runs['cuda'][1]}): card logits within 1e-5 "
        f"of the CPU's (max abs err {worst:.3e}), greedy tokens equal, "
        f"{counts['swa_decode']} swa_decode launches")


def phase_small_serve() -> None:
    small_serve(SERVE_ARCH, 8, 16, 24)
    for arch in FAMILIES:
        small_serve(arch, 16, 24, 16)
    small_serve("phi-3-vision-4.2b", 8, 24, 16)   # 16 patches + 8 tokens
    small_serve("whisper-small", 16, 24, 16)
    for arch in CONFIGS:
        small_serve(arch, 16, 24, 16)


# ---------------------------------------------------------------------------
# phase 7: the serving paths at full width
# ---------------------------------------------------------------------------

def decode_step_bytes(cfg, params: dict, cache: dict, batch: int,
                      slots_read: float) -> float:
    """Bytes a decode step must move at least: every weight it reads once
    (the embedding only its batch rows unless it is the tied head; every
    expert, since at capacity 1 each expert runs its slot; ``dec_pos`` one
    row; not the audio encoder, ``enc_pos``, the vlm's ``vis_proj`` or the
    cross-attention's K/V projections, which only prefill reads), the
    valid K/V slots of every attention site read (``slots_read`` a site on
    average) and the token's slot written, the whole cross-attention cache
    read, each SSD layer's state and conv tail read and written, the
    logits written."""
    prefill_only = ("enc_blocks/", "enc_norm/", "enc_pos", "vis_proj",
                    "blocks/cross/wk", "blocks/cross/wv")
    n = 0.0
    for name, t in params.items():
        if name.startswith(prefill_only):
            continue
        gathered = name == "embed" and not cfg.tie_embeddings
        rows = batch if gathered else 1 if name == "dec_pos" else None
        n += (rows * t[0].numel() if rows else t.numel()) * t.element_size()
    for name in ("cross_k", "cross_v"):
        if name in cache:
            n += cache[name].numel() * cache[name].element_size()
    if "kv" in cache:
        k = cache["kv"]["k"]
        sites, b, kv, _, hd = k.shape
        n += 2 * sites * b * kv * (slots_read + 1) * hd * k.element_size()
    if "ssm" in cache:
        n += 2 * sum(t.numel() * t.element_size()
                     for t in cache["ssm"].values())
    return n + batch * cfg.vocab_padded * 4


def full_serve(arch: str, want_params: int, batch: int, prompt: int,
               gen: int, smi: str, window: int | None = None,
               profile_steps: int = 0, layers: int | None = None) -> dict:
    """The arch at full width in bf16, weights (and a vlm or audio
    prompt's modality stub) drawn on the card: ``batch`` prompts of
    ``prompt`` tokens into a ring of ``window`` slots (``cfg.window`` by
    default), then ``gen`` greedy steps past its wrap, and
    ``profile_steps`` more under torch.profiler; ``layers`` cuts the
    depth.  Checks the param count, the position, the wrap (none without
    K/V), finite logits, the tokens and the launches (swa_decode steps x
    sites, every other kernel 0); returns the timings beside the step's
    bytes bound."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve_decode import serve, stub_prefix
    from repro_torch.models import transformer as tf
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    n_params = tf.param_count(cfg)
    check(n_params == want_params, f"{arch} param_count {n_params}")
    window = window or cfg.window
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    draws = dict(LAUNCHES)
    check(draws["threefry_normal"] > 0 and all(
        c == 0 for name, c in draws.items() if name != "threefry_normal"),
          f"{arch}: the draw launched {draws}")
    gen_ = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=gen_, device="cuda")
    prefix = stub_prefix(cfg, batch, gen_, torch.device("cuda"))
    # warm-up at the same cache shape: cuBLAS handles, the allocator
    serve(params, cfg, prompts[:, :128], 2, prefix=prefix, window=window,
          cache_len=window)
    torch.cuda.synchronize()
    reset_launch_counts()
    r = serve(params, cfg, prompts, gen, prefix=prefix, window=window,
              cache_len=window, profile_steps=profile_steps)
    counts = dict(LAUNCHES)
    toks = r["tokens"]
    sites = attention_sites(cfg)
    steps = gen + (profile_steps if r["profile"] else 0)
    n_prefix = r["prefix_positions"]
    check(r["pos"] == n_prefix + prompt + steps
          and r["wrapped"] == (sites > 0)
          and r["cache_slots"] == (window if sites else None),
          f"{arch}: pos {r['pos']}, {r['cache_slots']} slots, wrapped "
          f"{r['wrapped']}")
    check(r["logits_finite"], f"{arch}: logits not finite")
    check(toks.shape == (batch, gen + 1)
          and bool(((toks >= 0) & (toks < cfg.vocab_padded)).all()),
          f"{arch}: generated tokens")
    want = steps * sites
    check(counts["swa_decode"] == want, f"swa_decode launched "
          f"{counts['swa_decode']} times on the {arch} serving path, "
          f"expected {want}")
    for name, c in counts.items():
        check(name == "swa_decode" or c == 0,
              f"{name} launched on the {arch} serving path")
    start = n_prefix + prompt
    slots = [min(p + 1, window) for p in range(start, start + gen)]
    step_bytes = decode_step_bytes(cfg, params, r["cache"], batch,
                                   sum(slots) / len(slots))
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    row = {"params": n_params, "layers": cfg.n_layers, "batch": batch,
           "prompt": prompt, "steps": steps, "draw_s": draw_s,
           "prefill_ms": r["prefill_s"] * 1e3,
           "prompt_tokens_per_s": r["prompt_tokens_per_s"],
           "decode_ms_per_step": r["decode_ms_per_step"],
           "generated_tokens_per_s": r["generated_tokens_per_s"],
           "step_bytes": step_bytes, "step_bound_ms": step_bound,
           "peak_mem_gib": r["peak_mem_gib"], "launches": counts,
           "draw_launches": draws["threefry_normal"],
           "swa_decode_sites": sites, "card": smi}
    if n_prefix:
        row["prefill_positions_per_s"] = r["prefill_positions_per_s"]
    if r["profile"]:
        row["profile"] = r["profile"]
    log(f"serve: {arch} full width, {cfg.n_layers} layers, {n_params:,} "
        f"params (bf16), drawn on the card in {draw_s:.2f} s "
        f"({draws['threefry_normal']} threefry_normal launches); batch "
        f"{batch}, prompt {prompt} "
        f"(+{n_prefix} patch positions), ring {window} slots, {steps} "
        f"greedy steps to pos {r['pos']}")
    log(f"serve: {arch} prefill {row['prefill_ms']:.1f} ms, "
        f"{row['prompt_tokens_per_s']:.1f} prompt tokens/s; decode "
        f"{row['decode_ms_per_step']:.4f} ms/step, "
        f"{row['generated_tokens_per_s']:.2f} generated tokens/s; bytes "
        f"bound of a step {step_bound:.4f} ms ({step_bytes:,.0f} B over "
        f"3.35 TB/s); peak device memory {row['peak_mem_gib']:.2f} GiB; "
        f"logits finite; tokens of row 0: {toks[0, :8].tolist()}")
    log(f"serve: {arch} kernel launches {counts} (want {want} for "
        f"swa_decode: {sites} sites x {steps} steps; 0 for the others)")
    if r["profile"]:
        log(f"serve: {arch} profiled {profile_steps} steps: {r['profile']}")
    del params, prompts, r
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_serve(smi: str) -> dict:
    return full_serve(SERVE_ARCH, SERVE_PARAMS, SERVE_BATCH, SERVE_PROMPT,
                      SERVE_GEN, smi)


def phase_families(smi: str) -> dict:
    """Phase 7b: the moe, ssm and hybrid families at full width; one
    ``families`` JSON line."""
    out = {arch: full_serve(arch, n, FAMILY_BATCH, FAMILY_PROMPT,
                            FAMILY_GEN, smi)
           for arch, n in FAMILIES.items()}
    print(json.dumps({"families": out}), flush=True)
    return out


# what a profiled serve's JSON row keeps of ``serve_decode._profile``
PROFILE_KEYS = ("device_idle_share", "device_busy_ms_per_step",
                "kernel_ms_per_step_by_group", "kernel_launches_per_step")


def phase_modalities(smi: str) -> dict:
    """Phase 7c: the vlm and audio families at full width, each with its
    last steps profiled; one ``modalities`` JSON line."""
    t0 = time.perf_counter()
    out = {}
    for arch, (n, batch, prompt, gen, window) in MODALITIES.items():
        row = full_serve(arch, n, batch, prompt, gen, smi, window,
                         MODALITY_PROFILE_STEPS)
        prof = row.pop("profile")
        out[arch] = {k: row[k] for k in (
            "params", "draw_s", "prompt_tokens_per_s", "decode_ms_per_step",
            "generated_tokens_per_s", "step_bytes", "step_bound_ms",
            "peak_mem_gib", "launches", "draw_launches", "card")} | {
            "prefill_s": row["prefill_ms"] / 1e3,
            "swa_decode_per_step": row["swa_decode_sites"]} | {
            k: prof[k] for k in PROFILE_KEYS}
        if "prefill_positions_per_s" in row:
            out[arch]["prefill_positions_per_s"] = row[
                "prefill_positions_per_s"]
    print(json.dumps({"modalities": out}), flush=True)
    log(f"phase 7c (vlm and audio at full width): "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_configs(smi: str) -> dict:
    """Phase 7d: A15's configs at full width (grok-1 at 2 of 64 layers),
    each with its last steps profiled; one ``configs`` JSON line."""
    t0 = time.perf_counter()
    out = {}
    for arch, (layers, n, batch, prompt, gen) in CONFIGS.items():
        row = full_serve(arch, n, batch, prompt, gen, smi,
                         profile_steps=CONFIG_PROFILE_STEPS, layers=layers)
        prof = row.pop("profile")
        out[arch] = row | {k: prof[k] for k in PROFILE_KEYS}
    print(json.dumps({"configs": out}), flush=True)
    log(f"phase 7d (A15's configs at full width): "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 8: the simulator, card against CPU
# ---------------------------------------------------------------------------

def phase_prng() -> None:
    """The threefry PRNG on the card: every call bitwise equal to the CPU's."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.scenario import stream_key, stream_keys
    for seed in (0, 1, 2 ** 31 - 1):
        kc, kg = prng.PRNGKey(seed), prng.PRNGKey(seed, device="cuda")
        calls = {
            "split": lambda k: prng.split(k, 4),
            "fold_in": lambda k: prng.fold_in(k, 2 ** 31 + 5),
            "stream_key": lambda k: stream_key(k, 1, 119, 7),
            "random_bits": lambda k: prng.random_bits(k, (3, 5)),
            "randint": lambda k: prng.randint(k, (4096,), 0, 70_000),
            "uniform": lambda k: prng.uniform(k, (206_922,)),
            "normal": lambda k: prng.normal(k, (7_850,)),
            "truncated_normal": lambda k: prng.truncated_normal(
                k, -2.0, 2.0, (200_704,)),
        }
        for name, fn in calls.items():
            got, want = fn(kg), fn(kc)
            check(got.device.type == "cuda" and bits_equal(got.cpu(), want),
                  f"prng {name} seed {seed}: card and CPU differ")
        dither = prng.uniform(kc, (206_922,), device="cuda")
        check(bits_equal(dither.cpu(), prng.uniform(kc, (206_922,))),
              "prng: bits drawn on the card from a CPU key")
        # the batched engine's forms: CPU base key, rounds and devices as
        # tensors on the device, rows of keys there
        rows = {
            "stream_keys": lambda d: stream_keys(
                kc, 0, torch.arange(96, 100, device=d),
                torch.arange(8, device=d)),
            "randint_rows": lambda d: prng.randint_rows(
                prng.split(kc, 8).to(d), 64,
                torch.arange(1, 9, device=d) * 9_000),
            "uniform_rows": lambda d: prng.uniform_rows(
                prng.split(kc, 8).to(d), 7_850),
            "normal_rows": lambda d: prng.normal_rows(
                prng.split(kc, 8).to(d), 3),
        }
        for name, fn in rows.items():
            got, want = fn("cuda"), fn("cpu")
            check(got.device.type == "cuda" and bits_equal(got.cpu(), want),
                  f"prng {name} seed {seed}: card and CPU differ")
    torch.cuda.synchronize()
    log(f"prng: {', '.join(calls)}, {', '.join(rows)} on the card bitwise "
        f"equal to the CPU's (seeds 0, 1, 2**31-1)")


@contextlib.contextmanager
def syncs_held_against_plain(compared: list, engine: str,
                             masks: list | None = None):
    """Wrap ``repro_torch.kernels.lgc_compress_hist`` (the loop engine's
    ``_ef_step`` imports it at every sync) or ``lgc_compress_hist_rows``
    (the batched engine's, likewise, and both engines' under per-layer
    budgets): each sync's (g, e') must be bitwise
    equal to the plain pipeline on the same card tensors; ``compared`` gets
    each synced device's received pattern.  The plain calls launch no
    kernel of the port.  On the batched engine, the window's phases run
    under torch's sync debug mode "error": a host sync inside a window
    raises.  With ``masks`` (per-layer budgets), each sync's candidate mask
    (``per_layer_candidates_hist_rows``) must be bitwise the plain
    segmented pipeline's, and ``masks`` gets its rows' count."""
    import torch
    import repro_torch.kernels as kernels
    from repro_torch.core.fl_batched import BatchedEngine
    from repro_torch.kernels import ref
    flat = engine == "loop" and masks is None
    name = "lgc_compress_hist" if flat else "lgc_compress_hist_rows"
    plain = ref.hist_lgc_compress if flat else ref.hist_lgc_compress_rows
    kern = getattr(kernels, name)

    def checked(e, delta, cum_ks, received):
        g, e_new = kern(e, delta, cum_ks, received)
        # the check's own reads wait for the card: not the engine's
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        g_ref, e_ref = plain(e, delta, cum_ks, received)
        check(bits_equal(g, g_ref) and bits_equal(e_new, e_ref),
              f"simulator sync {len(compared)} ({engine}): the kernels' "
              f"(g, e') differ from the plain versions' on the same inputs")
        rows = received.tolist()
        compared.extend([tuple(rows)] if flat else map(tuple, rows))
        torch.cuda.set_sync_debug_mode(mode)
        return g, e_new

    def no_sync(fn):
        def guarded(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return guarded
    cand = kernels.per_layer_candidates_hist_rows

    def checked_mask(u, segments, budgets):
        mask = cand(u, segments, budgets)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        check(bits_equal(mask, ref.hist_candidates_segments(
            u, segments.offsets, budgets)), f"simulator sync {len(masks)} "
            f"({engine}): the candidate mask differs from the plain "
            f"segmented pipeline's")
        masks.append(u.shape[0])
        torch.cuda.set_sync_debug_mode(mode)
        return mask
    window = ("_channels", "_draw_batches", "_local_steps", "_sync")
    saved = {m: getattr(BatchedEngine, m) for m in window}
    setattr(kernels, name, checked)
    if masks is not None:
        kernels.per_layer_candidates_hist_rows = checked_mask
    if engine == "batched":
        for m in window:
            setattr(BatchedEngine, m, no_sync(saved[m]))
    try:
        yield
    finally:
        setattr(kernels, name, kern)
        kernels.per_layer_candidates_hist_rows = cand
        for m in window:
            setattr(BatchedEngine, m, saved[m])


def sim_run(task_name: str, m: int, n_train: int | None, rounds: int,
            eval_every: int, mode: str, scenario, engine: str,
            device: str, compared: list | None = None,
            masks: list | None = None, backend: str = "cuda",
            **cfg_kw) -> dict:
    """One run (backend "cuda": the kernels on the card, their plain
    versions on the CPU) under ``scenario`` (a name or a Scenario) with its
    launch counts and host times; with ``compared``, every sync is held
    against the plain versions (a run not timed), with ``masks`` also each
    per-layer candidate mask; ``cfg_kw`` go to FLConfig."""
    import torch
    from repro_torch.core import FLConfig
    from repro_torch.core.fl import EVAL_SUBSET, baseline_simulator
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models.paper_models import make_task
    kw = {} if n_train is None else {"n_train": n_train}
    task = make_task(task_name, m_devices=m, scenario=scenario, **kw)
    cfg = FLConfig(rounds=rounds, eval_every=eval_every, backend=backend,
                   engine=engine, scenario=scenario, **cfg_kw)
    sim = baseline_simulator(task, cfg, mode, h=SIM_H, device=device)
    held = (syncs_held_against_plain(compared, engine, masks)
            if compared is not None else contextlib.nullcontext())
    if device == "cuda":
        torch.cuda.synchronize()
    with held:
        reset_launch_counts()
        t0 = time.perf_counter()
        hist = sim.run()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    check(all(math.isfinite(x) for x in hist.loss + hist.accuracy),
          f"{task_name} {mode} {engine} on {device}: History not finite")
    y_eval = task.eval_data[1]       # (n,) labels or (n, S) next tokens
    out = {"hist": hist, "d": sim.d, "launches": counts, "wall_s": wall,
           "params": sim.params,
           "n_eval": (min(EVAL_SUBSET, len(y_eval))
                      * math.prod(y_eval.shape[1:])),
           "host_ms_per_round": wall * 1e3 / rounds,
           "device_steps_per_s": m * rounds / wall}
    if engine == "loop":
        sync = [ms for t, ms in enumerate(sim.round_ms)
                if (t + 1) % SIM_H == 0]
        other = [ms for t, ms in enumerate(sim.round_ms) if (t + 1) % SIM_H]
        out |= {"median_sync_round_ms": statistics.median(sync),
                "median_other_round_ms": statistics.median(other)}
    else:
        out["median_window_ms"] = statistics.median(
            sim.batched_engine.window_ms)
    return out


def history_gaps(a, b, n_eval: int) -> tuple[float, int]:
    """The largest loss gap and accuracy-count gap (on the ``n_eval`` eval
    predictions) between two Histories."""
    worst = max(abs(x - y) for x, y in zip(a.loss, b.loss))
    gap = max(round(abs(x - y) * n_eval)
              for x, y in zip(a.accuracy, b.accuracy))
    return worst, gap


def check_history(tag: str, gpu, cpu, n_eval: int,
                  tol: float = 1e-3) -> tuple[float, int]:
    """step and uplink_mb equal, losses within ``tol`` and the accuracy
    counts on the ``n_eval`` eval predictions within ``tol`` of them;
    returns the worst gaps."""
    check(gpu.step == cpu.step and gpu.uplink_mb == cpu.uplink_mb,
          f"{tag}: step or uplink_mb differ between card and CPU")
    worst, gap = history_gaps(gpu, cpu, n_eval)
    check(worst <= tol, f"{tag}: losses differ by {worst}")
    # accuracy is a count over the eval predictions: 1e-3 of 1000 samples
    # is one, whose f32 mean differs by 0.0010000467
    check(gap <= round(tol * n_eval),
          f"{tag}: accuracy counts differ by {gap} of {n_eval}")
    return worst, gap


def phase_simulator(smi: str) -> dict:
    """lr_mnist at the quickstart's defaults (lgc, fedavg) and cnn_mnist at
    the factory's (lgc, topk), then cnn_mnist under gilbert_flaky and
    rnn_shakespeare under mobile_noniid (lgc), on the loop and the batched
    engine: the card against the CPU, each sync's (g, e') on the card
    bitwise equal to the plain versions on the same inputs, the loop
    engine launching the flat LGC kernels once per device and sync and the
    batched engine the row kernels once per sync boundary; under a dynamic
    scenario some sync must have lost a channel or the whole device.  A
    second card run of each, not checked per sync, gives the host times.
    Returns the launch counts of the checked runs by (task mode [scenario],
    engine)."""
    launches = {}
    for (task_name, m, n_train, rounds, eval_every, modes,
         scenario) in SIM_RUNS:
        for mode in modes:
            timing, cpu_hist = {}, {}
            for engine in ENGINES:
                args = (task_name, m, n_train, rounds, eval_every, mode,
                        scenario, engine)
                tag = f"{task_name} {mode} {engine}"
                if scenario != "static":
                    tag = f"{task_name} {mode} {scenario} {engine}"
                compared: list = []
                cpu = sim_run(*args, "cpu")
                gpu = sim_run(*args, "cuda", compared=compared)
                timed = sim_run(*args, "cuda")
                n_eval = cpu["n_eval"]
                tol = 1e-3 if scenario == "static" else SCENARIO_HIST_TOL
                worst, gap = check_history(tag, gpu["hist"], cpu["hist"],
                                           n_eval, tol)
                check_history(f"{tag} (timed run)", timed["hist"],
                              cpu["hist"], n_eval, tol)
                cpu_hist[engine] = cpu["hist"]
                syncs = m * (rounds // SIM_H) if mode != "fedavg" else 0
                boundaries = rounds // SIM_H if mode != "fedavg" else 0
                for name, rows_name in ROW_KERNELS.items():
                    want = {name: syncs if engine == "loop" else 0,
                            rows_name: boundaries if engine == "batched"
                            else 0}
                    for run in (gpu, timed):
                        for k, v in want.items():
                            check(run["launches"][k] == v,
                                  f"{tag}: {k} launched "
                                  f"{run['launches'][k]} times, expected {v}")
                check(gpu["launches"]["swa_decode"] == 0
                      and timed["launches"]["swa_decode"] == 0,
                      f"{tag}: swa_decode launched")
                check(len(compared) == syncs, f"{tag}: {len(compared)} syncs "
                      f"held against the plain versions, expected {syncs}")
                dropped = sum(1 for r in compared if not all(r))
                lost = sum(1 for r in compared if not any(r))
                if scenario != "static":
                    check(dropped > 0, f"{tag}: no sync lost a channel or "
                          f"a device under the scenario")
                launches[tag] = gpu["launches"]
                timing[engine] = timed
                h = gpu["hist"]
                log(f"simulator {tag}: D={gpu['d']:,}, M={m}, {rounds} "
                    f"rounds, H={SIM_H}; loss {h.loss[0]:.4f} -> "
                    f"{h.loss[-1]:.4f}, accuracy {h.accuracy[-1]:.4f}, uplink "
                    f"{h.uplink_mb[-1]:.4f} MB, energy {h.energy_j[-1]:.1f} J; "
                    f"card's losses within {worst:.2e} of the CPU's, accuracy "
                    f"count within {gap} of {n_eval}; {len(compared)} device "
                    f"syncs bitwise equal to the plain versions ({dropped} "
                    f"with a channel dropped, {lost} with nothing delivered: "
                    f"the device dropped or every channel down); launches "
                    f"{gpu['launches']}")
                for dev, r in (("cuda", timed), ("cpu", cpu)):
                    detail = (f"median sync round "
                              f"{r['median_sync_round_ms']:.3f}, other rounds "
                              f"{r['median_other_round_ms']:.3f}"
                              if engine == "loop" else
                              f"median window {r['median_window_ms']:.3f}")
                    log(f"simulator {tag} on {dev}: host ms per round "
                        f"{r['host_ms_per_round']:.3f} ({detail}), "
                        f"device-steps/s {r['device_steps_per_s']:.1f} "
                        f"({r['wall_s']:.2f} s); {smi}")
            # the yardstick of summation order alone: the CPU's two engines
            # run the same trajectory with the same syncs
            yard_loss, yard_gap = history_gaps(cpu_hist["loop"],
                                               cpu_hist["batched"], n_eval)
            log(f"simulator {tag.rsplit(' ', 1)[0]}: the CPU's loop and "
                f"batched engines differ by {yard_loss:.2e} in loss and "
                f"{yard_gap} of {n_eval} in accuracy counts (summation "
                f"order alone; the card is held to {tol})")
            log(f"simulator {tag.rsplit(' ', 1)[0]} on the card, batched "
                f"against loop in this call: device-steps/s "
                f"{timing['batched']['device_steps_per_s']:.1f} against "
                f"{timing['loop']['device_steps_per_s']:.1f}, host ms per "
                f"round {timing['batched']['host_ms_per_round']:.3f} against "
                f"{timing['loop']['host_ms_per_round']:.3f}; {smi}")
    return launches


def phase_per_layer(smi: str) -> dict:
    """cnn_mnist (M=8, 12 rounds, H=4, lgc) under each per-layer policy
    on both engines with backend "cuda", the card against the CPU: every
    sync's candidate mask and (g, e') bitwise the plain segmented pipeline
    on the same card tensors; one launch of each segmented kernel per sync
    boundary (batched) or per syncing device (loop), then the LGC row
    kernels on the masked update; History within the CPU's at the
    phase-8 tolerances.  Then ``uniform`` against ``global`` on the exact
    backend on the card, bitwise.  Returns the launch counts by (policy,
    engine)."""
    import torch
    task_name, m, n_train, rounds, eval_every = PER_LAYER_RUN
    syncs, boundaries = m * (rounds // SIM_H), rounds // SIM_H
    launches = {}
    for policy in PER_LAYER_POLICIES:
        for engine in ENGINES:
            args = (task_name, m, n_train, rounds, eval_every, "lgc",
                    "static", engine)
            tag = f"{task_name} {policy} {engine}"
            compared, masks = [], []
            cpu = sim_run(*args, "cpu", layer_policy=policy)
            gpu = sim_run(*args, "cuda", compared=compared, masks=masks,
                          layer_policy=policy)
            worst, gap = check_history(tag, gpu["hist"], cpu["hist"],
                                       cpu["n_eval"])
            per_sync = syncs if engine == "loop" else boundaries
            want = {"maxabs_segments": per_sync,
                    "histogram_segments": per_sync}
            for name, rows_name in ROW_KERNELS.items():
                want[name] = 0
                want[rows_name] = per_sync
            got = gpu["launches"]
            check(all(got[k] == v for k, v in want.items())
                  and got["swa_decode"] == 0,
                  f"{tag}: launches {got}, expected {want}")
            check(len(compared) == syncs and sum(masks) == syncs,
                  f"{tag}: {len(compared)} syncs and {sum(masks)} masks "
                  f"held against the plain versions, expected {syncs}")
            launches[tag] = got
            h = gpu["hist"]
            log(f"per-layer {tag}: D={gpu['d']:,}, M={m}, {rounds} rounds; "
                f"loss {h.loss[0]:.4f} -> {h.loss[-1]:.4f}, accuracy "
                f"{h.accuracy[-1]:.4f}, uplink {h.uplink_mb[-1]:.4f} MB; "
                f"card's losses within {worst:.2e} of the CPU's, accuracy "
                f"count within {gap} of {cpu['n_eval']}; {len(masks)} "
                f"candidate masks ({sum(masks)} device rows) and "
                f"{len(compared)} device syncs bitwise equal to the plain "
                f"segmented pipeline; launches {got}; card {gpu['wall_s']:.2f}"
                f" s ({gpu['host_ms_per_round']:.3f} ms per round, checked), "
                f"CPU {cpu['wall_s']:.2f} s; {smi}")
    for engine in ENGINES:
        args = (task_name, m, n_train, rounds, eval_every, "lgc", "static",
                engine, "cuda")
        uni = sim_run(*args, backend="exact", layer_policy="uniform")
        glo = sim_run(*args, backend="exact")
        check(uni["hist"].asdict() == glo["hist"].asdict()
              and all(bits_equal(uni["params"][k], glo["params"][k])
                      for k in glo["params"]),
              f"{task_name} {engine}: uniform differs from global on the "
              f"exact backend")
        log(f"per-layer {task_name} {engine}: uniform bitwise equal to "
            f"global on the exact backend on the card (History and params, "
            f"{rounds} rounds)")
    torch.cuda.synchronize()
    return launches


def phase_server(smi: str) -> dict:
    """lr_mnist (M=8, 20 rounds, every 4th device 3x slower) under diloco
    and semi_sync (staleness_cap=2) on both engines, the card against the
    CPU: History within 1e-3, server_wall_s equal, the LGC kernels launched
    as under the mean.  Returns the runs' server_wall_s by tag."""
    from repro_torch.core.scenario import Scenario, StragglerSpec
    scn = Scenario(name="stragglers",
                   straggler=StragglerSpec(slow_every=4, slowdown=3.0))
    task_name, m, n_train, rounds, eval_every = SERVER_RUN
    syncs, boundaries = m * (rounds // SIM_H), rounds // SIM_H
    walls = {}
    for agg in ("mean",) + SERVER_AGGS:
        for engine in ENGINES:
            args = (task_name, m, n_train, rounds, eval_every, "lgc", scn,
                    engine)
            kw = {"aggregator": agg,
                  "staleness_cap": 2 if agg == "semi_sync" else 0}
            tag = f"{task_name} {agg} {engine}"
            cpu = sim_run(*args, "cpu", **kw)
            gpu = sim_run(*args, "cuda", **kw)
            worst, gap = check_history(tag, gpu["hist"], cpu["hist"],
                                       cpu["n_eval"])
            check(gpu["hist"].server_wall_s == cpu["hist"].server_wall_s,
                  f"{tag}: server_wall_s differs between card and CPU")
            for name, rows_name in ROW_KERNELS.items():
                want = ((syncs, 0) if engine == "loop" else (0, boundaries))
                got = (gpu["launches"][name], gpu["launches"][rows_name])
                check(got == want, f"{tag}: {name} launches {got}, "
                      f"expected {want}")
            h = gpu["hist"]
            walls[tag] = h.server_wall_s[-1]
            log(f"server {tag}: M={m}, {rounds} rounds, stragglers; loss "
                f"{h.loss[0]:.4f} -> {h.loss[-1]:.4f}, server wall "
                f"{h.server_wall_s[-1]:.6f} s (equal to the CPU's); card's "
                f"losses within {worst:.2e} of the CPU's, accuracy count "
                f"within {gap} of {cpu['n_eval']}; card "
                f"{gpu['host_ms_per_round']:.3f} ms per round; {smi}")
    for engine in ENGINES:
        check(walls[f"{task_name} semi_sync {engine}"]
              < walls[f"{task_name} mean {engine}"],
              f"semi_sync does not cut the server wall under stragglers "
              f"({engine})")
    return walls


# ---------------------------------------------------------------------------
# phase 8 (cont.): the learning-based control plane
# ---------------------------------------------------------------------------

# the two main paths of the control plane: (tag, task, M, n_train, rounds,
# eval_every, FLConfig fields); the fleets' configs in control_fleet
CONTROL_PATHS = [
    ("lr_mnist ddpg", "lr_mnist", 3, 3000, 60, 20, {}),
    ("cnn_mnist ddpg per_device hetero_fleet", "cnn_mnist", 8, None, 24, 8,
     {"scenario": "hetero_fleet", "action_space": "per_device",
      "pipeline_decisions": True, "max_gap": 4}),
]
# the reference's heterogeneous scripted decisions
# (tests/test_hetero_control.py:35-39)
SCRIPTED_HS = [1, 2, 3, 4, 5, 6, 7, 8]
SCRIPTED_KSS = [[60, 30, 10], [10, 60, 30], [30, 10, 60], [80, 10, 10],
                [10, 80, 10], [10, 10, 80], [34, 33, 33], [5, 5, 90]]
SCRIPTED_RUN = ("lr_mnist", 8, 1600, 24, 8)
FLEET_PHASES = {"act": "_fleet_decide", "reward": "_reward_enqueue",
                "reward_read": "_reward_read"}


class ScriptedFleet:
    """Fleet-protocol controller replaying fixed per-device decisions."""

    def __init__(self, hs, kss):
        self.m = len(hs)
        self.hs, self.kss = list(hs), [list(k) for k in kss]
        import numpy as np
        self.needs_reward = np.zeros(self.m, bool)

    def act(self, states, mask=None):
        import numpy as np
        return np.asarray(self.hs, np.int64), [list(k) for k in self.kss]

    def observe(self, *a, **k):
        pass


def control_fleet(per_device: bool, m: int, d: int, device: str):
    """The paths' fleets: the shared space at make_fleet_ddpg's settings, or
    the reference's hetero per_device settings; replay batches of 4."""
    from repro_torch.core.controller import DDPGConfig, FleetDDPG, obs_dim
    k_total = max(3, int(0.05 * d))
    if per_device:
        cfg = DDPGConfig(state_dim=obs_dim(3, "per_device"), n_channels=3,
                         action_space="per_device", h_max=4, h_prior=1.5,
                         k_total_max=k_total, batch_size=4, seed=0)
    else:
        cfg = DDPGConfig(state_dim=obs_dim(3, "shared"), n_channels=3,
                         k_total_max=k_total, batch_size=4, seed=0)
    return FleetDDPG(m, cfg, device=device)


def timed_fleet(sim) -> dict:
    """Wrap the simulator's controller calls with host clocks: seconds in
    act, the reward eval (enqueue and read) and the fleet's observe (replay
    and training), and the count of boundaries."""
    spent = {k: 0.0 for k in (*FLEET_PHASES, "observe")} | {"boundaries": 0}

    def wrap(key, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return timed
    for key, attr in FLEET_PHASES.items():
        setattr(sim, attr, wrap(key, getattr(sim, attr)))
    sim.fleet.observe = wrap("observe", sim.fleet.observe)
    observe = sim._observe_devices

    def counted(*a, **k):
        spent["boundaries"] += 1
        return observe(*a, **k)
    sim._observe_devices = counted
    return spent


def fleet_ms(spent: dict) -> dict:
    n = max(spent["boundaries"], 1)
    return {"act": spent["act"] * 1e3 / n,
            "reward": (spent["reward"] + spent["reward_read"]) * 1e3 / n,
            "observe": spent["observe"] * 1e3 / n,
            "boundaries": spent["boundaries"]}


def control_run(path, engine: str, device: str, compared=None,
                **cfg_kw) -> dict:
    """One run of a control path on ``engine`` (the fleet and the
    simulator on ``device``, backend "cuda"), its launches, host times and
    the fleet's per-boundary host ms."""
    import torch
    from repro_torch.core import FLConfig, LGCSimulator, prng, tree_size
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models.paper_models import make_task
    tag, task_name, m, n_train, rounds, eval_every, fields = path
    fields = fields | cfg_kw
    kw = {} if n_train is None else {"n_train": n_train}
    task = make_task(task_name, m_devices=m,
                     scenario=fields.get("scenario"), **kw)
    cfg = FLConfig(rounds=rounds, eval_every=eval_every, backend="cuda",
                   engine=engine, **fields)
    d = tree_size(task.init(prng.PRNGKey(0)))
    fleet = control_fleet(cfg.action_space == "per_device", m, d, device)
    sim = LGCSimulator(task, cfg, fleet, device=device)
    spent = timed_fleet(sim)
    held = (syncs_held_against_plain(compared, engine)
            if compared is not None else contextlib.nullcontext())
    torch.cuda.synchronize()
    with held:
        reset_launch_counts()
        t0 = time.perf_counter()
        hist = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    check(all(math.isfinite(x) for x in hist.loss + hist.accuracy),
          f"{tag} {engine}: History not finite")
    out = {"sim": sim, "hist": hist, "launches": counts, "wall_s": wall,
           "fleet_ms": fleet_ms(spent),
           "host_ms_per_round": wall * 1e3 / rounds,
           "device_steps_per_s": m * rounds / wall}
    if engine == "batched":
        out["median_window_ms"] = statistics.median(
            sim.batched_engine.window_ms)
    return out


def check_decisions(tag: str, sim) -> tuple[int, int]:
    """Every committed decision within 1 <= h <= min(max_gap, battery cap),
    1 <= ks and sum(ks) <= k_total_max; returns the device syncs and the
    sync boundaries of the run (from the decision log)."""
    from repro_torch.core.audit import sync_round_of
    cfg, fcfg = sim.cfg, sim.fleet.cfg
    for (t, m, h, ks) in sim.decision_log:
        cap = cfg.max_gap
        if fcfg.action_space == "per_device":
            cap = min(cap, 1 + int(math.floor(sim.profiles[m].battery
                                              * (fcfg.h_max - 1))))
        check(1 <= h <= cap and min(ks) >= 1
              and sum(ks) <= fcfg.k_total_max,
              f"{tag}: decision {(t, m, h, ks)} out of bounds (h cap {cap}, "
              f"budget {fcfg.k_total_max})")
    syncs = [sync_round_of(cfg, t, h) for (t, m, h, ks) in sim.decision_log]
    syncs = [t for t in syncs if t < cfg.rounds]
    return len(syncs), len(set(syncs))


def phase_control(smi: str) -> dict:
    """The paper's learning-based control on the card, through the LGC
    kernels: lr_mnist (M=3, 60 rounds) under a shared-space FleetDDPG and
    cnn_mnist (M=8) on hetero_fleet under a per_device fleet, pipelined, on
    both engines.  Every sync bitwise the plain pipeline (per-row budgets),
    the LGC launches once per device sync (loop) or boundary (batched),
    every device trained, the decisions in their bounds, the spend audit
    exact.  Then a fleet against its agent list on the card (bitwise), the
    card's fleet against the CPU's in lockstep, the scripted per_device
    runs card against CPU, pipelined against blocking.  Returns the checked
    runs' launch counts by tag."""
    import numpy as np
    import torch
    from repro_torch.core.audit import audit_simulator
    launches = {}
    for path in CONTROL_PATHS:
        for engine in ENGINES:
            tag = f"{path[0]} {engine}"
            compared: list = []
            run = control_run(path, engine, "cuda", compared=compared)
            sim = run["sim"]
            syncs, boundaries = check_decisions(tag, sim)
            check(len(compared) == syncs, f"{tag}: {len(compared)} syncs "
                  f"held against the plain pipeline, expected {syncs}")
            for name, rows_name in ROW_KERNELS.items():
                want = {name: syncs if engine == "loop" else 0,
                        rows_name: boundaries if engine == "batched" else 0}
                for k, v in want.items():
                    check(run["launches"][k] == v, f"{tag}: {k} launched "
                          f"{run['launches'][k]} times, expected {v}")
            check(run["launches"]["swa_decode"] == 0, f"{tag}: swa_decode")
            check(bool((sim.fleet._n_train > 0).all()),
                  f"{tag}: a device never trained: {sim.fleet._n_train}")
            rec, live = audit_simulator(sim)
            check(rec == live, f"{tag}: the audit's spend differs from the "
                  f"live spend")
            launches[tag] = run["launches"]
            hs = sorted({h for _, _, h, _ in sim.decision_log})
            h = run["hist"]
            log(f"control {tag}: D={sim.d:,}, M={sim.m_devices}, "
                f"{sim.cfg.rounds} rounds; loss {h.loss[0]:.4f} -> "
                f"{h.loss[-1]:.4f}, uplink {h.uplink_mb[-1]:.4f} MB; "
                f"{len(sim.decision_log)} decisions (h in {hs}), {syncs} "
                f"device syncs over {boundaries} boundaries bitwise the plain "
                f"pipeline; n_train {sim.fleet._n_train.tolist()}; audit "
                f"exact; launches {run['launches']}; fleet host ms per "
                f"boundary {run['fleet_ms']}; host ms per round "
                f"{run['host_ms_per_round']:.3f}, device-steps/s "
                f"{run['device_steps_per_s']:.1f}; {smi}")
    # the timed runs: pipelined against blocking on the batched engine,
    # and the fixed controller on the same cells
    for path in CONTROL_PATHS:
        runs = {"fleet": control_run(path, "batched", "cuda")}
        if path[6].get("pipeline_decisions"):
            runs["blocking"] = control_run(path, "batched", "cuda",
                                           pipeline_decisions=False)
        for kind, r in runs.items():
            log(f"control {path[0]} batched ({kind}, timed): median window "
                f"{r['median_window_ms']:.3f} ms, host ms per round "
                f"{r['host_ms_per_round']:.3f}, device-steps/s "
                f"{r['device_steps_per_s']:.1f}, fleet host ms per boundary "
                f"{r['fleet_ms']}; {smi}")
        tag, task_name, m, n_train, rounds, eval_every, fields = path
        fixed = sim_run(task_name, m, n_train, rounds, eval_every, "lgc",
                        fields.get("scenario", "static"), "batched", "cuda",
                        **{k: v for k, v in fields.items()
                           if k != "scenario"})
        log(f"control {tag} batched: device-steps/s "
            f"{runs['fleet']['device_steps_per_s']:.1f} (DDPG) against "
            f"{fixed['device_steps_per_s']:.1f} (fixed H={SIM_H}, 5% "
            f"budget) in this call; {smi}")
    phase_control_equivalences(smi)
    torch.cuda.synchronize()
    return launches


def phase_control_equivalences(smi: str) -> None:
    """fleet == list bitwise on the card, the card's fleet against the
    CPU's in lockstep, and the scripted per_device runs card against CPU
    (spend exact, pipelined == blocking)."""
    import numpy as np
    import torch
    from repro_torch.core import FLConfig, LGCSimulator
    from repro_torch.core.audit import audit_simulator
    from repro_torch.core.controller import (DDPGConfig, DDPGController,
                                             FleetDDPG)
    from repro_torch.core.fl import EVAL_SUBSET
    from repro_torch.models.paper_models import make_task
    from repro_torch.weights import ddpg_from_jax, ddpg_to_jax
    task = make_task("lr_mnist", m_devices=3, n_train=1200)
    for engine in ENGINES:
        runs = {}
        for kind in ("fleet", "list"):
            cfg = dict(k_total_max=392, batch_size=4)
            ctrls = (FleetDDPG(3, DDPGConfig(seed=5, **cfg), device="cuda")
                     if kind == "fleet" else
                     [DDPGController(DDPGConfig(seed=5 + 17 * m, **cfg),
                                     device="cuda") for m in range(3)])
            sim = LGCSimulator(task, FLConfig(rounds=40, eval_every=10,
                                              backend="cuda", engine=engine),
                               ctrls, device="cuda")
            hist = sim.run()
            trains = (sim.fleet._n_train if kind == "fleet" else np.array(
                [c._fleet._n_train[0] for c in sim.fleet.controllers]))
            runs[kind] = (sim.decision_log, hist.asdict(), trains.tolist())
        check(runs["fleet"] == runs["list"] and min(runs["fleet"][2]) > 0,
              f"control: fleet and agent list differ on the card ({engine})")
        log(f"control: FleetDDPG(3) bitwise its agent list on the card "
            f"({engine}, lr_mnist 40 rounds, {len(runs['fleet'][0])} "
            f"decisions, n_train {runs['fleet'][2]})")
    # lockstep: the card's fleet re-loaded from the CPU's at each boundary
    cfg = DDPGConfig(k_total_max=10346, batch_size=4, seed=3, state_dim=9,
                     action_space="per_device", h_max=4)
    cpu, gpu = FleetDDPG(8, cfg, device="cpu"), FleetDDPG(8, cfg,
                                                          device="cuda")
    rng = np.random.default_rng(0)
    worst_a = worst_w = 0.0
    for _ in range(10):
        states = np.abs(rng.normal(size=(8, 9)) * 10 ** rng.uniform(
            -2, 3, size=(8, 9))).astype(np.float32)
        states[:, 4] = rng.uniform(size=8)
        mask = rng.random(8) < 0.9
        cpu.act(states, mask)
        gpu.act(states, mask)
        check(bool(np.allclose(gpu._last_a, cpu._last_a, rtol=1e-4,
                               atol=1e-6)),
              "control lockstep: card and CPU raw actions differ")
        worst_a = max(worst_a, float(np.abs(gpu._last_a
                                            - cpu._last_a).max()))
        new = states + np.abs(rng.normal(size=(8, 9))).astype(np.float32)
        drops = rng.normal(size=8) * 0.1
        cpu.observe(drops, new, mask)
        gpu.observe(drops, new, mask)
        got, want = ddpg_to_jax(gpu), ddpg_to_jax(cpu)
        for k in ("actor", "critic", "actor_t", "critic_t"):
            for lg, lw in zip(got[k], want[k]):
                for leaf in ("w", "b"):
                    check(bool(np.allclose(lg[leaf], lw[leaf], rtol=1e-4,
                                           atol=1e-6)),
                          f"control lockstep: card and CPU {k} differ "
                          f"after one step")
                    worst_w = max(worst_w, float(np.abs(
                        lg[leaf] - lw[leaf]).max()))
        ddpg_from_jax(want, gpu)
    check(bool((cpu._n_train > 0).all()), "control lockstep: no training")
    log(f"control lockstep, card fleet against CPU fleet (M=8 per_device, "
        f"10 boundaries, re-loaded each): raw actions within {worst_a:.2e}, "
        f"one-step nets within {worst_w:.2e} (rtol 1e-4); n_train "
        f"{cpu._n_train.tolist()}")
    # the scripted heterogeneous runs, card against CPU
    task_name, m, n_train, rounds, eval_every = SCRIPTED_RUN
    for scn in ("static", "gilbert_flaky"):
        task = make_task(task_name, m_devices=m, n_train=n_train,
                         scenario=scn)
        for engine in ENGINES:
            hists = {}
            for dev, pipe in (("cpu", False), ("cuda", False),
                              ("cuda", True)):
                cfg = FLConfig(rounds=rounds, eval_every=eval_every,
                               max_gap=8, scenario=scn, backend="cuda",
                               action_space="per_device", engine=engine,
                               pipeline_decisions=pipe)
                sim = LGCSimulator(task, cfg, ScriptedFleet(
                    SCRIPTED_HS, SCRIPTED_KSS), device=dev)
                compared: list = []
                held = (syncs_held_against_plain(compared, engine)
                        if dev == "cuda" and not pipe
                        else contextlib.nullcontext())
                with held:
                    hist = sim.run()
                rec, live = audit_simulator(sim)
                check(rec == live, f"scripted {scn} {engine} {dev}: audit")
                hists[dev, pipe] = (hist, sim)
            gpu, cpu = hists["cuda", False], hists["cpu", False]
            tag = f"scripted per_device {scn} {engine}"
            worst, gap = check_history(
                tag, gpu[0], cpu[0], min(EVAL_SUBSET, len(task.eval_data[1])),
                SCENARIO_HIST_TOL if scn != "static" else 1e-3)
            check(gpu[1].spend == cpu[1].spend
                  and gpu[1].decision_log == cpu[1].decision_log,
                  f"{tag}: spend or decisions differ between card and CPU")
            check(hists["cuda", True][0].asdict() == gpu[0].asdict(),
                  f"{tag}: pipelined differs from blocking on the card")
            log(f"control {tag}: card within {worst:.2e} in loss and {gap} "
                f"in accuracy counts of the CPU, spend and decisions equal, "
                f"pipelined == blocking asdict-equal on the card; {smi}")


# ---------------------------------------------------------------------------
# phase 8 (cont.): the population layer
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def population_window_without_sync():
    """Run ``population._window`` (the cohort's device phase) under torch's
    sync debug mode "error": a host sync inside a window raises."""
    import torch
    from repro_torch.core import population
    window = population._window

    def guarded(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return window(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    population._window = guarded
    try:
        yield
    finally:
        population._window = window


def population_run(config: str, store: str, engine: str, rounds: int,
                   device: str, compared: list | None = None) -> dict:
    """One population run (N = 100,000, M = 64, H = 4, backend "cuda",
    lgc) with its cohorts, launch counts and host time; with ``compared``,
    every sync is held bitwise against the plain row pipeline and the
    window may not sync the host."""
    import torch
    from repro_torch.core import FLConfig, population
    from repro_torch.core.population import make_population, run_population
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.bench_population import make_config
    task = make_config(config)
    cohorts = []
    draw = population.sample_cohort

    def recorded(*a, **k):
        ids = draw(*a, **k)
        cohorts.append(ids.copy())
        return ids
    population.sample_cohort = recorded
    held = contextlib.ExitStack()
    if compared is not None:
        held.enter_context(syncs_held_against_plain(compared, "batched"))
        held.enter_context(population_window_without_sync())
    try:
        with held:
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
            pop = make_population(task, POP_N, ef_store=store, device=device)
            cfg = FLConfig(rounds=rounds, eval_every=max(rounds // 4, 1),
                           backend="cuda")
            if device == "cuda":
                torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            hist = run_population(pop, cfg, "lgc", h=SIM_H,
                                  m_cohort=POP_M, engine=engine)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
    finally:
        population.sample_cohort = draw
    check(all(math.isfinite(x) for x in hist.loss + hist.accuracy),
          f"population {config} {store} {engine} on {device}: History not "
          f"finite")
    out = {"hist": hist, "cohorts": cohorts, "launches": counts,
           "participation": pop.participation, "ef_bytes": pop.ef_nbytes,
           "d": pop.d, "wall_s": wall,
           "host_ms_per_window": wall * 1e3 / len(cohorts),
           "device_steps_per_s": POP_M * rounds / wall,
           "n_eval": min(2048, len(task.eval_data[1]))}
    if device == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["allocated_before"] = before
        out["ef_device"] = str(pop.ef_store.device)
    return out


def phase_population(smi: str) -> dict:
    """The population layer (N = 100,000, M = 64, H = 4, lgc through the LGC
    row kernels) on the card: (a) the reference bench's configuration
    (population task, 12 rounds) with each EF store on the batched engine
    and the dense store on the loop engine, (b) lr_mnist with the dense
    store (3.14 GB on the card) and the int8 store, 8 rounds.  Each card
    run against the same run on the CPU: cohorts and participation equal,
    History within phase 8's tolerances; every sync bitwise the plain row
    pipeline on the same card tensors, no host sync inside a window; each
    LGC row kernel launched once per window (batched) or once per cohort
    row (loop), the flat kernels never.  Returns the launch counts by
    tag."""
    launches = {}
    t_phase = time.perf_counter()
    for config, store, engine, rounds in POP_RUNS:
        tag = f"{config} {store} {engine}"
        compared: list = []
        gpu = population_run(config, store, engine, rounds, "cuda",
                             compared)
        cpu = population_run(config, store, engine, rounds, "cpu")
        windows = len(gpu["cohorts"])
        check(windows == -(-rounds // SIM_H), f"population {tag}: "
              f"{windows} windows")
        check(all((a == b).all() for a, b in zip(gpu["cohorts"],
                                                  cpu["cohorts"]))
              and len(gpu["cohorts"]) == len(cpu["cohorts"]),
              f"population {tag}: the card's cohorts differ from the CPU's")
        check(bool((gpu["participation"] == cpu["participation"]).all()),
              f"population {tag}: participation differs")
        worst, gap = check_history(f"population {tag}", gpu["hist"],
                                   cpu["hist"], cpu["n_eval"])
        per_window = POP_M if engine == "loop" else 1
        for name, rows_name in ROW_KERNELS.items():
            want = {name: 0, rows_name: per_window * windows}
            for k, v in want.items():
                check(gpu["launches"][k] == v, f"population {tag}: {k} "
                      f"launched {gpu['launches'][k]} times, expected {v}")
        check(len(compared) == POP_M * windows, f"population {tag}: "
              f"{len(compared)} syncs held against the plain pipeline, "
              f"expected {POP_M * windows}")
        check(gpu["ef_device"].startswith("cuda"),
              f"population {tag}: the store is not on the card")
        if config == "lr_mnist" and store == "dense":
            check(gpu["ef_bytes"] == POP_N * LR_D * 4,
                  f"population {tag}: {gpu['ef_bytes']} EF bytes")
        launches[tag] = gpu["launches"]
        h = gpu["hist"]
        log(f"population {tag}: N={POP_N:,}, M={POP_M}, D={gpu['d']:,}, "
            f"{rounds} rounds; EF store {gpu['ef_bytes']:,} bytes on "
            f"{gpu['ef_device']}, max_memory_allocated "
            f"{gpu['max_memory_allocated']:,} bytes ("
            f"{gpu['allocated_before']:,} allocated before the run); loss "
            f"{h.loss[0]:.4f} "
            f"-> {h.loss[-1]:.4f}, accuracy {h.accuracy[-1]:.4f}; cohorts "
            f"and participation equal to the CPU's, losses within "
            f"{worst:.2e}, accuracy count within {gap} of {cpu['n_eval']}; "
            f"{len(compared)} syncs bitwise the plain row pipeline; "
            f"launches {gpu['launches']}; host ms per window "
            f"{gpu['host_ms_per_window']:.3f} (CPU "
            f"{cpu['host_ms_per_window']:.3f}), device-steps/s "
            f"{gpu['device_steps_per_s']:.1f}; {smi}")
    log(f"population phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 8 (cont.): the sharded engine over torch.distributed
# ---------------------------------------------------------------------------

# world 1 over NCCL in this process: cnn_mnist at the factory's width and
# samples, M = 8, 20 rounds, lgc
SHARDED_W1 = ("cnn_mnist", 8, 6000, 20, 10)
# world 2: two processes on the one card over gloo; lr_mnist M = 8, and a
# population window set (lr_mnist, N = 100,000, M = 64, dense store,
# 3 windows)
SHARDED_W2_M, SHARDED_W2_TRAIN = 8, 2000
SHARDED_TIMEOUT_S = 300.0


def sharded_w2_cases() -> list:
    from repro_torch.launch.sharded_runs import population_case, sim_case
    lr = {"task": "lr_mnist", "m": SHARDED_W2_M,
          "n_train": SHARDED_W2_TRAIN, "rounds": 20, "eval_every": 10}
    cases = [sim_case(f"lr_mnist {mode}", mode=mode, **lr)
             for mode in ("lgc", "topk", "lgc_q8")]
    cases.append(sim_case(
        "lr_mnist hetero gaps", hs=[2 + m % 5 for m in range(SHARDED_W2_M)],
        ks=[200, 300, 400], **(lr | {"rounds": 25, "eval_every": 8}),
        cfg={"max_gap": 6}))
    for reduce in ("gather", "psum"):
        cases.append(sim_case(f"lr_mnist semi_sync {reduce}",
                              server_reduce=reduce,
                              cfg={"aggregator": "semi_sync",
                                   "staleness_cap": 2}, **lr))
    cases.append(sim_case(
        "lr_mnist ddpg per_device hetero_fleet", fleet="ddpg",
        **(lr | {"rounds": 24, "eval_every": 8}),
        cfg={"scenario": "hetero_fleet", "action_space": "per_device",
             "pipeline_decisions": True, "max_gap": 4}))
    cases.append(population_case("population lr_mnist dense",
                                 config="lr_mnist", n=POP_N, m_cohort=POP_M,
                                 rounds=3 * SIM_H, h=SIM_H))
    return cases


def rows_launched(launches: dict) -> dict:
    return {name: launches[name] + launches[rn]
            for name, rn in ROW_KERNELS.items()}


def check_sharded(tag: str, case: dict, got: dict, want: dict,
                  rows_bitwise: bool = True) -> list:
    """A sharded result against the unsharded one on the card
    (``sharded_runs.compare``): every row kernel call bitwise its plain
    version, and the result bitwise (gather) or within the psum bound."""
    from repro_torch.launch.sharded_runs import compare
    stats = got["rows_checked"]
    check(stats.get("differ", 0) == 0, f"sharded {tag}: "
          f"{stats.get('differ')} row kernel calls differ from the plain "
          f"versions")
    bad = compare(case, got, want)
    check(not bad, f"sharded {tag}: differs from the unsharded run: {bad}")
    return bad


def median(xs) -> float:
    return statistics.median(xs) if xs else float("nan")


def phase_sharded(smi: str) -> dict:
    """The sharded engine (``engine="sharded"``) on the card.

    World 1 over NCCL in this process: cnn_mnist (M = 8, 20 rounds, lgc)
    under gather and psum against the unsharded batched engine: gather
    bitwise with the same row kernel launches, psum within 1e-4 in loss
    and uplink_mb; each sync's row kernels bitwise their plain versions;
    then an unchecked run of each for the host ms per window.

    World 2, two processes on the card over gloo (``mesh.spawn``):
    lr_mnist M = 8 (lgc, topk, lgc_q8, gaps 2 + m mod 5, semi_sync under
    both reduces, a per_device DDPG fleet on hetero_fleet) and a
    population run (lr_mnist, N = 100,000, M = 64, dense store, 3
    windows): both ranks equal, each equal to the unsharded run on the
    card (bitwise under gather), every rank's row kernel calls bitwise
    their plain versions on its block.  Returns the ``sharded`` line."""
    import faulthandler
    from repro_torch.launch.mesh import make_host_mesh, spawn
    from repro_torch.launch.sharded_runs import (rank_main, run_case,
                                                 sim_case)
    t_phase = time.perf_counter()
    # a collective that never returns must not hang the run: dump every
    # thread's stack and exit non-zero
    faulthandler.dump_traceback_later(3 * SHARDED_TIMEOUT_S, exit=True)
    out: dict = {"card": smi}
    # -- world 1, NCCL, in process ------------------------------------------
    mesh = make_host_mesh(device="cuda")
    check(mesh.transport == "nccl" and mesh.size == 1,
          f"sharded world 1: mesh {mesh}")
    log(f"sharded world 1: {mesh}")
    task_name, m, n_train, rounds, eval_every = SHARDED_W1
    w1: dict = {"transport": mesh.transport, "task": task_name, "m": m,
                "rounds": rounds}
    base = sim_case(f"{task_name} lgc", task=task_name, m=m,
                    n_train=n_train, rounds=rounds, eval_every=eval_every)
    want = run_case(base, "batched", "cuda", check_rows=True)
    for reduce in ("gather", "psum"):
        case = base | {"server_reduce": reduce}
        got = run_case(case, "sharded", "cuda", mesh, check_rows=True)
        check_sharded(f"world 1 {reduce}", case, got, want)
        if reduce == "gather":
            check(got["launches"] == want["launches"],
                  f"sharded world 1: launches {got['launches']} against "
                  f"the unsharded {want['launches']}")
        timed = run_case(case, "sharded", "cuda", mesh)
        w1[reduce] = {"bitwise": got["hist"] == want["hist"],
                      "loss_gap": max(abs(a - b) for a, b in zip(
                          got["hist"]["loss"], want["hist"]["loss"])),
                      "launches": rows_launched(got["launches"]),
                      "row_calls_checked": got["rows_checked"]["calls"],
                      "host_ms_per_window": median(timed["window_ms"])}
    timed = run_case(base, "batched", "cuda")
    w1["unsharded"] = {"launches": rows_launched(want["launches"]),
                       "host_ms_per_window": median(timed["window_ms"])}
    out["world1"] = w1
    log(f"sharded world 1 ({mesh.transport}): {task_name} M={m}, {rounds} "
        f"rounds: gather bitwise the batched engine, psum losses within "
        f"{w1['psum']['loss_gap']:.2e}; launches {w1['gather']['launches']}"
        f"; host ms per window gather {w1['gather']['host_ms_per_window']:.3f}"
        f", psum {w1['psum']['host_ms_per_window']:.3f}, unsharded "
        f"{w1['unsharded']['host_ms_per_window']:.3f}; {smi}")
    # -- world 2, gloo, two processes on the one card ------------------------
    cases = sharded_w2_cases()
    log(f"sharded world 2: spawning 2 gloo ranks for {len(cases)} cases")
    t0 = time.perf_counter()
    timed = (cases[0]["name"], cases[-1]["name"])
    ranks = spawn(rank_main, 2, "gloo", args=(cases, "cuda", True, timed),
                  timeout=SHARDED_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    transports = {r["transport"] for r in ranks}
    check(transports == {"gloo"}, f"sharded world 2: transports "
          f"{transports}")
    w2: dict = {"transport": "gloo", "ranks": 2, "device": "cuda:0",
                "spawn_s": spawn_s, "cases": {}}
    for case in cases:
        tag = case["name"]
        r0, r1 = (r["results"][tag] for r in ranks)
        check(r0["hist"] == r1["hist"], f"sharded world 2 {tag}: the "
              f"ranks' Histories differ")
        want = run_case(case, "batched", "cuda", check_rows=True)
        for r, got in enumerate((r0, r1)):
            check_sharded(f"world 2 {tag} rank {r}", case, got, want)
            check(got["launches"]["maxabs_rows"]
                  == got["rows_checked"].get("calls", 0),
                  f"sharded world 2 {tag} rank {r}: "
                  f"{got['launches']['maxabs_rows']} row launches, "
                  f"{got['rows_checked'].get('calls', 0)} row calls")
        summed = {k: r0["launches"][k] + r1["launches"][k]
                  for k in r0["launches"]}
        row = {"bitwise": r0["hist"] == want["hist"],
               "launches_summed": rows_launched(summed),
               "launches_unsharded": rows_launched(want["launches"]),
               "rows_checked": [r0["rows_checked"], r1["rows_checked"]]}
        if tag in timed:
            row["host_ms_per_window"] = [median(r0["timed_window_ms"]),
                                         median(r1["timed_window_ms"])]
            row["unsharded_host_ms_per_window"] = median(
                run_case(case, "batched", "cuda")["window_ms"])
        if case["kind"] == "population":
            row["ef_bytes_per_rank"] = r0["ef_bytes"]
            row["max_memory_allocated"] = [r0["max_memory_allocated"],
                                           r1["max_memory_allocated"]]
        w2["cases"][tag] = row
        how = "bitwise" if row["bitwise"] else "within the psum bound of"
        times = (f"; host ms per window {row['host_ms_per_window']} "
                 f"(ranks) against {row['unsharded_host_ms_per_window']:.3f}"
                 if tag in timed else "")
        log(f"sharded world 2 {tag}: {how} the unsharded run; launches "
            f"summed {row['launches_summed']} (unsharded "
            f"{row['launches_unsharded']}){times}; {smi}")
    out["world2"] = w2
    faulthandler.cancel_dump_traceback_later()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"sharded phase: {out['seconds']:.1f} s")
    print(json.dumps({"sharded": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: timings
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median over ``reps`` single calls, each between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_row(n: int, kern, plain, lib, n_bytes: float, n_ops: float,
             m_flat=None, lib_reps=(100, 20)) -> dict:
    """Times of a kernel, its plain version and a library call; with
    ``m_flat``, also of the M flat launches that the row form replaces."""
    from repro_torch.device import device_ms
    bnd, by = bound_ms(n_bytes, n_ops)
    lib_device_ms, lib_reps_used = None, None
    # a library call of many launches (8 histc calls: fills, counts) fills
    # the card's launch queue behind the hold at 100 calls, and the host
    # then waits: fewer calls (``lib_reps``)
    for reps in lib_reps if lib else ():
        try:
            lib_device_ms, lib_reps_used = device_ms(lib, reps=reps), reps
            break
        except RuntimeError as err:    # the enqueue outlasted the hold
            log(f"timing: no device time for the library call over {reps} "
                f"calls ({err})")
    row = {"n": n, "ms": time_ms(kern), "plain_ms": time_ms(plain),
           "library_ms": time_ms(lib) if lib else None,
           "device_ms": device_ms(kern), "library_device_ms": lib_device_ms,
           "library_device_reps": lib_reps_used,
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes}
    if m_flat is not None:
        row |= {"m_flat_ms": time_ms(m_flat),
                "m_flat_device_ms": device_ms(m_flat)}
    return row


def log_row(name: str, tag, row: dict) -> None:
    log(f"timing {name} {tag}: kernel {row['ms']:.5f} ms one call, "
        f"{row['device_ms']:.5f} ms device; plain {row['plain_ms']:.5f} ms; "
        f"library {row['library_ms']} ms one call, "
        f"{row['library_device_ms']} ms device; bound {row['bound_ms']:.5f} "
        f"ms ({row['bound_by']})")


def histogram_case(u) -> tuple:
    """histogram on u with m = maxabs(u): kernel, plain version, histc,
    bytes and operations."""
    import torch
    from repro_torch.kernels import histogram, maxabs, ref
    n = u.numel()
    m = maxabs(u)
    m_host = float(m)
    a = u.abs()
    return (lambda: histogram(u, m), lambda: ref.hist_counts(u, m),
            lambda: torch.histc(a, bins=256, min=0.0, max=m_host),
            4 * n + 4 + 4 * 256, 3 * n)


def phase_timings(gen, main_u) -> dict:
    """The LGC kernels at the largest leaf and at embed (Gaussian u), the
    histogram also on the main path's real u and on a constant vector, and
    maxabs forming u = e + x (``sum_maxabs``) against the add and maxabs
    apart; at the simulator's sizes (lr, cnn) with its budget, maxabs as
    the path calls it: ``sum_maxabs``."""
    import itertools
    import torch
    from repro_torch.core.fl import baseline_ks
    from repro_torch.device import device_ms
    from repro_torch.kernels import maxabs, ref, sparsify_ef, sum_maxabs
    rows: dict = {}
    c_n = 3
    recv = torch.tensor([1, 1, 1], dtype=torch.int32, device="cuda")
    for n in (LARGEST_LEAF, EMBED, CNN_D, LR_D):
        x = torch.randn(n, generator=gen, device="cuda") * 1e-3
        e = torch.randn(n, generator=gen, device="cuda") * 1e-4
        u = e + x
        m = maxabs(u)
        on_sim_path = n in (CNN_D, LR_D)
        cum = torch.tensor(list(itertools.accumulate(baseline_ks(n)))
                           if on_sim_path else
                           [n // 100, 3 * n // 100, 5 * n // 100],
                           dtype=torch.int32, device="cuda")
        thr = ref.hist_thresholds(ref.hist_counts(u, m), m, cum)
        inf = float("inf")
        cases = {
            "maxabs": ((lambda: sum_maxabs(e, x),
                        lambda: ref.hist_maxabs(ref.ftz_add(e, x)), None,
                        12 * n + 4, 2 * n) if on_sim_path else
                       (lambda: maxabs(u), lambda: ref.hist_maxabs(u),
                        lambda: torch.linalg.vector_norm(u, inf),
                        4 * n + 4, n)),
            "histogram": histogram_case(u),
            "sparsify_ef": (lambda: sparsify_ef(e, x, thr, recv),
                            lambda: ref.hist_layered_sparsify(
                                ref.ftz_add(e, x), thr, recv),
                            None, 16 * n + 8 * c_n, (2 + 4 * c_n) * n),
        }
        for name, case in cases.items():
            rows.setdefault(name, {})[n] = time_row(n, *case)
            if name == "maxabs" and on_sim_path:
                rows[name][n]["call"] = "sum_maxabs"
            log_row("sum_maxabs" if name == "maxabs" and on_sim_path
                    else name, f"D={n}", rows[name][n])
        if n == LARGEST_LEAF:
            row = time_row(n, lambda: sum_maxabs(e, x),
                           lambda: ref.hist_maxabs(ref.ftz_add(e, x)), None,
                           12 * n + 4, 2 * n)
            row["unfused_device_ms"] = device_ms(lambda: maxabs(e + x))
            rows["maxabs"]["sum"] = row
            log_row("sum_maxabs", f"D={n}", row)
            log(f"timing maxabs(e + x), the add apart: "
                f"{row['unfused_device_ms']:.5f} ms device")
    one_bin = torch.full((LARGEST_LEAF,), 1e-3, device="cuda")
    for tag, v in (("main_path_u", main_u), ("one_bin", one_bin)):
        rows["histogram"][tag] = time_row(v.numel(), *histogram_case(v))
        log_row("histogram", tag, rows["histogram"][tag])
    return rows


def phase_time_rows(gen) -> dict:
    """Each LGC row kernel at the paths' (M, D), as the paths call it:
    ``sum_maxabs_rows`` (library: ``vector_norm(u, inf, dim=1)`` on u),
    ``histogram_rows`` (library: M ``histc`` calls), ``sparsify_ef_rows``;
    each beside its plain row version and the M flat launches it
    replaces.  Returns {kernel: {"MxD": row}}."""
    import torch
    from repro_torch.kernels import (histogram, histogram_rows, ref,
                                     sparsify_ef, sparsify_ef_rows,
                                     sum_maxabs, sum_maxabs_rows,
                                     thresholds_from_counts)
    rows: dict = {name: {} for name in ROW_KERNELS}
    inf = float("inf")
    for m, n in ROW_SHAPES:
        e, x, cum = row_inputs(gen, m, n)
        x[1 % m] = torch.randn(n, generator=gen, device="cuda") * 1e-3
        e[1 % m] = torch.randn(n, generator=gen, device="cuda") * 1e-4
        recv = torch.ones((m, 3), dtype=torch.int32, device="cuda")
        u, mx = sum_maxabs_rows(e, x)
        mx_host = mx.tolist()
        a = u.abs()
        thr = thresholds_from_counts(histogram_rows(u, mx), mx, cum)
        c_n, md = 3, m * n
        cases = {
            "maxabs": (lambda: sum_maxabs_rows(e, x),
                       lambda: ref.hist_maxabs_rows(ref.ftz_add(e, x)),
                       lambda: torch.linalg.vector_norm(u, inf, dim=1),
                       12 * md + 4 * m, 2 * md,
                       lambda: [sum_maxabs(e[r], x[r]) for r in range(m)]),
            "histogram": (lambda: histogram_rows(u, mx),
                          lambda: ref.hist_counts_rows(u, mx),
                          lambda: [torch.histc(a[r], bins=256, min=0.0,
                                               max=mx_host[r])
                                   for r in range(m)],
                          4 * md + 4 * m + 4 * 256 * m, 3 * md,
                          lambda: [histogram(u[r], mx[r]) for r in range(m)]),
            "sparsify_ef": (lambda: sparsify_ef_rows(e, x, thr, recv),
                            lambda: ref.hist_layered_sparsify_rows(
                                ref.ftz_add(e, x), thr, recv),
                            None, 16 * md + 8 * c_n * m,
                            (2 + 4 * c_n) * md,
                            lambda: [sparsify_ef(e[r], x[r], thr[r], recv[r])
                                     for r in range(m)]),
        }
        for name, (kern, plain, lib, n_bytes, n_ops, m_flat) in cases.items():
            row = time_row(n, kern, plain, lib, n_bytes, n_ops, m_flat)
            row["shape"] = [m, n]
            rows[name][f"{m}x{n}"] = row
            log_row(f"{ROW_KERNELS[name]}", f"(M, D)=({m}, {n})", row)
            log(f"timing {m} flat launches of {name} at D={n}: "
                f"{row['m_flat_ms']:.5f} ms one call, "
                f"{row['m_flat_device_ms']:.5f} ms device")
        del e, x, u, a
    return rows


def phase_time_segments(gen) -> dict:
    """The segmented kernels at the simulator's models' (M, D) (cnn M=8,
    lr M=3, rnn M=8), Gaussian u: each beside its plain version, its bound
    and the M x L library calls it replaces (``amax`` of |u| per slice,
    ``histc`` per slice), and for maxabs also one
    ``segment_reduce(|u|, "max")`` over all slices.  Returns {kernel:
    {"MxD": row}}."""
    import torch
    from repro_torch.device import device_ms
    from repro_torch.kernels import (SegmentTable, histogram_segments,
                                     maxabs_segments, ref)
    rows: dict = {name: {} for name in SEGMENT_KERNELS}
    for name, m in SEGMENT_MODELS:
        edges = model_edges(name)
        n, n_l = edges[-1], len(edges) - 1
        pairs = list(zip(edges[:-1], edges[1:]))
        u = segment_inputs(gen, m, edges)
        table = SegmentTable(edges, "cuda")
        mx = maxabs_segments(u, table)
        mx_host = mx.tolist()
        a = u.abs()
        lengths = torch.tensor([[hi - lo for lo, hi in pairs]] * m,
                               device="cuda")
        md = m * n
        cases = {
            "maxabs_segments": (
                lambda: maxabs_segments(u, table),
                lambda: ref.hist_maxabs_segments(u, edges),
                lambda: [a[r, lo:hi].amax() for r in range(m)
                         for lo, hi in pairs],
                4 * md + 4 * m * n_l, md),
            "histogram_segments": (
                lambda: histogram_segments(u, mx, table),
                lambda: ref.hist_counts_segments(u, mx, edges),
                # a slice whose max is 0 bins all in bin 0: histc over
                # [0, 1] does too (over [0, 0] it reads the data's range on
                # the host, a sync)
                lambda: [torch.histc(a[r, lo:hi], bins=256, min=0.0,
                                     max=mx_host[r][i] or 1.0)
                         for r in range(m) for i, (lo, hi) in
                         enumerate(pairs)],
                4 * md + 4 * m * n_l + 4 * 256 * m * n_l, 3 * md),
        }
        for kname, (kern, plain, lib, n_bytes, n_ops) in cases.items():
            row = time_row(n, kern, plain, lib, n_bytes, n_ops,
                           lib_reps=(20, 5, 2))
            row |= {"shape": [m, n], "slices": n_l,
                    "library_calls": m * n_l,
                    "blocks": table.n_blocks * m}
            if kname == "maxabs_segments":
                def seg_max():
                    return torch.segment_reduce(a, "max", lengths=lengths,
                                                axis=1)
                try:
                    same = bits_equal(seg_max(), mx)
                except (RuntimeError, NotImplementedError) as err:
                    log(f"timing {kname}: segment_reduce does not apply "
                        f"({err})")
                else:
                    row |= {"segment_reduce_ms": time_ms(seg_max),
                            "segment_reduce_bitwise_equal": same}
                    try:
                        row["segment_reduce_device_ms"] = device_ms(seg_max)
                    except RuntimeError as err:  # the call waits for the card
                        log(f"timing {kname}: no device time for "
                            f"segment_reduce ({err})")
                        row["segment_reduce_device_ms"] = None
            rows[kname][f"{m}x{n}"] = row
            log_row(kname, f"{name} (M, D)=({m}, {n}), L={n_l}", row)
            log(f"timing {kname} {name}: the library yardstick is "
                f"{m * n_l} calls" + (
                    f"; segment_reduce(|u|, max) {row['segment_reduce_ms']:.5f}"
                    f" ms one call, {row['segment_reduce_device_ms']} ms "
                    f"device" if "segment_reduce_ms" in row else ""))
        del u, a
    return rows


def phase_time_swa(gen, shape=SWA_SERVE_SHAPE, partial: bool = False
                   ) -> dict:
    """swa_decode at a decode shape in bf16, every slot valid (the ring
    after the wrap).  Each call takes the next of four input copies
    (4 x 33.6 MB at the serve shape, beyond the 50 MB L2), as a decode
    step finds a layer's cache cold; ``ms_l2_warm`` repeats one copy;
    ``device_ms_length1`` is the same grid at length 1, the launch's fixed
    cost (its blocks, the merge).  With ``partial``: the partial form
    (``swa_decode_partial``: f32 output, m and l) at a rank's shard of the
    cache, beside ``swa_decode`` at the same shape (``swa_decode_ms``,
    ``swa_decode_device_ms``); the library call computes the output only,
    without the softmax state."""
    import torch
    import torch.nn.functional as F
    from repro_torch.device import device_ms
    from repro_torch.kernels import ref, swa_decode, swa_decode_partial
    b, h, kv, w, dh = shape
    sets = [swa_inputs(gen, shape, torch.bfloat16) for _ in range(4)]
    ln = torch.full((b,), w, dtype=torch.int32, device="cuda")
    one = torch.ones_like(ln)       # the same grid, one slot a row to read
    mask = (torch.arange(w, device="cuda")[None, :]
            < ln[:, None])[:, None, None, :]

    def rotate(f):
        it = iter(range(1 << 30))
        return lambda: f(*sets[next(it) % len(sets)])

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask,
                                              enable_gqa=True)
    fn = swa_decode_partial if partial else swa_decode
    kern = rotate(lambda q, k, v: fn(q, k, v, ln))
    plain = rotate(lambda q, k, v: (ref.swa_decode_partial_ref if partial
                                    else ref.swa_decode_ref)(q, k, v, ln))
    try:
        sdpa(*sets[0])
        lib = rotate(sdpa)
    except TypeError as err:      # a torch without enable_gqa
        log(f"timing swa_decode: no library yardstick ({err})")
        lib = None
    # K and V, q, the output (f32 with m and l in the partial form), length
    out_bytes = b * h * (dh + 2) * 4 if partial else b * h * dh * 2
    n_bytes = 2 * b * kv * w * dh * 2 + b * h * dh * 2 + out_bytes + 4 * b
    n_ops = 4 * b * h * w * dh
    bnd, by = bound_ms(n_bytes, n_ops)
    row = {"shape": list(shape), "dtype": "bfloat16",
           "ms": time_ms(kern), "plain_ms": time_ms(plain),
           "library_ms": time_ms(lib) if lib else None,
           "device_ms": device_ms(kern),
           "library_device_ms": device_ms(lib) if lib else None,
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes,
           "ms_l2_warm": time_ms(lambda: fn(*sets[0], ln)),
           "device_ms_l2_warm": device_ms(lambda: fn(*sets[0], ln)),
           "device_ms_length1": device_ms(lambda: fn(*sets[0], one))}
    name = "swa_decode_partial" if partial else "swa_decode"
    if partial:
        whole = rotate(lambda q, k, v: swa_decode(q, k, v, ln))
        row |= {"swa_decode_ms": time_ms(whole),
                "swa_decode_device_ms": device_ms(whole),
                "library_computes": "the output only (no m, l)"}
    log(f"timing {name} (B,H,Kv,W,Dh)={shape} bf16: kernel "
        f"{row['ms']:.5f} ms one call, {row['device_ms']:.5f} ms device "
        f"({row['device_ms_l2_warm']:.5f} ms with the inputs in L2, "
        f"{row['device_ms_length1']:.5f} ms at length 1); plain "
        f"{row['plain_ms']:.5f} ms; library {row['library_ms']} ms one "
        f"call, {row['library_device_ms']} ms device; bound {bnd:.5f} ms "
        f"({by}, {n_bytes:,} B)" + (
            f"; swa_decode at this shape {row['swa_decode_ms']:.5f} ms one "
            f"call, {row['swa_decode_device_ms']:.5f} ms device"
            if partial else ""))
    return row


def phase_time_threefry() -> dict:
    """threefry_normal at the first of ``THREEFRY_CASES`` (one layer of
    yi-34b's ``w_up``) beside its plain version; no library call draws
    these numbers.  The bound: the output written once against
    ``THREEFRY_OPS`` operations an element."""
    import torch
    from repro_torch.core import prng
    from repro_torch.device import device_ms
    from repro_torch.kernels import ref, threefry_normal
    shape, dt, std = THREEFRY_CASES[0]
    dtype = getattr(torch, dt)
    out = torch.empty(shape, dtype=dtype, device="cuda")
    key = prng.PRNGKey(0)
    n = out.numel()
    n_bytes = n * out.element_size()
    bnd, by = bound_ms(n_bytes, n * THREEFRY_OPS)
    row = {"shape": list(shape), "dtype": dt,
           "ms": time_ms(lambda: threefry_normal(out, key, std)),
           "plain_ms": time_ms(lambda: ref.threefry_normal_ref(
               key, shape, std, dtype, "cuda"), reps=3, warmup=1),
           "library_ms": None,
           "device_ms": device_ms(lambda: threefry_normal(out, key, std)),
           "bound_ms": bnd, "bound_by": by, "bytes": n_bytes,
           "ops": n * THREEFRY_OPS}
    log(f"timing threefry_normal {shape} {dt}: kernel {row['ms']:.5f} ms one "
        f"call, {row['device_ms']:.5f} ms device; plain {row['plain_ms']:.3f}"
        f" ms; bound {bnd:.5f} ms ({by}); {n / row['device_ms'] / 1e6:.1f} G "
        f"elements/s")
    return row


# ---------------------------------------------------------------------------
# phase 8 in a process of its own, beside phases 5c-7d
# ---------------------------------------------------------------------------

# Phase 8 needs nothing of phases 5c-7d, so it runs in a spawned process
# started before 5c and joined after 7d, with PHASE8_THREADS intra-op
# threads (its CPU runs): the script's wall time is the longer of the two
# instead of their sum.  Both share the card and the host's cores, so the
# host ms and device times that 5c-7d and phase 8 print are taken beside
# each other's work; phase 9's timings run alone, after the join.
PHASE8_THREADS = 2


def phase8_body(smi: str) -> dict:
    """Phase 8: the PRNG, the simulator, the per-layer budgets, the
    servers, the control plane, the population and the sharded engine,
    with their own clock; returns their launch counts and the ``sharded``
    record."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(PHASE8_THREADS)
    t0 = time.perf_counter()

    def done(what: str) -> None:
        log(f"clock: phase 8, {what} done at {time.perf_counter() - t0:.1f} "
            f"s of phase 8's process")
    phase_prng()
    sim_launches = phase_simulator(smi)
    done("simulator")
    per_layer_launches = phase_per_layer(smi)
    done("per-layer")
    phase_server(smi)
    done("servers")
    sim_launches |= phase_control(smi)
    done("control")
    pop_launches = phase_population(smi)
    done("population")
    sharded = phase_sharded(smi)
    done("sharded")
    return {"sim": sim_launches, "per_layer": per_layer_launches,
            "population": pop_launches, "sharded": sharded}


def _phase8_process(conn, smi: str) -> None:
    """The spawned process: phase 8's record, or the traceback of its
    failure, back through ``conn``."""
    try:
        sys.path.insert(0, str(ROOT / "src"))
        conn.send(("ok", phase8_body(smi)))
    except BaseException:
        import traceback
        conn.send(("failed", traceback.format_exc()))
    finally:
        conn.close()


def start_phase8(smi: str) -> tuple:
    """Phase 8's process, started; it is killed at exit if still alive
    (a failure elsewhere ends the run without waiting for it)."""
    import atexit
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_phase8_process, args=(send, smi),
                       name="chip_smoke phase 8")
    proc.start()
    send.close()

    def stop() -> None:
        if proc.is_alive():
            proc.kill()
            proc.join()
    atexit.register(stop)
    return proc, recv


def join_phase8(handle: tuple) -> dict:
    """Phase 8's record; raises if its process failed or died."""
    proc, recv = handle
    try:
        status, value = recv.recv()
    except EOFError:
        status, value = "failed", "it ended without a record"
    proc.join(timeout=120)
    if proc.is_alive():
        proc.kill()
        proc.join()
    check(status == "ok", f"phase 8's process (exit code {proc.exitcode}) "
          f"failed: {value}")
    return value


def main(argv: list[str]) -> int:
    # growable segments: yi-34b's serve (at 60 layers, 64.05 GiB of weights
    # and a 75.4 GiB peak) runs after phases whose freed blocks would otherwise split the
    # card's last free GiBs (an out-of-memory error at its prefill's
    # 1.71 GiB logits chunk with 3.04 GiB reserved and unused)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if argv not in ([], ["--rows"], ["--sharded"], ["--swa-digests"],
                    ["--family-training"], ["--model-axis"],
                    ["--model-axis-faults"]):
        print(f"usage: python3 chip_smoke.py [--rows | --sharded | "
              f"--swa-digests | --family-training | --model-axis | "
              f"--model-axis-faults]; got {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import card_name_and_power_limit
    from repro_torch.kernels import _build

    # parity runs keep TF32 off (the defaults for matmul, set explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_name_and_power_limit()
    kind = torch.cuda.get_device_name(0)
    log(smi)                      # the card's name and power limit
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    so = _build.build()
    log(f"build: {so.name} in {time.perf_counter() - t0:.1f} s "
        f"({'cached' if not _build.build_log else 'compiled'})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            log(f"  ptxas: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if argv == ["--rows"]:      # the row kernels at the sparse path's rows
        print(json.dumps({"sparse_rows": time_sparse_rows(gen),
                          "sweep": sweep_row_forms(gen)}), flush=True)
        return 0
    if argv == ["--swa-digests"]:   # SWA_DIGESTS of this checkout's kernel
        print(json.dumps({"made_on": swa_digests_made_on(),
                          "digests": swa_digests()}), flush=True)
        return 0
    if argv == ["--sharded"]:   # the sharded engine alone
        phase_sharded(smi)
        return 0
    if argv == ["--family-training"]:   # phase 5c alone
        phase_family_training(smi, {k: 0.0 for k in TPU_KERNELS})
        return 0
    if argv == ["--model-axis"]:        # phase 5d alone
        phase_model_axis(smi)
        return 0
    if argv == ["--model-axis-faults"]:     # the readings behind its limit
        model_axis_faults(smi)
        return 0
    errs = {k: 0.0 for k in (*TPU_KERNELS, *SEGMENT_KERNELS,
                             "threefry_normal", "swa_decode_partial")}

    def done(what: str) -> None:   # the run's clock at each phase's end
        log(f"clock: {what} done at {time.perf_counter() - t0:.1f} s")
    phase_kernels(gen, errs)
    done("phase 2")
    phase_swa(gen, errs)
    phase_swa_partial(gen, errs)
    phase_swa_cross_heads(gen, errs)
    phase_threefry(errs)
    done("phase 3")
    phase_small_trainer()
    launches, main_u, dense_steps_per_s = phase_main_path()
    flaky_launches = phase_main_path_scenario(smi)
    done("phases 4-5")
    sparse_launches = phase_sparse_uplinks(smi, dense_steps_per_s)
    done("phase 5b")
    phase8 = start_phase8(smi)         # beside 5c-7d, joined after 7d
    family_training = phase_family_training(smi, errs)
    done("phase 5c")
    model_axis = phase_model_axis(smi)
    done("phase 5d")
    phase_small_serve()
    done("phase 6")
    serving = phase_serve(smi)
    done("phase 7")
    families = phase_families(smi)
    done("phase 7b")
    modalities = phase_modalities(smi)
    done("phase 7c")
    configs = phase_configs(smi)
    done("phase 7d")
    p8 = join_phase8(phase8)
    done("phase 8 (joined)")
    sim_launches, per_layer_launches = p8["sim"], p8["per_layer"]
    pop_launches, sharded = p8["population"], p8["sharded"]
    rows = phase_timings(gen, main_u)
    row_times = phase_time_rows(gen)
    seg_times = phase_time_segments(gen)
    done("phase 9, LGC kernels' timings")
    swa_row = phase_time_swa(gen)
    swa_family_rows = {arch: phase_time_swa(gen, shape)
                       for arch, shape in SWA_FAMILY_SHAPES.items()}
    swa_modality_rows = {arch: phase_time_swa(gen, shape)
                         for arch, shape in SWA_MODALITY_SHAPES.items()}
    swa_config_rows = {arch: phase_time_swa(gen, shape)
                       for arch, shape in SWA_CONFIG_SHAPES.items()}
    swa_partial_row = phase_time_swa(gen, SWA_PARTIAL_SHAPES[0],
                                     partial=True)
    swa_partial_shards = {arch: phase_time_swa(gen, shape, partial=True)
                          for arch, shape in SWA_PARTIAL_SHARDS.items()}
    swa_cross_row = time_swa_cross_heads(gen)
    threefry_row = phase_time_threefry()
    done("phase 9, timings")

    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "max_abs_err": errs[name]}
        if name in LGC_KERNELS:        # the training path's kernels
            rn = ROW_KERNELS[name]
            big = rows[name][LARGEST_LEAF]
            row |= {"launches": launches[name] + launches[rn],
                    "launches_by_form": {"flat": launches[name],
                                         "rows": launches[rn]},
                    "launches_gilbert_flaky": flaky_launches[name]
                    + flaky_launches[rn]} | big | {
                "at_embed": rows[name][EMBED]}
            if name == "histogram":
                row |= {"at_main_path_u": rows[name]["main_path_u"],
                        "at_one_bin": rows[name]["one_bin"]}
            if name == "maxabs":
                row["at_sum"] = rows[name]["sum"]
            row["launches_family_training"] = {
                arch: f["launches"][name] + f["launches"][rn]
                for arch, f in family_training.items()}
            # each rank's row launches over phase 5d's 4 rounds, and over
            # (e)'s rounds of the ssm and hybrid families
            row["launches_model_axis"] = model_axis["launches"][name]
            for key in MODEL_AXIS_PART_KEYS.values():
                row[f"launches_model_axis_{key}"] = {
                    arch: a["launches_rows"][rn]
                    for arch, a in model_axis[key].items()
                    if isinstance(a, dict) and "launches_rows" in a}
            if name != "sparsify_ef":
                row["launches_sparse_gather"] = sparse_launches[rn]
                row["at_sparse_gather_rows"] = sparse_launches["timing"][
                    "rows"][name]
                # device ms of each form at SWEEP_FLOATS floats of rows
                calls = (("sum_maxabs_rows", "maxabs_rows")
                         if name == "maxabs" else ("histogram_rows",))
                row["row_form_sweep"] = [
                    {"shape": [v["rows"], v["n"]],
                     "picked": v["picked" if name == "maxabs"
                                 else "picked_histogram"],
                     "wide_launches": v["wide_launches"]}
                    | {c: v[c] for c in calls}
                    for v in sparse_launches["timing"]["sweep"].values()]
            row |= {"launches_simulator": {
                        tag: c[name] + c[rn]
                        for tag, c in sim_launches.items()},
                    "launches_population": {
                        tag: c[name] + c[rn]
                        for tag, c in pop_launches.items()},
                    "launches_sharded": {
                        f"world1 {red}": sharded["world1"][red]["launches"][
                            name] for red in ("gather", "psum")} | {
                        f"world2 {tag} (ranks summed)":
                            c["launches_summed"][name]
                        for tag, c in sharded["world2"]["cases"].items()},
                    "at_cnn_mnist": rows[name][CNN_D],
                    "at_lr_mnist": rows[name][LR_D]}
            # the row form at each path's (M, D), with that path's launches
            path_launches = (
                sim_launches["lr_mnist lgc batched"][rn],
                sim_launches["cnn_mnist lgc batched"][rn],
                sim_launches["rnn_shakespeare lgc mobile_noniid batched"][rn],
                launches[rn])
            for (m, n), k in zip(ROW_SHAPES, path_launches):
                row_times[name][f"{m}x{n}"]["launches"] = k
            row["rows"] = row_times[name]
        else:                          # the serving paths' kernel
            row |= {"launches": serving["launches"][name]} | swa_row | {
                "launches_families": {
                    arch: f["launches"][name] for arch, f in families.items()},
                "at_families": swa_family_rows,
                "launches_modalities": {
                    arch: f["launches"][name]
                    for arch, f in modalities.items()},
                "at_modalities": swa_modality_rows,
                "launches_configs": {
                    arch: f["launches"][name] for arch, f in configs.items()},
                "at_configs": swa_config_rows,
                # phase 5d (g): the plain form over a rank's heads of
                # whisper-small's cross cache, fed and entry runs, a rank
                **axis_serve_launch_rows(model_axis, "swa_decode",
                                         ("audio",)),
                "at_whisper_cross_heads": swa_cross_row}
        kernels.append(row)
    # the segmented forms: their path is the per-layer runs (the batched
    # CNN run under size_prop for ``launches``), timed at the CNN's (M, D)
    cnn = f"{SEGMENT_MODELS[0][1]}x{CNN_D}"
    for name, (form_of, source, replaces) in SEGMENT_KERNELS.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "form_of": form_of,
               "max_abs_err": errs[name],
               "launches": per_layer_launches[
                   f"{PER_LAYER_RUN[0]} size_prop batched"][name],
               "launches_per_layer": {tag: c[name] for tag, c in
                                      per_layer_launches.items()}}
        row |= seg_times[name][cnn] | {"at": seg_times[name]}
        kernels.append(row)
    # swa_decode's partial form: its path is phase 5d's serving job at
    # P = 2 (``launches``: rank 0's free run through serve_decode.serve),
    # timed at a rank's shard of the 4,096-slot serve cache
    serve = model_axis["serve"]
    kernels.append({
        "name": "swa_decode_partial", "route": "cuda",
        "source": TPU_KERNELS["swa_decode"][0],
        "replaces": TPU_KERNELS["swa_decode"][1], "form_of": "swa_decode",
        "max_abs_err": errs["swa_decode_partial"],
        "launches": serve["free"]["launches"]["swa_decode_partial"],
        "launches_model_axis_serve": {
            key: r["launches"]["swa_decode_partial"]
            for key, r in serve["runs"].items()},
        # phase 5d (e), (f) and (g): each arch's fed run (8 steps) and
        # its serve_decode.serve(mesh=) run, a rank
        **axis_serve_launch_rows(model_axis, "swa_decode_partial"),
        "at_zamba2_shard": swa_partial_shards["zamba2-1.2b"],
        "at_olmoe_shard": swa_partial_shards["olmoe-1b-7b"],
        "at_phi3v_shard": swa_partial_shards["phi-3-vision-4.2b"],
        "at_whisper_shard": swa_partial_shards["whisper-small"]}
        | swa_partial_row)
    # the weights' draw: the port's own kernel, with no Pallas counterpart
    # (the reference's jax.random.normal draw is at ``replaces``)
    kernels.append({
        "name": "threefry_normal", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/threefry_normal.cu",
        "replaces": "src/repro/models/layers.py:257",
        "max_abs_err": errs["threefry_normal"],
        "launches": serving["draw_launches"],
        "launches_families": {arch: f["draw_launches"]
                              for arch, f in families.items()},
        "launches_modalities": {arch: f["draw_launches"]
                                for arch, f in modalities.items()},
        "launches_configs": {arch: f["draw_launches"]
                             for arch, f in configs.items()}} | threefry_row)
    # every TPU kernel of the repo is in TPU_KERNELS: none is left to port
    print(json.dumps({"kernels": kernels, "not_ported": []}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
