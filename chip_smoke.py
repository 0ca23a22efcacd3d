#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's serving and training paths on one CUDA
card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels build for sm_90a) and `nvcc`.
Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. device: the card's name and power limit.
2. build: compile the port's CUDA sources with nvcc.
3. K5 (paged KV append) against its plain PyTorch version at the
   Llama-3-8B KV shape, bf16 / f32 / int8: pools bit-equal outside the
   scratch block.
4. K6 (paged decode attention) against its plain version at H=32,
   KV=8, hd=128, BS=16, B in {8, 32}, ragged positions up to 1024,
   shuffled tables; timed at B=32, bf16, beside its bound and SDPA over
   the same KV gathered dense, with K6's split plan; then at hd 1,032
   (the wide-head kernel) and at tables of 65,540 blocks (splits past
   the 1,024 staged table entries), f32 and bf16, the fused append +
   attention there too.  The decode step launches neither K5 nor K6 on
   its own, so their launch counts on the kernels line are these
   checks'.
5. main path: Llama-3-8B at full width and depth (bf16, random weights
   from a seed) served by `LlamaEngine` to 8 concurrent requests, three
   of them sharing a 64-token prefix, its decode chunks replayed from
   one CUDA graph a gather width (each width's capture ms, split into
   prepare / record / instantiate, its reserved device bytes, the host
   memory and CPU seconds it took, and its replays; the same for the
   throwaway engine that precedes it, whose captures are the process's
   first; the engine's admit / dispatch / harvest seconds); the kernel launch
   counts of that run (32 fused append + attention launches a decode
   step, replays counted, no K5 or K6 of their own; every chunk stepper
   a captured graph, at least one replay); decode_step_paged (kernels) against decode_step_vec
   (dense) at a mid-decode state; K5/K6 timed at the main path's shapes
   (K6 with the L2 cold and warm, beside its bound and SDPA, with its
   split plan).  K5K6_fused_vs_pair: the fused op (K5 folded into K6's
   launch) against K5 then K6 on cloned pools, bit-equal (outputs, and
   pools outside the scratch block), and against its plain version, in
   f32, bf16 and int8 at the mid-decode state and at B 32 with rows to
   1,024; timed beside K5 then K6, K6 alone and an empty kernel.
6. graph vs eager: the mid-decode state loaded into an idle engine (bf16
   KV, and int8 KV quantized from it): the chunk replayed from its CUDA
   graph bit-equal to the eager chunk (token rows, tokens, positions,
   whole pools), twice; both timed, with the capture's ms and bytes.
6b. perf_plane (decode_full_width): the perf harness's decode rows at
   the main path's width, before its model is freed: two engines over
   its params, one after the other (slots 8, chunk 8, block 16, max_len
   512, prefix cache off, the kernel route then the gather route), each
   driven by `perf._engine_run` through the main path's 8 prompts with
   32 new tokens, a warm-up run (every width's capture) and then the
   measured run: `decode_b8_kernel` and `decode_b8_gather` shaped as
   `perf.measure_decode_kernel` shapes its rows.  Held: the reference
   test's decode gates (kernel ticks and no fallback ticks on the kernel
   row, the reverse on the gather row, equal ticks), the measured run's
   fused launches = 32 x 8 x its dispatches on the kernel row and none
   on the gather row, no K5 or K6 of their own, no capture inside a
   measured run.
7. tiny parity: a tiny f32 engine on the card gives `generate`'s greedy
   tokens exactly.
8. serve plane: the driver's Llama-3-8B is freed, the port's runtime
   boots one node (its GPU count detected, not given), and
   `ContinuousLlamaService` (Llama-3-8B, slots 8, chunk 8, block 16)
   is deployed as a `num_gpus=1` replica actor through `serve.run`;
   HTTP POSTs go through the proxy and router to it: one POST carrying
   the main path's 8 prompts (in the same order), then 8 concurrent
   single-prompt POSTs.  Held: every answer well formed, the replica
   took the kernel route only, and its fused append + attention
   launches (read from the replica: the driver's counters cannot see
   another process) equal L x chunk x its decode dispatches, with no K5
   or K6 of their own, and its chunk steppers are captured graphs, at
   least one replayed (held as the main path's; with its tick phases,
   and the CPU cores the replica's process kept busy over each window
   and over 2 s with no request in flight).  Then a tiny replica with f32 compute answers
   over HTTP with `generate`'s greedy tokens exactly.  HTTP wall time,
   tokens/s, per-request latency, the engine's TTFT and the replica's
   start-up seconds are recorded.
9. K1-K4 (flash attention forward, fused backward, split dQ and dK/dV)
   against their plain versions at the training shape (BH 32*12, T
   1024, D 64) and at Llama's head width (BH 64, T 512, D 128), causal
   and full, f32 and bf16, plus a ragged T of 1000 (bf16, causal, D 64
   and 128), the train plane worker's shape (BH 64, T 1,024, D 128) and
   a pipeline_1f1b stage's (BH 32, T 1,024, D 128), causal, f32 and
   bf16, and heads of 712 and 1,032 (f32 and bf16, BH 2, T 256: the
   first design cut into column slices): element by element and by the
   relative norm of the difference.
10. training main path: GPT-2 124M at full width and depth (bf16 compute,
   f32 master weights, flash attention, full remat, bf16 logits),
   batch 32 x 1024, through `make_train_step`: 2 warm-up steps, then 5
   timed steps with the launch counts of exactly those steps (12 layers
   x (forward + remat replay) K1 and 12 K2 a step, no K3/K4, no plain
   dispatch); at full size, the step-0 loss and the gradients of the
   attention weights on the flash and dense routes.
11. split route: the flash op at the training shape with blocks of 256,
   and at the reference's own split route (default blocks of 1,024 at T
   4,096, B 1, H 32, D 128: Llama-3-8B's head width), forward and
   backward, so K3 + K4 run once each per case (their launch counts are
   these runs', summed in the kernels line), against dense attention's
   autograd in f32.
12. route parity: tiny GPT-2 in f32, 3 train steps on the flash kernels
    against 3 on dense attention from the same params and tokens.
13. Llama LoRA training: `scripts/train_llama_lora.py` at the JAX
    bench's `bench_llama_lora` size (1.26e9 params, dim 2,048, 22
    layers, head width 128, 8 x 1,024 tokens, flash, full remat, frozen
    bf16 base, rank-8 LoRA on wq wk wv wo, adamw(2e-4)): the flash
    route's step-0 loss and LoRA-B gradients against the dense route's
    at 4 layers (the train line's limits), 1 warm-up + 6 timed steps
    with the launches of exactly those steps (22 x 2 K1 and 22 K2 a
    step, no K3 / K4, no plain dispatch), step-0 loss within 0.5 of ln
    32,000, the loss falling; K1 / K2 held and timed at that shape (BH
    128, T 1,024, D 128) beside SDPA and their bounds.
13b. train plane: `CudaTrainer(dp_train_loop).fit()` in collective mode
    with two workers sharing the card (`GPU` 0.5, `CPU` 1 each), each
    running the LoRA step of 13, at 4 of its 22 layers, on its 4 x
    1,024 half of the global batch, the adapters' gradients (524,289
    f32 values: the ring path
    of the object plane) mean-allreduced through
    `cuda_utils.sync_gradients` before every AdamW update, rank 0
    checkpointing every step: 3 steps, then a second `fit` resumed from
    the last checkpoint for 1 more.  Held: both ranks' adapters
    bit-equal after every step; the first synced gradient against one
    process's gradient on the whole batch (computed here after the
    trainer shut down; relative norm 3e-2); step-0 loss within 0.5 of
    ln 32,000 and falling; 8 K1 and 4 K2 launches a step in each
    worker (each worker's counts set to 0 before a step and read after
    it), no plain dispatch; the resumed workers start at the
    checkpoint's step with its adapters.  Recorded: the global step ms
    and tokens/s, the sync's device-to-host / allreduce / host-to-device
    ms, each worker's peak memory, the trainer's start-up s.  Then
    `torch_distributed`: one `num_gpus=1` worker joins an NCCL group,
    builds its `DeviceMesh` on `cuda` and takes one step, whose loss
    equals the one-process step's.
13c. sharded_train: four gloo ranks (this script, `--shard-rank`) share
    the card (NCCL refuses two ranks on one GPU) in an fsdp 2 x tp 2
    mesh.  GPT-2 124M at full width and depth (the train main path's
    config: flash, bf16 on f32 master, full remat, `default_optimizer`)
    through `make_train_step` on DTensor params (`shard_params`), the
    moments placed by `optimizer_shardings`, the batch (global 8 x
    1,024) by `prepare_batch`: 1 + 2 steps.  Held: step-0 loss within
    0.5 of ln 50,257 and falling; step-0 loss within 2e-2 and the
    pre-clip gradient norm within 3e-2 (relative) of one process's step
    on the same weights and batch; 24 K1 and 12 K2 a step a rank, every
    one on its local [4 x 6, 1,024, 64] block, no plain dispatch; every
    collective through the host (gloo), and the c10d ops of step 0 only
    those (no functional collective of DTensor's).  The state is saved
    sharded after step 2, loaded onto fsdp 4 x tp 1 in the same ranks
    (params' global norm within 1e-6 relative, the step count kept) and
    steps once more.  Then the LoRA bench's width at 4 layers (bf16
    frozen base, rank-8 adapters, both sharded): one step, its loss
    within 2e-2 of one process's, 8 K1 and 4 K2 a rank on [4 x 8,
    1,024, 128] blocks.  Recorded: step ms, tokens/s, each rank's peak
    memory, calls / bytes / ms in collectives by op and route,
    start-up s.  Then sp_attention on the same
    ranks over dp 2 x sp 2: `ring_attention` and `ulysses_attention` at
    B 8, T 1,024, H 16, D 128, f32 and bf16, causal and not, against
    `plain_attention` on the whole sequence (f32 1e-5, bf16 2e-2); the
    gradient of a sum through the ring against dense (1e-4);
    `llama.loss_fn` with attention "ring" over the mesh at 4 layers
    against dense (2e-2); with the backend and how each collective's
    bytes travelled (gloo: through the host).  Then sharded_sp,
    sequence parallelism inside the sharded step on the same ranks:
    (a) GPT-2 124M (the config above, `default_optimizer` without its
    warm-up) on DTensor params over tp 2 x sp 2, each rank computing on
    its 512-token half of the sequence, with attention "ring" for 1 + 1
    steps, then "ulysses" for one step from the same weights; each
    step-0 loss within 2e-2 and pre-clip gradient norm within 3e-2
    (relative) of one process's step on the same weights and batch with
    dense attention, the ring's loss falling, no K1-K4 launch and no
    plain dispatch (the reference's ring and Ulysses are plain
    blockwise attention), every collective through the host, the
    ring's ppermutes, Ulysses' all_to_alls and the sums among them;
    (b) the LoRA width at 4 layers over dp 2 x sp 2 with "ring", one
    step, its loss within 2e-2 of one process's; (c) the multichip dry
    run (`ray_tpu_torch.dryrun.dryrun_multichip(4)` in f32: GPT-2 over
    tp 2 x sp 2 with the ring, `pipeline_apply` over pp 4, Mixtral's
    step over ep 4, `dryrun_multislice(2, 2)`), each loss finite and
    within 1e-5 relative of one process's on the same draws (Mixtral's:
    the local path on each ep rank's batch shard, averaged), the
    pipeline's output within 1e-5 of its stages in series; on rank 0
    `dryrun.entry()`'s GPT-2 124M forward, finite logits [4, 512,
    50,257].  Recorded:
    step ms, tokens/s, collectives' calls / bytes / ms, each rank's peak
    memory.  Then sharded_moe on the same ranks: Mixtral-8x7B's widths
    (`MixtralConfig.mixtral_8x7b`: vocab 32,000, dim 4,096, 32 / 8
    heads, expert hidden 14,336, 8 experts, top-2, capacity 1.25;
    flash, remat, bf16 on f32 master, adamw(3e-4), seed 0) at depth 1,
    global batch 4 x 1,024, through `make_train_step` on DTensor params
    over ep 2 x tp 2 (1 + 1 steps) and ep 2 x fsdp 2 (one step): the
    experts split over ep, each ep rank's ranks routing their chunk of
    the batch with its capacity and exchanging the slots with
    all_to_all.  Held: the step-0 loss within 2e-2 and the pre-clip
    gradient norm within 3e-2 (relative) of one process's step on the
    same draws that routes each ep chunk of the batch on its own
    (`chunk_routed`); the load-balance loss in (0.5, 2.0); over ep 2 x
    tp 2 the step-0 flash loss within 2e-2 of dense attention's under
    the same mesh; 2 K1 and 1 K2 a step a rank on its local [32, 1,024,
    128] block, no plain dispatch; every collective through the host,
    all_to_all among them.  Recorded: step ms, tokens/s, collectives'
    calls / bytes / ms by op, each rank's peak memory.
13c'. data_ingest: 16 `.npz` files of 1,024 rows (int32 tokens [1,025]
    uniform in [0, 32,000) from `default_rng(0)`, int64 `row_id`; 67.2
    MB) written to a temp directory, then `read_numpy` -> `map_batches`
    (the user's transform: tokens int32 and contiguous, a per-row int64
    `digest`) -> `random_shuffle(seed=0)` into
    `CudaTrainer(ingest_train_loop, datasets={"train": ds})` with two
    collective-mode workers sharing the card (`GPU` 0.5, `CPU` 1 each),
    each taking 4 rows a step through `iter_cuda_batches` at the LoRA
    bench's width at 4 of its 22 layers for 3 steps.  Held: every batch on the card, int32
    [4, 1,025], its digest recomputed there; every (row_id, digest) pair
    against the driver's own corpus and no row_id twice; both ranks'
    adapters bit-equal after every step; the step-0 synced gradient
    within relative norm 3e-2 of one process's on the same 8 rows; the
    step-0 loss within 0.5 of ln V + s^2 / 2; 8 K1 and 4 K2 a step a
    worker, no plain dispatch.  Recorded: step ms, tokens/s, the ingest
    wait (ms inside `next()`, steady median / max and its share of the
    step), `first_batch_s` (the shuffle's barrier), the dataset's MB and
    the spill directory's bytes, each worker's peak memory, start-up s.
13c''. tune_trainer: the same corpus after `read_numpy` ->
    `map_batches`, the same width with depth cut to 4 layers, through
    `Tuner(CudaTrainer(...))` over `lr` in {1e-4, 1e-3}, two one-worker
    trials at once (`GPU` 0.5, `CPU` 1 a worker; `CPU` 0.5 a trial), 3
    steps of 4 x 1,024 tokens each.  Held: both trials TERMINATED, no
    errors; each trial's step-0 loss within 1e-3 relative of one
    process's on its rows (by row_id); each records its lr and their
    adapters differ after step 1; `get_best_result("loss", "min")` is
    the trial with the lower last loss; the trials' step windows
    overlap; 8 K1 and 4 K2 a step a trial.  Each phase fails past a
    wall-clock limit (a resource deadlock shows up as a hang).
13d. compiled_dag: the port's runtime boots again; two `num_gpus=0.5`
    actors form a compiled chain `a.hop(inp) -> b.hop(...)` carrying a
    CUDA bf16 tensor [8, 1,024, 4,096] (64 MB: spilled past the 128 KiB
    slot into one store object a hop) and a dict of small f32 / int8
    CUDA tensors (inline in the slot): each arrives bit-equal, in its
    dtype, on the reader's card (each hop checks it got CUDA tensors);
    ms an execute over 5 calls and the route of each payload.
13e. mixtral_train: Mixtral-8x7B's full width (vocab 32,000, dim 4,096,
    32 / 8 heads, expert hidden 14,336, 8 experts, top-2, capacity 1.25)
    with its depth cut to 2 layers (2.23e9 params: f32 params,
    gradients and AdamW moments take 35.6 GB), flash attention, full
    remat, bf16 compute on f32 master params, adamw(3e-4), batch 4 x
    1,024 on one batch: the flash route's step-0 loss (2e-2 relative)
    and `wq` / `moe_w_in` gradients (relative norm 3e-2) against the
    dense route's; 1 warm-up + 5 timed steps with the launches of
    exactly those steps (4 K1 and 2 K2 a step, no K3 / K4, no plain
    dispatch); step-0 CE within 0.5 of ln 32,000, load-balance loss in
    (0.5, 2.0), the loss falling; step ms, tokens/s, MFU (6 x active
    params a token over 989 TFLOP/s), peak memory, and one profiled
    step split into K1, K2, GEMMs, the scatter-gathers, elementwise
    work and AdamW.
13f. moe_ep: the MoE layer at Mixtral's widths (bf16) over `ep` 2 on
    two gloo ranks sharing the card (this script, `--moe-rank`), global
    x [2, 1,024, 4,096]: output against the reference's oracle (the
    local path on each batch shard alone) at sp_attention's bf16 limits,
    the gradients of the router, both expert weights and x through both
    all_to_alls against the oracle's at relative norm 3e-2; a forward
    and a backward timed, with how each collective's bytes travelled.
13g. pipeline_1f1b: `compile_pipeline` with 2 stage actors on the card
    (`num_gpus` 0.5), each one Llama-3-8B block at full width (flash,
    bf16 compute, f32 params of 0.87 GB), 4 microbatches of 1 x 1,024
    (8 MB activations, spilled past the slot), loss mean(y^2): loss (1e-2
    relative) and each stage's gradients (relative norm 3e-2) against
    one process's serial autograd over the same two blocks with dense
    attention; ms of one timed execute after the warm-up one, the bytes
    through the channels, the bubble model's
    (S-1)/(M+S-1), and each stage's K1 / K2 launches over the timed
    executes (M each an execute), read in the stage.
13h. rllib_ppo: BASELINE config #3's fleet (`rllib/bench.py`'s
    defaults: CartPole, 8 runners x 16 envs x 64 steps, minibatch
    2,048, 2 epochs, lr 3e-4, seed 0) with the learner on the card, a
    gang of 1, 1 warm-up + 2 iterations in the overlap, sync and
    compiled-DAG rounds: env steps/s, updates/s, the overlap, the
    learner's ms a minibatch (h2d copy, forward + backward, optimizer;
    CUDA events), the weights' device-to-host ms, the card's idle share
    over one more profiled iteration, peak memory.  Held: exact
    accounting and no replacement; the first update on the card against
    the plain CPU learner from the same state and minibatch
    (`RLLIB_TOL`); the runners' weights bit-equal to the learner's.
    Then the reference's learning gate on the card (2 x 8 x 64,
    minibatch 256, 4 epochs, 20 iterations: late > max(40, early +
    15)).  rllib_ppo_pixels: `CatchPixelEnv` at 84 x 84 stacked to 4,
    the default `CNNModule`, 4 runners x 8 envs x 64 steps, minibatch
    512, 4 epochs, sync, 1 + 3 iterations, cuDNN's TF32 on around it:
    the same readings and gate, and a runner's batch MB.
13i. rllib_impala and rllib_appo: the same fleet with each algorithm's
    own defaults (lr 5e-4, minibatch 256; IMPALA's async pipeline with
    4 batches a step at most, APPO's one epoch), the learner on the card
    in a gang of 1, 1 warm-up + 4 iterations + 1 profiled: env steps/s,
    updates/s, the learner's split, the weights' d2h ms, the driver's
    v-trace ms an iteration (numpy), IMPALA's `num_async_batches`, the
    idle share.  Held: exact accounting over the batches the iterations
    consumed, no replacement, the first update against the CPU learner
    (`RLLIB_TOL`), the runners' weights bit-equal to the learner's after
    one blocking sync at the end; then the reference's learning gates
    (2 x 8 x 64, minibatch 256, 25 iterations: late > max(40, early +
    15); IMPALA delivers some iteration from the async pipeline).
    rllib_replay: DQN, discrete SAC and continuous SAC at the shapes and
    gates of the reference's tests, with the no-grad target forward's
    and `_td_targets`' ms (CUDA events), updates/s and the same holds.
    rllib_offline: BC, MARWIL and CQL from datasets made from seeds as
    the reference's tests make them, with their gates.
13j. rllib_multi_agent: multi-agent PPO at the reference test's
    configuration (the coordination game, 2 runners x 200 steps, lr
    3e-3, minibatch 128, 4 epochs, modules `pol_a` / `pol_b`), both
    learners on the card: agent steps/s, each module's updates/s and
    learner split, peak memory, the idle share.  Held: each module's
    first update against the plain CPU learner (`RLLIB_TOL`); every
    iteration's rollouts recomputed from the learners' published
    weights, bit for bit; the reference's gate (15 iterations, late >
    7.0); the shared-policy case (2 x 100 agent steps on one module).
    rllib_dreamer: DreamerV3 on CartPole at `DreamerConfig()`'s widths:
    one world-model and one actor-critic update on the card against the
    CPU from one state, batch and Gumbel noise (losses 1e-5 relative,
    gradients 1e-5 relative norm, params and Adam moments at
    `RLLIB_TOL`); 1 + 3 iterations: each update's device and host ms,
    updates/s, the replay's rows, the policy weights' d2h ms, what the
    updates' host reads cost, the idle share; then the reference test's
    configuration with its gate.  rllib_dreamer_pixels: the reference's
    pixel case (Catch 10 x 5) with its gates over 20 iterations, then
    the default filters at 84 x 84 for 1 + 2 iterations: the updates'
    ms, the decoder's output shape, `decode` against the CPU.
    examples: `ppo_pixels.run` and `mnist.run` on the card with the
    reference tests' gates, each worker's peak memory.
13k. ops_plane: the port's runtime boots with a head of no GPU
    (`num_gpus=0`), the dashboard actor, and `AutoscalerV2` over the
    local provider in a thread (one node type, `gpu_worker`: 4 CPUs,
    `{"GPU": 1}`, at most one node, 5 s idle timeout, a pass every
    0.5 s).  The workflow `gpt2_wf` (make_batch: 8 x 1,025 seeded int32
    tokens on a CPU; train: `num_gpus=1`, GPT-2 124M at full width and
    depth, bf16, flash attention, 3 steps on the card, host values out;
    report: fails on its first run through a flag file) runs through
    `workflow.run_async`; `train`'s pending `{"GPU": 1}` scales the GPU
    node up, and its worker is profiled over `/api/profile` while it
    runs.  `workflow.resume` reruns only `report` and returns the stored
    losses and digest bit for bit.  Held: step-0 loss within 0.5 of ln
    50,257 and falling; 72 K1 and 36 K2 in `train` (24 and 12 a step),
    no plain dispatch; the node advertises `GPU` 1 and `train`'s worker
    sees one device; `train`'s frame in the flamegraph; `/api/timeline`
    equal to `timeline()` with the three steps as complete slices and
    `train`'s worker the profiled one on the GPU node; the node
    terminated after it idles, its daemon gone, no `GPU` left.  Then
    `scripts/train_gpt2.py` as a job (batch 8, 2 steps after 1 warm-up)
    followed to SUCCEEDED, its first warm-up loss held as step 0; a
    second (100,000 steps) stopped after its first line: STOPPED within
    30 s, the card's memory back within 512 MiB; `/api/jobs` lists
    both.  Recorded: scale-up and scale-down s, train's ms a step and
    tokens/s, the workflow's first run and resume s, the job's submit ->
    RUNNING -> SUCCEEDED s, the stop's s and MiB, each endpoint's ms,
    the timeline's event count.
13l. cli_plane: a head that counts the card boots, and the driver
    reads the cluster only through `python -m
    ray_tpu_torch.scripts.cli --address <ready.json>` in subprocesses:
    `status` (`GPU` 1), `list nodes`, `list workers`, `events`,
    `grafana-dashboard`; `job submit --wait` of `scripts/train_gpt2.py`
    (GPT-2 124M, 8 x 1,024, 1 warm-up + 3 steps), `job status`
    SUCCEEDED, `job logs` (step-0 loss within 0.5 of ln 50,257 and
    falling; 96 K1 / 48 K2 counted in the job's process, no plain
    dispatch), `job list`; a long job stopped with `job stop`: STOPPED
    within 30 s, the card's memory back within 512 MiB.  Then
    `util.multiprocessing.Pool(processes=2, ray_remote_args={"num_gpus":
    0.5})` over 8 seeded items, each `flash_attention` forward and
    backward at B 4, H 12, T 1,024, D 64, bf16, causal (one K1 and one
    K2 in a pool worker), through `map` (chunksize 2), `imap_unordered`
    and one `apply_async` with a callback: O / dQ / dK / dV within
    `FLASH_TOL["bf16"]` of the plain versions, two worker pids, one
    device each, the O digests equal across both workers and item 0
    recomputed here.  `memory --json` while the driver holds `rt.put`
    of a 64 MiB bf16 CUDA tensor (a driver-owned object of its bytes);
    `timeline --output` holding the pool's 13 tasks.  Recorded: each
    command's ms, the job's s and steps' ms, the stop's s and MiB, the
    pool's map s and item ms, the timeline's events.  The kernels
    line's K1 / K2 launches add the job's and the pool workers' counts.
13m. perf_plane: the port's perf harness (`ray_tpu_torch.scripts.perf`)
    through `perf.main` in this process, the launch counts set to 0
    before each run and read after it, one line a run (its rows as the
    harness returned them, wall s, launches): `--engine-trace` (24
    requests), `--config decode_kernel` (batches 16, 32, 64),
    `--overload` and `--config obs_overhead` (1,000-task storms, 2
    rounds), all on `--device cuda` with the tiny model; the runtime
    matrix (13 rows, 1 round of 0.3 s) with the storm, the core split
    and busbw; `--config dag_calls` (500 calls); `--config rllib_ppo` at
    the reference test's small shape, the learner a gang of two shards
    on the card.  Then `python -m ray_tpu_torch.scripts.perf
    --engine-trace --engine-requests 12 --json <file>` in a subprocess
    with no `--device`: the card is its default.  Held: the reference
    test's gates of each run; no row holds `"error"`; the decode rows'
    fused launches = L x chunk x (their engines' kernel dispatches + one
    warm-up chunk each kernel-route engine runs when it is built), none
    of K5 or K6 of their own in any run; the JSON file equals the
    subprocess's last line.  The kernels line's fused K5 + K6 launches
    add this phase's.
14. K1-K4 timed at the training shape (bf16, causal), and K3 and K4 at
    the second split shape (BH 32, T 4,096, D 128), beside their bounds,
    plain versions and `scaled_dot_product_attention`, with each
    kernel's achieved TFLOP/s, its time over its bound and over SDPA's
    (forward for K1, backward for K2-K4).
15. K7-K9 (the fused cross entropy's forward, dx and dw) against their
    plain versions at GPT-2 124M's head (N 32,768, E 768, V 50,257;
    bf16 x with the f32 master w, and all f32), at Llama-3-8B's head (N
    4,096, E 4,096, V 128,256, bf16), at a ragged N 200, E 128, V 300
    (f32 and bf16) and at N 130, E 1,032, V 515 (bf16: E wider than a
    K8 / K9 block holds, not a multiple of 64), targets at 0 and V - 1:
    element by element and by the relative norm of the difference;
    K7-K9 timed at Llama's head (E wider than a CTA holds) beside the
    one `torch.matmul` of each kernel's main product.
16. xent main path: `pallas_cross_entropy` forward and backward at
    GPT-2 124M's full head (x = the seeded model's final hidden states
    in bf16, w = the f32 master `wte`, targets = the shifted tokens),
    with the launch counts of exactly that call (K7, K8, K9 once each,
    no plain dispatch); loss, dx and dw against the materialising lse
    form under autograd, and so the row-chunked `fused_cross_entropy`
    (plain PyTorch, f32 products: a yardstick, not a kernel route); all
    three timed forward + backward, each with its peak memory.
17. K7-K9 timed at GPT-2's head (bf16), beside their bounds, plain
    versions and the one `torch.matmul` of each kernel's main product,
    with each kernel's achieved TFLOP/s.
18. the kernels line, the `nvidia-smi` line, and the final result line.

Side groups.  Three groups of phases run each in a process of its own
(this script, `--side <group>`) beside the main sequence, their lines
relayed here as they come.  `rllib` (13h, 13i's IMPALA / APPO, replay
and offline algorithms, the examples) needs none of the port's kernels
and starts with the run; `rllib_last` (13j's multi-agent PPO and
DreamerV3, then data_ingest and tune_trainer) and `graph` (13f, 13g,
then 13d) start once the main path's kernels are timed (after phase 5).
The two rllib groups run at nice 10, and every process they start with
them, so the main sequence's phases take the CPU first.  None of the
groups feeds the kernels line.  A lease on the card (an exclusive
`flock`) keeps the phases that hold 40-55 GB of it (phases 6-6b and the
int8 configurations while Llama-3-8B's params are held, 13c's ranks,
13e) apart from those that hold ~25 (13f, 13g); the rllib groups' phases
hold a few GB at most.  The main sequence waits for the three groups
before 13k: 13k and 13l (their gates read the whole card's used memory)
and 13m (its overhead rows) run alone.  A `sides` line gives each
group's wall s; a `load` line before the processes line gives the
card's used memory (`nvidia-smi` every 0.5 s) and the CPU seconds of
the run's processes by group and by kind (/proc, every second).

Times are medians of CUDA-event timings of device work, with the 50 MB
L2 flushed (a 1 GiB write) before each launch.  Bounds use the H100 SXM's published 3.35 TB/s of
HBM and its dense peaks (989 TFLOP/s bf16, 67 TFLOP/s f32).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import fcntl
import functools
import gc
import json
import math
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import cloudpickle
import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch as rt
from ray_tpu_torch import dryrun
from ray_tpu_torch import serve as rt_serve
from ray_tpu_torch.core import accelerators
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.dag import channel as dag_channel
from ray_tpu_torch.examples.serve_llm import ContinuousLlamaService, _build_model
from ray_tpu_torch.models import gpt2, llama, mixtral
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.ops import paged_attention as pa
from ray_tpu_torch.ops import fused_cross_entropy, pallas_cross_entropy
from ray_tpu_torch.ops import xent_pallas as xp
from ray_tpu_torch.parallel import collectives, moe, pipeline_dag
from ray_tpu_torch.parallel.ring_attention import plain_attention
from ray_tpu_torch.scripts import perf, train_gpt2, train_llama_lora
from ray_tpu_torch.serve.llm_engine import EngineGraph, LlamaEngine, _next_pow2

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PAGED_SRC = "ray_tpu_torch/ops/csrc/paged_attention.cu"
FLASH_SRC = "ray_tpu_torch/ops/csrc/attention.cu"
XENT_SRC = "ray_tpu_torch/ops/csrc/xent.cu"
SOURCES = {"paged_kv_append": PAGED_SRC, "paged_decode_attention": PAGED_SRC,
           "paged_append_decode_attention": PAGED_SRC,
           "flash_fwd": FLASH_SRC, "flash_bwd_fused": FLASH_SRC,
           "flash_bwd_dq": FLASH_SRC, "flash_bwd_dkv": FLASH_SRC,
           "xent_fwd": XENT_SRC, "xent_dx": XENT_SRC, "xent_dw": XENT_SRC}
REPLACES = {"paged_kv_append": "ray_tpu/ops/paged_attention.py:93",
            "paged_decode_attention": "ray_tpu/ops/paged_attention.py:247",
            "paged_append_decode_attention":
                "ray_tpu/ops/paged_attention.py:93 + "
                "ray_tpu/ops/paged_attention.py:247",
            "flash_fwd": "ray_tpu/ops/attention.py:61",
            "flash_bwd_fused": "ray_tpu/ops/attention.py:202",
            "flash_bwd_dq": "ray_tpu/ops/attention.py:143",
            "flash_bwd_dkv": "ray_tpu/ops/attention.py:253",
            "xent_fwd": "ray_tpu/ops/xent_pallas.py:51",
            "xent_dx": "ray_tpu/ops/xent_pallas.py:86",
            "xent_dw": "ray_tpu/ops/xent_pallas.py:114"}
PAGED = ("paged_kv_append", "paged_decode_attention",
         "paged_append_decode_attention")
FLASH = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
XENT = ("xent_fwd", "xent_dx", "xent_dw")
# K6 tolerances: f32 to rounding; bf16 / int8 the reference's own
# (tests/test_paged_attention.py:78-79)
ATTN_TOL = {"f32": 1e-5, "bf16": 2e-2, "int8": 2e-2}
# K1-K4 against their plain versions, two measures per output: element
# by element, |kernel - plain| <= atol + rtol |plain| (as
# torch.testing.assert_close), and the norm of the difference over the
# plain version's norm, which a kernel wrong on a share of its rows
# cannot pass however small those rows' values are.  f32: tiled online
# softmax and tiled sums in another order, K2's dQ summed by f32 atomics
# in an order that changes from run to run.  bf16: P and dS rounded to
# bf16 at other running maxima, outputs rounded to bf16 (one ulp is
# 2^-8 of a value).  The relative-norm limits are about 3x the worst
# readings on an H100 (PERF.md): f32 7.5e-7; bf16 per kernel, K1 2.2e-3
# (P rounded to bf16 at other running maxima), the backward kernels
# 1.5e-4 (P from the same LSE, so only dS's and the outputs' roundings)
FLASH_TOL = {"f32": {"rtol": 1e-4, "atol": 1e-5, "rel": 3e-6},
             "bf16": {"rtol": 2e-2, "atol": 1e-2, "rel": 7e-3}}
FLASH_REL_BF16 = {"flash_fwd": 7e-3, "flash_bwd_fused": 5e-4,
                  "flash_bwd_dq": 5e-4, "flash_bwd_dkv": 5e-4}
# the split route in bf16 against dense attention in f32 on the same
# (bf16-valued) inputs: the bf16 route's own rounding against exact
# arithmetic.  Elements of dK and dV near zero are sums of up to 1024
# terms each rounded to bf16, so atol is twice the kernel checks'; the
# relative norm is about 3x the H100 reading of 3.0e-3
SPLIT_TOL = {"rtol": 2e-2, "atol": 2e-2, "rel": 1e-2}
# route parity (tiny GPT-2, f32, 3 AdamW steps, flash kernels vs dense):
# loss and grad norm rtol; params abs at lr / 10, because Adam divides
# each gradient by its own running magnitude, so a rounding difference
# in a small gradient moves its param by a fraction of lr.  The key
# bias's gradient is rounding noise around an exact zero (it adds the
# same q.b_k to every score of a row): that slice is held only to the
# most Adam can move a param, lr a step
ROUTE_LR = 1e-3
ROUTE_TOL = {"loss": 1e-4, "params": ROUTE_LR / 10, "key_bias": 3 * ROUTE_LR}
# full-size bf16 step 0, flash vs dense: the loss (bf16 rounding through
# 12 layers on a loss near ln 50257), and the relative norm of the
# difference of the attention weights' gradients.  The dense route
# rounds its scores and softmax to bf16, which the kernels keep in f32;
# the limit is about 3x the H100 reading of 1.08e-2 (PERF.md)
FULL_LOSS_TOL = 2e-2
FULL_GRAD_TOL = 3e-2
# K7-K9 against their plain versions, as K1-K4 are held, with atol taken
# relative to the output's largest magnitude (lse ~ ln V, dx ~ |w|, dw ~
# |x| times the rows a class is the target of).  f32: the same sums in
# another order (64-column vocab tiles with an online logsumexp, E in
# chunks).  bf16: dl rounded to bf16 from scores summed in another order,
# so a few of its elements land one bf16 step (2^-8 of |dl|) apart, and an
# output element near zero then misses by ~|dl| |w| / 256.  The
# relative-norm limits are about 3x the worst readings on an H100 (f32
# 3.5e-6, bf16 1.8e-4; PERF.md)
XENT_TOL = {"f32": {"rtol": 1e-4, "atol": 1e-5, "rel": 1e-5},
            "bf16": {"rtol": 2e-2, "atol": 5e-3, "rel": 6e-4}}
# the fused op against the materialising lse form at GPT-2's full head
# (bf16 x, f32 w): the lse form rounds its logits to bf16 before the
# logsumexp and its softmax gradient to bf16 before the products, the
# kernels keep scores in f32; loss absolute, dx / dw by relative norm of
# the difference, each about 3x its H100 reading (2.9e-6, 5.5e-4, 1.7e-3)
XENT_MAIN_TOL = {"loss": 1e-5, "dx": 2e-3, "dw": 5e-3}


# a side group's lines count from the main run's start: perf_counter is
# CLOCK_MONOTONIC, one clock for every process of the host
T0_ENV = "CHIP_SMOKE_T0"
_T0 = float(os.environ.get(T0_ENV, time.perf_counter()))
# the main sequence's lines and the side groups' relayed lines, whole
_OUT_LOCK = threading.Lock()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's elapsed s."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
        note_processes(obj["phase"])
    line = json.dumps(obj) + "\n"
    with _OUT_LOCK:
        sys.stdout.write(line)
        sys.stdout.flush()


# ----------------------------------------------------------------------
# the processes the run starts
# ----------------------------------------------------------------------
# every process the script starts, and every process those start,
# inherits this variable (a daemon in a session of its own too), so
# /proc finds them all whoever their parent is now
RUN_TAG = "CHIP_SMOKE_RUN"
# pid -> [its command line, the first and the last phase line that saw
# it alive]
_SEEN: dict = {}


def started_processes() -> dict:
    """pid -> command line of every live process that carries this run's
    tag, this one apart.  Zombies carry no environment and are left to
    their parents."""
    tag = f"{RUN_TAG}={os.environ.get(RUN_TAG, '')}".encode()
    if tag.endswith(b"="):
        return {}
    found = {}
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == os.getpid():
            continue
        try:
            with open(f"/proc/{name}/environ", "rb") as f:
                if tag not in f.read().split(b"\0"):
                    continue
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:  # gone, or not ours to read
            continue
        found[int(name)] = cmd.strip()[:300]
    return found


def note_processes(phase: str) -> None:
    """Remember the first and the last phase line that saw each live
    started process."""
    for pid, cmd in started_processes().items():
        _SEEN.setdefault(pid, [cmd, phase, phase])[2] = phase


def stop_processes(grace_s: float = 15.0) -> dict:
    """Stop every process the run started that is still alive: wait
    `grace_s` for it to end on its own (a shut-down cluster's daemons
    exit within seconds), then SIGTERM, then SIGKILL.  Returns what was
    found and stopped; raises if one outlives SIGKILL."""
    left = started_processes()
    deadline = time.monotonic() + grace_s
    while left and time.monotonic() < deadline:
        time.sleep(0.25)
        left = started_processes()
    report = {"left_after_grace": {
        str(p): {"cmd": c, "seen": _SEEN.get(p, [c, None, None])[1:]}
        for p, c in left.items()}, "terminated": [], "killed": []}
    for sig, key, wait_s in ((signal.SIGTERM, "terminated", 5.0),
                             (signal.SIGKILL, "killed", 5.0)):
        if not left:
            break
        for pid in left:
            try:
                os.kill(pid, sig)
                report[key].append(pid)
            except OSError:
                pass
        deadline = time.monotonic() + wait_s
        while left and time.monotonic() < deadline:
            time.sleep(0.1)
            left = started_processes()
    if left:
        raise AssertionError(f"processes outlived SIGKILL: {left}")
    return report


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ----------------------------------------------------------------------
# timing and bounds
# ----------------------------------------------------------------------
def time_ms(fn, iters: int = 25, cold: bool = True) -> float:
    """Median CUDA-event time of `fn` on the device, L2 flushed before
    each launch (the decode step streams ~0.5 GB of weights between two
    launches of a layer's kernel, so the real caller finds the cache
    cold).  The flush writes 1 GiB, ~0.3 ms of device time, so the host
    has enqueued `fn` and the closing event before the device reaches
    them: the events bracket device work, not the wrapper's host time.
    `cold=False` runs `fn` once more, untimed, after the flush, so the
    timed launch finds its inputs in L2."""
    flush = torch.empty(2 ** 30 // 4, dtype=torch.float32, device="cuda")
    fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        if not cold:
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _bound(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def append_bound(case) -> tuple:
    """Bytes a call must move: each row inside the table's reach reads
    its new K and V (+ int8 scales) once and writes them once; plus
    pos and the one table entry per such row."""
    kp, k_new, tables, pos = (case["k_pool"], case["k_new"],
                              case["tables"], case["pos"])
    BS, KV, hd = kp.shape[2:]
    live = int(((pos >= 0) & (pos < tables.shape[1] * BS)).sum())
    row = KV * hd * k_new.element_size() + (
        KV * 4 if case["k_scale"] is not None else 0)
    n_bytes = 2 * 2 * live * row + 4 * pos.numel() + 4 * live
    return _bound(n_bytes, 0.0, torch.bfloat16)


def _attention_work(case) -> tuple:
    """(bytes, operations) of K6 on `case`.  Bytes: q read and o written
    once, each row's live K and V (pos + 1 columns, + int8 scales) read
    once, the table entries it walks, pos.  Operations: 4 * H * hd per
    live column (QK and PV)."""
    q, kp, tables, pos = case["q"], case["k_pool"], case["tables"], case["pos"]
    BS, KV, hd = kp.shape[2:]
    W = tables.shape[1]
    cols = (pos.long() + 1).clamp(min=0, max=W * BS)
    live = int(cols.sum())
    n_blocks = int(((cols + BS - 1) // BS).sum())
    per_col = 2 * KV * hd * kp.element_size() + (
        2 * KV * 4 if case["k_scale"] is not None else 0)
    n_bytes = (2 * q.numel() * q.element_size() + live * per_col
               + 4 * n_blocks + 4 * pos.numel())
    return n_bytes, 4.0 * q.shape[1] * hd * live


def attention_bound(case) -> tuple:
    return _bound(*_attention_work(case), case["q"].dtype)


def fused_bound(case) -> tuple:
    """The fused op: K6's work, with each written row's new K and V
    (the live column it reads, counted there as read from the pool)
    written once more into the pool."""
    n_bytes, flops = _attention_work(case)
    kp, pos = case["k_pool"], case["pos"]
    BS, KV, hd = kp.shape[2:]
    written = int(((pos >= 0) & (pos < case["tables"].shape[1] * BS)).sum())
    row = KV * hd * kp.element_size() + (
        KV * 4 if case["k_scale"] is not None else 0)
    return _bound(n_bytes + 2 * written * row, flops, case["q"].dtype)


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------
def _pool_like(shape, dtype, gen, device):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _scales(shape, gen, device):
    return torch.rand(shape, generator=gen, device=device) * 0.05


def append_case(kind: str, device, *, L=32, B=8, W=16, BS=16, KV=8, hd=128,
                seed=0):
    """Pools with shuffled, non-contiguous tables; ragged positions, one
    row past the table's reach (dropped) and one idle row on scratch."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "int8": torch.int8}[kind]
    NB = 1 + B * W
    shape = (L, NB, BS, KV, hd)
    tables = rng.permutation(np.arange(1, NB)).reshape(B, W)
    pos = rng.integers(0, W * BS, size=B)
    pos[1] = W * BS + 3      # overshoots: writes nothing
    tables[2] = 0            # idle row: scratch block only
    pos[2] = 5
    case = {
        "k_pool": _pool_like(shape, dtype, gen, device),
        "v_pool": _pool_like(shape, dtype, gen, device),
        "k_new": _pool_like((B, KV, hd), dtype, gen, device),
        "v_new": _pool_like((B, KV, hd), dtype, gen, device),
        "tables": torch.as_tensor(tables, dtype=torch.int32, device=device),
        "pos": torch.as_tensor(pos, dtype=torch.int32, device=device),
        "layer": L - 1,
        "k_scale": None, "v_scale": None,
        "k_new_scale": None, "v_new_scale": None,
    }
    if kind == "int8":
        case["k_scale"] = _scales(shape[:-1], gen, device)
        case["v_scale"] = _scales(shape[:-1], gen, device)
        case["k_new_scale"] = _scales((B, KV), gen, device)
        case["v_new_scale"] = _scales((B, KV), gen, device)
    return case


def _run_append(fn, case, clone: bool):
    c = {k: (v.clone() if clone and torch.is_tensor(v) else v)
         for k, v in case.items()}
    out = fn(c["k_pool"], c["v_pool"], c["k_new"], c["v_new"], c["tables"],
             c["pos"], c["layer"], k_scale=c["k_scale"],
             v_scale=c["v_scale"], k_new_scale=c["k_new_scale"],
             v_new_scale=c["v_new_scale"])
    return out


def check_append(device) -> dict:
    """K5 against its plain version, bit-equal outside scratch block 0."""
    out = {}
    for kind in ("bf16", "f32", "int8"):
        case = append_case(kind, device, seed=len(out))
        got = _run_append(pa.paged_kv_append, case, clone=True)
        want = _run_append(pa.paged_kv_append_reference, case, clone=True)
        for g, w in zip(got, want):
            if not torch.equal(g[:, 1:], w[:, 1:]):
                raise AssertionError(f"K5 {kind}: pools differ outside "
                                     "the scratch block")
        changed = not torch.equal(got[0][:, 1:], case["k_pool"][:, 1:])
        if not changed:
            raise AssertionError(f"K5 {kind}: nothing was written")
        out[kind] = "bit-equal"
    return out


def attention_case(kind: str, device, *, B=8, max_pos=1024, L=4, H=32, KV=8,
                   hd=128, BS=16, seed=0):
    """Ragged positions up to max_pos (one row at max_pos) over shuffled
    block tables; q in bf16 for int8 pools."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    pool_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                  "int8": torch.int8}[kind]
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    W = _cdiv(max_pos + 1, BS)
    NB = 1 + B * W
    shape = (L, NB, BS, KV, hd)
    pos = rng.integers(0, max_pos + 1, size=B)
    pos[0] = max_pos
    case = {
        "q": torch.randn((B, H, hd), generator=gen, device=device).to(q_dtype),
        "k_pool": _pool_like(shape, pool_dtype, gen, device),
        "v_pool": _pool_like(shape, pool_dtype, gen, device),
        "tables": torch.as_tensor(
            rng.permutation(np.arange(1, NB)).reshape(B, W),
            dtype=torch.int32, device=device),
        "pos": torch.as_tensor(pos, dtype=torch.int32, device=device),
        "layer": L - 1, "k_scale": None, "v_scale": None,
    }
    if kind == "int8":
        case["k_scale"] = _scales(shape[:-1], gen, device)
        case["v_scale"] = _scales(shape[:-1], gen, device)
    return case


def _run_attention(fn, case):
    return fn(case["q"], case["k_pool"], case["v_pool"], case["tables"],
              case["pos"], case["layer"], k_scale=case["k_scale"],
              v_scale=case["v_scale"])


def check_attention(case, kind: str) -> float:
    """K6 against its plain version at the stated tolerance; returns
    the max abs difference."""
    got = _run_attention(pa.paged_decode_attention, case).float()
    want = _run_attention(pa.paged_decode_attention_reference, case).float()
    tol = ATTN_TOL[kind]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    return float((got - want).abs().max())


def dense_sdpa(case):
    """The yardstick: F.scaled_dot_product_attention over the same KV
    gathered dense (the gather is done here, outside the timed call)."""
    q, kp, vp, tables, pos = (case["q"], case["k_pool"], case["v_pool"],
                              case["tables"], case["pos"])
    B, H, hd = q.shape
    _, _, BS, KV, _ = kp.shape
    W = tables.shape[1]
    t = tables.long()
    k = kp[case["layer"]][t].reshape(B, W * BS, KV, hd)
    v = vp[case["layer"]][t].reshape(B, W * BS, KV, hd)
    if case["k_scale"] is not None:
        layer = case["layer"]
        k = pa.dequantize_int8(k, case["k_scale"][layer][t].reshape(
            B, W * BS, KV), q.dtype)
        v = pa.dequantize_int8(v, case["v_scale"][layer][t].reshape(
            B, W * BS, KV), q.dtype)
    k = k.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
    v = v.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
    cols = torch.arange(W * BS, device=q.device)
    mask = (cols[None, :] <= pos[:, None].long())[:, None, None, :]
    qd = q[:, :, None, :].contiguous()
    return lambda: F.scaled_dot_product_attention(qd, k, v, attn_mask=mask)


def library_append(case):
    """The yardstick for K5: two `index_put_` calls (one per pool) on the
    rows the kernel writes."""
    kp, vp, tables, pos = (case["k_pool"], case["v_pool"], case["tables"],
                           case["pos"])
    BS = kp.shape[2]
    p = pos.long()
    ok = (p >= 0) & (p < tables.shape[1] * BS)
    rows = ok.nonzero()[:, 0]
    idx = (torch.full_like(rows, case["layer"]),
           tables[rows, p[rows] // BS].long(), p[rows] % BS)
    k_new, v_new = case["k_new"][rows], case["v_new"][rows]

    def run():
        kp.index_put_(idx, k_new)
        vp.index_put_(idx, v_new)
    return run


def k6_splits(case) -> list:
    """[splits, blocks per split] of K6's plan for `case` on this card."""
    q, kp, tables = case["q"], case["k_pool"], case["tables"]
    return list(pa.split_plan(
        q.shape[0], q.shape[1], kp.shape[3], tables.shape[1], kp.shape[2],
        torch.cuda.get_device_properties(q.device).multi_processor_count))


def time_kernels(app_case, attn_case) -> dict:
    """ms / plain_ms / bound_ms / library_ms of K5 and K6 on one case
    each (K5 rewrites the same rows each time: idempotent)."""
    a_bound, a_by = append_bound(app_case)
    k_bound, k_by = attention_bound(attn_case)
    return {
        "paged_kv_append": {
            "ms": time_ms(lambda: _run_append(pa.paged_kv_append, app_case,
                                              clone=False)),
            "plain_ms": time_ms(lambda: _run_append(
                pa.paged_kv_append_reference, app_case, clone=False)),
            "bound_ms": a_bound, "bound_by": a_by,
            "library_ms": time_ms(library_append(app_case)),
        },
        "paged_decode_attention": {
            "ms": time_ms(lambda: _run_attention(pa.paged_decode_attention,
                                                 attn_case)),
            "plain_ms": time_ms(lambda: _run_attention(
                pa.paged_decode_attention_reference, attn_case)),
            "bound_ms": k_bound, "bound_by": k_by,
            "library_ms": time_ms(dense_sdpa(attn_case)),
        },
    }


# ----------------------------------------------------------------------
# K5 folded into K6: the fused op against the pair
# ----------------------------------------------------------------------
_WRITTEN = ("k_pool", "v_pool", "k_scale", "v_scale")


def with_new_rows(case, kind: str, gen) -> dict:
    """An attention case with a decode step's new K / V rows (pool
    dtype, + int8 scales) for every row."""
    kp = case["k_pool"]
    B, (KV, hd) = case["q"].shape[0], kp.shape[3:]
    out = dict(case)
    out["k_new"] = _pool_like((B, KV, hd), kp.dtype, gen, kp.device)
    out["v_new"] = _pool_like((B, KV, hd), kp.dtype, gen, kp.device)
    quant = kind == "int8"
    out["k_new_scale"] = _scales((B, KV), gen, kp.device) if quant else None
    out["v_new_scale"] = _scales((B, KV), gen, kp.device) if quant else None
    return out


def _run_fused(fn, case):
    return fn(case["q"], case["k_pool"], case["v_pool"], case["k_new"],
              case["v_new"], case["tables"], case["pos"], case["layer"],
              k_scale=case["k_scale"], v_scale=case["v_scale"],
              k_new_scale=case["k_new_scale"],
              v_new_scale=case["v_new_scale"])


def _run_pair(case):
    _run_append(pa.paged_kv_append, case, clone=False)
    return _run_attention(pa.paged_decode_attention, case)


def _clone_written(case) -> dict:
    return {k: (v.clone() if k in _WRITTEN and v is not None else v)
            for k, v in case.items()}


def check_fused(case, kind: str) -> float:
    """The fused op against K5 then K6 on clones of the same pools:
    outputs bit-equal on every row (no row of these cases shares a
    block), pools and int8 scales bit-equal outside scratch block 0;
    then against its plain version at K6's tolerance.  Returns the max
    abs difference from the plain version."""
    # every row inside the table's reach, its destination slot, and a
    # check that the slot does not already hold the new row (else a fused
    # op that wrote nothing would pass)
    pos, BS = case["pos"].long(), case["k_pool"].shape[2]
    rows = ((pos >= 0) & (pos < case["tables"].shape[1] * BS)).nonzero()[:, 0]
    slot = (case["layer"], case["tables"][rows, pos[rows] // BS].long(),
            pos[rows] % BS)
    for pool, new in (("k_pool", "k_new"), ("v_pool", "v_new")):
        same = (case[pool][slot] == case[new][rows]).flatten(1).all(1)
        if bool(same.any()):
            raise AssertionError(f"fused {kind}: {pool} already holds a "
                                 "new row before the call")
    f, p, r = (_clone_written(case) for _ in range(3))
    got = _run_fused(pa.paged_append_decode_attention, f)
    want = _run_pair(p)
    plain = _run_fused(pa.paged_append_decode_attention_reference, r)
    if not torch.equal(got, want):
        raise AssertionError(f"fused {kind}: output differs from K5 then K6")
    for n in _WRITTEN:
        if f[n] is not None and not torch.equal(f[n][:, 1:], p[n][:, 1:]):
            raise AssertionError(f"fused {kind}: {n} differs from K5's "
                                 "outside the scratch block")
    # every row inside the table's reach holds its new K and V now
    if not (torch.equal(f["k_pool"][slot], case["k_new"][rows])
            and torch.equal(f["v_pool"][slot], case["v_new"][rows])):
        raise AssertionError(f"fused {kind}: a new row was not written")
    tol = ATTN_TOL[kind]
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)
    return float((got.float() - plain.float()).abs().max())


def time_fused(case) -> dict:
    """Device ms of the fused op, of K5 then K6, and of K6 alone on one
    case (each call rewrites the same rows with the same bytes)."""
    return {
        "fused_ms": time_ms(lambda: _run_fused(
            pa.paged_append_decode_attention, case)),
        "k5_then_k6_ms": time_ms(lambda: _run_pair(case)),
        "k6_ms": time_ms(lambda: _run_attention(pa.paged_decode_attention,
                                                case)),
    }


def launch_floor_ms(device) -> float:
    """An empty kernel's device time, timed as the kernels are: the
    floor of any launch of its own."""
    lib = pa._lib()

    def run():
        rc = lib.rt_empty_launch(torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")
    return time_ms(run)


# ----------------------------------------------------------------------
# the main path
# ----------------------------------------------------------------------
def main_path_prompts(vocab: int, seed: int = 0):
    """8 prompts of 16-200 tokens; prompts 2, 4 and 6 share a 64-token
    prefix, so the two later ones take the radix-hit suffix prefill."""
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(0, vocab, size=64)]
    prompts = []
    for i, n in enumerate((16, 40, 72, 96, 120, 150, 180, 200)):
        body = [int(t) for t in rng.integers(0, vocab, size=n)]
        prompts.append(prefix + body[:n - 64] if i in (2, 4, 6) else body)
    return prompts


def serve(engine: LlamaEngine, prompts, max_new_tokens: int) -> dict:
    """Submit every prompt at once and wait for all; a failed future
    raises.  Returns outputs, wall time, and the launch counts of the
    kernels taken over exactly this run."""
    d0 = engine.stats()["decode_kernel_dispatch_total"]
    reset_counts()
    t0 = time.perf_counter()
    futs = [engine.submit(p, max_new_tokens) for p in prompts]
    outs = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    launches = {name: getattr(pa, name).launches for name in PAGED}
    stats = engine.stats()
    return {"outs": outs, "wall_s": wall, "launches": launches,
            "dispatches": stats["decode_kernel_dispatch_total"] - d0,
            "stats": stats}


def mid_decode_state(cfg, params, prompts, device, block_size=16, steps=3):
    """A decode state as the engine holds it: every prompt prefilled
    into shuffled pool blocks, then `steps` fused decode steps."""
    B, L = len(prompts), cfg.n_layers
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    need = _cdiv(max(len(p) for p in prompts) + steps + 1, block_size)
    W = 1 << (need - 1).bit_length()
    NB = 1 + B * W
    rng = np.random.default_rng(1)
    tables = rng.permutation(np.arange(1, NB)).reshape(B, W)
    k_pool = torch.zeros((L, NB, block_size, KV, hd), dtype=cfg.dtype,
                         device=device)
    v_pool = torch.zeros_like(k_pool)
    tok = torch.zeros(B, dtype=torch.int32, device=device)
    for b, p in enumerate(prompts):
        T = len(p)
        logits, (k1, v1) = llama.forward(
            cfg, params, torch.as_tensor([p], device=device), return_kv=True)
        nb = _cdiv(T, block_size)
        blk = torch.as_tensor(tables[b, :nb], device=device)
        kb = k1.new_zeros((L, nb * block_size, KV, hd))
        vb = v1.new_zeros((L, nb * block_size, KV, hd))
        kb[:, :T], vb[:, :T] = k1[:, 0], v1[:, 0]
        k_pool[:, blk] = kb.reshape(L, nb, block_size, KV, hd)
        v_pool[:, blk] = vb.reshape(L, nb, block_size, KV, hd)
        tok[b] = logits[0, -1].argmax()
    tables = torch.as_tensor(tables, dtype=torch.int32, device=device)
    pos = torch.as_tensor([len(p) for p in prompts], dtype=torch.int32,
                          device=device)
    for _ in range(steps):
        logits = llama.decode_step_paged(cfg, params, tok, k_pool, v_pool,
                                         tables, pos)[0]
        tok = logits.argmax(-1).to(torch.int32)
        pos = pos + 1
    return {"k_pool": k_pool, "v_pool": v_pool, "tables": tables,
            "pos": pos, "tok": tok}


def compare_routes(cfg, params, state) -> dict:
    """decode_step_paged (kernels) against decode_step_vec (dense, over
    the same pool gathered): the max abs logit difference, and equal
    argmax on every row whose top-2 margin exceeds it."""
    kp, vp, tables = state["k_pool"], state["v_pool"], state["tables"]
    L, _, BS, KV, hd = kp.shape
    B, W = tables.shape
    t = tables.long()
    k_dense = kp[:, t].reshape(L, B, W * BS, KV, hd)
    v_dense = vp[:, t].reshape(L, B, W * BS, KV, hd)
    paged = llama.decode_step_paged(cfg, params, state["tok"], kp.clone(),
                                    vp.clone(), tables, state["pos"])[0]
    dense = llama.decode_step_vec(cfg, params, state["tok"],
                                  (k_dense, v_dense), state["pos"])[0]
    if not (torch.isfinite(paged).all() and paged.shape == dense.shape):
        raise AssertionError("paged logits not finite or misshapen")
    diff = float((paged - dense).abs().max())
    top = dense.topk(2, dim=-1).values
    decided = (top[:, 0] - top[:, 1]) > diff
    same = paged.argmax(-1) == dense.argmax(-1)
    if not bool(same[decided].all()):
        raise AssertionError("argmax differs on a row whose margin "
                             "exceeds the logit difference")
    return {"max_abs_logit_diff": diff,
            "max_abs_logit": float(dense.abs().max()), "rows": B,
            "rows_decided": int(decided.sum()),
            "argmax_equal_rows": int(same.sum())}


def chunk_graphs(engine: LlamaEngine) -> dict:
    """The engine's chunk steppers: per gather width, whether it is a
    captured CUDA graph, the capture's ms and reserved bytes, and its
    replays; with the cache's size and evictions."""
    st = engine.stats()
    return {
        "chunk_cache_size": st["chunk_cache_size"],
        "chunk_cache_evictions": st["chunk_cache_evictions"],
        "widths": {str(W): {"graph": isinstance(s, EngineGraph)
                            and s.captured,
                            "capture_ms": getattr(s, "capture_ms", None),
                            "capture_phases_ms":
                                getattr(s, "capture_phases_ms", None),
                            "graph_bytes": getattr(s, "graph_bytes", None),
                            "capture_host_bytes":
                                getattr(s, "capture_host_bytes", None),
                            "capture_cpu_s": getattr(s, "capture_cpu_s", None),
                            "replays": getattr(s, "replays", 0)}
                   for W, s in engine._chunk_cache.items()},
    }


def prefill_families(engine: LlamaEngine) -> dict:
    """The engine's prefill program families (full prefill by bucket,
    suffix prefill by (suffix bucket, prefix blocks), block write by
    (rows in, blocks)): per key, whether it is a captured CUDA graph,
    the capture's ms and reserved bytes, and its replays; with the
    engine's prefill calls and the families' total capture cost."""
    def entries(cache):
        return {str(k): {"graph": isinstance(g, EngineGraph) and g.captured,
                         "capture_ms": getattr(g, "capture_ms", None),
                         "graph_bytes": getattr(g, "graph_bytes", None),
                         "replays": getattr(g, "replays", 0)}
                for k, g in cache.items()}

    st = engine.stats()
    return {"prefill": entries(engine._prefill_cache),
            "suffix": entries(engine._suffix_cache),
            "write": entries(engine._write_cache),
            "prefill_calls": st["prefill_calls"],
            "capture_ms": st["prefill_capture_ms"],
            "graph_bytes": st["prefill_graph_bytes"],
            "replays": st["prefill_replays"]}


def on_prefill_graphs(fams: dict, what: str) -> None:
    """Every prefill-family entry of the run is a captured graph: the
    card's kernel route never prefills eagerly past an entry's first
    call."""
    entries = [e for k in ("prefill", "suffix", "write")
               for e in fams[k].values()]
    if not entries or not all(e["graph"] for e in entries):
        raise AssertionError(f"{what} did not run on captured prefill "
                             f"graphs: {fams}")


def tick_phases(stats: dict, after: int, upto: int) -> dict:
    """The engine's tick ring over the ticks whose dispatch count lies
    in (after, upto]: how many, and the seconds they spent admitting
    (prefills), dispatching (chunks) and harvesting (waiting on the
    previous chunk's tokens)."""
    ring = [t for t in stats["tick_ring"] if after < t["seq"] <= upto]
    return {"ticks": len(ring),
            **{k: sum(t[k] for t in ring)
               for k in ("admit_s", "dispatch_s", "harvest_s")}}


def on_graphs(graphs: dict, what: str) -> None:
    """Every chunk stepper of the run is a captured graph, and the run
    replayed at least one."""
    widths = graphs["widths"].values()
    if (not widths or not all(w["graph"] for w in widths)
            or sum(w["replays"] for w in widths) < 1):
        raise AssertionError(f"{what} did not run on captured chunk "
                             f"graphs: {graphs}")


_ENGINE_STATE = ("_k_pool", "_v_pool", "_k_scale", "_v_scale", "_tok",
                 "_pos")


def _engine_snapshot(engine: LlamaEngine) -> dict:
    return {k: getattr(engine, k).clone() for k in _ENGINE_STATE
            if getattr(engine, k) is not None}


def _engine_restore(engine: LlamaEngine, snap: dict) -> None:
    for k, v in snap.items():
        getattr(engine, k).copy_(v)


def graph_vs_eager(cfg, params, state, device, *, chunk=8, block_size=16,
                   max_len=512, reps=3) -> dict:
    """The engine's chunk replayed from its CUDA graph against its eager
    chunk, from the main path's mid-decode state loaded into an idle
    engine (bf16 KV, and int8 KV quantized from it): token rows,
    tokens, positions and the whole pools bit-equal, on the first replay
    and on a repeat.  Both timed from the restored state (host wall to
    a device sync, medians of `reps`, in turns), with the capture's ms
    and the graph's reserved bytes."""
    B, W = state["tables"].shape
    NB = state["k_pool"].shape[1]
    out = {}
    for kv_dtype in ("model", "int8"):
        eng = LlamaEngine(cfg, params, slots=B, chunk=chunk,
                          block_size=block_size, max_len=max_len,
                          kv_dtype=kv_dtype, device=device)
        try:
            for pool, scale, src in ((eng._k_pool, eng._k_scale, "k_pool"),
                                     (eng._v_pool, eng._v_scale, "v_pool")):
                if kv_dtype == "int8":
                    q, sc = pa.quantize_int8(state[src])
                    pool[:, :NB].copy_(q)
                    scale[:, :NB].copy_(sc)
                else:
                    pool[:, :NB].copy_(state[src])
            eng._tok.copy_(state["tok"])
            eng._pos.copy_(state["pos"])
            tables = state["tables"]
            snap = _engine_snapshot(eng)
            rows = eng._run_chunk(tables).clone()
            want = _engine_snapshot(eng)
            step = eng._chunk_step_for(W)
            _engine_restore(eng, snap)
            step(tables)  # eager, then the capture
            for _ in range(2):  # a replay, and a repeat
                _engine_restore(eng, snap)
                got_rows = step(tables).clone()
                got = _engine_snapshot(eng)
                if not torch.equal(got_rows, rows) or not all(
                        torch.equal(got[k], want[k]) for k in want):
                    raise AssertionError(
                        f"graph replay differs from the eager chunk "
                        f"({kv_dtype} KV): rows "
                        f"{torch.equal(got_rows, rows)}, state "
                        f"{[k for k in want if not torch.equal(got[k], want[k])]}")
            times = {"eager": [], "graph": []}
            for _ in range(reps):
                for route, fn in (("eager", eng._run_chunk),
                                  ("graph", step), ("graph", step),
                                  ("eager", eng._run_chunk)):
                    _engine_restore(eng, snap)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(tables)
                    torch.cuda.synchronize()
                    times[route].append((time.perf_counter() - t0) * 1e3)
            out[kv_dtype] = {
                "bit_equal": True,
                "eager_chunk_ms": statistics.median(times["eager"]),
                "graph_chunk_ms": statistics.median(times["graph"]),
                "capture_ms": step.capture_ms,
                "capture_phases_ms": step.capture_phases_ms,
                "graph_bytes": step.graph_bytes,
                "capture_host_bytes": step.capture_host_bytes,
                "launches_per_replay": step.launches,
                **{k: eng.stats()[k] for k in ("chunk_cache_size",
                                               "chunk_cache_evictions")},
            }
        finally:
            eng.shutdown()
        del eng
    return {"phase": "graph_vs_eager", "B": B, "W": W, "chunk": chunk,
            "pos": state["pos"].tolist(), **out}


def run_main_path(cfg, params, device, *, slots=8, chunk=8, block_size=16,
                  max_len=512, max_new_tokens=32) -> dict:
    def make_engine():
        return LlamaEngine(cfg, params, slots=slots, chunk=chunk,
                           block_size=block_size, max_len=max_len,
                           decode_kernel="auto", device=device)

    # a throwaway engine takes the first-use costs (library handles,
    # kernel load, the process's first graph captures), so the measured
    # engine's TTFT window and counts hold only the measured requests
    engine = make_engine()
    try:
        engine.submit(list(range(1, 9)), 4).result(timeout=900)
        first_graphs = chunk_graphs(engine)
    finally:
        engine.shutdown()
    prompts = main_path_prompts(cfg.vocab_size)
    engine = make_engine()
    try:
        run = serve(engine, prompts, max_new_tokens)
        graphs = chunk_graphs(engine)
        prefills = prefill_families(engine)
    finally:
        engine.shutdown()
    st = run["stats"]
    need = cfg.n_layers * chunk * run["dispatches"]
    if st["decode_kernel"] != "kernel":
        raise AssertionError(f"decode_kernel resolved to "
                             f"{st['decode_kernel']!r}")
    on_graphs(graphs, "the main path")
    on_prefill_graphs(prefills, "the main path")
    if prefills["prefill_calls"] != len(prompts):
        raise AssertionError(f"{prefills['prefill_calls']} prefill calls "
                             f"for {len(prompts)} prompts")
    if run["dispatches"] <= 0 or st["decode_fallback_dispatch_total"] != 0:
        raise AssertionError("the run did not take the kernel route only")
    # one fused launch a layer a decode step, and no K5 or K6 of its own
    want = {"paged_kv_append": 0, "paged_decode_attention": 0,
            "paged_append_decode_attention": need}
    if run["launches"] != want:
        raise AssertionError(f"serve launches {run['launches']}, want "
                             f"{want} (L x chunk x dispatches = {need})")
    for out in run["outs"]:
        if len(out) != max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in out):
            raise AssertionError("malformed engine output")
    n_tok = sum(len(o) for o in run["outs"])
    return {
        "prompts": prompts, "outs": run["outs"], "launches": run["launches"],
        "line": {
            "phase": "main_path",
            "model": "llama3_8b", "dim": cfg.dim, "n_layers": cfg.n_layers,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "intermediate": cfg.intermediate, "vocab": cfg.vocab_size,
            "dtype": str(cfg.dtype).replace("torch.", ""),
            "depth_cut": False,
            "requests": len(prompts), "max_new_tokens": max_new_tokens,
            "prompt_lens": [len(p) for p in prompts],
            "decode_kernel": st["decode_kernel"],
            "decode_kernel_dispatch_total": run["dispatches"],
            "decode_steps": chunk * run["dispatches"],
            "decode_fallback_dispatch_total":
                st["decode_fallback_dispatch_total"],
            "launches": run["launches"],
            "chunk_graphs": graphs,
            "throwaway_engine_chunk_graphs": first_graphs,
            "prefill_graphs": prefills,
            "prefill_calls": st["prefill_calls"],
            "tick_phases": tick_phases(st, 0, st["ticks"]),
            "prefix_hit_tokens": st["prefix_hit_tokens"],
            "wall_s": run["wall_s"],
            "tokens_per_s": n_tok / run["wall_s"],
            "ttft_p50_s": st["ttft_p50_s"],
            "ttft_p90_s": st["ttft_p90_s"],
        },
    }


# ----------------------------------------------------------------------
# the prefill program families, and the int8 configurations
# ----------------------------------------------------------------------
def _outside_scratch(snap: dict) -> dict:
    """An engine snapshot without scratch block 0 of the pools and
    scales (every program may write padding there)."""
    return {k: (v[:, 1:] if k in ("_k_pool", "_v_pool", "_k_scale",
                                  "_v_scale") else v)
            for k, v in snap.items()}


def prefill_graphs(cfg, params, prompts, device, *, slots=8, chunk=8,
                   block_size=16, max_len=512, reps=3) -> dict:
    """The prefill families' CUDA graphs at Llama-3-8B, in bf16 and int8
    KV: a full prefill per bucket the main path uses (16 / 64 / 128 /
    256) and its radix-hit suffix prefill (prompt 4 over prompt 2's
    64-token prefix), each with its block write, run by the engine's own
    `_admit_programs`.  Each admission's first call (eager, then the
    captures) and two replays, from one restored state, are held
    bit-equal to the programs run eagerly: the staged logits row T - 1,
    tokens, positions, the pools and int8 scales outside the scratch
    block.  Then a chunk's token rows of the six admitted slots,
    dispatched from its graph and read only after a prefill replay, are
    held equal to the rows of a replay read at once.  Eager and replay
    times are host wall to a device sync, medians of `reps`, in
    turns."""
    t_start = time.perf_counter()
    bs = block_size
    out = {}
    for kv_dtype in ("model", "int8"):
        eng = LlamaEngine(cfg, params, slots=slots, chunk=chunk,
                          block_size=bs, max_len=max_len, kv_dtype=kv_dtype,
                          device=device)
        try:
            # (prompt, shared blocks, own blocks, slot): each slot's own
            # blocks cover its prompt and one chunk, as `_admit`
            # allocates them; prompt 4 over the prefix blocks prompt 2's
            # prefill wrote
            nxt, cases = 1, {}
            for slot, i in enumerate((0, 1, 3, 7, 2, 4)):
                shared = cases["full_72"][2][:4] if i == 4 else []
                n = _cdiv(len(prompts[i]) + chunk, bs) - len(shared)
                name = "suffix" if i == 4 else "full"
                cases[f"{name}_{len(prompts[i])}"] = (
                    prompts[i], shared, list(range(nxt, nxt + n)), slot)
                nxt += n
            entries = {}
            for name, case in cases.items():
                snap = _engine_snapshot(eng)
                eng._admit_programs(*case, route="eager")
                want_row = eng._stage_logits.clone()
                want = _outside_scratch(_engine_snapshot(eng))
                for call in range(3):  # eager + capture, then 2 replays
                    _engine_restore(eng, snap)
                    pf, wf = eng._admit_programs(*case)
                    got = _outside_scratch(_engine_snapshot(eng))
                    row_equal = torch.equal(eng._stage_logits, want_row)
                    bad = [k for k in want if not torch.equal(got[k], want[k])]
                    if not row_equal or bad:
                        raise AssertionError(
                            f"{name} ({kv_dtype} KV) call {call}: logits "
                            f"row {row_equal}, state {bad}")
                times = {"eager": [], "entry": []}
                for _ in range(reps):
                    for route in ("eager", "entry", "entry", "eager"):
                        _engine_restore(eng, snap)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        eng._admit_programs(*case, route=route)
                        torch.cuda.synchronize()
                        times[route].append((time.perf_counter() - t0) * 1e3)
                entries[name] = {
                    "key": str(next(k for c in (eng._prefill_cache,
                                                eng._suffix_cache)
                                    for k, g in c.items() if g is pf)),
                    "write_key": str(next(k for k, g in
                                          eng._write_cache.items()
                                          if g is wf)),
                    "bit_equal": True,
                    "eager_ms": statistics.median(times["eager"]),
                    "replay_ms": statistics.median(times["entry"]),
                    **{f"{what}{k}": getattr(g, k, None)
                       for what, g in (("", pf), ("write_", wf))
                       for k in ("capture_ms", "graph_bytes", "replays")},
                }
            # every case written once more, then a chunk over the six slots
            for case in cases.values():
                eng._admit_programs(*case)
            tables = [c[1] + c[2] for c in cases.values()]
            W = _next_pow2(max(len(t) for t in tables))
            tables = torch.as_tensor([t + [0] * (W - len(t)) for t in tables]
                                     + [[0] * W] * (slots - len(tables)),
                                     dtype=torch.int32, device=device)
            step = eng._chunk_step_for(W)
            snap = _engine_snapshot(eng)
            step(tables)  # eager, then the capture
            _engine_restore(eng, snap)
            want_rows = step(tables).clone()
            _engine_restore(eng, snap)
            rows = step(tables)  # the static rows, not read yet
            eng._admit_programs(*cases["full_200"])
            torch.cuda.synchronize()
            # the idle slots' rows are garbage by design: their tables all
            # name scratch block 0, where their appends race
            live = len(cases)
            survived = torch.equal(rows[:, :live], want_rows[:, :live])
            if not survived:
                raise AssertionError(f"a prefill replay overwrote a chunk's "
                                     f"token rows ({kv_dtype} KV)")
            out[kv_dtype] = {
                "entries": entries, "chunk_rows_survive_prefill": survived,
                "own_graph_pools": eng._graph_pool
                != eng._prefill_graph_pool,
                "stage_bytes": sum(t.nbytes for t in (
                    eng._stage_k, eng._stage_v, eng._stage_logits)),
                **{k: eng.stats()[k] for k in (
                    "prefill_cache_size", "suffix_cache_size",
                    "write_cache_size", "prefill_capture_ms",
                    "prefill_graph_bytes")},
            }
        finally:
            eng.shutdown()
        del eng
        torch.cuda.empty_cache()
    return {"phase": "prefill_graphs", "slots": slots, "chunk": chunk,
            "block_size": bs, "max_len": max_len, **out,
            "wall_s": time.perf_counter() - t_start}


def _quantiles(vals) -> dict:
    vals = sorted(vals)
    return {f"ttft_p{int(q * 100)}_s": (vals[min(len(vals) - 1,
                                                  int(len(vals) * q))]
                                        if vals else None)
            for q in (0.5, 0.9)}


def _cut(params: dict, depth: int, dtype=None) -> dict:
    """The first `depth` blocks of `params` (views), every floating leaf
    cast to `dtype` where one is given."""
    def cast(t):
        if dtype is None or not t.is_floating_point():
            return t
        return t.to(dtype)

    out = {k: cast(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: cast(v[:depth]) for k, v in params["blocks"].items()}
    return out


def _err_over_max(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


# the int8-weight path's bf16 error may reach twice the bf16 model's:
# each projection's output is rounded to bf16 twice (x @ q, then its
# product with the bf16-rounded per-channel scale) where the bf16
# model rounds it once
INT8_BF16_ERR_RATIO = 2.0


def int8_logit_profile(cfg, params, qparams, tokens,
                       depths=(1, 2, 4, 8, 16, 32)) -> list:
    """The int8-weight model (`quantize_weights_int8`, bf16 compute)
    over `tokens` against what it should compute: the same model in f32,
    its weights the dequantized q x scale; both cut to each depth, the
    model as served (32) included.  Gate: that error (the max over the
    f32 max |logit|) within `INT8_BF16_ERR_RATIO` times the bf16
    model's own error against its weights in f32, measured on the same
    tokens at the same depth.  Recorded beside it: the int8 model
    against the bf16 model and its argmax agreement, and the
    quantization alone (the dequantized weights against the original,
    both in f32)."""
    rows = []
    with torch.no_grad():
        for d in depths:
            cd = dataclasses.replace(cfg, n_layers=d)
            c32 = dataclasses.replace(cd, dtype=torch.float32)
            lf = llama.forward(cd, _cut(params, d), tokens)
            lq = llama.forward(cd, _cut(qparams, d), tokens)
            p32 = _cut(params, d, torch.float32)
            l32 = llama.forward(c32, p32, tokens)
            # the weights dequantized in place, a layer at a time
            for name in llama.QUANT_TARGETS:
                q = qparams["blocks"][name]
                sc = qparams["blocks"][name + "_scale"]
                for i in range(d):
                    p32["blocks"][name][i].copy_(q[i].float()
                                                 * sc[i][None, :])
            p32["lm_head"].copy_(qparams["lm_head"].float()
                                 * qparams["lm_head_scale"][None, :])
            l32q = llama.forward(c32, p32, tokens)
            del p32
            bf16 = _err_over_max(lf, l32)
            err = _err_over_max(lq, l32q)
            rows.append({
                "depth": d, "int8_vs_dequant_f32_err_over_max": err,
                "bf16_vs_f32_err_over_max": bf16, "ratio": err / bf16,
                "limit": INT8_BF16_ERR_RATIO * bf16,
                "int8_vs_bf16_err_over_max": _err_over_max(lq, lf),
                "argmax_agree": float((lq.argmax(-1) == lf.argmax(-1))
                                      .float().mean()),
                "quant_only_f32_err_over_max": _err_over_max(l32q, l32)})
            del lf, lq, l32, l32q
            torch.cuda.empty_cache()
            if not err <= INT8_BF16_ERR_RATIO * bf16:
                raise AssertionError(
                    f"int8-weight logits at depth {d}: error {err} against "
                    f"the dequantized model in f32, over "
                    f"{INT8_BF16_ERR_RATIO} x the bf16 model's {bf16}: "
                    f"{rows}")
    return rows


def int8_reference_bound(device) -> dict:
    """The reference's bound on its own model
    (`tests/test_paged_attention.py:305-320`: `LlamaConfig.tiny(vocab_size
    =128)`, bf16, two rows of 10 tokens): the int8-weight logits within
    5% of the bf16 logits' max |logit|, on the card.  The reference also
    asserts equal argmax rows, a near tie its own runs flip: recorded
    here, not gated."""
    cfg = llama.LlamaConfig.tiny(vocab_size=128)
    params = llama.init_params(cfg, 0, device=device, dtype=cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 10), generator=gen,
                           device=device)
    with torch.no_grad():
        lf = llama.forward(cfg, params, tokens)
        lq = llama.forward(cfg, llama.quantize_weights_int8(params), tokens)
    err = _err_over_max(lq, lf)
    if not err <= 0.05:
        raise AssertionError(f"int8 weight logit error {err} of the max "
                             f"|logit| on the reference's tiny model")
    return {"err_over_max": err, "tolerance": 0.05,
            "argmax_agree": float((lq.argmax(-1) == lf.argmax(-1))
                                  .float().mean())}


def int8_serve(cfg, params, prompts, device, *, slots=8, chunk=8,
               block_size=16, max_len=512, n_new=32) -> dict:
    """The main path's 8 prompts at Llama-3-8B, `n_new` tokens each,
    through `LLMEngineConfig` as the serve example builds an engine: in
    int8 weights (`quantize_weights_int8`) with int8 KV, in int8 KV
    alone, and in bf16 as the yardstick of the same call.  Each engine
    first serves prompts of the same shapes (seed 1), which captures
    every program, then the measured run.  Gates: the kernel route only
    and one fused launch a layer a step, every prefill a graph replay,
    well-formed outputs; the quantized model's logits over the longest
    prompt against the dequantized model in f32 within twice bf16's own
    error at every depth to 32 (`int8_logit_profile`), and within 5% of
    the bf16 max |logit| on the reference's tiny model, where the
    reference sets that bound (`int8_reference_bound`); a tiny f32
    engine over int8 weights equal to `generate`."""
    from ray_tpu_torch.serve.config import LLMEngineConfig

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    qparams = llama.quantize_weights_int8(params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    profile = int8_logit_profile(
        cfg, params, qparams, torch.as_tensor([prompts[-1]], device=device))
    warm = main_path_prompts(cfg.vocab_size, seed=1)
    runs = {}
    for name, weights, kv, p in (
            ("int8_weights_int8_kv", "int8", "int8", qparams),
            ("int8_kv", "model", "int8", params),
            ("bf16", "model", "model", params)):
        ecfg = LLMEngineConfig(slots=slots, chunk=chunk, max_len=max_len,
                               block_size=block_size, kv_dtype=kv,
                               weight_dtype=weights).validate()
        eng = LlamaEngine(cfg, p, device=device, **ecfg.engine_kwargs())
        try:
            first = serve(eng, warm, n_new)
            since = time.monotonic()
            base = eng.stats()
            run = serve(eng, prompts, n_new)
            ttft = [v for ts, v in eng._ttft_samples if ts >= since]
            fams = prefill_families(eng)
        finally:
            eng.shutdown()
        st = run["stats"]
        need = cfg.n_layers * chunk * run["dispatches"]
        want = {"paged_kv_append": 0, "paged_decode_attention": 0,
                "paged_append_decode_attention": need}
        calls = st["prefill_calls"] - base["prefill_calls"]
        replays = st["prefill_replays"] - base["prefill_replays"]
        if (st["decode_kernel"] != "kernel" or run["dispatches"] <= 0
                or st["decode_fallback_dispatch_total"] != 0):
            raise AssertionError(f"{name} did not take the kernel route only")
        if run["launches"] != want:
            raise AssertionError(f"{name} launches {run['launches']}, want "
                                 f"{want} (L x chunk x dispatches)")
        on_prefill_graphs(fams, name)
        if calls != len(prompts) or replays != 2 * calls:
            raise AssertionError(f"{name}: {calls} prefills, {replays} "
                                 f"prefill-family replays")
        for o in run["outs"]:
            if len(o) != n_new or not all(0 <= t < cfg.vocab_size
                                          for t in o):
                raise AssertionError(f"{name}: malformed output {o}")
        runs[name] = {
            "weight_dtype": weights, "kv_dtype": st["kv_dtype"],
            "decode_kernel_dispatch_total": run["dispatches"],
            "decode_fallback_dispatch_total":
                st["decode_fallback_dispatch_total"],
            "launches": run["launches"],
            "prefill_calls": calls, "prefill_replays": replays,
            "first_run_wall_s": first["wall_s"],
            "wall_s": run["wall_s"],
            "tokens_per_s": len(prompts) * n_new / run["wall_s"],
            **_quantiles(ttft),
            "kv_pool_bytes": st["kv_pool_bytes"],
            "kv_scale_bytes": st["kv_scale_bytes"],
            "prefill_capture_ms": fams["capture_ms"],
            "outs_equal_bf16": None,
            "outs": run["outs"],
        }
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("int8_weights_int8_kv", "int8_kv"):
        runs[name]["outs_equal_bf16"] = (runs[name]["outs"]
                                          == runs["bf16"]["outs"])
    for r in runs.values():
        del r["outs"]
    tiny = tiny_parity(device, weights="int8")
    return {"phase": "int8_serve", "model": "llama3_8b",
            "requests": len(prompts), "max_new_tokens": n_new,
            "quantize_s": quantize_s,
            "logit_err_over_max": profile[-1]["int8_vs_bf16_err_over_max"],
            "int8_vs_dequant_f32_err_over_max":
                profile[-1]["int8_vs_dequant_f32_err_over_max"],
            "argmax_agree": profile[-1]["argmax_agree"],
            "logit_profile": profile,
            "reference_bound": int8_reference_bound(device),
            **runs, "tiny_int8_weights_equal_generate":
                tiny["tokens_equal_generate"],
            "wall_s": time.perf_counter() - t_start}


def tiny_parity(device, weights: str = "model") -> dict:
    """A tiny f32 engine (kernel route, prefill graphs) on the card
    against greedy `generate` over the same params: tokens equal, prefix
    cache on, more requests than slots.  `weights="int8"` serves
    `quantize_weights_int8`'s params (the reference's engine parity,
    `tests/test_paged_attention.py:325-331`)."""
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=128),
                              dtype=torch.float32)
    params = llama.init_params(cfg, 0, device=device)
    if weights == "int8":
        params = llama.quantize_weights_int8(params)
    rng = np.random.default_rng(42)
    shared = [int(t) for t in rng.integers(0, 128, size=16)]
    prompts = [[int(t) for t in rng.integers(0, 128, size=int(n))]
               for n in rng.integers(1, 24, size=7)]
    prompts[3] = shared + [5, 6]
    prompts[5] = shared + [7]
    engine = LlamaEngine(cfg, params, slots=4, chunk=4, block_size=8,
                         max_len=64, device=device)
    try:
        outs = [f.result(timeout=300)
                for f in [engine.submit(p, 9) for p in prompts]]
    finally:
        engine.shutdown()
    want = [llama.generate(cfg, params, [p], 9, device=device)[0].tolist()
            for p in prompts]
    if outs != want:
        raise AssertionError(f"tiny f32 engine ({weights} weights) != "
                             f"generate: {outs} vs {want}")
    return {"phase": "tiny_parity", "weights": weights,
            "requests": len(prompts), "tokens_equal_generate": True}


# ----------------------------------------------------------------------
# the serve plane: HTTP -> proxy -> router -> a replica actor
# ----------------------------------------------------------------------
class SmokeLlamaService(ContinuousLlamaService.func_or_class):
    """`ContinuousLlamaService` with what this script reads from the
    replica: its paged-attention launch counts (the driver's counters
    cannot see another process), the card it was pinned to, and an f32
    compute switch for the tiny model's exact gate."""

    def __init__(self, f32_compute: bool = False, **kwargs):
        super().__init__(**kwargs)
        if f32_compute:
            eng = self.engine
            eng.shutdown()
            self.engine = LlamaEngine(
                dataclasses.replace(eng.cfg, dtype=torch.float32),
                eng.params, slots=eng.slots, chunk=eng.chunk,
                max_len=eng.max_len, block_size=eng.block_size,
                device=eng.device)

    def reset_counts(self) -> int:
        """Zero the launch counters and drop the TTFT samples taken so
        far (the first request's carries the kernel library's load);
        returns the decode dispatches so far, so the caller can take
        the difference."""
        for name in PAGED:
            getattr(pa, name).launches = 0
        self.engine._ttft_samples.clear()
        return self.engine.stats()["decode_kernel_dispatch_total"]

    def launches(self) -> dict:
        return {name: getattr(pa, name).launches for name in PAGED}

    def graphs(self) -> dict:
        return chunk_graphs(self.engine)

    def cpu_s(self) -> float:
        """CPU seconds the replica's process has used, all threads."""
        return time.process_time()

    def card(self) -> dict:
        return {"CUDA_VISIBLE_DEVICES": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device_count": torch.cuda.device_count(),
                "name": torch.cuda.get_device_name(0),
                "engine_device": str(self.engine.device)}


def cpu_window(h, fn) -> tuple:
    """fn()'s result, and its wall seconds and the CPU cores the
    replica's process kept busy over it."""
    rep0 = h.cpu_s.remote().result(timeout_s=120)
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    rep1 = h.cpu_s.remote().result(timeout_s=120)
    return out, {"wall_s": wall, "replica_cpu_cores": (rep1 - rep0) / wall}


def post(addr, route: str, body: dict, timeout: float = 900.0) -> tuple:
    """One HTTP POST through the serve proxy: (tokens, seconds)."""
    t0 = time.perf_counter()
    req = urllib.request.Request(
        f"http://{addr[0]}:{addr[1]}{route}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status} from {route}")
        out = json.loads(resp.read())["tokens"]
    return out, time.perf_counter() - t0


class Echo:
    """A replica that hands its request back: what the plane costs a
    request with no engine behind it."""

    async def __call__(self, request):
        return {"tokens": request.json()["tokens"]}

    def echo(self, tokens):
        return tokens


def hop_cost(addr, prompt, reps: int = 20) -> dict:
    """The plane's own cost a request: an Echo replica reached over HTTP
    (proxy, router, replica) and through a handle (router, replica),
    with the serve main path's request body; medians in seconds.  A
    one-token request to the engine would not resolve it: the engine
    answers a chunk (8 decode steps, ~0.5 s) at a time."""
    h = rt_serve.run(rt_serve.deployment(Echo).bind(), name="echo",
                     route_prefix="/echo", timeout_s=300)
    body = {"tokens": [prompt], "max_new_tokens": 1}
    post(addr, "/echo", body)
    h.echo.remote([prompt]).result(timeout_s=120)
    t = {"http": [], "handle": []}
    for _ in range(reps):
        t["http"].append(post(addr, "/echo", body)[1])
        t0 = time.perf_counter()
        h.echo.remote([prompt]).result(timeout_s=120)
        t["handle"].append(time.perf_counter() - t0)
    rt_serve.delete("echo")
    return {"reps": reps, "prompt_len": len(prompt),
            "http_median_s": statistics.median(t["http"]),
            "http_max_s": max(t["http"]),
            "handle_median_s": statistics.median(t["handle"]),
            "handle_max_s": max(t["handle"])}


def _well_formed(outs, n: int, vocab: int) -> None:
    for out in outs:
        if len(out) != n or not all(0 <= t < vocab for t in out):
            raise AssertionError(f"malformed answer over HTTP: {out}")


def serve_plane(cfg, prompts, main_outs, *, slots=8, chunk=8,
                block_size=16, max_len=512, max_new_tokens=32) -> dict:
    """Llama-3-8B behind the port's serve plane on the card, then the
    tiny exact gate.  The runtime and serve are shut down on the way
    out, whatever happens."""
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    rt.init(num_workers=2, num_cpus=8)
    try:
        gpus = rt.cluster_resources().get("GPU", 0.0)
        if gpus != torch.cuda.device_count():
            raise AssertionError(f"the runtime detected {gpus} GPUs, torch "
                                 f"sees {torch.cuda.device_count()}")
        dep = rt_serve.deployment(max_ongoing_requests=256)(SmokeLlamaService)
        app = dep.options(
            name="Llama", health_check_timeout_s=600,
            ray_actor_options={"num_gpus": 1},
        ).bind(model_size="llama3_8b", max_new_tokens=max_new_tokens,
               slots=slots, chunk=chunk, block_size=block_size,
               max_len=max_len)
        t0 = time.perf_counter()
        h = rt_serve.run(app, name="llm", route_prefix="/llm",
                         timeout_s=900)
        deploy_s = time.perf_counter() - t0
        addr = rt_serve.http_address()
        card = h.card.remote().result(timeout_s=120)
        if card["CUDA_VISIBLE_DEVICES"] != "0" or card["device_count"] != 1:
            raise AssertionError(f"replica not pinned to one card: {card}")
        # first use: the kernel library loads in the replica
        _, warm_s = post(addr, "/llm", {"tokens": [list(range(1, 9))],
                                        "max_new_tokens": 4})
        hop = hop_cost(addr, prompts[0])
        # what the replica burns with no request in flight
        _, idle_cpu = cpu_window(h, lambda: time.sleep(2.0))
        d0 = h.reset_counts.remote().result(timeout_s=120)
        (outs, batch_s), batch_cpu = cpu_window(h, lambda: post(
            addr, "/llm", {"tokens": prompts,
                           "max_new_tokens": max_new_tokens}))
        _well_formed(outs, max_new_tokens, cfg.vocab_size)
        batch_stats = h.stats.remote().result(timeout_s=120)
        with ThreadPoolExecutor(len(prompts)) as pool:
            single, conc_cpu = cpu_window(h, lambda: list(pool.map(
                lambda p: post(addr, "/llm", {
                    "tokens": [p], "max_new_tokens": max_new_tokens}),
                prompts)))
        conc_s = conc_cpu["wall_s"]
        _well_formed([o[0][0] for o in single], max_new_tokens,
                     cfg.vocab_size)
        stats = h.stats.remote().result(timeout_s=120)
        launches = h.launches.remote().result(timeout_s=120)
        graphs = h.graphs.remote().result(timeout_s=120)
        on_graphs(graphs, "the replica")
        dispatches = stats["decode_kernel_dispatch_total"] - d0
        need = cfg.n_layers * chunk * dispatches
        if stats["decode_kernel"] != "kernel" or dispatches <= 0 \
                or stats["decode_fallback_dispatch_total"] != 0:
            raise AssertionError(f"the replica left the kernel route: "
                                 f"{stats['decode_kernel']}, "
                                 f"{stats['decode_fallback_dispatch_total']}")
        want = {"paged_kv_append": 0, "paged_decode_attention": 0,
                "paged_append_decode_attention": need}
        if launches != want:
            raise AssertionError(f"replica launches {launches}, want {want}"
                                 f" (L x chunk x dispatches = {need})")
        same = sum(a == b for o, m in zip(outs, main_outs)
                   for a, b in zip(o, m))
        lat = sorted(o[1] for o in single)
        rt_serve.delete("llm")
        # the tiny replica takes the card once the deleted one let go
        deadline = time.monotonic() + 120
        while rt.available_resources().get("GPU", 0.0) < gpus:
            if time.monotonic() > deadline:
                raise AssertionError("the deleted replica kept its GPU")
            time.sleep(0.2)
        tiny = tiny_over_http(addr, dep)
    finally:
        rt_serve.shutdown()
        rt.shutdown()
    n_tok = len(prompts) * max_new_tokens
    return {
        "phase": "serve_plane",
        "path": "HTTP -> proxy -> router -> replica actor (num_gpus=1)",
        "model": "llama3_8b", "dim": cfg.dim, "n_layers": cfg.n_layers,
        "dtype": str(cfg.dtype).replace("torch.", ""), "depth_cut": False,
        "slots": slots, "chunk": chunk, "block_size": block_size,
        "max_len": max_len, "gpus_detected": gpus,
        "gpus_by_nvml": accelerators._nvml_count(), "replica_card": card,
        "mem_free_gb_before": free_gb, "deploy_s": deploy_s,
        "first_request_s": warm_s, "hop": hop, "idle_cpu": idle_cpu,
        "batch_post": {"requests": len(prompts), "wall_s": batch_s,
                       "tokens_per_s": n_tok / batch_s, "cpu": batch_cpu,
                       "ttft_p50_s": batch_stats["ttft_p50_s"],
                       "ttft_p90_s": batch_stats["ttft_p90_s"]},
        "concurrent_posts": {
            "requests": len(prompts), "wall_s": conc_s,
            "tokens_per_s": n_tok / conc_s, "cpu": conc_cpu,
            "latency_p50_s": lat[len(lat) // 2],
            "latency_p90_s": lat[min(len(lat) - 1, int(len(lat) * 0.9))],
            "ttft_p50_s": stats["ttft_p50_s"],
            "ttft_p90_s": stats["ttft_p90_s"]},
        "decode_kernel": stats["decode_kernel"],
        "decode_kernel_dispatch_total": dispatches,
        "decode_fallback_dispatch_total":
            stats["decode_fallback_dispatch_total"],
        "launches": launches, "fused_launches_want": need,
        "chunk_graphs": graphs,
        "tick_phases": {
            "batch_post": tick_phases(batch_stats, d0, batch_stats["ticks"]),
            "concurrent_posts": tick_phases(stats, batch_stats["ticks"],
                                            stats["ticks"])},
        "tokens_equal_main_path_share": same / n_tok,
        "tiny_f32": tiny,
    }


def tiny_over_http(addr, dep) -> dict:
    """A tiny replica with f32 compute on the card, over HTTP: its greedy
    tokens equal `generate` in the driver on `_build_model("tiny", 0)`'s
    params, exactly; more requests than slots, two sharing a prefix."""
    app = dep.options(name="Tiny", health_check_timeout_s=300,
                      ray_actor_options={"num_gpus": 1}).bind(
        model_size="tiny", max_new_tokens=9, slots=4, chunk=4,
        block_size=8, max_len=64, f32_compute=True)
    t0 = time.perf_counter()
    rt_serve.run(app, name="tiny", route_prefix="/tiny", timeout_s=600)
    deploy_s = time.perf_counter() - t0
    cfg, params = _build_model("tiny", 0, device="cuda")
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    rng = np.random.default_rng(42)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size, size=16)]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, size=int(n))]
               for n in rng.integers(1, 24, size=7)]
    prompts[3] = shared + [5, 6]
    prompts[5] = shared + [7]
    outs, _ = post(addr, "/tiny", {"tokens": prompts, "max_new_tokens": 9})
    want = [llama.generate(cfg, params, [p], 9)[0].tolist() for p in prompts]
    rt_serve.delete("tiny")
    if outs != want:
        raise AssertionError(f"tiny f32 over HTTP != generate: {outs} vs "
                             f"{want}")
    return {"requests": len(prompts), "tokens_equal_generate": True,
            "deploy_s": deploy_s}


# ----------------------------------------------------------------------
# flash attention (K1-K4)
# ----------------------------------------------------------------------
def flash_case(BH, T, D, dtype, causal, device, seed=0) -> dict:
    """Seeded q, k, v, dO [BH, T, D] and the plain forward's O, LSE and
    delta: the inputs each backward kernel shares with its plain
    version."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn((BH, T, D), generator=gen,
                               device=device).to(dtype) for _ in range(4))
    scale = D ** -0.5
    o, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return {"q": q, "k": k, "v": v, "do": do, "o": o, "lse": lse,
            "delta": delta, "causal": causal, "scale": scale}


def run_flash(name: str, c: dict, plain: bool = False) -> tuple:
    fn = getattr(fa, name + "_reference" if plain else name)
    args = (c["q"], c["k"], c["v"])
    if name == "flash_bwd_fused":
        args += (c["do"], c["lse"], c["o"])
    elif name != "flash_fwd":
        args += (c["do"], c["lse"], c["delta"])
    out = fn(*args, c["causal"], c["scale"])
    return out if isinstance(out, tuple) else (out,)


def compare(got, want, tol: dict) -> tuple:
    """(max abs error, max |got - want| / (atol + rtol |want|), norm of
    the difference / norm of want), in f32; the second must stay <= 1
    and the third <= tol["rel"]."""
    g, w = got.detach().float(), want.detach().float()
    d = (g - w).abs()
    return (float(d.max()),
            float((d / (tol["atol"] + tol["rtol"] * w.abs())).max()),
            float(torch.linalg.vector_norm(g - w)
                  / torch.linalg.vector_norm(w)))


def within(errs, tol: dict) -> bool:
    return errs[1] <= 1.0 and errs[2] <= tol["rel"]


def flash_tol(name: str, kind: str) -> dict:
    """FLASH_TOL[kind], with the kernel's own norm limit in bf16."""
    if kind == "f32":
        return FLASH_TOL[kind]
    return {**FLASH_TOL[kind], "rel": FLASH_REL_BF16[name]}


def check_flash(c: dict, kind: str) -> dict:
    """K1-K4 each against its plain version on the same inputs.  Returns
    {name: (max abs err, elementwise ratio, relative norm)}, each the
    worst over the kernel's outputs; raises beyond flash_tol(name, kind)."""
    out = {}
    for name in FLASH:
        tol = flash_tol(name, kind)
        got, want = run_flash(name, c), run_flash(name, c, plain=True)
        worst = (0.0, 0.0, 0.0)
        for g, w in zip(got, want):
            if (g.shape != w.shape or g.dtype != w.dtype
                    or not bool(torch.isfinite(g.float()).all())):
                raise AssertionError(f"{name}: misshapen or non-finite")
            worst = tuple(map(max, worst, compare(g, w, tol)))
        if not within(worst, tol):
            raise AssertionError(f"{name} {kind}: (max abs, elementwise "
                                 f"ratio, rel norm) {worst} beyond {tol}")
        out[name] = worst
    return out


def flash_flops(name: str, c: dict) -> float:
    """2 * D per (q, k) pair per product, over the pairs this call needs
    (the lower triangle with the diagonal when causal); K1 does 2
    products, K2 5, K3 3, K4 4."""
    BH, T, D = c["q"].shape
    pairs = BH * (T * (T + 1) // 2 if c["causal"] else T * T)
    mats = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3,
            "flash_bwd_dkv": 4}[name]
    return 2.0 * D * pairs * mats


def flash_bound(name: str, c: dict) -> tuple:
    """Operations: `flash_flops`.  Bytes: each input read once, each
    output written once."""
    BH, T, D = c["q"].shape
    n = BH * T * D * c["q"].element_size()
    vec = BH * T * 4
    n_bytes = {"flash_fwd": 4 * n + vec, "flash_bwd_fused": 8 * n + vec,
               "flash_bwd_dq": 5 * n + 2 * vec,
               "flash_bwd_dkv": 6 * n + 2 * vec}[name]
    return _bound(n_bytes, flash_flops(name, c), c["q"].dtype)


def sdpa_yardsticks(c: dict, H: int) -> tuple:
    """`scaled_dot_product_attention` on the same inputs as [B, H, T, D]:
    its forward ms, and its backward ms (forward + backward minus
    forward)."""
    BH, T, D = c["q"].shape
    shape = (BH // H, H, T, D)
    q, k, v, do = (c[n].view(shape) for n in ("q", "k", "v", "do"))
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def fwd():
        F.scaled_dot_product_attention(q, k, v, is_causal=c["causal"])

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg,
                                             is_causal=c["causal"])
        torch.autograd.grad(out, (qg, kg, vg), do)

    f = time_ms(fwd)
    return f, time_ms(fwd_bwd) - f


def time_flash(c: dict, H: int, names=FLASH) -> dict:
    """ms / plain_ms / bound_ms / library_ms of the kernels `names` of
    K1-K4 on one case, with the achieved TFLOP/s, ms over the bound and
    ms over SDPA's.  The library call for K1 is SDPA's forward, for K2
    its backward; no one call computes K3's or K4's function alone, so
    they are set against SDPA's backward (the pair's yardstick, also in
    the phase line) and their library_ms stays null."""
    lib_fwd, lib_bwd = sdpa_yardsticks(c, H)
    out = {}
    for name in names:
        bound, by = flash_bound(name, c)
        ms = time_ms(lambda: run_flash(name, c))
        sdpa = lib_fwd if name == "flash_fwd" else lib_bwd
        out[name] = {
            "ms": ms,
            "plain_ms": time_ms(lambda: run_flash(name, c, plain=True)),
            "bound_ms": bound, "bound_by": by,
            "library_ms": {"flash_fwd": lib_fwd,
                           "flash_bwd_fused": lib_bwd}.get(name),
            "tflops": flash_flops(name, c) / (ms * 1e-3) / 1e12,
            "x_bound": ms / bound,
            "x_sdpa": ms / sdpa,
        }
    return out, lib_bwd


def reset_counts() -> None:
    for name in FLASH:
        getattr(fa, name).launches = 0
    fa.flash_attention.plain_dispatches = 0
    for name in PAGED:
        getattr(pa, name).launches = 0
    for name in XENT:
        getattr(xp, name).launches = 0


def read_counts() -> dict:
    return {name: getattr(fa, name).launches for name in FLASH}


# ----------------------------------------------------------------------
# the training main path
# ----------------------------------------------------------------------
def route_grads(cfg, params, tokens) -> tuple:
    """The loss and the gradients of the attention weights, qkv (which
    only the attention backward reaches) and out (fed by its forward)."""
    names = ("attn_qkv_w", "attn_out_w")
    ws = [params["blocks"][n].requires_grad_(True) for n in names]
    loss = gpt2.loss_fn(cfg, params, tokens)
    grads = torch.autograd.grad(loss, ws)
    return float(loss.detach()), dict(zip(names, grads))


def run_training(device, *, cfg=None, batch=32, seq=1024, warmup=2,
                 steps=5) -> dict:
    """GPT-2 (124M by default) through `make_train_step`: the step-0 loss
    and attention-weight gradients on the flash and dense routes from
    the initial params, `warmup` steps, then `steps` timed steps with
    the counts of exactly those steps."""
    state = train_gpt2.build(device, batch, seq, seed=0, cfg=cfg)
    cfg = state["cfg"]
    routes = {a: route_grads(dataclasses.replace(cfg, attention=a),
                             state["params"], state["tokens"])
              for a in ("flash", "dense")}
    (loss_flash, g_flash), (loss_dense, g_dense) = (routes["flash"],
                                                    routes["dense"])
    grad_err = {n: float(torch.linalg.vector_norm(g_flash[n] - g_dense[n])
                         / torch.linalg.vector_norm(g_dense[n]))
                for n in g_dense}
    del routes, g_flash, g_dense
    if (abs(loss_flash - loss_dense) > FULL_LOSS_TOL
            or max(grad_err.values()) > FULL_GRAD_TOL):
        raise AssertionError(f"step 0, flash vs dense: loss {loss_flash} "
                             f"vs {loss_dense}, grads {grad_err}")
    warm = train_gpt2.run_steps(state, warmup)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    timed = train_gpt2.run_steps(state, steps)
    launches = read_counts()
    plain = fa.flash_attention.plain_dispatches
    want = {"flash_fwd": steps * cfg.n_layer * 2,
            "flash_bwd_fused": steps * cfg.n_layer,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != want or plain != 0:
        raise AssertionError(f"training launches {launches} (want {want}), "
                             f"plain dispatches {plain}")
    summary = train_gpt2.summarize(state, timed)
    losses = [s["loss"] for s in warm] + summary["losses"]
    if not all(math.isfinite(x) for x in losses + summary["grad_norms"]):
        raise AssertionError(f"non-finite training metrics: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"step-0 loss {losses[0]} far from "
                             f"ln V = {math.log(cfg.vocab_size)}")
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    return {"launches": launches, "line": {
        "phase": "train_main_path", "model": "gpt2_124m",
        "n_layer": cfg.n_layer, "n_embd": cfg.n_embd, "n_head": cfg.n_head,
        "vocab": cfg.vocab_size, "dtype": str(cfg.dtype).replace(
            "torch.", ""), "master_dtype": "float32",
        "logits_dtype": str(cfg.logits_dtype).replace("torch.", ""),
        "attention": cfg.attention, "remat_policy": cfg.remat_policy,
        "depth_cut": False, "batch": batch, "seq": seq,
        "warmup_steps": warmup, "timed_steps": steps,
        "step0_loss": losses[0], "step0_loss_flash": loss_flash,
        "step0_loss_dense": loss_dense,
        "step0_grad_rel_err_flash_vs_dense": grad_err,
        "step0_tolerance": {"loss": FULL_LOSS_TOL, "grad": FULL_GRAD_TOL},
        "launches": launches, "launches_want": want,
        "plain_dispatches": plain, "peak_mem_gb": peak,
        **{k: summary[k] for k in ("tokens_per_step", "n_params", "step_ms",
                                   "losses", "grad_norms", "tokens_per_s",
                                   "mfu")},
    }}


def split_route(device, *, B=32, T=1024, H=12, D=64, block=256) -> dict:
    """The flash op with blocks of `block` (bf16, causal), forward and
    backward: K1, then K3 + K4 with delta from the wrapper.  Held against
    dense attention's autograd in f32 on the same inputs."""
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    q, k, v, w = (torch.randn((B, T, H, D), generator=gen, device=device)
                  for _ in range(4))
    xs = [t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v)]
    reset_counts()
    out = fa.flash_attention(*xs, True, block, block)
    grads = torch.autograd.grad(out, xs, w.to(torch.bfloat16))
    launches = read_counts()
    if (launches["flash_bwd_dq"] != 1 or launches["flash_bwd_dkv"] != 1
            or launches["flash_bwd_fused"] != 0
            or fa.flash_attention.plain_dispatches != 0):
        raise AssertionError(f"split route launches {launches}")
    ref = [t.detach().float().requires_grad_(True) for t in xs]
    dense = plain_attention(*ref, causal=True)
    want = (dense, *torch.autograd.grad(dense, ref, w))
    errs = {n: compare(g, r, SPLIT_TOL)
            for n, g, r in zip(("out", "dq", "dk", "dv"), (out, *grads), want)}
    if not all(within(e, SPLIT_TOL) for e in errs.values()):
        raise AssertionError(f"split route vs dense: {errs}")
    return {"launches": launches, "line": {
        "phase": "split_route", "B": B, "T": T, "H": H, "D": D,
        "block_q": block, "block_k": block, "dtype": "bfloat16",
        "launches": launches,
        "max_abs_elementwise_relnorm": errs, "tolerance": SPLIT_TOL}}


def route_parity(device, steps=3) -> dict:
    """Tiny GPT-2 in f32: `steps` AdamW steps on the flash kernels and on
    dense attention, from the same params and tokens."""
    base = dataclasses.replace(gpt2.GPT2Config.tiny(), dtype=torch.float32)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, base.vocab_size, (4, 129)), dtype=torch.int32, device=device)
    runs = {}
    for attention in ("flash", "dense"):
        cfg = dataclasses.replace(base, attention=attention)
        params = gpt2.init_params(cfg, 0, device=device)
        opt = gpt2.default_optimizer(lr=ROUTE_LR, warmup_steps=1,
                                     total_steps=10)
        state, step = opt.init(params), gpt2.make_train_step(cfg, opt)
        metrics = []
        for _ in range(steps):
            params, state, m = step(params, state, tokens)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs[attention] = (metrics, params)
    (mf, pf), (md, pd) = runs["flash"], runs["dense"]
    metric_err = max(abs(a - b) / abs(b) for x, y in zip(mf, md)
                     for a, b in zip(x, y))
    E = base.n_embd
    with torch.no_grad():
        kb_err = float((pf["blocks"]["attn_qkv_b"][:, E:2 * E]
                        - pd["blocks"]["attn_qkv_b"][:, E:2 * E]).abs().max())
        for p in (pf, pd):
            p["blocks"]["attn_qkv_b"][:, E:2 * E] = 0.0
        param_err = max(float((a - b).abs().max())
                        for a, b in zip(gpt2._leaves(pf), gpt2._leaves(pd)))
    if (metric_err > ROUTE_TOL["loss"] or param_err > ROUTE_TOL["params"]
            or kb_err > ROUTE_TOL["key_bias"]):
        raise AssertionError(f"flash vs dense: metrics {metric_err}, "
                             f"params {param_err}, key bias {kb_err}")
    return {"phase": "route_parity", "model": "gpt2_tiny_f32",
            "steps": steps, "losses_flash": [m[0] for m in mf],
            "losses_dense": [m[0] for m in md],
            "max_rel_err_loss_gnorm": metric_err,
            "max_abs_err_params": param_err,
            "max_abs_err_key_bias": kb_err, "tolerance": ROUTE_TOL}


# ----------------------------------------------------------------------
# the fused cross entropy (K7-K9)
# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# Llama's training half: the LoRA trainer
# ----------------------------------------------------------------------
def lora_route_grads(cfg, state) -> tuple:
    """Step 0 on `cfg`'s attention route: the loss and the gradients of
    the adapters' B leaves (every A gradient is zero while B is)."""
    lora = state["lora"]
    names = sorted(n for n in lora["blocks"] if n.endswith("_b"))
    ws = [lora["blocks"][n].requires_grad_(True) for n in names]
    loss = llama.loss_fn(cfg, state["params"], state["tokens"], lora=lora)
    grads = torch.autograd.grad(loss, ws)
    for w in ws:
        w.requires_grad_(False)
    return float(loss.detach()), dict(zip(names, grads))


def llama_lora_train(device, *, batch=8, seq=1024, warmup=1, steps=6,
                     route_layers=4) -> dict:
    """`scripts/train_llama_lora.py`'s run at full size (the JAX bench's
    `bench_llama_lora` config, frozen bf16 base, rank-8 LoRA): the
    flash route's step-0 loss and LoRA-B gradients against the dense
    route's at `route_layers` layers, then `warmup` + `steps` steps
    with the flash launches of exactly the timed steps (K1 twice a
    layer, forward and remat replay; K2 once; no K3 / K4, no plain
    dispatch), the loss near ln V at step 0 and falling on the repeated
    batch; K1 and K2 held and timed at this path's attention shape."""
    cfg_r = train_llama_lora.lora_config(n_layers=route_layers)
    st = train_llama_lora.build(device, batch, seq, seed=0, cfg=cfg_r)
    routes = {a: lora_route_grads(dataclasses.replace(cfg_r, attention=a),
                                  st) for a in ("flash", "dense")}
    (loss_flash, g_flash), (loss_dense, g_dense) = (routes["flash"],
                                                    routes["dense"])
    grad_err = {n: float(torch.linalg.vector_norm(g_flash[n] - g_dense[n])
                         / torch.linalg.vector_norm(g_dense[n]))
                for n in g_dense}
    del st, routes, g_flash, g_dense
    if (abs(loss_flash - loss_dense) > FULL_LOSS_TOL
            or max(grad_err.values()) > FULL_GRAD_TOL):
        raise AssertionError(f"LoRA step 0, flash vs dense: loss "
                             f"{loss_flash} vs {loss_dense}, B grads "
                             f"{grad_err}")
    torch.cuda.empty_cache()
    res = train_llama_lora.bench_llama_lora(device, batch, seq, steps,
                                            warmup)
    cfg = res.pop("state")["cfg"]
    torch.cuda.empty_cache()
    launches = res["launches"]
    want = {"flash_fwd": steps * cfg.n_layers * 2,
            "flash_bwd_fused": steps * cfg.n_layers, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "plain_dispatches": 0}
    if launches != want:
        raise AssertionError(f"LoRA training launches {launches}, want "
                             f"{want}")
    losses = res["warmup_losses"] + res["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite LoRA losses: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"LoRA step-0 loss {losses[0]} far from "
                             f"ln V = {math.log(cfg.vocab_size)}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"LoRA loss did not fall: {losses}")
    case = flash_case(batch * cfg.n_heads, seq, cfg.head_dim,
                      torch.bfloat16, True, device, seed=seq)
    errs = check_flash(case, "bf16")
    timed, _ = time_flash(case, H=cfg.n_heads,
                          names=("flash_fwd", "flash_bwd_fused"))
    del case
    torch.cuda.empty_cache()
    return {
        "phase": "llama_lora_train", "model": "llama_1b4",
        "source": "bench.py bench_llama_lora (its chip config)",
        "vocab": cfg.vocab_size, "dim": cfg.dim, "n_layers": cfg.n_layers,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "intermediate": cfg.intermediate,
        "attention": cfg.attention, "remat": cfg.remat,
        "base_dtype": "bfloat16", "lora_rank": 8,
        "lora_targets": list(llama.LORA_TARGETS), "optimizer": "adamw(2e-4)",
        "depth_cut": False, "batch": batch, "seq": seq,
        "warmup_steps": warmup, "timed_steps": steps,
        "step0_loss": losses[0], "losses_all": losses,
        "route_check_layers": route_layers,
        "step0_loss_flash": loss_flash, "step0_loss_dense": loss_dense,
        "step0_lora_b_grad_rel_err_flash_vs_dense": grad_err,
        "step0_tolerance": {"loss": FULL_LOSS_TOL, "grad": FULL_GRAD_TOL},
        "launches": launches, "launches_want": want,
        **{k: res[k] for k in ("tokens_per_step", "n_params",
                               "n_lora_params", "step_ms", "tokens_per_s",
                               "mfu", "peak_mem_gb")},
        "k1_k2_at_this_shape": {
            "BH": batch * cfg.n_heads, "T": seq, "D": cfg.head_dim,
            "dtype": "bf16", "causal": True,
            "vs_plain_max_abs_elementwise_relnorm": errs, **timed},
    }


# ----------------------------------------------------------------------
# the train plane: CudaTrainer, two data-parallel workers on one card
# ----------------------------------------------------------------------
# ring / Ulysses on the card against dense attention on the whole
# sequence: f32 to rounding (blocks summed in another order), bf16 the
# reference's own attention tolerance; the gradient of a sum through the
# ring in f32 as the reference's own test holds it (1e-3 / 1e-4, tightened
# to 1e-4 / 1e-4)
SP_TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2,
                                                          atol=2e-2)}
SP_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _records(out_dir: str) -> dict:
    """rank -> the JSON lines `dp_train_loop` appended, in order."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith("rank") and name.endswith(".jsonl"):
            with open(os.path.join(out_dir, name)) as f:
                out[int(name[4:-6])] = [json.loads(ln) for ln in f]
    return out


# the train plane and the data feed run the LoRA bench's width at 4 of
# its 22 layers: what they hold (the sync, checkpoint and resume, the
# feed) does not depend on depth, and the script keeps its time limit
PLANE_LAYERS = 4
PLANE_REDUCED = ("depth 22 -> 4 layers: keeps the script in its time "
                 "limit; the trainer's and the feed's mechanisms do not "
                 "depend on depth")


def train_plane(device, *, batch=8, seq=1024, steps=3, resume_steps=1,
                cfg=None) -> dict:
    """`CudaTrainer(...).fit()` with two collective-mode workers sharing
    the card (`GPU` 0.5 each), each running `dp_train_loop` on its half
    of the global batch at the bench's LoRA size, gradients synced over
    the host collective group every step; rank 0 checkpoints every step
    and a second `fit` resumes from the last checkpoint for
    `resume_steps` more.  Then `torch_distributed` mode: one worker on
    the whole card joins an NCCL group, builds its mesh on `cuda` and
    takes one step.  The runtime is shut down on the way out."""
    from ray_tpu_torch.train import (CheckpointConfig, CudaConfig,
                                     CudaTrainer, RunConfig, ScalingConfig)

    cfg = cfg or train_llama_lora.lora_config(n_layers=PLANE_LAYERS)
    work = tempfile.mkdtemp(prefix="rtt_train_plane_")
    dirs = {k: os.path.join(work, k) for k in ("fit1", "fit2", "nccl",
                                               "store")}
    for d in dirs.values():
        os.makedirs(d)
    base = {"device": device.type, "batch": batch, "seq": seq, "seed": 0,
            "cfg": cfg}
    scaling = ScalingConfig(num_workers=2, use_gpu=True,
                            resources_per_worker={"GPU": 0.5, "CPU": 1})
    run = RunConfig(name="train_plane", storage_path=dirs["store"],
                    checkpoint_config=CheckpointConfig(num_to_keep=1))
    rt.init(num_workers=2, num_cpus=8)
    try:
        t0 = time.time()
        res1 = CudaTrainer(
            train_llama_lora.dp_train_loop,
            train_loop_config={**base, "steps": steps,
                               "out_dir": dirs["fit1"]},
            scaling_config=scaling, run_config=run,
            cuda_config=CudaConfig(distributed_mode="collective",
                                   device=device.type)).fit()
        fit1_s = time.time() - t0
        if res1.error is not None:
            raise AssertionError(f"train_plane fit failed: {res1.error!r}")
        saved = res1.checkpoint.to_dict()
        t1 = time.time()
        res2 = CudaTrainer(
            train_llama_lora.dp_train_loop,
            train_loop_config={**base, "steps": steps + resume_steps,
                               "out_dir": dirs["fit2"]},
            scaling_config=scaling, run_config=run,
            resume_from_checkpoint=res1.checkpoint,
            cuda_config=CudaConfig(distributed_mode="collective",
                                   device=device.type)).fit()
        if res2.error is not None:
            raise AssertionError(f"resumed fit failed: {res2.error!r}")
        fit2_s = time.time() - t1
        t2 = time.time()
        res3 = CudaTrainer(
            train_llama_lora.dp_train_loop,
            train_loop_config={**base, "steps": 1, "out_dir": dirs["nccl"]},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="nccl", storage_path=dirs["store"]),
            cuda_config=CudaConfig(distributed_mode="torch_distributed",
                                   device=device.type),
        ).fit()
        if res3.error is not None:
            raise AssertionError(f"torch_distributed fit failed: "
                                 f"{res3.error!r}")
        fit3_s = time.time() - t2
    finally:
        rt.shutdown()
    recs1, recs2, recs3 = (_records(dirs[k]) for k in ("fit1", "fit2",
                                                       "nccl"))
    # the reference: one process, the whole batch, after the trainer
    ref = train_llama_lora.build(device, batch, seq, 0, cfg)
    ref_loss, ref_grads = train_llama_lora.lora_grads(ref, ref["tokens"])
    ref_loss = float(ref_loss)
    flat_ref = torch.cat([g.float().reshape(-1) for g in ref_grads])

    def rel_to_ref(fit: str) -> float:
        """A fit's first synced gradient (rank 0's `grad0.npz`) against
        the one-process gradient, by the relative norm of the gap."""
        with np.load(os.path.join(dirs[fit], "grad0.npz")) as z:
            flat = torch.cat([torch.from_numpy(z[f"arr_{i}"]).reshape(-1)
                              for i in range(len(z.files))]).to(device)
        return float(torch.linalg.vector_norm(flat - flat_ref)
                     / torch.linalg.vector_norm(flat_ref))

    grad_rel, nccl_grad_rel = rel_to_ref("fit1"), rel_to_ref("nccl")
    n_grad = int(flat_ref.numel())
    del ref, ref_grads, flat_ref
    torch.cuda.empty_cache()
    return {"recs": (recs1, recs2, recs3), "saved": saved,
            "ref_loss": ref_loss, "grad_rel": grad_rel,
            "nccl_grad_rel": nccl_grad_rel, "n_grad": n_grad,
            "fit_s": (fit1_s, fit2_s, fit3_s), "t0": (t0, t1, t2),
            "batch": batch, "seq": seq, "steps": steps,
            "resume_steps": resume_steps, "work": work,
            "cfg": cfg}


def train_plane_lines(tp: dict, smi: str) -> tuple:
    """The `train_plane` and `torch_distributed` lines, each gate held."""
    recs1, recs2, recs3 = tp["recs"]
    cfg = tp["cfg"]
    steps, batch, seq = tp["steps"], tp["batch"], tp["seq"]
    if sorted(recs1) != [0, 1] or sorted(recs2) != [0, 1]:
        raise AssertionError(f"train_plane ranks reported: {sorted(recs1)}, "
                             f"{sorted(recs2)}")
    for recs, n, first in ((recs1, steps, 1), (recs2, tp["resume_steps"],
                                               steps + 1)):
        for r in (0, 1):
            got = [x["step"] for x in recs[r] if "step" in x]
            if got != list(range(first, first + n)):
                raise AssertionError(f"rank {r} steps {got}")
        # the data-parallel invariant: both ranks hold the same adapters
        # after every step, bit for bit
        for a, b in zip(recs[0], recs[1]):
            if a.get("digest") != b.get("digest"):
                raise AssertionError(f"ranks diverged at {a} / {b}")
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_fused": cfg.n_layers,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "plain_dispatches": 0}
    for recs in (recs1, recs2, recs3):
        for r, lines in recs.items():
            for x in lines:
                if "launches" in x and x["launches"] != want:
                    raise AssertionError(f"rank {r} step {x['step']} "
                                         f"launches {x['launches']}, want "
                                         f"{want}")
    losses = [x["global_loss"] for x in recs1[0]] + [
        x["global_loss"] for x in recs2[0] if "step" in x]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"step-0 loss {losses[0]} far from ln V")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_plane loss did not fall: {losses}")
    if tp["grad_rel"] > FULL_GRAD_TOL:
        raise AssertionError(f"synced step-0 gradient vs one process on "
                             f"the whole batch: {tp['grad_rel']}")
    saved = tp["saved"]
    resumed = [x for x in recs2[0] if "resumed_from" in x]
    ck_digest = train_llama_lora.digest_arrays(gpt2._leaves(saved["lora"]))
    if (saved["step"] != steps or not resumed
            or resumed[0]["resumed_from"] != steps
            or resumed[0]["digest_at_resume"] != ck_digest):
        raise AssertionError(f"resume: checkpoint step {saved['step']}, "
                             f"worker {resumed}, checkpoint digest "
                             f"{ck_digest}")
    tokens = batch * seq
    step_ms = [max(a["ms"], b["ms"]) for a, b in zip(recs1[0], recs1[1])]
    steady = step_ms[1:]
    sync = {k: [max(a["sync_ms"][k], b["sync_ms"][k])
                for a, b in zip(recs1[0], recs1[1])]
            for k in ("d2h", "allreduce", "h2d")}
    first_entry = min(recs1[r][0]["loop_entry"] for r in (0, 1))
    first_step = min(recs1[r][0]["t_start"] for r in (0, 1))
    plane = {
        "phase": "train_plane", "nvidia_smi": smi,
        "trainer": "CudaTrainer", "distributed_mode": "collective",
        "workers": 2, "resources_per_worker": {"GPU": 0.5, "CPU": 1},
        "model": "llama_1b4", "source": "bench.py bench_llama_lora (its "
        "chip config)", "reduced": PLANE_REDUCED, "n_layers": cfg.n_layers,
        "dim": cfg.dim, "attention": cfg.attention, "lora_rank": 8,
        "global_batch": batch,
        "seq": seq, "local_batch": batch // 2, "steps": steps,
        "resume_steps": tp["resume_steps"], "global_losses": losses,
        "step0_loss": losses[0], "ln_vocab": math.log(cfg.vocab_size),
        "ranks_bit_equal_every_step": True,
        "grad_values": tp["n_grad"], "grad_bytes_f32": 4 * tp["n_grad"],
        "ring_path": 4 * tp["n_grad"] >= collectives._RING_MIN_BYTES,
        "step0_synced_grad_rel_err_vs_one_process": tp["grad_rel"],
        "step0_grad_tolerance": FULL_GRAD_TOL,
        "one_process_step0_loss": tp["ref_loss"],
        "launches_per_step_per_worker": want,
        "launches_total": {k: sum(x["launches"][k] for recs in (recs1, recs2)
                                  for lines in recs.values() for x in lines
                                  if "launches" in x) for k in want},
        "step_ms": step_ms, "tokens_per_s_steady":
            tokens * len(steady) / (sum(steady) / 1e3),
        "sync_ms": sync,
        "peak_mem_gb": {r: max(x["peak_gb"] for x in recs1[r])
                        for r in (0, 1)},
        "startup_s": first_entry - tp["t0"][0],
        "build_s": first_step - first_entry,
        "fit_s": tp["fit_s"][0], "resumed_fit_s": tp["fit_s"][1],
        "resumed_from_step": steps,
        "resumed_digest_equals_checkpoint": True,
    }
    n3 = recs3.get(0, [])
    steps3 = [x for x in n3 if "step" in x]
    meshes = [x for x in n3 if "mesh" in x]
    if len(steps3) != 1 or not meshes:
        raise AssertionError(f"torch_distributed records: {n3}")
    m = meshes[0]["mesh"]
    if m["device_type"] != "cuda" or m["backend"] != "nccl":
        raise AssertionError(f"torch_distributed mesh: {m}")
    loss3 = steps3[0]["loss"]
    if abs(loss3 - tp["ref_loss"]) > 1e-5 * abs(tp["ref_loss"]):
        raise AssertionError(f"torch_distributed step loss {loss3} vs the "
                             f"single-process step {tp['ref_loss']}")
    # the step's gradient, after the NCCL all-reduce, against the one
    # process's: the loss alone is computed before any exchange
    if tp["nccl_grad_rel"] > FULL_GRAD_TOL:
        raise AssertionError(f"torch_distributed synced gradient vs one "
                             f"process: {tp['nccl_grad_rel']}")
    nccl = {"phase": "torch_distributed", "nvidia_smi": smi,
            "distributed_mode": "torch_distributed", "workers": 1,
            "num_gpus": 1, "mesh": m, "loss": loss3,
            "single_process_loss": tp["ref_loss"],
            "loss_diff": loss3 - tp["ref_loss"],
            "synced_grad_rel_err_vs_one_process": tp["nccl_grad_rel"],
            "grad_tolerance": FULL_GRAD_TOL,
            "sync_ms": steps3[0]["sync_ms"],
            "step_ms": steps3[0]["ms"], "fit_s": tp["fit_s"][2],
            "launches": steps3[0]["launches"]}
    return plane, nccl


# ----------------------------------------------------------------------
# ring and Ulysses attention over a process group, on the card
# ----------------------------------------------------------------------
# the sharded step (`sharded_train`): four gloo ranks sharing the card
# over fsdp 2 x tp 2, GPT-2 124M and the LoRA bench's width, against one
# process's step on the same weights and batch; the state resharded onto
# fsdp 4 x tp 1 through a sharded checkpoint
SHARD_WORLD = 4
SHARD_MESH = {"fsdp": 2, "tp": 2}
SHARD_RELOAD_MESH = {"fsdp": 4}
SHARD_BATCH, SHARD_SEQ = 8, 1024
SHARD_TIMED = 2  # steps after the first
# step 0 against one process: the loss relative (the lse over a
# vocabulary split over tp, bf16 products summed in other orders), the
# pre-clip gradient norm relative (the data ranks' gradients summed
# through the host in f32 where one process sums one batch); the f32
# params' norm across the reshard (the same values, summed per block)
SHARD_LOSS_TOL = 2e-2
SHARD_GRAD_TOL = 3e-2
SHARD_NORM_TOL = 1e-6
SHARD_LORA_LAYERS = 4  # the LoRA bench's 22 layers cut, as train_plane
# sequence parallelism inside the sharded step, on the same ranks: GPT-2
# 124M over tp 2 x sp 2 with ring attention (1 + 1 steps) and Ulysses
# (one step), the LoRA width over dp 2 x sp 2 with the ring (one step),
# each against one process on the same weights and batch at the limits
# above; then the multichip dry run in f32, each of its losses within
# DRYRUN_TOL (relative) of one process's on the same draws
SP_MESH = {"tp": 2, "sp": 2}
SP_LORA_MESH = {"dp": 2, "sp": 2}
SP_RING_STEPS = 2
DRYRUN_TOL = 1e-5
# Mixtral's expert-parallel step inside the sharded mesh, on the same
# ranks: Mixtral-8x7B's widths at depth 1 (one layer is 1.2e9 params:
# ~19 GB of f32 params, gradients and moments over the 4 ranks), over ep
# 2 x tp 2 then ep 2 x fsdp 2, (tag, mesh, steps); step 0 against one
# process's step that routes each ep chunk on its own, at the sharded
# step's limits above
MOE_SHARD_MESHES = (("ep2tp2", {"ep": 2, "tp": 2}, 2),
                    ("ep2fsdp2", {"ep": 2, "fsdp": 2}, 1))
MOE_SHARD_EP = 2
MOE_SHARD_LAYERS = 1
MOE_SHARD_BATCH = 4
MOE_SHARD_LR = 3e-4


class recorded_flash:
    """K1 and K2's wrappers, called through, recording the folded [BH,
    T, D] q of each call in this process (`shapes[name]`).  A wrapper
    counts its launches on the module's name, so the recorders carry
    the counts while they stand in, and hand them back at the end."""

    def __enter__(self):
        self.shapes = {"flash_fwd": [], "flash_bwd_fused": []}
        self.orig = {n: getattr(fa, n) for n in self.shapes}

        def recorder(name):
            def call(q, *args):
                self.shapes[name].append(tuple(q.shape))
                return self.orig[name](q, *args)
            call.launches = self.orig[name].launches
            return call

        for name in self.shapes:
            setattr(fa, name, recorder(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            fn.launches = getattr(fa, name).launches
            setattr(fa, name, fn)


def _clear_collectives() -> None:
    for c in (collectives.TRANSPORTS, collectives.TRANSPORT_BYTES,
              collectives.TRANSPORT_MS):
        c.clear()


def _collective_rows() -> dict:
    """(op / backend / route) -> calls, input bytes and host ms since the
    last `_clear_collectives`."""
    return {"/".join(k): {"calls": n,
                          "bytes": collectives.TRANSPORT_BYTES[k],
                          "ms": collectives.TRANSPORT_MS[k]}
            for k, n in sorted(collectives.TRANSPORTS.items())}


def _peak_gb(device):
    return (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)


def _sharded_step(step, args, device, debug: bool = False) -> tuple:
    """One sharded step: (its outputs, its record: wall ms to a sync, the
    K1-K4 counts and plain dispatches of this step alone, each flash
    call's folded q shape, the collectives by op and route, and with
    `debug` every c10d op it dispatched, by name)."""
    from torch.distributed.tensor.debug import CommDebugMode

    reset_counts()
    _clear_collectives()
    with recorded_flash() as rec:
        _sync(device)
        t0 = time.perf_counter()
        if debug:
            comm = CommDebugMode()
            with comm:
                outs = step(*args)
        else:
            outs = step(*args)
        loss = float(outs[-1]["loss"])
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
    rec_ = {"ms": ms, "loss": loss, "launches": read_counts(),
            "plain_dispatches": fa.flash_attention.plain_dispatches,
            "shapes": {n: [list(t) for t in sorted(set(v))]
                       for n, v in rec.shapes.items()},
            "collectives": _collective_rows()}
    for k in ("grad_norm", "ce_loss", "load_balance_loss"):
        if k in outs[-1]:
            rec_[k] = float(outs[-1][k])
    if debug:
        # every c10d op the step dispatched; DTensor's own would be
        # functional collectives
        rec_["comm_ops"] = {str(k): int(v) for k, v in
                            comm.get_comm_counts().items()}
    return outs, rec_


def shard_gpt2_config() -> gpt2.GPT2Config:
    """The train main path's GPT-2 124M (`train_gpt2.build`'s config)."""
    return gpt2.GPT2Config(attention="flash", logits_dtype=torch.bfloat16)


def shard_gpt2_inputs(cfg, device, seq: int = SHARD_SEQ) -> tuple:
    """(the params, the global batch [8, seq + 1]) from their seeds: the
    same on every rank and in the one-process reference."""
    return gpt2.init_params(cfg, 0, device=device), shard_gpt2_tokens(
        cfg, device, seq)


def shard_gpt2_tokens(cfg, device, seq: int = SHARD_SEQ):
    """The global batch [8, seq + 1] from its seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (SHARD_BATCH, seq + 1),
                         generator=gen, device=device, dtype=torch.int32)


def moe_shard_inputs(cfg, device, seq: int = SHARD_SEQ) -> tuple:
    """(the f32 params from seed 0, the global batch [4, seq + 1] from
    seed 1): the same on every rank and in the one-process reference."""
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (MOE_SHARD_BATCH, seq + 1),
                           generator=gen, device=device, dtype=torch.int32)
    return mixtral.init_params(cfg, 0, device=device), tokens


class chunk_routed:
    """While entered, Mixtral's MoE layer routes each of `ep` contiguous
    chunks of the batch on its own (`moe._moe_forward_local` a chunk,
    the capacity from the chunk) and its aux loss is the mean of the
    chunks': the reference's MoE function under a mesh that splits ep
    (`ray_tpu/parallel/moe.py`'s `shard_map` over P("ep")), on one
    process."""

    def __init__(self, ep: int):
        self.ep = ep

    def __enter__(self):
        self._orig = mixtral.moe_forward

        def chunked(cfg, params, x, mesh=None, shards=None):
            parts = [moe._moe_forward_local(cfg, params, c)
                     for c in x.chunk(self.ep)]
            return (torch.cat([y for y, _ in parts]),
                    {"load_balance_loss": torch.stack(
                        [a["load_balance_loss"] for _, a in parts]).mean()})

        mixtral.moe_forward = chunked
        return self

    def __exit__(self, *exc):
        mixtral.moe_forward = self._orig
        return False


def moe_one_process(device, cfg=None, seq: int = SHARD_SEQ) -> dict:
    """One process's step 0 on `sharded_moe`'s draws, each ep chunk of the
    batch routed on its own: the loss, its parts and the pre-clip
    gradient norm."""
    from ray_tpu_torch.parallel.sharding import global_norm

    cfg = cfg or mixtral_config(MOE_SHARD_LAYERS)
    params, tokens = moe_shard_inputs(cfg, device, seq)
    leaves = [p.requires_grad_(True) for p in gpt2._leaves(params)]
    with chunk_routed(MOE_SHARD_EP):
        loss, m = mixtral.loss_fn(cfg, params, tokens)
        grads = torch.autograd.grad(loss, leaves)
    out = {"loss": float(loss.detach()),
           "grad_norm": float(global_norm(grads)),
           **{k: float(v.detach()) for k, v in m.items()}}
    del params, tokens, leaves, grads, loss, m
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def one_process_references(device) -> dict:
    """One process's GPT-2 steps (flash, as the fsdp x tp step; dense, for
    the sp steps), LoRA loss and chunk-routed Mixtral step on the sharded
    phase's weights and batches, taken while its ranks run."""
    cfg = shard_gpt2_config()
    out = {}
    # the main path's flash step; the sp steps' dense one
    for tag, c in (("", cfg), ("dense_", dataclasses.replace(
            cfg, attention="dense"))):
        params, tokens = shard_gpt2_inputs(c, device)
        opt = gpt2.default_optimizer(total_steps=1000)
        _, _, m = gpt2.make_train_step(c, opt)(params, opt.init(params),
                                               tokens)
        out[tag + "loss"] = float(m["loss"])
        out[tag + "grad_norm"] = float(m["grad_norm"])
        del params, tokens, m
        torch.cuda.empty_cache()
    lcfg = train_llama_lora.lora_config(n_layers=SHARD_LORA_LAYERS)
    st = train_llama_lora.build(device, SHARD_BATCH, SHARD_SEQ, 0, lcfg)
    with torch.no_grad():
        out["lora_loss"] = float(llama.loss_fn(
            lcfg, st["params"], st["tokens"], lora=st["lora"]))
    del st
    torch.cuda.empty_cache()
    out["moe"] = moe_one_process(device)
    return out


def _gpt2_sharded(cfg, mesh, device, seq: int, opt) -> tuple:
    """(params, optimizer state, step, batch) of GPT-2's sharded step over
    `mesh` from `shard_gpt2_inputs`' seeds."""
    from ray_tpu_torch.parallel import (optimizer_shardings, shard_params,
                                        tree_shardings)
    from ray_tpu_torch.parallel.sharding import distribute_tree
    from ray_tpu_torch.train.cuda_utils import prepare_batch

    logical = gpt2.logical_axes(cfg)
    params, tokens = shard_gpt2_inputs(cfg, device, seq)
    opt_state = distribute_tree(opt.init(params), mesh, optimizer_shardings(
        mesh, opt, params, tree_shardings(mesh, logical)))
    params = shard_params(params, mesh, logical)
    return (params, opt_state, gpt2.make_train_step(cfg, opt, mesh),
            prepare_batch(tokens, mesh))


def _lora_sharded_step(lcfg, mesh, device, seq: int) -> tuple:
    """One LoRA step (the bench's bf16 frozen base and rank-8 adapters,
    both sharded over `mesh`): (its record, the rank's peak GB)."""
    from ray_tpu_torch.parallel import (optimizer_shardings, shard_params,
                                        tree_shardings)
    from ray_tpu_torch.parallel.sharding import distribute_tree
    from ray_tpu_torch.train.cuda_utils import prepare_batch

    st = train_llama_lora.build(device, SHARD_BATCH, seq, 0, lcfg)
    lopt = train_llama_lora.adamw()
    lora_axes = llama.lora_logical_axes(lcfg, st["lora"])
    lstate = distribute_tree(lopt.init(st["lora"]), mesh, optimizer_shardings(
        mesh, lopt, st["lora"], tree_shardings(mesh, lora_axes)))
    base = shard_params(st["params"], mesh, llama.logical_axes(lcfg))
    lora = shard_params(st["lora"], mesh, lora_axes)
    lbatch = prepare_batch(st["tokens"], mesh)
    del st
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    _, rec = _sharded_step(llama.make_lora_train_step(lcfg, lopt, mesh),
                           (base, lora, lstate, lbatch), device)
    peak = _peak_gb(device)
    del base, lora, lstate, lbatch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec, peak


def sp_optimizer() -> gpt2.AdamW:
    """`default_optimizer` without its warm-up: lr 3e-4 from step 0, so
    the sp steps' one update shows the loss falling."""
    return gpt2.default_optimizer(total_steps=1000, warmup_steps=0)


def sp_train(device, out: dict, *, cfg=None, lcfg=None,
             seq: int = SHARD_SEQ) -> None:
    """Sequence parallelism inside the sharded step, into `out`: GPT-2
    124M on DTensor params over tp 2 x sp 2 with attention "ring" (1 + 1
    steps), then "ulysses" (one step from the same weights), each rank
    computing on its half of the sequence; the LoRA width over dp 2 x
    sp 2 with "ring", one step."""
    from ray_tpu_torch.parallel import MeshSpec

    cfg = cfg or shard_gpt2_config()
    mesh = MeshSpec(**SP_MESH).build(device_type=device.type)
    out["sp_gpt2"] = {}
    for kind, steps in (("ring", SP_RING_STEPS), ("ulysses", 1)):
        params, opt_state, step, batch = _gpt2_sharded(
            dataclasses.replace(cfg, attention=kind), mesh, device, seq,
            sp_optimizer())
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        recs = []
        for _ in range(steps):
            (params, opt_state, _), rec = _sharded_step(
                step, (params, opt_state, batch), device)
            recs.append(rec)
        out["sp_gpt2"][kind] = {"steps": recs, "peak_gb": _peak_gb(device)}
        del params, opt_state, step, batch
        if device.type == "cuda":
            torch.cuda.empty_cache()
    lcfg = dataclasses.replace(
        lcfg or train_llama_lora.lora_config(n_layers=SHARD_LORA_LAYERS),
        attention="ring")
    out["sp_lora"], out["sp_lora_peak_gb"] = _lora_sharded_step(
        lcfg, MeshSpec(**SP_LORA_MESH).build(device_type=device.type),
        device, seq)


def dryrun_check(device) -> dict:
    """`dryrun.dryrun_multichip(SHARD_WORLD)` in f32 on this rank, and
    one process's f32 readings on the same draws: GPT-2's step with
    dense attention, the multi-slice step's loss, the pipeline's stages
    applied in series, and Mixtral's loss on each ep rank's batch shard
    (the capacity each rank routes with), averaged over the shards; on
    rank 0 also `dryrun.entry()`'s forward."""
    f32 = torch.float32
    _sync(device)
    t0 = time.perf_counter()
    got = dryrun.dryrun_multichip(SHARD_WORLD, device=device, dtype=f32)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    axes = got["mesh"]
    ref = {}
    cfg = dataclasses.replace(dryrun.gpt2_config(axes, f32),
                              attention="dense")
    params, tokens = dryrun.gpt2_inputs(
        cfg, axes["dp"] * axes["fsdp"] * 2, 32 * axes["sp"], 1, device)
    opt = gpt2.default_optimizer(total_steps=10)
    ref["gpt2_loss"] = float(gpt2.make_train_step(cfg, opt)(
        params, opt.init(params), tokens)[2]["loss"])
    per_slice = SHARD_WORLD // 2
    fsdp = max(1, per_slice // 2)
    cfg = dryrun.multislice_config(per_slice // fsdp, f32)
    params, tokens = dryrun.gpt2_inputs(cfg, 2 * 2 * fsdp, 32, 2, device)
    with torch.no_grad():
        ref["multislice_loss"] = float(gpt2.loss_fn(cfg, params, tokens))
        w, x = dryrun.pp_inputs(4, device)
        for s in range(w["w"].shape[0]):
            x = dryrun.pp_stage({"w": w["w"][s]}, x)
        ep = min(4, SHARD_WORLD)
        mcfg = dryrun.mixtral_config(ep, f32)
        mparams, mtokens = dryrun.mixtral_inputs(mcfg, ep, device)
        ref["mixtral_loss"] = statistics.mean(
            float(mixtral.loss_fn(mcfg, mparams, shard)[0])
            for shard in mtokens.chunk(ep))
    pp = got["pp_out"].to(device)
    out = {}
    if torch.distributed.get_rank() == 0:
        # `entry()`: GPT-2 124M's forward over its example args
        fwd, args = dryrun.entry(device)
        with torch.no_grad():
            logits = fwd(*args)
        out["entry"] = {"shape": list(logits.shape),
                        "finite": bool(torch.isfinite(logits).all())}
        del fwd, args, logits
    return {**out, "ms": ms, "mesh": axes,
            "losses": {k: got[k] for k in ref},
            "one_process": ref,
            "rel_err": {k: _rel(got[k], ref[k]) for k in ref},
            "pp_max_abs_err": float((pp - x).abs().max()),
            "pp_within": bool(torch.allclose(pp, x, rtol=DRYRUN_TOL,
                                             atol=DRYRUN_TOL))}


def sharded_moe(device, out: dict, *, cfg=None,
                seq: int = SHARD_SEQ) -> None:
    """Mixtral's expert-parallel step inside the sharded mesh, into
    `out["moe"]`: for each of `MOE_SHARD_MESHES`, the params from their
    seed sharded by `mixtral.logical_axes` (the experts over ep), AdamW's
    moments on their blocks, the batch by `prepare_batch`, then the
    mesh's steps through `make_train_step`; over the first mesh also
    step 0's loss with dense attention (no gradient) under the mesh."""
    from ray_tpu_torch.parallel import MeshSpec, shard_params
    from ray_tpu_torch.train.cuda_utils import prepare_batch

    cfg = cfg or mixtral_config(MOE_SHARD_LAYERS)
    out["moe"] = {}
    for i, (tag, mesh_kw, steps) in enumerate(MOE_SHARD_MESHES):
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        mesh = MeshSpec(**mesh_kw).build(device_type=device.type)
        t0 = time.perf_counter()
        params, tokens = moe_shard_inputs(cfg, device, seq)
        params = shard_params(params, mesh, mixtral.logical_axes(cfg))
        batch = prepare_batch(tokens, mesh)
        # the moments on their parameters' blocks: the same placements as
        # `optimizer_shardings` gives (tests/test_torch_sharded_moe.py),
        # without the whole f32 moments on every rank first
        opt = gpt2.AdamW(lambda count: MOE_SHARD_LR, max_norm=float("inf"),
                         b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
        state = opt.init(params)
        _sync(device)
        row = {"mesh_dims": list(params["tok_emb"].device_mesh
                                 .mesh_dim_names),
               "init_s": time.perf_counter() - t0,
               "init_peak_gb": _peak_gb(device)}
        if i == 0:
            with torch.no_grad():
                row["dense_loss"] = float(mixtral.loss_fn(
                    dataclasses.replace(cfg, attention="dense"), params,
                    batch)[0])
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        step = mixtral.make_train_step(cfg, opt, mesh)
        row["steps"] = []
        for _ in range(steps):
            (params, state, _), rec = _sharded_step(
                step, (params, state, batch), device)
            row["steps"].append(rec)
        row["peak_gb"] = _peak_gb(device)
        out["moe"][tag] = row
        del params, state, batch, step, tokens


def shard_rank(rank: int, port: str, out_dir: str, *, device="cuda",
               cfg=None, lcfg=None, seq: int = SHARD_SEQ,
               sp: bool = True, moe_cfg=None) -> None:
    """One of `SHARD_WORLD` gloo ranks sharing the card (NCCL refuses two
    ranks on one GPU).  GPT-2 124M's sharded step over fsdp 2 x tp 2,
    its state saved sharded, reloaded onto fsdp 4 x tp 1 and
    stepped once more; the LoRA bench's width at 4 layers, one step; the
    sequence-parallel checks over dp 2 x sp 2; sequence parallelism
    inside the sharded step (`sp_train`); the multichip dry run
    (`dryrun_check`); Mixtral's expert-parallel step inside the sharded
    mesh (`sharded_moe`).  Writes its readings as JSON.  `device`, the
    configs, `seq` and `sp` are for a rehearsal on the CPU at a small
    size."""
    t_start = time.perf_counter()
    import datetime

    import torch.distributed as dist

    from ray_tpu_torch.parallel import (MeshSpec, optimizer_shardings,
                                        shard_params, tree_shardings)
    from ray_tpu_torch.parallel.sharding import distribute_tree, global_norm
    from ray_tpu_torch.train.cuda_utils import prepare_batch
    from ray_tpu_torch.train.sharded_checkpoint import (load_sharded,
                                                        save_sharded)

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=SHARD_WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    device = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    path = os.path.join(out_dir, f"shard_rank{rank}.json")
    out = {"rank": rank, "world": dist.get_world_size(),
           "backend": str(dist.get_backend())}

    # GPT-2 124M: the train main path's config, 8 x 1,024 a step
    cfg = cfg or shard_gpt2_config()
    logical = gpt2.logical_axes(cfg)
    opt = gpt2.default_optimizer(total_steps=1000)
    mesh = MeshSpec(**SHARD_MESH).build(device_type=device.type)
    params, opt_state, step, batch = _gpt2_sharded(cfg, mesh, device, seq,
                                                   opt)
    out["startup_s"] = time.perf_counter() - t_start
    out["mesh_dims"] = list(params["wte"].device_mesh.mesh_dim_names)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    steps = []
    for i in range(1 + SHARD_TIMED):
        (params, opt_state, _), rec = _sharded_step(
            step, (params, opt_state, batch), device, debug=i == 0)
        steps.append(rec)
    out["gpt2_steps"] = steps
    out["gpt2_peak_gb"] = _peak_gb(device)

    # the state through a sharded checkpoint onto fsdp 4 x tp 1
    norm_saved = float(global_norm(gpt2._leaves(params)))
    ck = os.path.join(out_dir, "sharded_ckpt")
    t0 = time.perf_counter()
    save_sharded({"params": params, "opt_state": opt_state,
                  "step": len(steps)}, ck)
    dist.barrier()
    save_s = time.perf_counter() - t0
    del params, opt_state, step
    mesh2 = MeshSpec(**SHARD_RELOAD_MESH).build(device_type=device.type)
    whole = gpt2.init_params(cfg, 1, device=device)
    target = {"params": shard_params(whole, mesh2, logical),
              "opt_state": distribute_tree(
                  opt.init(whole), mesh2, optimizer_shardings(
                      mesh2, opt, whole, tree_shardings(mesh2, logical))),
              "step": 0}
    del whole
    t0 = time.perf_counter()
    state = load_sharded(ck, target)
    load_s = time.perf_counter() - t0
    norm_loaded = float(global_norm(gpt2._leaves(state["params"])))
    (_, _, _), rec = _sharded_step(
        gpt2.make_train_step(cfg, opt, mesh2),
        (state["params"], state["opt_state"],
         prepare_batch(shard_gpt2_tokens(cfg, device, seq), mesh2)),
        device)
    out["reshard"] = {"mesh": SHARD_RELOAD_MESH, "step": state["step"],
                      "count": state["opt_state"]["count"],
                      "norm_saved": norm_saved, "norm_loaded": norm_loaded,
                      "save_s": save_s, "load_s": load_s, "next_step": rec}
    del state, target

    # the LoRA bench's width: a bf16 frozen base, rank-8 adapters
    lcfg = lcfg or train_llama_lora.lora_config(n_layers=SHARD_LORA_LAYERS)
    out["lora_step"], out["lora_peak_gb"] = _lora_sharded_step(
        lcfg, mesh, device, seq)

    # ring and Ulysses attention over dp 2 x sp 2 on the same ranks, then
    # sequence parallelism inside the sharded step, then the dry run
    t0 = time.perf_counter()
    if sp:
        sp_checks(MeshSpec(dp=2, sp=2).build(device_type="cuda"), device,
                  out)
    out["sp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if sp:
        sp_train(device, out, cfg=cfg, lcfg=lcfg, seq=seq)
    out["sp_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if sp:
        out["dryrun"] = dryrun_check(device)
    out["dryrun_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded_moe(device, out, cfg=moe_cfg, seq=seq)
    out["moe_s"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def sp_checks(mesh, device, out: dict) -> None:
    """Ring and Ulysses attention at the LoRA shape against dense
    attention on the whole sequence, the gradient of a sum through the
    ring, and `llama.loss_fn` with attention "ring" over the mesh at 4
    layers against dense, into `out`."""
    from ray_tpu_torch.parallel.ring_attention import (ring_attention,
                                                       ulysses_attention)

    B, T, H, D = 8, 1024, 16, 128
    out["mesh_device_type"] = mesh.device_type
    out["cases"] = []
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gen = torch.Generator(device=device)
        gen.manual_seed(11)
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device=device
                               ).to(dt) for _ in range(3))
        for causal in (True, False):
            dense = plain_attention(q, k, v, causal=causal)
            for name, fn in (("ring", ring_attention),
                             ("ulysses", ulysses_attention)):
                _clear_collectives()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn(q, k, v, mesh, causal=causal)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                tol = SP_TOL[kind]
                err = float((got.float() - dense.float()).abs().max())
                ok = bool(torch.allclose(got.float(), dense.float(), **tol))
                out["cases"].append({
                    "fn": name, "dtype": kind, "causal": causal,
                    "max_abs_err": err, "within": ok, "tolerance": tol,
                    "wall_ms": ms, "transports": {
                        "/".join(k_): n for k_, n in
                        collectives.TRANSPORTS.items()}})
        del q, k, v, dense, got
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    q, k, v = (torch.randn((B, T, H, D), generator=gen, device=device
                           ).requires_grad_(True) for _ in range(3))
    g_ring = torch.autograd.grad(ring_attention(q, k, v, mesh).sum(),
                                 (q, k, v))
    g_dense = torch.autograd.grad(plain_attention(q, k, v).sum(), (q, k, v))
    out["grad"] = {
        n: {"max_abs_err": float((a - b).abs().max()),
            "within": bool(torch.allclose(a, b, **SP_GRAD_TOL))}
        for n, a, b in zip(("dq", "dk", "dv"), g_ring, g_dense)}
    del q, k, v, g_ring, g_dense
    torch.cuda.empty_cache()
    cfg = train_llama_lora.lora_config(n_layers=4, attention="ring")
    st = train_llama_lora.build(device, 8, 1024, 0, cfg)
    with torch.no_grad():
        ring_loss = float(llama.loss_fn(cfg, st["params"], st["tokens"],
                                        mesh, lora=st["lora"]))
        dense_loss = float(llama.loss_fn(
            dataclasses.replace(cfg, attention="dense"), st["params"],
            st["tokens"], lora=st["lora"]))
    out["llama"] = {"n_layers": 4, "ring_loss": ring_loss,
                    "dense_loss": dense_loss,
                    "within": abs(ring_loss - dense_loss) <= FULL_LOSS_TOL}


def _spawn_ranks(flag: str, timeout: float, world: int = 2,
                 meanwhile=None) -> tuple:
    """Runs this script as `world` ranks (`flag` rank port dir), and
    `meanwhile()` here while they run; returns (their output dir, wall
    s, what `meanwhile` returned).  A rank that outlives `timeout` is
    killed and the phase fails."""
    work = tempfile.mkdtemp(prefix="rtt" + flag.replace("-", "_") + "_")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r), port,
         work], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs, got = [], None
    try:
        # each rank's output drained on its own thread: a rank that
        # fills its pipe must not stall the group
        with ThreadPoolExecutor(world) as pool:
            futs = [pool.submit(p.communicate, timeout=timeout)
                    for p in procs]
            if meanwhile is not None:
                got = meanwhile()
            logs = [f.result()[0] for f in futs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs)
              if p.returncode != 0]
    if failed:
        r = failed[0][0]
        raise AssertionError(f"{flag} ranks failed (rank, code): {failed}; "
                             f"rank {r}'s output: {logs[r][-3000:]}")
    return work, time.perf_counter() - t0, got


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def sharded_train(smi: str, timeout: float = 480.0) -> tuple:
    """Spawns the `shard_rank` processes (this script, `--shard-rank`) and
    holds their readings; returns (the `sharded_train` line, the
    `sp_attention` line, the `sharded_sp` line, the `sharded_moe` line,
    the main path's K1-K4 launches over every rank).
    One process's references (the GPT-2 step, the LoRA loss) are taken
    here while the ranks run.  A rank that fails, or outlives
    `timeout`, fails the phase."""
    work, wall, ref = _spawn_ranks(
        "--shard-rank", timeout, world=SHARD_WORLD,
        meanwhile=lambda: one_process_references(torch.device("cuda")))
    ranks = []
    for r in range(SHARD_WORLD):
        with open(os.path.join(work, f"shard_rank{r}.json")) as f:
            ranks.append(json.load(f))
    shutil.rmtree(work, ignore_errors=True)
    r0 = ranks[0]
    cfg = gpt2.GPT2Config()
    lcfg = train_llama_lora.lora_config(n_layers=SHARD_LORA_LAYERS)
    tp = SHARD_MESH["tp"]
    local_b = SHARD_BATCH // SHARD_MESH["fsdp"]
    want = {"flash_fwd": 2 * cfg.n_layer, "flash_bwd_fused": cfg.n_layer,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    shape = [local_b * cfg.n_head // tp, SHARD_SEQ, cfg.head_dim]
    shape2 = [SHARD_BATCH // SHARD_RELOAD_MESH["fsdp"] * cfg.n_head,
              SHARD_SEQ, cfg.head_dim]
    lwant = {"flash_fwd": 2 * lcfg.n_layers, "flash_bwd_fused": lcfg.n_layers,
             "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    lshape = [local_b * lcfg.n_heads // tp, SHARD_SEQ, lcfg.head_dim]
    bad = []

    def held(what, rec, launches, shape_):
        if rec["launches"] != launches or rec["plain_dispatches"]:
            bad.append((what, "launches", rec["launches"],
                        rec["plain_dispatches"]))
        if rec["shapes"] != {"flash_fwd": [shape_],
                             "flash_bwd_fused": [shape_]}:
            bad.append((what, "local blocks", rec["shapes"]))
        if not all(row.endswith("/host") for row in rec["collectives"]):
            bad.append((what, "a collective off the host route",
                        rec["collectives"]))

    for r in ranks:
        losses = [s["loss"] for s in r["gpt2_steps"]]
        if not all(math.isfinite(x) for x in losses):
            bad.append((r["rank"], "losses", losses))
        if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
            bad.append((r["rank"], "step-0 loss far from ln V", losses[0]))
        if not losses[-1] < losses[0]:
            bad.append((r["rank"], "loss not falling", losses))
        s0 = r["gpt2_steps"][0]
        if _rel(s0["loss"], ref["loss"]) > SHARD_LOSS_TOL:
            bad.append((r["rank"], "step-0 loss", s0["loss"], ref["loss"]))
        if _rel(s0["grad_norm"], ref["grad_norm"]) > SHARD_GRAD_TOL:
            bad.append((r["rank"], "step-0 grad norm", s0["grad_norm"],
                        ref["grad_norm"]))
        # the c10d ops of step 0 are the staged collectives' own, one
        # each; DTensor issued none (no functional collective)
        staged = sum(c["calls"] for c in s0["collectives"].values())
        if (any("functional" in op for op in s0["comm_ops"])
                or sum(s0["comm_ops"].values()) != staged):
            bad.append((r["rank"], "collectives outside the staged ones",
                        s0["comm_ops"], staged))
        for i, s in enumerate(r["gpt2_steps"]):
            held((r["rank"], "gpt2", i), s, want, shape)
        rs = r["reshard"]
        if _rel(rs["norm_loaded"], rs["norm_saved"]) > SHARD_NORM_TOL:
            bad.append((r["rank"], "reshard norm", rs))
        if (rs["step"], rs["count"]) != (1 + SHARD_TIMED, 1 + SHARD_TIMED):
            bad.append((r["rank"], "reshard step", rs["step"], rs["count"]))
        if not math.isfinite(rs["next_step"]["loss"]):
            bad.append((r["rank"], "step after the reshard", rs))
        held((r["rank"], "gpt2 after the reshard"), rs["next_step"], want,
             shape2)
        ls = r["lora_step"]
        if _rel(ls["loss"], ref["lora_loss"]) > SHARD_LOSS_TOL:
            bad.append((r["rank"], "lora loss", ls["loss"],
                        ref["lora_loss"]))
        held((r["rank"], "lora"), ls, lwant, lshape)
    if bad:
        raise AssertionError(f"sharded_train outside its limits: {bad}")
    launches = {n: sum(s["launches"][n] for r in ranks
                       for s in r["gpt2_steps"] + [r["reshard"]["next_step"],
                                                   r["lora_step"]]
                       + [s for m in r["moe"].values() for s in m["steps"]])
                for n in FLASH}
    timed = [s["ms"] for s in r0["gpt2_steps"][1:]]
    step_s = statistics.mean(timed) / 1e3
    line = {
        "phase": "sharded_train", "nvidia_smi": smi, "ranks": SHARD_WORLD,
        "backend": r0["backend"], "mesh": SHARD_MESH,
        "mesh_dims": r0["mesh_dims"], "wall_s": wall,
        "gpt2": {
            "model": "gpt2_124m", "n_layer": cfg.n_layer,
            "attention": "flash", "dtype": "bfloat16",
            "master_dtype": "float32", "logits_dtype": "bfloat16",
            "remat_policy": cfg.remat_policy, "global_batch": SHARD_BATCH,
            "seq": SHARD_SEQ, "steps": 1 + SHARD_TIMED,
            "losses": [s["loss"] for s in r0["gpt2_steps"]],
            "grad_norms": [s["grad_norm"] for s in r0["gpt2_steps"]],
            "loss_spread_over_ranks": max(
                abs(r["gpt2_steps"][0]["loss"] - r0["gpt2_steps"][0]["loss"])
                for r in ranks),
            "one_process": {k: ref[k] for k in ("loss", "grad_norm")},
            "step0_rel_err": {
                "loss": _rel(r0["gpt2_steps"][0]["loss"], ref["loss"]),
                "grad_norm": _rel(r0["gpt2_steps"][0]["grad_norm"],
                                  ref["grad_norm"])},
            "tolerance": {"loss": SHARD_LOSS_TOL,
                          "grad_norm": SHARD_GRAD_TOL},
            "step_ms": [s["ms"] for s in r0["gpt2_steps"]],
            "tokens_per_s": SHARD_BATCH * SHARD_SEQ / step_s,
            "launches_a_step_a_rank": r0["gpt2_steps"][-1]["launches"],
            "local_blocks": r0["gpt2_steps"][-1]["shapes"],
            "c10d_ops_step0": r0["gpt2_steps"][0]["comm_ops"],
            "collectives_a_step": r0["gpt2_steps"][-1]["collectives"],
            "peak_gb_each_rank": [r["gpt2_peak_gb"] for r in ranks]},
        "reshard": {k: r0["reshard"][k] for k in (
            "mesh", "step", "norm_saved", "norm_loaded", "save_s",
            "load_s")} | {
            "norm_rel_err": _rel(r0["reshard"]["norm_loaded"],
                                 r0["reshard"]["norm_saved"]),
            "tolerance": SHARD_NORM_TOL,
            "next_step": {k: r0["reshard"]["next_step"][k] for k in (
                "ms", "loss", "launches", "shapes")}},
        "lora": {
            "n_layers": lcfg.n_layers, "depth_cut": "22 -> 4",
            "loss": r0["lora_step"]["loss"],
            "one_process_loss": ref["lora_loss"],
            "rel_err": _rel(r0["lora_step"]["loss"], ref["lora_loss"]),
            "tolerance": SHARD_LOSS_TOL, "ms": r0["lora_step"]["ms"],
            "launches": r0["lora_step"]["launches"],
            "local_blocks": r0["lora_step"]["shapes"],
            "collectives": r0["lora_step"]["collectives"],
            "peak_gb_each_rank": [r["lora_peak_gb"] for r in ranks]},
        "startup_s_each_rank": [r["startup_s"] for r in ranks],
        "launches_all_ranks": launches,
    }
    return (line, sp_line(ranks, smi), sp_train_line(ranks, ref, smi),
            moe_line(ranks, ref["moe"], smi), launches)


def moe_line(ranks: list, ref: dict, smi: str) -> dict:
    """The `sharded_moe` line from the ranks' `sharded_moe` readings, held
    against one process's chunk-routed step 0 (`ref`): the step-0 loss
    and pre-clip gradient norm, the load-balance loss, flash against
    dense under ep 2 x tp 2, K1 / K2 a step a rank on each rank's local
    block with no plain dispatch, every collective through the host with
    all_to_all among them."""
    cfg = mixtral_config(MOE_SHARD_LAYERS)
    tp_heads = {tag: cfg.n_heads // kw.get("tp", 1)
                for tag, kw, _ in MOE_SHARD_MESHES}
    rows_a_rank = {tag: MOE_SHARD_BATCH // (kw["ep"] * kw.get("fsdp", 1))
                   for tag, kw, _ in MOE_SHARD_MESHES}
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_fused": cfg.n_layers,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    bad = []
    for r in ranks:
        for tag, _, n in MOE_SHARD_MESHES:
            m = r["moe"][tag]
            steps = m["steps"]
            s0 = steps[0]
            if len(steps) != n or not all(math.isfinite(s["loss"])
                                          for s in steps):
                bad.append((r["rank"], tag, "losses", steps))
            if _rel(s0["loss"], ref["loss"]) > SHARD_LOSS_TOL:
                bad.append((r["rank"], tag, "step-0 loss", s0["loss"],
                            ref["loss"]))
            if _rel(s0["grad_norm"], ref["grad_norm"]) > SHARD_GRAD_TOL:
                bad.append((r["rank"], tag, "step-0 grad norm",
                            s0["grad_norm"], ref["grad_norm"]))
            if not 0.5 < s0["load_balance_loss"] < 2.0:
                bad.append((r["rank"], tag, "load-balance loss",
                            s0["load_balance_loss"]))
            if "dense_loss" in m and _rel(s0["loss"], m["dense_loss"]) > \
                    FULL_LOSS_TOL:
                bad.append((r["rank"], tag, "flash vs dense", s0["loss"],
                            m["dense_loss"]))
            shape = [rows_a_rank[tag] * tp_heads[tag], SHARD_SEQ,
                     cfg.head_dim]
            for i, s in enumerate(steps):
                if s["launches"] != want or s["plain_dispatches"]:
                    bad.append((r["rank"], tag, i, "launches",
                                s["launches"], s["plain_dispatches"]))
                if s["shapes"] != {"flash_fwd": [shape],
                                   "flash_bwd_fused": [shape]}:
                    bad.append((r["rank"], tag, i, "local blocks",
                                s["shapes"]))
                rows = s["collectives"]
                if not all(row.endswith("/host") for row in rows):
                    bad.append((r["rank"], tag, i, "a collective off the "
                                "host route", rows))
                if "all_to_all" not in {row.split("/")[0] for row in rows}:
                    bad.append((r["rank"], tag, i, "no all_to_all", rows))
        if "dense_loss" not in r["moe"][MOE_SHARD_MESHES[0][0]]:
            bad.append((r["rank"], "no dense step 0"))
    if bad:
        raise AssertionError(f"sharded_moe outside its limits: {bad}")
    r0 = ranks[0]
    meshes = {}
    for tag, kw, _ in MOE_SHARD_MESHES:
        m = r0["moe"][tag]
        steps = m["steps"]
        s0 = steps[0]
        meshes[tag] = {
            "mesh": kw, "mesh_dims": m["mesh_dims"],
            "losses": [s["loss"] for s in steps],
            "ce_losses": [s["ce_loss"] for s in steps],
            "load_balance_losses": [s["load_balance_loss"] for s in steps],
            "grad_norms": [s["grad_norm"] for s in steps],
            "step0_rel_err": {"loss": _rel(s0["loss"], ref["loss"]),
                              "grad_norm": _rel(s0["grad_norm"],
                                                ref["grad_norm"])},
            "loss_spread_over_ranks": max(
                abs(r["moe"][tag]["steps"][0]["loss"] - s0["loss"])
                for r in ranks),
            "step_ms": [s["ms"] for s in steps],
            "tokens_per_s": [MOE_SHARD_BATCH * SHARD_SEQ / (s["ms"] / 1e3)
                             for s in steps],
            "collectives_a_step": [s["collectives"] for s in steps],
            "collectives_ms_share": [
                sum(c["ms"] for c in s["collectives"].values()) / s["ms"]
                for s in steps],
            "launches_a_step_a_rank": steps[-1]["launches"],
            "local_blocks": steps[-1]["shapes"],
            "init_s": m["init_s"],
            "init_peak_gb_each_rank": [r["moe"][tag]["init_peak_gb"]
                                       for r in ranks],
            "peak_gb_each_rank": [r["moe"][tag]["peak_gb"] for r in ranks]}
        if "dense_loss" in m:
            meshes[tag]["dense_step0_loss"] = m["dense_loss"]
            meshes[tag]["flash_vs_dense_rel_err"] = _rel(s0["loss"],
                                                         m["dense_loss"])
    return {
        "phase": "sharded_moe", "nvidia_smi": smi, "ranks": len(ranks),
        "backend": r0["backend"], "model": "mixtral_8x7b",
        "source": "MixtralConfig.mixtral_8x7b (Mixtral-8x7B's published "
                  "widths)",
        "reduced": {"n_layers": [32, cfg.n_layers]},
        "vocab": cfg.vocab_size, "dim": cfg.dim, "n_heads": cfg.n_heads,
        "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "intermediate": cfg.intermediate, "num_experts": cfg.num_experts,
        "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
        "capacity_slots_a_chunk": moe._capacity(
            MOE_SHARD_BATCH // MOE_SHARD_EP * SHARD_SEQ, cfg.moe,
            MOE_SHARD_EP),
        "attention": cfg.attention, "remat": cfg.remat,
        "compute_dtype": str(cfg.dtype)[6:], "master_dtype": "float32",
        "optimizer": f"adamw({MOE_SHARD_LR})",
        "global_batch": MOE_SHARD_BATCH, "seq": SHARD_SEQ,
        "one_process_chunk_routed": ref,
        "tolerance": {"loss": SHARD_LOSS_TOL, "grad_norm": SHARD_GRAD_TOL,
                      "flash_vs_dense": FULL_LOSS_TOL,
                      "load_balance_loss": [0.5, 2.0]},
        "launches_want_a_step_a_rank": want,
        **meshes, "wall_s": r0["moe_s"]}


def sp_train_line(ranks: list, ref: dict, smi: str) -> dict:
    """The `sharded_sp` line from the ranks' `sp_train` and `dryrun_check`
    readings, held against one process's (`ref`): GPT-2's step 0 (ring
    and Ulysses) against the dense one-process step, loss falling over
    the ring's steps, no K1-K4 launch or plain dispatch in these steps,
    every collective on the host route with the ring's sends, Ulysses'
    all_to_alls and the sums among them; the LoRA loss; the dry run's
    losses against one process's f32 readings."""
    cfg = shard_gpt2_config()
    bad = []

    def on_host(what, rec, ops):
        rows = rec["collectives"]
        if not all(row.endswith("/host") for row in rows):
            bad.append((what, "a collective off the host route", rows))
        got = {row.split("/")[0] for row in rows}
        if not set(ops) <= got:
            bad.append((what, "collectives missing", sorted(ops), rows))
        if any(rec["launches"].values()) or rec["plain_dispatches"]:
            bad.append((what, "flash launches", rec["launches"],
                        rec["plain_dispatches"]))

    for r in ranks:
        for kind, ops in (("ring", ("ppermute", "psum")),
                          ("ulysses", ("all_to_all", "psum"))):
            steps = r["sp_gpt2"][kind]["steps"]
            s0 = steps[0]
            if not all(math.isfinite(s["loss"]) for s in steps):
                bad.append((r["rank"], kind, "losses", steps))
            if _rel(s0["loss"], ref["dense_loss"]) > SHARD_LOSS_TOL:
                bad.append((r["rank"], kind, "step-0 loss", s0["loss"],
                            ref["dense_loss"]))
            if _rel(s0["grad_norm"], ref["dense_grad_norm"]) > SHARD_GRAD_TOL:
                bad.append((r["rank"], kind, "step-0 grad norm",
                            s0["grad_norm"], ref["dense_grad_norm"]))
            for i, s in enumerate(steps):
                on_host((r["rank"], kind, i), s, ops)
        ring = [s["loss"] for s in r["sp_gpt2"]["ring"]["steps"]]
        if not ring[-1] < ring[0]:
            bad.append((r["rank"], "ring loss not falling", ring))
        ls = r["sp_lora"]
        if _rel(ls["loss"], ref["lora_loss"]) > SHARD_LOSS_TOL:
            bad.append((r["rank"], "sp lora loss", ls["loss"],
                        ref["lora_loss"]))
        on_host((r["rank"], "sp lora"), ls, ("ppermute", "psum"))
        d = r["dryrun"]
        if not all(math.isfinite(x) for x in d["losses"].values()):
            bad.append((r["rank"], "dry run losses", d["losses"]))
        if max(d["rel_err"].values()) > DRYRUN_TOL or not d["pp_within"]:
            bad.append((r["rank"], "dry run against one process", d))
    entry = ranks[0]["dryrun"]["entry"]
    if entry != {"shape": [4, 512, cfg.vocab_size], "finite": True}:
        bad.append(("entry() forward", entry))
    if bad:
        raise AssertionError(f"sharded_sp outside its limits: {bad}")
    r0 = ranks[0]

    def step_row(steps, tokens):
        return {"losses": [s["loss"] for s in steps],
                "grad_norms": [s["grad_norm"] for s in steps],
                "step_ms": [s["ms"] for s in steps],
                "tokens_per_s": [tokens / (s["ms"] / 1e3) for s in steps],
                "collectives": [s["collectives"] for s in steps],
                "launches": steps[-1]["launches"]}

    gpt2_rows = {}
    for kind in ("ring", "ulysses"):
        steps = r0["sp_gpt2"][kind]["steps"]
        gpt2_rows[kind] = {
            **step_row(steps, SHARD_BATCH * SHARD_SEQ),
            "step0_rel_err": {
                "loss": _rel(steps[0]["loss"], ref["dense_loss"]),
                "grad_norm": _rel(steps[0]["grad_norm"],
                                  ref["dense_grad_norm"])},
            "peak_gb_each_rank": [r["sp_gpt2"][kind]["peak_gb"]
                                  for r in ranks]}
    d0 = r0["dryrun"]
    return {
        "phase": "sharded_sp", "nvidia_smi": smi, "ranks": len(ranks),
        "backend": r0["backend"],
        "gpt2": {"model": "gpt2_124m", "n_layer": cfg.n_layer,
                 "mesh": SP_MESH, "dtype": "bfloat16",
                 "master_dtype": "float32", "logits_dtype": "bfloat16",
                 "remat_policy": cfg.remat_policy,
                 "optimizer": "default_optimizer, warmup 0",
                 "global_batch": SHARD_BATCH, "seq": SHARD_SEQ,
                 "local_seq": SHARD_SEQ // SP_MESH["sp"],
                 "one_process_dense": {k: ref["dense_" + k]
                                       for k in ("loss", "grad_norm")},
                 "tolerance": {"loss": SHARD_LOSS_TOL,
                               "grad_norm": SHARD_GRAD_TOL},
                 **gpt2_rows},
        "lora": {"n_layers": SHARD_LORA_LAYERS, "mesh": SP_LORA_MESH,
                 "attention": "ring", "loss": r0["sp_lora"]["loss"],
                 "one_process_loss": ref["lora_loss"],
                 "rel_err": _rel(r0["sp_lora"]["loss"], ref["lora_loss"]),
                 "tolerance": SHARD_LOSS_TOL, "ms": r0["sp_lora"]["ms"],
                 "tokens_per_s": SHARD_BATCH * SHARD_SEQ
                 / (r0["sp_lora"]["ms"] / 1e3),
                 "collectives": r0["sp_lora"]["collectives"],
                 "launches": r0["sp_lora"]["launches"],
                 "peak_gb_each_rank": [r["sp_lora_peak_gb"] for r in ranks]},
        "dryrun": {"n_devices": SHARD_WORLD, "dtype": "float32",
                   **{k: d0[k] for k in ("entry", "mesh", "ms", "losses",
                                         "one_process", "rel_err",
                                         "pp_max_abs_err")},
                   "rel_err_all_ranks": max(
                       max(r["dryrun"]["rel_err"].values()) for r in ranks),
                   "tolerance": DRYRUN_TOL},
        "wall_s": {"sp_train": r0["sp_train_s"], "dryrun": r0["dryrun_s"]},
    }


def sp_line(ranks: list, smi: str) -> dict:
    """The `sp_attention` line from the ranks' sequence-parallel
    readings (dp 2 x sp 2 over the sharded step's ranks)."""
    bad = [(r["rank"], c) for r in ranks for c in r["cases"]
           if not c["within"]]
    bad += [(r["rank"], n, g) for r in ranks for n, g in r["grad"].items()
            if not g["within"]]
    bad += [(r["rank"], r["llama"]) for r in ranks
            if not r["llama"]["within"]]
    if bad:
        raise AssertionError(f"sp_attention outside its limits: {bad}")
    r0 = ranks[0]
    return {"phase": "sp_attention", "nvidia_smi": smi,
            "ranks": len(ranks), "sp": 2, "dp": 2, "backend": r0["backend"],
            "mesh_device_type": r0["mesh_device_type"],
            "shape": {"B": 8, "T": 1024, "H": 16, "D": 128},
            "cases": [{k: c[k] for k in ("fn", "dtype", "causal",
                                         "max_abs_err", "wall_ms",
                                         "transports")}
                      for c in r0["cases"]],
            "max_abs_err_all_ranks": max(c["max_abs_err"] for r in ranks
                                         for c in r["cases"]),
            "tolerance": SP_TOL, "grad": r0["grad"],
            "grad_tolerance": SP_GRAD_TOL, "llama": r0["llama"],
            "llama_tolerance": FULL_LOSS_TOL, "wall_s": r0["sp_s"]}


# ----------------------------------------------------------------------
# compiled graphs, experts and pipelines
# ----------------------------------------------------------------------
# the MoE layer and Mixtral on the card: flash against dense (the LoRA
# line's limits: loss relative, gradients by the relative norm of the
# difference), expert parallelism against the local path on each batch
# shard (sp_attention's bf16 limits), the pipeline against one process's
# serial autograd over the same blocks
MOE_EP_TOL = SP_TOL["bf16"]
PIPE_LOSS_TOL = 1e-2


@rt.remote
class DagHop:
    """One hop of the compiled chain: what arrives must lie on this
    actor's card; it is handed on unchanged."""

    def hop(self, value):
        for t in (value.values() if isinstance(value, dict) else [value]):
            if not t.is_cuda:
                raise AssertionError(f"a hop received a tensor on {t.device}")
        return value


def _same_on_card(got, want) -> bool:
    """Bit-equal, with the dtype, on the reader's card."""
    pairs = ([(got[k], want[k]) for k in want] if isinstance(want, dict)
             else [(got, want)])
    if isinstance(want, dict) and set(got) != set(want):
        return False
    return all(isinstance(a, torch.Tensor) and a.is_cuda
               and a.dtype == b.dtype and a.shape == b.shape
               and torch.equal(a, b) for a, b in pairs)


def compiled_dag(device, smi: str, *, reps: int = 5,
                 big_shape=(8, 1024, 4096)) -> dict:
    """Two `num_gpus=0.5` port actors in a compiled chain `a.hop(inp) ->
    b.hop(...)` carry a CUDA bf16 tensor (64 MB: spilled past the slot
    into one store object a hop) and a dict of small f32 / int8 CUDA
    tensors (inline in the slot); each arrives bit-equal on the reader's
    card.  The runtime must be up."""
    gen = torch.Generator(device=device)
    gen.manual_seed(21)
    payloads = {
        "bf16": torch.randn(big_shape, generator=gen,
                            device=device).to(torch.bfloat16),
        "dict_f32_int8": {
            "f32": torch.randn((16, 64), generator=gen, device=device),
            "i8": torch.randint(-128, 128, (4096,), generator=gen,
                                device=device, dtype=torch.int8)},
    }
    slot = get_config().dag_slot_bytes
    Hop = DagHop.options(num_gpus=0.5)
    a, b = Hop.remote(), Hop.remote()
    with InputNode() as inp:
        dag = b.hop.bind(a.hop.bind(inp))
    t0 = time.perf_counter()
    c = dag.experimental_compile()
    compile_s = time.perf_counter() - t0
    out = {}
    try:
        for name, value in payloads.items():
            first = c.execute(value).get(timeout=300)
            if not _same_on_card(first, value):
                raise AssertionError(f"compiled_dag: {name} did not arrive "
                                     "bit-equal on the reader's card")
            ms = []
            for _ in range(reps):
                torch.cuda.synchronize(device)
                t1 = time.perf_counter()
                got = c.execute(value).get(timeout=300)
                torch.cuda.synchronize(device)
                ms.append((time.perf_counter() - t1) * 1e3)
                if not _same_on_card(got, value):
                    raise AssertionError(f"compiled_dag: {name} changed "
                                         "on a repeat")
            n = dag_channel.encode_tensors(value)[1]
            tensors = value.values() if isinstance(value, dict) else [value]
            out[name] = {
                "shapes": {k: list(t.shape) for k, t in (
                    value.items() if isinstance(value, dict)
                    else [("x", value)])},
                "dtypes": sorted({str(t.dtype)[6:] for t in tensors}),
                "payload_bytes": n, "slot_bytes": slot,
                "route": "inline" if n <= slot else "spill",
                "hops": 3, "ms_per_execute": statistics.median(ms),
                "ms_all": ms, "bit_equal_on_card": True}
    finally:
        c.teardown()
    return {"phase": "compiled_dag", "nvidia_smi": smi,
            "actors": 2, "num_gpus_each": 0.5, "compile_s": compile_s,
            "executes_timed": reps, "payloads": out}


def init_ce(vocab: int, dim: int, std: float = 0.02) -> float:
    """The cross entropy a freshly drawn model starts at: its logits are
    unit-RMS hidden states through an N(0, std^2) head, so each is
    N(0, s^2) with s^2 = dim std^2, and E[logsumexp] over V of them is
    ln V + s^2 / 2 (ln V alone only while s is small: 0.41 above it at
    dim 2,048, the LoRA line's 10.787; 0.82 at 4,096)."""
    return math.log(vocab) + dim * std * std / 2


def mixtral_config(n_layers: int = 2, attention: str = "flash"):
    return dataclasses.replace(mixtral.MixtralConfig.mixtral_8x7b(),
                               n_layers=n_layers, attention=attention)


def _rel_norm(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()))


class held_routing:
    """While entered, `moe._route` records each router's top-k choices
    (keyed by the router weight's address, so the remat replay and a
    later pass find their layer's), and once `hold()` is called makes
    every later call choose the recorded experts, with the probabilities
    of its own softmax at them.  Discrete top-k turns the last-bit
    differences between two attention routes into different experts for
    a few tokens, which moves the experts' gradients far more than the
    attention route does; holding the routing compares the routes on
    the same experts, as the CPU parity tests hold the indices equal."""

    def __enter__(self):
        self.chosen, self.held, self.flips = {}, False, []
        self._orig = moe._route
        moe._route = self._route
        return self

    def hold(self):
        self.held = True

    def _route(self, cfg, router_w, x2d):
        top_p, top_i, aux = self._orig(cfg, router_w, x2d)
        key = router_w.data_ptr()
        if not self.held:
            self.chosen.setdefault(key, top_i.detach())
            return top_p, top_i, aux
        want = self.chosen[key]
        self.flips.append(float((want != top_i).any(-1).float().mean()))
        return moe._gate(cfg, moe._router_probs(router_w, x2d), want)

    def __exit__(self, *exc):
        moe._route = self._orig
        return False


def _route_grads(cfg, params, tokens) -> tuple:
    """Step 0's loss and the gradients of `wq` and `moe_w_in`."""
    ws = [params["blocks"][n].requires_grad_(True)
          for n in ("wq", "moe_w_in")]
    loss, _ = mixtral.loss_fn(cfg, params, tokens)
    grads = torch.autograd.grad(loss, ws)
    for w in ws:
        w.requires_grad_(False)
    return float(loss.detach()), grads


def mixtral_route_check(cfg, params, tokens) -> dict:
    """Step 0 on the flash and the dense route: the loss (2e-2
    relative), and the gradients of `wq` and `moe_w_in` (relative norm
    of the difference, 3e-2) with the flash pass routed to the dense
    pass's experts (`held_routing`); the free pass's gradients and the
    share of tokens it routes elsewhere are recorded beside them."""
    dense = dataclasses.replace(cfg, attention="dense")
    flash = dataclasses.replace(cfg, attention="flash")
    with held_routing() as hr:
        ld, gd = _route_grads(dense, params, tokens)
        lf_free, gf_free = _route_grads(flash, params, tokens)
        hr.hold()
        lf, gf = _route_grads(flash, params, tokens)
    names = ("wq", "moe_w_in")
    out = {"loss_flash": lf, "loss_dense": ld,
           "loss_rel_err": abs(lf - ld) / abs(ld),
           "grad_rel_err": {n: _rel_norm(a, b) for n, a, b in
                            zip(names, gf, gd)},
           "routing": "held to the dense pass's experts",
           "free_routing": {
               "loss_flash": lf_free,
               "loss_rel_err": abs(lf_free - ld) / abs(ld),
               "grad_rel_err": {n: _rel_norm(a, b) for n, a, b in
                                zip(names, gf_free, gd)}},
           # a router call at a time (forward, then the remat replay):
           # the share of tokens whose own top-k differs from the dense
           # pass's
           "flash_tokens_routed_elsewhere": hr.flips}
    del gf_free
    if (out["loss_rel_err"] > FULL_LOSS_TOL
            or out["free_routing"]["loss_rel_err"] > FULL_LOSS_TOL
            or max(out["grad_rel_err"].values()) > FULL_GRAD_TOL):
        raise AssertionError(f"Mixtral step 0, flash vs dense: {out}")
    return out


_KERNEL_KINDS = (
    ("K1", ("flash_fwd",)), ("K2", ("flash_bwd",)),
    ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "gemv", "matmul")),
    ("dispatch_combine_scatter_gather", ("index", "scatter", "gather",
                                         "embedding")),
    ("memcpy_memset", ("memcpy", "memset", "Memcpy", "Memset")),
)


def kernel_split(prof) -> dict:
    """Device ms by kind of kernel in a profile: K1, K2, GEMMs, the
    scatter-gathers (the MoE dispatch / combine, the embedding), copies,
    and the rest (elementwise work and reductions)."""
    out = {k: 0.0 for k, _ in _KERNEL_KINDS}
    out["elementwise_and_reductions"] = 0.0
    n = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us:
            continue
        n += e.count
        for kind, keys in _KERNEL_KINDS:
            if any(s in e.key for s in keys):
                out[kind] += us / 1e3
                break
        else:
            out["elementwise_and_reductions"] += us / 1e3
    out["kernels"] = n
    return out


def mixtral_train(device, smi: str, *, batch=4, seq=1024, n_layers=2,
                  warmup=1, steps=5, lr=3e-4) -> dict:
    """Mixtral-8x7B's full width (vocab 32,000, dim 4,096, 32 / 8 heads,
    expert hidden 14,336, 8 experts, top-2, capacity 1.25), depth cut to
    `n_layers`: flash attention, full remat, bf16 compute on f32 master
    params, AdamW (optax.adamw(lr)'s arithmetic), seed 0.  The flash
    route's step-0 loss and gradients against the dense route's, then
    `warmup` + `steps` steps on one batch with the launches of exactly
    the timed steps (K1 twice a layer: forward and remat replay; K2
    once; no K3 / K4, no plain dispatch), then one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    cfg = mixtral_config(n_layers)
    t0 = time.perf_counter()
    params = mixtral.init_params(cfg, 0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=device)
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    n_params = mixtral.num_params(params)
    active = mixtral.active_params_per_token(cfg, params)
    route = mixtral_route_check(cfg, params, tokens)
    torch.cuda.empty_cache()
    opt = gpt2.AdamW(lambda count: lr, max_norm=float("inf"), b1=0.9,
                     b2=0.999, eps=1e-8, weight_decay=1e-4)
    state = opt.init(params)
    step = mixtral.make_train_step(cfg, opt)
    metrics = []
    for _ in range(warmup):
        params, state, m = step(params, state, tokens)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    step_ms = []
    for _ in range(steps):
        t1 = time.perf_counter()
        params, state, m = step(params, state, tokens)
        torch.cuda.synchronize(device)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {**read_counts(),
                "plain_dispatches": fa.flash_attention.plain_dispatches}
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    want = {"flash_fwd": steps * 2 * n_layers,
            "flash_bwd_fused": steps * n_layers, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "plain_dispatches": 0}
    if launches != want:
        raise AssertionError(f"Mixtral training launches {launches}, want "
                             f"{want}")
    losses = [x["loss"] for x in metrics]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite Mixtral losses: {losses}")
    ce0, lb0 = metrics[0]["ce_loss"], metrics[0]["load_balance_loss"]
    ce_init = init_ce(cfg.vocab_size, cfg.dim)
    if abs(ce0 - ce_init) > 0.5:
        raise AssertionError(f"Mixtral step-0 CE {ce0} far from "
                             f"ln V + s^2 / 2 = {ce_init}")
    if not 0.5 < lb0 < 2.0:
        raise AssertionError(f"Mixtral step-0 load-balance loss {lb0}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"Mixtral loss did not fall: {losses}")
    # one more step, profiled: forward + backward, then AdamW, each timed
    # with CUDA events and traced
    leaves = gpt2._leaves(params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    # the CPU activity only where there is no card (a rehearsal)
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as p_fb:
        ev[0].record()
        loss, _ = mixtral.loss_fn(cfg, params, tokens)
        grads = torch.autograd.grad(loss, leaves)
        ev[1].record()
        torch.cuda.synchronize(device)
    with profile(activities=acts) as p_opt:
        state, _ = opt.update(grads, state, params)
        ev[2].record()
        torch.cuda.synchronize(device)
    del grads, loss
    fb_split = kernel_split(p_fb)
    opt_split = kernel_split(p_opt)
    tokens_per_step = batch * seq
    steady = statistics.median(step_ms)
    tps = tokens_per_step / (steady / 1e3)
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "phase": "mixtral_train", "nvidia_smi": smi,
        "model": "mixtral_8x7b", "source": "MixtralConfig.mixtral_8x7b "
        "(Mixtral-8x7B's published widths)",
        "reduced": {"n_layers": [32, n_layers]}, "vocab": cfg.vocab_size,
        "dim": cfg.dim, "n_layers": n_layers, "n_heads": cfg.n_heads,
        "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "intermediate": cfg.intermediate, "num_experts": cfg.num_experts,
        "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
        "capacity_slots": moe._capacity(batch * seq, cfg.moe, 1),
        "attention": cfg.attention, "remat": cfg.remat,
        "compute_dtype": str(cfg.dtype)[6:], "master_dtype": "float32",
        "optimizer": f"adamw({lr})", "batch": batch, "seq": seq,
        "n_params": n_params, "active_params_per_token": active,
        "init_s": init_s, "flash_vs_dense_step0": route,
        "step0_tolerance": {"loss_rel": FULL_LOSS_TOL,
                            "grad_rel_norm": FULL_GRAD_TOL},
        "warmup_steps": warmup, "timed_steps": steps, "losses": losses,
        "ce_losses": [x["ce_loss"] for x in metrics],
        "load_balance_losses": [x["load_balance_loss"] for x in metrics],
        "ln_vocab": math.log(cfg.vocab_size), "step0_ce_expected": ce_init,
        "launches": launches, "launches_want": want,
        "launches_per_step": {"flash_fwd": 2 * n_layers,
                              "flash_bwd_fused": n_layers},
        "step_ms": step_ms, "step_ms_median": steady,
        "tokens_per_step": tokens_per_step, "tokens_per_s": tps,
        "flops_per_token": 6 * active,
        "mfu": 6 * active * tps / PEAK_FLOPS[torch.bfloat16],
        "mfu_counts": "6 x active params a token, attention FLOPs left "
                      "out, over 989 TFLOP/s",
        "peak_mem_gb": peak,
        "profiled_step": {
            "fwd_bwd_ms": ev[0].elapsed_time(ev[1]),
            "adamw_ms": ev[1].elapsed_time(ev[2]),
            "fwd_bwd_device_ms_by_kind": fb_split,
            "adamw_device_ms": {k: v for k, v in opt_split.items()
                                if k != "kernels"},
            "adamw_kernels": opt_split["kernels"]},
    }


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def moe_rank(rank: int, port: str, out_dir: str, *, device="cuda",
             dim=4096, hidden=14336, T=1024) -> None:
    """One of two gloo ranks sharing the card: the MoE layer at
    Mixtral's widths over `ep` 2 (global x [2, T, dim], bf16), forward
    and backward timed, against the reference's oracle: the local path
    on each batch shard alone, its output and the gradients of the
    params and of x.  Writes its readings as JSON."""
    import datetime

    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshSpec

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    mesh = MeshSpec(ep=2).build(device_type=device.type)
    cfg = moe.MoEConfig(dim=dim, hidden=hidden, num_experts=8, top_k=2,
                        capacity_factor=1.25, dtype=torch.bfloat16)
    params = moe.init_moe(cfg, 0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    x = torch.randn((2, T, cfg.dim), generator=gen,
                    device=device).to(torch.bfloat16)
    x.requires_grad_(True)  # dx returns through the first all_to_all
    names = ("router", "w_in", "w_out", "x")
    ws = [*(params[n].requires_grad_(True) for n in names[:-1]), x]

    def loss_of(out, aux):
        return out.float().square().mean() + 0.01 * aux

    timings = []
    for _ in range(2):  # the first call warms up; the second is timed
        collectives.TRANSPORTS.clear()
        _sync(device)
        t0 = time.perf_counter()
        out, aux = moe.moe_forward(cfg, params, x, mesh)
        _sync(device)
        t1 = time.perf_counter()
        grads = torch.autograd.grad(
            loss_of(out, aux["load_balance_loss"]), ws)
        _sync(device)
        timings.append({"fwd_ms": (t1 - t0) * 1e3,
                        "bwd_ms": (time.perf_counter() - t1) * 1e3})
    transports = {"/".join(k): n for k, n in collectives.TRANSPORTS.items()}
    shards = [moe._moe_forward_local(cfg, params, x[i:i + 1])
              for i in range(2)]
    o_ref = torch.cat([o for o, _ in shards])
    aux_ref = torch.stack([a["load_balance_loss"] for _, a in shards]).mean()
    g_ref = torch.autograd.grad(loss_of(o_ref, aux_ref), ws)
    out, o_ref = out.detach(), o_ref.detach()
    res = {
        "rank": rank, "backend": str(dist.get_backend()),
        "capacity_slots": moe._capacity(T, cfg, 2),
        "out_max_abs_err": float((out.float() - o_ref.float()).abs().max()),
        "out_within": bool(torch.allclose(out.float(), o_ref.float(),
                                          **MOE_EP_TOL)),
        "aux": float(aux["load_balance_loss"].detach()),
        "aux_oracle": float(aux_ref.detach()),
        "grad_rel_err": {n: _rel_norm(a, b)
                         for n, a, b in zip(names, grads, g_ref)},
        "timings": timings, "transports_one_call": transports}
    with open(os.path.join(out_dir, f"moe_rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def moe_ep(smi: str, timeout: float = 600.0) -> dict:
    """The two `moe_rank` processes (this script, `--moe-rank`), their
    readings held: the output within sp_attention's bf16 limits of the
    oracle's, the gradients of the router, both expert weights and x
    through both all_to_alls within relative norm 3e-2 of the oracle's,
    on both ranks."""
    work, wall, _ = _spawn_ranks("--moe-rank", timeout)
    ranks = []
    for r in (0, 1):
        with open(os.path.join(work, f"moe_rank{r}.json")) as f:
            ranks.append(json.load(f))
    bad = [(r["rank"], "out", r["out_max_abs_err"]) for r in ranks
           if not r["out_within"]]
    bad += [(r["rank"], n, e) for r in ranks
            for n, e in r["grad_rel_err"].items() if e > FULL_GRAD_TOL]
    if bad:
        raise AssertionError(f"moe_ep outside its limits: {bad}")
    r0 = ranks[0]
    return {"phase": "moe_ep", "nvidia_smi": smi, "ranks": 2, "ep": 2,
            "backend": r0["backend"], "dim": 4096, "hidden": 14336,
            "num_experts": 8, "top_k": 2, "capacity_factor": 1.25,
            "dtype": "bfloat16", "global_x": [2, 1024, 4096],
            "capacity_slots": r0["capacity_slots"],
            "slots_per_direction_bytes": 8 * r0["capacity_slots"] * 4096 * 2,
            "out_max_abs_err": [r["out_max_abs_err"] for r in ranks],
            "out_tolerance": MOE_EP_TOL,
            "aux": r0["aux"], "aux_oracle": r0["aux_oracle"],
            "grad_rel_err": {r["rank"]: r["grad_rel_err"] for r in ranks},
            "grad_tolerance": FULL_GRAD_TOL,
            "fwd_ms": [r["timings"][-1]["fwd_ms"] for r in ranks],
            "bwd_ms": [r["timings"][-1]["bwd_ms"] for r in ranks],
            "first_call": r0["timings"][0],
            "transports_one_call": r0["transports_one_call"],
            "wall_s": wall}


class PipeStageFn:
    """A pipeline stage: one Llama block (its x; K and V dropped).  Each
    call first appends its process's flash launch counts to a log, so
    the driver can read a stage's launches between two calls."""

    def __init__(self, cfg, log_dir: str):
        self.cfg, self.log_dir = cfg, log_dir

    def __call__(self, params, x):
        counts = {n: getattr(fa, n).launches for n in FLASH}
        counts["plain_dispatches"] = fa.flash_attention.plain_dispatches
        with open(os.path.join(self.log_dir, f"stage_{os.getpid()}.jsonl"),
                  "a") as f:
            f.write(json.dumps(counts) + "\n")
        return llama._block(self.cfg, params, None, x)[0]


def pipe_loss(y):
    return y.float().square().mean()


def pipeline_1f1b(device, smi: str, *, M=4, mb=1, seq=1024, executes=1,
                  cfg=None) -> dict:
    """`compile_pipeline` with 2 stage actors on the card (`num_gpus`
    0.5 each), each one Llama-3-8B block at full width (flash, bf16
    compute, f32 params), M microbatches of mb x seq, loss mean(y^2):
    loss and each stage's gradients against one process's serial
    autograd over the same two blocks on the card with dense attention,
    so the gate holds the flash stages against the plain route; a
    warm-up execute,
    `executes` timed ones, and a last one whose first forward reads the
    stages' launch counts after the timed ones.  The runtime must be
    up."""
    cfg = cfg or dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                                     attention="flash")
    S = 2
    blocks = llama.init_params(dataclasses.replace(
        cfg, n_layers=S, vocab_size=8), 0, device=device)["blocks"]
    stages = [{k: v[s].clone() for k, v in blocks.items()}
              for s in range(S)]
    del blocks
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    x = torch.randn((M * mb, seq, cfg.dim), generator=gen,
                    device=device).to(cfg.dtype)
    # one process's serial autograd over the same two blocks, on the
    # plain attention route
    dense = dataclasses.replace(cfg, attention="dense")
    leaves = [p.requires_grad_(True) for st in stages for p in st.values()]
    h = x
    for st in stages:
        h = llama._block(dense, st, None, h)[0]
    ref_loss = pipe_loss(h)
    ref_grads = torch.autograd.grad(ref_loss, leaves)
    ref_loss = float(ref_loss.detach())
    for p in leaves:
        p.requires_grad_(False)
    del h
    names = list(stages[0])
    ref = [dict(zip(names, ref_grads[s * len(names):(s + 1) * len(names)]))
           for s in range(S)]
    del ref_grads
    log_dir = tempfile.mkdtemp(prefix="rtt_pipe_")
    t0 = time.perf_counter()
    pipe = pipeline_dag.compile_pipeline(
        PipeStageFn(cfg, log_dir), stages, pipe_loss, M,
        stage_options=[{"num_gpus": 0.5}] * S)
    compile_s = time.perf_counter() - t0

    def check(out) -> dict:
        errs = {"loss_rel_err": abs(out["loss"] - ref_loss) / abs(ref_loss),
                "grad_rel_err": [
                    {n: _rel_norm(out["grads"][s][n].to(device), ref[s][n])
                     for n in names} for s in range(S)]}
        worst = max(e for st in errs["grad_rel_err"] for e in st.values())
        if errs["loss_rel_err"] > PIPE_LOSS_TOL or worst > FULL_GRAD_TOL:
            raise AssertionError(f"pipeline vs serial autograd: {errs}")
        return errs

    try:
        t1 = time.perf_counter()
        first = pipe.execute(x).get(timeout=600)
        first_ms = (time.perf_counter() - t1) * 1e3
        errs = check(first)
        del first
        ms, losses = [], []
        for _ in range(executes):
            t1 = time.perf_counter()
            out = pipe.execute(x).get(timeout=600)
            ms.append((time.perf_counter() - t1) * 1e3)
            check(out)
            losses.append(out["loss"])
            del out
        pipe.execute(x).get(timeout=600)  # its first forwards log the counts
    finally:
        pipe.teardown()
    logs = []
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name)) as f:
            logs.append([json.loads(ln) for ln in f])
    want = {"flash_fwd": executes * M, "flash_bwd_fused": executes * M,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "plain_dispatches": 0}
    # entry j is read at the forward of microbatch j % M of execute j // M
    launches = [{k: log[(1 + executes) * M][k] - log[M][k] for k in want}
                for log in logs]
    if len(logs) != S or any(got != want for got in launches):
        raise AssertionError(f"pipeline stage launches {launches}, want "
                             f"{want} in each of {S} stages")
    act = mb * seq * cfg.dim * x.element_size()
    grad_bytes = sum(p.numel() * 4 for st in stages for p in st.values())
    return {
        "phase": "pipeline_1f1b", "nvidia_smi": smi, "stages": S,
        "stage": "one Llama-3-8B block (LlamaConfig.llama3_8b widths)",
        "dim": cfg.dim, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "intermediate": cfg.intermediate, "attention": cfg.attention,
        "compute_dtype": str(cfg.dtype)[6:], "param_gb_per_stage":
            grad_bytes / S / 1e9,
        "microbatches": M, "microbatch": [mb, seq, cfg.dim],
        "stage_options": {"num_gpus": 0.5}, "compile_s": compile_s,
        "loss_serial": ref_loss, "loss_pipeline": losses,
        "first_execute": errs, "first_execute_ms": first_ms,
        "tolerance": {"loss_rel": PIPE_LOSS_TOL,
                      "grad_rel_norm": FULL_GRAD_TOL},
        "execute_ms": ms, "execute_ms_median": statistics.median(ms),
        "channel_bytes_per_execute": {
            "input": M * act, "activations": (S - 1) * M * act,
            "activation_grads": (S - 1) * M * act,
            "result_grads": grad_bytes},
        "activation_bytes": act,
        "activation_route": ("spill" if act > get_config().dag_slot_bytes
                             else "inline"),
        "bubble_model": pipeline_dag.bubble_fraction(S, M),
        "launches_per_stage_timed": launches[0], "launches_want": want,
    }


def store_bytes(need: int) -> int:
    """An object store for this phase: 60% of /dev/shm's free bytes, at
    most 16 GiB; fails if that is below `need`."""
    free = shutil.disk_usage("/dev/shm").free
    cap = int(min(16 << 30, 0.6 * free))
    if cap < need:
        raise AssertionError(f"/dev/shm has {free} bytes free: an object "
                             f"store of {need} does not fit")
    return cap


def compiled_dag_phase(device, smi: str) -> None:
    """compiled_dag on the card, inside a runtime of its own."""
    t0 = time.perf_counter()
    rt.init(num_workers=2, num_cpus=8)
    try:
        line = compiled_dag(device, smi)
    finally:
        rt.shutdown()
    emit({**line, "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()


def graph_phases(device, smi: str) -> None:
    """moe_ep and pipeline_1f1b, each on the card and under the card's
    lease; the port's runtime is up for the second."""
    with card_lease() as waited_s:
        emit({**moe_ep(smi), "lease_wait_s": waited_s})
    torch.cuda.empty_cache()
    with card_lease() as waited_s:
        t0 = time.perf_counter()
        rt.init(num_workers=2, num_cpus=8,
                object_store_memory=store_bytes(6 << 30))
        try:
            line = pipeline_1f1b(device, smi)
        finally:
            rt.shutdown()
        emit({**line, "wall_s": time.perf_counter() - t0,
              "lease_wait_s": waited_s})
    torch.cuda.empty_cache()


# the card's lease: a phase that holds 40-55 GB of the card (the serving
# phases with Llama-3-8B's params, the sharded ranks, Mixtral's step) and
# one that holds ~25 (moe_ep's ranks, the pipeline's stages) never run at
# once, whichever process runs them
LEASE_ENV = "CHIP_SMOKE_LEASE"


@contextlib.contextmanager
def card_lease():
    """Holds the run's lease (an exclusive `flock` on the file that
    `CHIP_SMOKE_LEASE` names; a no-op where it is unset); yields the
    seconds it waited."""
    path = os.environ.get(LEASE_ENV)
    if not path:
        yield 0.0
        return
    with open(path, "a") as f:
        t0 = time.perf_counter()
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield time.perf_counter() - t0
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


# ----------------------------------------------------------------------
# data and tune: a shuffled token dataset streamed into the trainer's
# workers, and a Tuner sweeping the trainer's learning rate
# ----------------------------------------------------------------------
CORPUS_ROWS, CORPUS_FILES, CORPUS_SEQ = 16384, 16, 1024
DIGEST_MOD = 2**31 - 1
TUNE_LOSS_TOL = 1e-3  # relative: the trial's step-0 loss vs one process's


def write_corpus(d: str, vocab: int, rows: int = CORPUS_ROWS,
                 files: int = CORPUS_FILES, seq: int = CORPUS_SEQ) -> dict:
    """`files` .npz files of `rows / files` rows: int32 `tokens` [n, seq
    + 1] uniform in [0, vocab) from `default_rng(0)`, int64 `row_id`.
    Returns the digest weights, each row's tokens by `row_id` and the
    corpus's bytes."""
    rng = np.random.default_rng(0)
    per = rows // files
    tokens = rng.integers(0, vocab, (rows, seq + 1), dtype=np.int32)
    for f in range(files):
        np.savez(os.path.join(d, f"part{f:02d}.npz"),
                 tokens=tokens[f * per:(f + 1) * per],
                 row_id=np.arange(f * per, (f + 1) * per, dtype=np.int64))
    # the digest's sum stays below 2^36: 32,000 x 2,047 x 1,025
    w = np.random.default_rng(1).integers(1, 2048, seq + 1)
    return {"dir": d, "files": files, "w": w, "tokens": tokens,
            "bytes": tokens.nbytes + 8 * rows}


def digest_fn(w):
    """The user's transform: `tokens` int32 and contiguous, and a per-row
    int64 `digest` = tokens @ w % (2^31 - 1)."""
    def fn(batch):
        t = np.ascontiguousarray(batch["tokens"], dtype=np.int32)
        return {"tokens": t, "row_id": batch["row_id"],
                "digest": t.astype(np.int64) @ w % DIGEST_MOD}

    return fn


def with_deadline(seconds: float, fn, what: str):
    """`fn()` on a daemon thread; the phase fails if it outlives
    `seconds` (a resource deadlock shows up as a hang, not an error)."""
    import threading

    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the caller below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True, name=what)
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise AssertionError(f"{what} outlived its {seconds} s limit")
    if "error" in out:
        raise out["error"]
    return out["value"]


def _spill_dir_bytes() -> int:
    from ray_tpu_torch import api

    d = os.path.join(api._session.get("session_dir") or "", "spilled")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)
               if f.endswith(".bin")) if os.path.isdir(d) else 0


def check_batches(recs: dict, corpus: dict, batch: int, seq: int) -> list:
    """Every step's batch on the card, int32 [batch, seq + 1], its digest
    checked there; every (row_id, digest) pair against the driver's own
    corpus; no row_id twice across ranks and steps.  Returns the rows
    trained on, in order."""
    w = corpus["w"]
    seen = []
    for r, lines in sorted(recs.items()):
        for x in lines:
            if (not x["device"].startswith("cuda") or x["dtype"] != "int32"
                    or x["shape"] != [batch, seq + 1] or not x["digest_ok"]):
                raise AssertionError(f"rank {r} step {x['step']} batch "
                                     f"{x['device']} {x['dtype']} "
                                     f"{x['shape']} digest {x['digest_ok']}")
            for rid, dg in zip(x["row_ids"], x["row_digests"]):
                want = int(corpus["tokens"][rid].astype(np.int64) @ w
                           % DIGEST_MOD)
                if dg != want:
                    raise AssertionError(f"row {rid}: digest {dg}, the "
                                         f"corpus's {want}")
            seen.extend(x["row_ids"])
    if len(set(seen)) != len(seen):
        raise AssertionError(f"rows trained on twice: {len(seen)} rows, "
                             f"{len(set(seen))} distinct")
    return seen


def data_ingest(device, smi: str, corpus: dict, *, batch=4, steps=3,
                cfg=None, timeout: float = 900.0) -> dict:
    """`read_numpy` -> `map_batches(digest_fn)` -> `random_shuffle(seed=0)`
    streamed into `CudaTrainer(ingest_train_loop)`: two collective-mode
    workers sharing the card (`GPU` 0.5, `CPU` 1 each), each taking
    `batch` rows a step through `iter_cuda_batches` at the LoRA bench's
    size, gradients synced as in `dp_train_loop`.  Every gate of the
    line is held here."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import (CudaConfig, CudaTrainer, RunConfig,
                                     ScalingConfig)

    cfg = cfg or train_llama_lora.lora_config(n_layers=PLANE_LAYERS)
    work = tempfile.mkdtemp(prefix="rtt_data_ingest_")
    out_dir = os.path.join(work, "out")
    os.makedirs(out_dir)
    seq = corpus["tokens"].shape[1] - 1
    rt.init(num_workers=2, num_cpus=8, object_store_memory=store_bytes(
        8 * corpus["bytes"]))
    try:
        ds = (rd.read_numpy(os.path.join(corpus["dir"], "*.npz"))
              .map_batches(digest_fn(corpus["w"]), batch_size=256)
              .random_shuffle(seed=0))
        trainer = CudaTrainer(
            train_llama_lora.ingest_train_loop,
            train_loop_config={"device": device.type, "seed": 0, "cfg": cfg,
                               "steps": steps, "batch": batch,
                               "digest_w": corpus["w"].tolist(),
                               "out_dir": out_dir},
            datasets={"train": ds},
            scaling_config=ScalingConfig(
                num_workers=2, use_gpu=True,
                resources_per_worker={"GPU": 0.5, "CPU": 1}),
            run_config=RunConfig(name="data_ingest",
                                 storage_path=os.path.join(work, "store")),
            cuda_config=CudaConfig(distributed_mode="collective",
                                   device=device.type))
        t0 = time.time()
        res = with_deadline(timeout, trainer.fit, "data_ingest fit")
        fit_s = time.time() - t0
        if res.error is not None:
            raise AssertionError(f"data_ingest fit failed: {res.error!r}")
        spilled = _spill_dir_bytes()
    finally:
        rt.shutdown()
    recs = _records(out_dir)
    if sorted(recs) != [0, 1]:
        raise AssertionError(f"data_ingest ranks reported {sorted(recs)}")
    for r, lines in recs.items():
        if [x["step"] for x in lines] != list(range(1, steps + 1)):
            raise AssertionError(f"rank {r} steps {[x['step'] for x in lines]}")
    # gates 1 and 2: the batches, checked by row_id (blocks reach the
    # split in the order they complete, so never by position)
    seen = check_batches(recs, corpus, batch, seq)
    # gate 3: the data-parallel invariant, bit for bit
    for step in range(steps):
        if len({recs[r][step]["digest"] for r in recs}) != 1:
            raise AssertionError(f"ranks' adapters differ after step "
                                 f"{step + 1}")
    # gate 6: each worker's launches a step
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_fused": cfg.n_layers,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "plain_dispatches": 0}
    for r, lines in recs.items():
        for x in lines:
            if x["launches"] != want:
                raise AssertionError(f"rank {r} step {x['step']} launches "
                                     f"{x['launches']}, want {want}")
    # gate 5: the step-0 loss against a fresh model's cross entropy
    losses = [x["global_loss"] for x in recs[0]]
    ce0 = init_ce(cfg.vocab_size, cfg.dim)
    if not all(math.isfinite(v) for v in losses) or abs(losses[0] - ce0) > 0.5:
        raise AssertionError(f"data_ingest losses {losses}, step-0 "
                             f"expected near {ce0}")
    # gate 4: the step-0 synced gradient against one process's on the
    # same rows (rank order: the mean over equal shares is the batch's)
    rows0 = [rid for r in sorted(recs) for rid in recs[r][0]["row_ids"]]
    ref = train_llama_lora.build(device, len(rows0), seq, 0, cfg,
                                 tokens=corpus["tokens"][rows0])
    ref_loss, ref_grads = train_llama_lora.lora_grads(ref, ref["tokens"])
    flat_ref = torch.cat([g.float().reshape(-1) for g in ref_grads])
    with np.load(os.path.join(out_dir, "grad0.npz")) as z:
        flat = torch.cat([torch.from_numpy(z[f"arr_{i}"]).reshape(-1)
                          for i in range(len(z.files))]).to(device)
    grad_rel = _rel_norm(flat, flat_ref)
    del ref, ref_grads, flat_ref, flat
    torch.cuda.empty_cache()
    if grad_rel > FULL_GRAD_TOL:
        raise AssertionError(f"data_ingest synced step-0 gradient vs one "
                             f"process on the same rows: {grad_rel}")
    step_ms = [max(recs[r][i]["ms"] for r in recs) for i in range(steps)]
    steady = step_ms[1:]
    waits = [recs[r][i]["wait_ms"] for r in recs for i in range(1, steps)]
    shares = [recs[r][i]["wait_ms"] / recs[r][i]["ms"] for r in recs
              for i in range(1, steps)]
    tokens = 2 * batch * seq
    first_entry = min(recs[r][0]["loop_entry"] for r in recs)
    return {
        "phase": "data_ingest", "nvidia_smi": smi,
        "pipeline": "read_numpy -> map_batches(digest, batch_size=256) -> "
                    "random_shuffle(seed=0) -> streaming_split(2) -> "
                    "iter_cuda_batches(batch_size=4)",
        "trainer": "CudaTrainer(ingest_train_loop)",
        "distributed_mode": "collective", "workers": 2,
        "resources_per_worker": {"GPU": 0.5, "CPU": 1},
        "model": "llama_1b4", "source": "bench.py bench_llama_lora (its "
        "chip config)", "reduced": PLANE_REDUCED, "n_layers": cfg.n_layers,
        "dim": cfg.dim, "attention": cfg.attention, "lora_rank": 8,
        "corpus_rows": int(corpus["tokens"].shape[0]),
        "corpus_files": corpus["files"], "seq": seq,
        "dataset_mb": (corpus["bytes"] + 8 * corpus["tokens"].shape[0]) / 1e6,
        "spill_dir_bytes_at_end": spilled,
        "global_batch": 2 * batch, "steps": steps,
        "rows_trained": len(seen), "rows_distinct": len(set(seen)),
        "batches_on_card_int32_digest_checked": True,
        "ranks_bit_equal_every_step": True,
        "global_losses": losses, "step0_loss": losses[0],
        "step0_expected_ce": ce0, "one_process_step0_loss": float(ref_loss),
        "step0_synced_grad_rel_err_vs_one_process": grad_rel,
        "step0_grad_tolerance": FULL_GRAD_TOL,
        "launches_per_step_per_worker": want,
        "launches_total": {k: sum(x["launches"][k] for lines in recs.values()
                                  for x in lines) for k in want},
        "step_ms": step_ms,
        "tokens_per_s_steady": tokens * len(steady) / (sum(steady) / 1e3),
        "first_batch_s": {r: recs[r][0]["wait_ms"] / 1e3 for r in recs},
        "ingest_wait_ms_steady": {
            "median": statistics.median(waits), "max": max(waits),
            "share_of_step_median": statistics.median(shares),
            "share_of_step_max": max(shares)},
        "sync_ms": {k: [max(recs[r][i]["sync_ms"][k] for r in recs)
                        for i in range(steps)]
                    for k in recs[0][0]["sync_ms"]},
        "peak_mem_gb": {r: max(x["peak_gb"] for x in recs[r])
                        for r in recs},
        "startup_s": first_entry - t0, "fit_s": fit_s,
    }


def tune_trainer(device, smi: str, corpus: dict, *, n_layers=4,
                 lrs=(1e-4, 1e-3), batch=4, steps=3, cfg=None,
                 timeout: float = 900.0) -> dict:
    """`Tuner(CudaTrainer(ingest_train_loop, datasets=...))` sweeping the
    learning rate over a grid, two trials at once, each a one-worker
    trainer (`GPU` 0.5, `CPU` 1) taking `steps` LoRA steps on `batch`
    rows of the corpus after `read_numpy` -> `map_batches` (no shuffle).
    Every gate of the line is held here."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import tune
    from ray_tpu_torch.train import (CudaConfig, CudaTrainer, RunConfig,
                                     ScalingConfig)

    cfg = cfg or train_llama_lora.lora_config(n_layers=n_layers)
    work = tempfile.mkdtemp(prefix="rtt_tune_trainer_")
    seq = corpus["tokens"].shape[1] - 1
    rt.init(num_workers=2, num_cpus=8, object_store_memory=store_bytes(
        8 * corpus["bytes"]))
    try:
        ds = (rd.read_numpy(os.path.join(corpus["dir"], "*.npz"))
              .map_batches(digest_fn(corpus["w"]), batch_size=256))
        trainer = CudaTrainer(
            train_llama_lora.ingest_train_loop, datasets={"train": ds},
            scaling_config=ScalingConfig(
                num_workers=1, resources_per_worker={"GPU": 0.5, "CPU": 1}),
            run_config=RunConfig(name="inner",
                                 storage_path=os.path.join(work, "inner")),
            cuda_config=CudaConfig(distributed_mode="collective",
                                   device=device.type))
        tuner = tune.Tuner(
            trainer,
            param_space={"train_loop_config": {
                "lr": tune.grid_search(list(lrs)), "device": device.type,
                "seed": 0, "cfg": cfg, "steps": steps, "batch": batch,
                "digest_w": corpus["w"].tolist()}},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=len(lrs),
                                        resources_per_trial={"CPU": 0.5}),
            run_config=RunConfig(name="tune_trainer", storage_path=work))
        t0 = time.time()
        grid = with_deadline(timeout, tuner.fit, "tune_trainer fit")
        fit_s = time.time() - t0
    finally:
        rt.shutdown()
    # gate 1: every trial ended TERMINATED, none in error
    with open(os.path.join(grid.experiment_path,
                           "experiment_state.json")) as f:
        status = [t["status"] for t in json.load(f)["trials"]]
    if grid.num_errors or status != ["TERMINATED"] * len(lrs):
        raise AssertionError(f"tune_trainer trials {status}, errors "
                             f"{grid.errors}")
    trials = {}
    for res in grid:
        hist = [m for m in res.metrics_history if "step" in m]
        lr = res.metrics["config"]["train_loop_config"]["lr"]
        if [m["step"] for m in hist] != list(range(1, steps + 1)):
            raise AssertionError(f"trial lr {lr} steps {hist}")
        # gate 3 (first half): the lr each trial's optimizer used
        if any(m["lr"] != lr for m in hist):
            raise AssertionError(f"trial lr {lr} recorded "
                                 f"{[m['lr'] for m in hist]}")
        trials[lr] = {"hist": hist, "result": res}
    for t in trials.values():  # each trial reads the dataset anew
        check_batches({0: t["hist"]}, corpus, batch, seq)
    # gate 2: each trial's step-0 loss against one process's on its rows
    ref = train_llama_lora.build(device, batch, seq, 0, cfg)
    ref_losses = {}
    with torch.no_grad():
        for lr, t in trials.items():
            rows = torch.as_tensor(corpus["tokens"][t["hist"][0]["row_ids"]],
                                   device=device)
            ref_losses[lr] = float(llama.loss_fn(cfg, ref["params"], rows,
                                                 lora=ref["lora"]))
            got = t["hist"][0]["loss"]
            if abs(got - ref_losses[lr]) > TUNE_LOSS_TOL * abs(ref_losses[lr]):
                raise AssertionError(f"trial lr {lr} step-0 loss {got} vs "
                                     f"one process {ref_losses[lr]}")
    del ref
    torch.cuda.empty_cache()
    # gate 3 (second half): the two learning rates gave other adapters
    after1 = [t["hist"][0]["digest"] for t in trials.values()]
    if len(set(after1)) != len(after1):
        raise AssertionError("trials' adapters are equal after step 1")
    # gate 4: the best result is the trial with the lower last loss
    best = grid.get_best_result("loss", "min")
    lowest = min(trials, key=lambda lr: trials[lr]["hist"][-1]["loss"])
    if best is not trials[lowest]["result"]:
        raise AssertionError(f"best result lr "
                             f"{best.metrics['config']['train_loop_config']}"
                             f", lowest last loss at lr {lowest}")
    # gate 5: the trials' step windows overlap (both on the card at once)
    windows = {lr: (t["hist"][0]["t_start"], t["hist"][-1]["t_end"])
               for lr, t in trials.items()}
    if max(a for a, _ in windows.values()) >= min(
            b for _, b in windows.values()):
        raise AssertionError(f"trial step windows do not overlap: "
                             f"{windows}")
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_fused": cfg.n_layers,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "plain_dispatches": 0}
    for lr, t in trials.items():
        for m in t["hist"]:
            if m["launches"] != want:
                raise AssertionError(f"trial lr {lr} step {m['step']} "
                                     f"launches {m['launches']}")
    return {
        "phase": "tune_trainer", "nvidia_smi": smi,
        "tuner": "Tuner(CudaTrainer(ingest_train_loop, datasets=...))",
        "model": "llama_1b4", "source": "bench.py bench_llama_lora (its "
        "chip config)", "dim": cfg.dim, "n_layers": cfg.n_layers,
        "reduced": "depth 22 -> 4 layers: keeps the phase in the time "
                   "limit; Tune's mechanism does not depend on depth",
        "lrs": list(lrs), "steps": steps, "batch": batch, "seq": seq,
        "pipeline": "read_numpy -> map_batches(digest, batch_size=256) -> "
                    "streaming_split(1) -> iter_cuda_batches(batch_size=4)",
        "max_concurrent_trials": len(lrs),
        "resources_per_trial": {"CPU": 0.5},
        "resources_per_worker": {"GPU": 0.5, "CPU": 1},
        "statuses": status, "num_errors": grid.num_errors,
        "best_lr": best.metrics["config"]["train_loop_config"]["lr"],
        "launches_per_step_per_trial": want,
        "windows_overlap_s": min(b for _, b in windows.values())
        - max(a for a, _ in windows.values()),
        "fit_s": fit_s,
        "trials": {str(lr): {
            "losses": [m["loss"] for m in t["hist"]],
            "step0_loss_one_process": ref_losses[lr],
            "step0_loss_rel_diff": abs(t["hist"][0]["loss"] - ref_losses[lr])
            / abs(ref_losses[lr]),
            "step_ms": [m["ms"] for m in t["hist"]],
            "ingest_wait_ms": [m["wait_ms"] for m in t["hist"]],
            "startup_s": t["hist"][0]["loop_entry"] - t0,
            "wall_s": t["hist"][-1]["t_end"] - t0,
            "peak_mem_gb": max(m["peak_gb"] for m in t["hist"]),
        } for lr, t in trials.items()},
    }


def data_tune_phases(device, smi: str) -> None:
    """data_ingest, then tune_trainer, over one corpus written to a temp
    directory; each boots the port's runtime and shuts it down."""
    corpus_dir = tempfile.mkdtemp(prefix="rtt_corpus_")
    try:
        t0 = time.perf_counter()
        corpus = write_corpus(corpus_dir, vocab=32000)
        write_s = time.perf_counter() - t0
        emit({**data_ingest(device, smi, corpus), "corpus_write_s": write_s,
              "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        emit({**tune_trainer(device, smi, corpus),
              "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(corpus_dir, ignore_errors=True)


def xent_case(N, E, V, x_dtype, w_dtype, device, seed=0) -> dict:
    """Seeded x [N, E] ~ N(0, 1), w [V, E] ~ N(0, 0.05^2), targets with 0
    and V - 1 among them, and the plain forward's lse: the inputs each
    kernel shares with its plain version."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((N, E), generator=gen, device=device).to(x_dtype)
    w = (torch.randn((V, E), generator=gen, device=device) * 0.05).to(
        w_dtype)
    targets = torch.randint(0, V, (N,), generator=gen, device=device,
                            dtype=torch.int32)
    targets[0], targets[-1] = 0, V - 1
    lse, _ = xp.xent_fwd_reference(x, w, targets)
    return {"x": x, "w": w, "targets": targets, "lse": lse}


def run_xent(name: str, c: dict, plain: bool = False) -> tuple:
    fn = getattr(xp, name + "_reference" if plain else name)
    args = (c["x"], c["w"], c["targets"])
    out = fn(*args) if name == "xent_fwd" else fn(*args, c["lse"])
    return out if isinstance(out, tuple) else (out,)


def _scaled(tol: dict, want) -> dict:
    """`tol` with atol taken relative to the largest |want|."""
    return dict(tol, atol=tol["atol"] * float(want.detach().abs().max()))


def check_xent(c: dict, kind: str) -> dict:
    """K7-K9 each against its plain version on the same inputs.  Returns
    {name: (max abs err, elementwise ratio, relative norm)}, each the
    worst over the kernel's outputs; raises beyond XENT_TOL[kind]."""
    tol, out = XENT_TOL[kind], {}
    for name in XENT:
        got, want = run_xent(name, c), run_xent(name, c, plain=True)
        worst = (0.0, 0.0, 0.0)
        for g, w in zip(got, want):
            if (g.shape != w.shape or g.dtype != w.dtype
                    or not bool(torch.isfinite(g).all())):
                raise AssertionError(f"{name}: misshapen or non-finite")
            worst = tuple(map(max, worst, compare(g, w, _scaled(tol, w))))
        del got, want
        if not within(worst, tol):
            raise AssertionError(f"{name} {kind}: (max abs, elementwise "
                                 f"ratio, rel norm) {worst} beyond {tol}")
        out[name] = worst
    return out


def xent_flops(name: str, c: dict) -> float:
    """2 N V E for the score product, plus 2 N V E for K8's and K9's
    second product."""
    (N, E), V = c["x"].shape, c["w"].shape[0]
    return 2.0 * N * V * E * (1 if name == "xent_fwd" else 2)


def xent_bound(name: str, c: dict) -> tuple:
    """Operations: `xent_flops` at x's dtype's peak.  Bytes: x, w (as
    the kernel reads it), targets and (K8, K9) lse read once; lse and
    target logit, dx or dw written once in f32."""
    x, w = c["x"], c["w"]
    N, E = x.shape
    V = w.shape[0]
    ins = x.numel() * x.element_size() + w.numel() * w.element_size() + 4 * N
    n_bytes = {"xent_fwd": ins + 8 * N, "xent_dx": ins + 4 * N + 4 * N * E,
               "xent_dw": ins + 4 * N + 4 * V * E}[name]
    return _bound(n_bytes, xent_flops(name, c), x.dtype)


def xent_library(name: str, c: dict):
    """The one `torch.matmul` that does the kernel's main product in x's
    dtype: x w^T into [N, V] for K7; dl w for K8 and dl^T x for K9, from
    a precomputed dl in x's dtype."""
    x, w = c["x"], c["w"].to(c["x"].dtype)
    if name == "xent_fwd":
        return lambda: torch.matmul(x, w.T)
    dl = xp._dlogits(x, w, c["targets"], c["lse"]).to(x.dtype)
    if name == "xent_dx":
        return lambda: torch.matmul(dl, w)
    return lambda: torch.matmul(dl.T, x)


def time_wide_xent(c: dict) -> dict:
    """ms, bound_ms, library_ms and TFLOP/s of K7-K9 where E is wider
    than the 768 columns a CTA holds (K7 streams x beside w; each 32-row
    step of K8 / K9 streams the output block's A panels again), beside
    the one `torch.matmul` of each kernel's main product."""
    out = {}
    for name in XENT:
        ms = time_ms(lambda: run_xent(name, c), iters=3)
        lib = xent_library(name, c)
        out[name] = {"ms": ms, "bound_ms": xent_bound(name, c)[0],
                     "library_ms": time_ms(lib, iters=3),
                     "tflops": xent_flops(name, c) / (ms * 1e-3) / 1e12}
        del lib
        torch.cuda.empty_cache()
    return out


def time_xent(c: dict) -> dict:
    """ms / plain_ms / bound_ms / bound_by / library_ms of K7-K9 on one
    case, with the achieved TFLOP/s."""
    out = {}
    for name in XENT:
        bound, by = xent_bound(name, c)
        lib = xent_library(name, c)
        ms = time_ms(lambda: run_xent(name, c), iters=10)
        out[name] = {
            "ms": ms,
            "plain_ms": time_ms(lambda: run_xent(name, c, plain=True),
                                iters=5),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_ms(lib, iters=10),
            "tflops": xent_flops(name, c) / (ms * 1e-3) / 1e12,
        }
        del lib
        torch.cuda.empty_cache()
    return out


class count_plain:
    """Counts calls of the K7-K9 plain versions while it is entered:
    the wrappers look them up in their module at each call, so a CUDA
    tensor that reached one would show here."""

    def __enter__(self):
        self.calls, self._saved = 0, {}
        for name in XENT:
            ref = name + "_reference"
            orig = self._saved[ref] = getattr(xp, ref)

            def counted(*a, _orig=orig, **k):
                self.calls += 1
                return _orig(*a, **k)
            setattr(xp, ref, counted)
        return self

    def __exit__(self, *exc):
        for ref, orig in self._saved.items():
            setattr(xp, ref, orig)
        return False


def _peak(fn, device) -> tuple:
    """(result, peak bytes above what was allocated before) of `fn()`."""
    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    return out, torch.cuda.max_memory_allocated(device) - base


def xent_main_path(device, *, cfg=None, batch=32, seq=1024,
                   time_it=True) -> dict:
    """`pallas_cross_entropy` at GPT-2's lm-head: x = the backbone's
    final hidden states of the seeded model and tokens (bf16, detached
    into a leaf), w = the f32 master `wte`, targets = the shifted
    tokens.  Forward and backward with the launch counts of exactly
    that call, held against `reference_cross_entropy` under autograd,
    and so the row-chunked `fused_cross_entropy`; then all three timed
    forward + backward, each with its peak memory."""
    state = train_gpt2.build(device, batch, seq, seed=0, cfg=cfg)
    cfg, params, tokens = state["cfg"], state["params"], state["tokens"]
    with torch.no_grad():
        h = gpt2.backbone(cfg, params, tokens[:, :-1])
    x = h.reshape(-1, cfg.n_embd).detach().requires_grad_(True)
    w = params["wte"].detach().requires_grad_(True)
    targets = tokens[:, 1:].reshape(-1).contiguous()
    del h, state

    def fused():
        loss = pallas_cross_entropy(x, w, targets)
        return (loss, *torch.autograd.grad(loss, (x, w)))

    def lse_form():
        loss = xp.reference_cross_entropy(x, w, targets)
        return (loss, *torch.autograd.grad(loss, (x, w)))

    def chunked():
        loss = fused_cross_entropy(x, w, targets)
        return (loss, *torch.autograd.grad(loss, (x, w)))

    reset_counts()
    with count_plain() as plain:
        (loss, dx, dw), fused_peak = _peak(fused, device)
    launches = {name: getattr(xp, name).launches for name in XENT}
    if launches != {n: 1 for n in XENT} or plain.calls != 0:
        raise AssertionError(f"xent launches {launches}, plain "
                             f"dispatches {plain.calls}")
    (r_loss, r_dx, r_dw), lse_peak = _peak(lse_form, device)
    r_loss = r_loss.detach()

    def against_lse_form(what, loss, dx, dw) -> dict:
        if dx.dtype != x.dtype or dw.dtype != w.dtype or not all(
                bool(torch.isfinite(t.float()).all())
                for t in (loss, dx, dw)):
            raise AssertionError(f"{what} grads misshapen or non-finite")
        err = {"loss": abs(float(loss) - float(r_loss)),
               **{n: float(torch.linalg.vector_norm(g.float() - r.float())
                            / torch.linalg.vector_norm(r.float()))
                  for n, g, r in (("dx", dx, r_dx), ("dw", dw, r_dw))}}
        if any(err[k] > XENT_MAIN_TOL[k] for k in err):
            raise AssertionError(f"{what} vs lse form: {err} beyond "
                                 f"{XENT_MAIN_TOL}")
        return err

    loss = loss.detach()
    err = against_lse_form("fused", loss, dx, dw)
    del dx, dw
    (c_loss, c_dx, c_dw), chunked_peak = _peak(chunked, device)
    err_chunked = against_lse_form("chunked", c_loss.detach(), c_dx, c_dw)
    if abs(float(loss) - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"loss {float(loss)} far from ln V = "
                             f"{math.log(cfg.vocab_size)}")
    del r_dx, r_dw, c_dx, c_dw
    line = {"phase": "xent_main_path", "model": "gpt2_124m",
            "N": x.shape[0], "E": x.shape[1], "V": w.shape[0],
            "x_dtype": str(x.dtype).replace("torch.", ""),
            "w_dtype": str(w.dtype).replace("torch.", ""),
            "depth_cut": False, "loss": float(loss),
            "loss_lse_form": float(r_loss), "ln_V": math.log(w.shape[0]),
            "launches": launches, "plain_dispatches": plain.calls,
            "err_vs_lse_form": err,
            "chunked_err_vs_lse_form": err_chunked,
            "tolerance": XENT_MAIN_TOL}
    if time_it:
        line.update({
            "fused_fwd_bwd_ms": time_ms(fused, iters=10),
            "fused_peak_extra_gb": fused_peak / 1e9,
            "lse_form_fwd_bwd_ms": time_ms(lse_form, iters=10),
            "lse_form_peak_extra_gb": lse_peak / 1e9,
            "chunked_fwd_bwd_ms": time_ms(chunked, iters=5),
            "chunked_peak_extra_gb": chunked_peak / 1e9,
        })
    return {"launches": launches, "line": line}


# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
# rllib: PPO at BASELINE config #3's fleet, and the CNN learner at
# Atari's frame shape
# ----------------------------------------------------------------------
# the first update on the card against the plain CPU learner from the
# same params, optimizer state and minibatch, both in f32 (the learner
# turns TF32 off for its own forward and backward): the loss relative,
# the gradient by the relative norm of the difference over all leaves,
# and the params after the step element by element wherever the CPU
# gradient is 0 or its magnitude above 1e-6.  Between, Adam's step sign
# can be rounding noise (a flip moves a param by 2 lr): those elements
# are counted and held to 2 lr
RLLIB_TOL = {"loss": 1e-5, "grad_rel": 1e-5, "rtol": 1e-5, "atol": 1e-6,
             "noisy_atol_lr": 2.0}
RLLIB_NOISE = 1e-6


class LearnerProbe:
    """Instruments a live local learner through instance attributes over
    its update's three parts: CUDA events around the host-to-device copy
    (`_to_device`), the forward + backward (`_shard_grads`) and the
    optimizer (`_apply`) of every minibatch, a host clock around every
    weights read (`get_weights_numpy`, the device-to-host copy), and
    copies of the first update's start state, minibatch, metrics,
    gradient and stepped params."""

    def __init__(self, learner):
        self.learner = learner
        self.first = None
        self._capture = False
        self.reset()
        for name, span in (("_to_device", "h2d"),
                           ("_shard_grads", "fwd_bwd"),
                           ("_apply", "optimizer")):
            self._time(name, span)
        update = learner.update_minibatch_device
        weights = learner.get_weights_numpy

        def probed_update(batch):
            if self.first is not None:
                return update(batch)
            state = learner.get_state()
            self._capture = True
            try:
                metrics = update(batch)
            finally:
                self._capture = False
            self.first.update(
                state=state, batch={k: np.array(v) for k, v in batch.items()},
                metrics={k: float(v) for k, v in metrics.items()},
                params=weights())
            return metrics

        def timed_weights():
            t0 = time.perf_counter()
            out = weights()
            self.d2h_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        learner.update_minibatch_device = probed_update
        learner.get_weights_numpy = timed_weights

    def _time(self, name: str, span: str) -> None:
        fn = getattr(self.learner, name)

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.spans[span].append((start, end))
            if name == "_apply" and self._capture:
                self.first = {"grads": [g.detach().cpu().numpy()
                                        for g in args[0]]}
            return out

        setattr(self.learner, name, timed)

    def reset(self) -> None:
        self.spans = {"h2d": [], "fwd_bwd": [], "optimizer": []}
        self.d2h_ms = []

    def split(self) -> dict:
        """ms a minibatch of each part (CUDA events, mean over the
        minibatches since `reset`), and the weights' ms an iteration."""
        torch.cuda.synchronize()
        out = {f"{span}_ms": statistics.fmean(s.elapsed_time(e)
                                              for s, e in pairs)
               for span, pairs in self.spans.items() if pairs}
        out["minibatches"] = len(self.spans["fwd_bwd"])
        out["weights_d2h_ms"] = (statistics.fmean(self.d2h_ms)
                                 if self.d2h_ms else None)
        return out


def update_vs_cpu(algo, first: dict, learner=None) -> dict:
    """The first update on the card (`first`, a `LearnerProbe`'s)
    against the plain CPU learner started from the same state, on the
    same minibatch, with the algorithm's own loss and optimizer.
    `learner`: the card's learner (default: the algorithm's one local
    learner; multi-agent PPO has one a module)."""
    from ray_tpu_torch.rllib.core.learner import Learner
    from ray_tpu_torch.models.bridge import tree_leaves

    card = learner if learner is not None else algo.learner_group._local
    cpu = Learner(card.module, card._loss_fn, device="cpu")
    cpu.optimizer = card.optimizer
    cpu.set_state(first["state"])
    metrics, grads = cpu._grads(first["batch"])
    cpu._apply(grads)
    loss_rel = abs(first["metrics"]["total_loss"]
                   - float(metrics["total_loss"])) / abs(
                       float(metrics["total_loss"]))
    want_g = np.concatenate([g.numpy().ravel() for g in grads])
    got_g = np.concatenate([g.ravel() for g in first["grads"]])
    grad_rel = float(np.linalg.norm(got_g - want_g)
                     / np.linalg.norm(want_g))
    lr = card.optimizer.schedule(0)
    held = noisy = 0
    worst = worst_noisy = 0.0
    for got, want, g in zip(tree_leaves(first["params"]),
                            tree_leaves(cpu.get_weights_numpy()), grads):
        g = g.numpy()
        mask = (np.abs(g) > RLLIB_NOISE) | (g == 0)
        np.testing.assert_allclose(got[mask], want[mask],
                                   rtol=RLLIB_TOL["rtol"],
                                   atol=RLLIB_TOL["atol"])
        np.testing.assert_allclose(got[~mask], want[~mask], rtol=0,
                                   atol=RLLIB_TOL["noisy_atol_lr"] * lr)
        held += int(mask.sum())
        noisy += int((~mask).sum())
        worst = max(worst, float(np.abs(got - want).max()))
        worst_noisy = max(worst_noisy, float(np.abs(
            got[~mask] - want[~mask]).max(initial=0.0)))
    line = {"loss_rel": loss_rel, "grad_rel_norm": grad_rel,
            "params_held_strictly": held, "params_noisy_grad": noisy,
            "params_max_abs_err": worst,
            "params_noisy_max_abs_err": worst_noisy, "lr": lr,
            "tolerance": RLLIB_TOL,
            "minibatch_rows": int(first["batch"]["obs"].shape[0])}
    assert loss_rel <= RLLIB_TOL["loss"], line
    assert grad_rel <= RLLIB_TOL["grad_rel"], line
    return line


def profile_call(fn) -> tuple:
    """`fn()` under `torch.profiler`: (its value, the wall ms to the
    card's last work, the card's busy ms: the device time of every
    kernel and copy in the trace).  The card's activity only: a trace of
    every host op as well took 7-35 s to collect after a 0.2-1.8 s
    iteration (rllib_ppo, rllib_dreamer_pixels, rllib_multi_agent on
    the H100), and its recording lengthened the wall it is read
    against."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages()) / 1e3
    return value, wall_ms, busy_ms


def device_idle_share(algo) -> dict:
    """One more iteration under `torch.profiler` (the card's activity
    only): the card's busy ms over the iteration's wall ms.  The
    tracer's host overhead still lengthens the wall a little, so the
    share reads high; None when the trace shows no device time."""
    _, wall_ms, busy_ms = profile_call(algo.train)
    return {"profiled_iteration_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms
            else None}


def published_weights_equal(algo) -> bool:
    """The weights the runners receive (the object they pull, or on the
    channel plane the tree written to their rings) bit-equal to the
    learner's."""
    group = algo.env_runner_group
    mine = algo.learner_group._local.get_weights_numpy()
    sent = (group._weights if group._chan_mode else
            rt.get(group._weights_refs[-1]["ref"], timeout=60))
    from ray_tpu_torch.models.bridge import tree_leaves

    a, b = tree_leaves(sent), tree_leaves(mine)
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def rllib_run(algo, probe, smi: str, *, iters: int, deadline: float
              ) -> dict:
    """1 warm-up + `iters` timed iterations of a built algorithm: the
    bench's row (env steps/s, updates/s, the overlap, exactly-once
    accounting), the learner's split, peak memory and the card's idle
    share over one more iteration."""
    group = algo.env_runner_group

    def run():
        algo.train()  # warm-up: primes the stream and the card
        probe.reset()
        torch.cuda.reset_peak_memory_stats()
        led0 = group.ledger.snapshot()
        t0 = time.perf_counter()
        res = [algo.train() for _ in range(iters)]
        torch.cuda.synchronize()
        return res, led0, time.perf_counter() - t0

    results, led0, wall_s = with_deadline(deadline, run, "rllib iterations")
    split = probe.split()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    led1 = group.ledger.snapshot()
    steps = sum(int(r["num_env_steps_sampled"]) for r in results)
    updates = sum(int(r["num_learner_updates"]) for r in results)
    batches = led1["batches"] - led0["batches"]
    row = {
        "env_steps_per_s": steps / wall_s, "updates_per_s": updates / wall_s,
        "env_steps": steps, "updates": updates, "wall_s": wall_s,
        "iters": iters,
        "accounting_exact": float(
            steps == int(led1["env_steps"] - led0["env_steps"])
            and batches == led1["unique"] - led0["unique"]),
        "replacements": group.num_replacements,
        "batch_mb_object_plane": (led1["bytes"] - led0["bytes"])
        / max(batches, 1) / 1e6,
        # the runners' own sampling seconds, summed over the batches
        "ledger_sample_s": led1["sample_s"] - led0["sample_s"],
        "final_loss": results[-1]["total_loss"],
        "learner": split, "peak_gb": peak_gb,
        "weights_bit_equal": published_weights_equal(algo),
        "nvidia_smi": smi,
    }
    if "sample_busy_s" in results[-1]:
        busy = sum(r["sample_busy_s"] for r in results)
        wait = sum(r["sample_wait_s"] for r in results)
        row.update(sample_busy_s=busy, sample_wait_s=wait,
                   overlap_ratio=max(0.0, busy - wait) / busy if busy
                   else 0.0)
    row.update(with_deadline(deadline, lambda: device_idle_share(algo),
                             "rllib profiled iteration"))
    assert row["accounting_exact"] == 1.0 and row["replacements"] == 0, row
    assert row["weights_bit_equal"], row
    return row


def rllib_ppo(device, smi: str, *, runners=8, envs=16, rollout=64,
              minibatch=2048, epochs=2, iters=2, learn_iters=20) -> dict:
    """BASELINE config #3's fleet (`rllib/bench.py`'s defaults:
    CartPole, 8 runners x 16 envs x 64 steps, minibatch 2,048, 2
    epochs, lr 3e-4, seed 0) with the learner on the card, a gang of 1:
    overlap, sync and compiled-DAG rounds; the first update held against
    the plain CPU learner; then the reference's learning criterion
    (tests/test_rllib.py:126-145) on the card."""
    from ray_tpu_torch.rllib import PPOConfig

    def config(overlap: bool, dag: bool):
        return (PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=runners,
                             num_envs_per_env_runner=envs,
                             rollout_fragment_length=rollout)
                .learners(num_learner_devices=1, device=device)
                .training(lr=3e-4, minibatch_size=minibatch,
                          num_epochs=epochs, sample_train_overlap=overlap,
                          use_compiled_dag=dag)
                .debugging(seed=0))

    out = {"phase": "rllib_ppo", "env": "CartPole-v1", "runners": runners,
           "envs_per_runner": envs, "rollout": rollout,
           "minibatch": minibatch, "epochs": epochs, "gang_devices": 1,
           "nvidia_smi": smi}
    rt.init(num_workers=runners + 2, num_cpus=max(16, 2 * runners))
    try:
        for mode, overlap, dag in (("overlap", True, False),
                                   ("sync", False, False),
                                   ("compiled_dag", True, True)):
            algo = config(overlap, dag).build()
            try:
                probe = LearnerProbe(algo.learner_group._local)
                out[mode] = rllib_run(algo, probe, smi, iters=iters,
                                      deadline=120.0)
                out[mode]["update_vs_cpu"] = update_vs_cpu(algo,
                                                           probe.first)
            finally:
                algo.stop()
        algo = (PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                             rollout_fragment_length=64)
                .learners(device=device)
                .training(lr=3e-4, minibatch_size=256, num_epochs=4)
                .debugging(seed=0).build())
        try:
            t0 = time.perf_counter()
            res = with_deadline(120.0, lambda: [
                algo.train() for _ in range(learn_iters)], "rllib learning")
            early = res[0]["episode_return_mean"]
            late = res[-1]["episode_return_mean"]
            out["learning"] = {"iters": learn_iters, "early": early,
                               "late": late, "wall_s":
                               time.perf_counter() - t0,
                               "gate": "late > max(40, early + 15)"}
            assert late > max(40.0, early + 15.0), out["learning"]
        finally:
            algo.stop()
    finally:
        rt.shutdown()
    return out


def rllib_ppo_pixels(device, smi: str, *, rows=84, cols=84, stack=4,
                     runners=4, envs=8, rollout=64, minibatch=512,
                     epochs=4, iters=3) -> dict:
    """The CNN learner at Atari's frame shape: `CatchPixelEnv` at 84 x
    84 through a picklable factory (built-in ids ignore `env_kwargs`), a
    `FrameStack(4)` connector factory ((84, 84, 4), as
    `wrap_atari_connectors` stacks; Catch renders 84 x 84 x 1 already,
    so no warp and no 1/255), `CNNModule` at its defaults (conv (16,4,2)
    (32,4,2) (64,3,2), hidden 256); 4 runners x 8 envs x 64 steps,
    minibatch 512, 4 epochs, sync, 1 + 3 iterations.  PyTorch's default
    TF32 for cuDNN is switched on around the phase: the learner's own
    scope must keep its convolutions f32 (the gate holds it)."""
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.rllib.connectors import FrameStack
    from ray_tpu_torch.rllib.core.rl_module import CNNModule
    from ray_tpu_torch.rllib.env.envs import CatchPixelEnv

    filters = ((16, 4, 2), (32, 4, 2), (64, 3, 2))
    out = {"phase": "rllib_ppo_pixels", "obs_shape": [rows, cols, stack],
           "runners": runners, "envs_per_runner": envs, "rollout": rollout,
           "minibatch": minibatch, "epochs": epochs, "conv_filters": filters,
           "hidden": [256], "nvidia_smi": smi,
           "tf32": "off inside the learner's update (its own scope); "
                   "cuDNN's TF32 on around it"}
    ambient = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    rt.init(num_workers=runners + 2, num_cpus=max(16, 2 * runners),
            object_store_memory=store_bytes(2 << 30))
    try:
        algo = (PPOConfig()
                .environment(functools.partial(CatchPixelEnv, rows=rows,
                                               cols=cols))
                .env_runners(num_env_runners=runners,
                             num_envs_per_env_runner=envs,
                             rollout_fragment_length=rollout,
                             env_to_module_connector=functools.partial(
                                 FrameStack, stack))
                .learners(device=device)
                .training(lr=3e-4, minibatch_size=minibatch,
                          num_epochs=epochs,
                          model={"conv_filters": filters, "hidden": (256,)})
                .debugging(seed=0).build())
        try:
            assert isinstance(algo.module, CNNModule)
            assert algo.module.observation_shape == (rows, cols, stack)
            probe = LearnerProbe(algo.learner_group._local)
            out["sync"] = rllib_run(algo, probe, smi, iters=iters,
                                    deadline=150.0)
            out["sync"]["update_vs_cpu"] = update_vs_cpu(algo, probe.first)
            assert torch.backends.cudnn.allow_tf32  # the scope restored it
        finally:
            algo.stop()
    finally:
        rt.shutdown()
        torch.backends.cudnn.allow_tf32 = ambient
    return out


def rllib_phases(device, smi: str) -> None:
    """rllib_ppo, then rllib_ppo_pixels; each boots the port's runtime
    and shuts it down."""
    t0 = time.perf_counter()
    emit({**rllib_ppo(device, smi), "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    emit({**rllib_ppo_pixels(device, smi),
          "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# rllib: the v-trace, replay and offline algorithms with the learner on
# the card
# ----------------------------------------------------------------------
class CudaTimer:
    """CUDA events around every call of one instance attribute (a
    target forward, `_td_targets`): the mean ms a call, and the calls,
    over the calls since `reset`."""

    def __init__(self, obj, name: str):
        fn = getattr(obj, name)
        self.reset()

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.pairs.append((start, end))
            return out

        setattr(obj, name, timed)

    def reset(self) -> None:
        self.pairs = []

    def read(self) -> dict:
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in self.pairs]
        return {"ms": statistics.fmean(ms) if ms else None,
                "calls": len(ms)}


class HostTimer:
    """The host clock around every call of an attribute (a module's
    function or an instance's method): seconds summed since `reset`."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.fn = obj, name, getattr(obj, name)
        self.reset()

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return self.fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0

        setattr(obj, name, timed)

    def reset(self) -> None:
        self.seconds = 0.0

    def restore(self) -> None:
        setattr(self.obj, self.name, self.fn)


def rllib_learner_line(algo, probe, smi: str) -> dict:
    """The learner's readings every new rllib phase prints: its device
    (a gang of 1 on the card), its split a minibatch and the weights'
    d2h ms (`LearnerProbe`), peak memory, and the first update on the
    card against the plain CPU learner (`update_vs_cpu`)."""
    group = algo.learner_group
    assert group.num_gang_devices == 1 and group.device.type == "cuda", (
        group.device)
    return {"learner_device": str(group.device), "learner": probe.split(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "update_vs_cpu": update_vs_cpu(algo, probe.first),
            "nvidia_smi": smi}


def vtrace_run(algo, probe, smi: str, *, iters: int, deadline: float,
               vtrace_timers) -> dict:
    """1 warm-up + `iters` timed iterations of APPO or IMPALA at the
    fleet shape, then one profiled iteration: env steps/s, updates/s
    (the learner's minibatches over the wall), exact accounting over the
    batches the iterations consumed (the ledger's unique keys against
    its batches, its env steps against the steps the results report),
    no replacement, the driver's v-trace seconds an iteration (numpy:
    the current weights' forward over the rollouts and `compute_vtrace`)
    and, after one blocking weights sync at the end of the round, the
    runners' weights bit-equal to the learner's (IMPALA broadcasts
    without waiting, so in-flight rollouts are stale by design)."""
    group = algo.env_runner_group

    def run():
        algo.train()  # warm-up: primes the card and, for IMPALA, the stream
        probe.reset()
        for t in vtrace_timers:
            t.reset()
        torch.cuda.reset_peak_memory_stats()
        led0 = group.ledger.snapshot()
        t0 = time.perf_counter()
        res = [algo.train() for _ in range(iters)]
        torch.cuda.synchronize()
        return res, led0, time.perf_counter() - t0

    results, led0, wall_s = with_deadline(deadline, run, "rllib iterations")
    vtrace_s = sum(t.seconds for t in vtrace_timers)
    led1 = group.ledger.snapshot()
    steps = sum(int(r["num_env_steps_sampled"]) for r in results)
    batches = led1["batches"] - led0["batches"]
    row = {
        "env_steps_per_s": steps / wall_s,
        "updates_per_s": len(probe.spans["fwd_bwd"]) / wall_s,
        "env_steps": steps, "wall_s": wall_s, "iters": iters,
        "accounting_exact": float(
            steps == int(led1["env_steps"] - led0["env_steps"])
            and batches == led1["unique"] - led0["unique"]),
        "batches_consumed": batches,
        "replacements": group.num_replacements,
        "vtrace_ms_per_iter": vtrace_s / iters * 1e3,
        "final_loss": results[-1]["total_loss"],
        **rllib_learner_line(algo, probe, smi),
    }
    if "num_async_batches" in results[-1]:
        row["num_async_batches"] = [r["num_async_batches"] for r in results]
    row.update(with_deadline(deadline, lambda: device_idle_share(algo),
                             "rllib profiled iteration"))
    group.sync_weights(algo.learner_group.get_weights_numpy())
    row["weights_bit_equal_after_sync"] = published_weights_equal(algo)
    assert row["accounting_exact"] == 1.0 and row["replacements"] == 0, row
    assert row["weights_bit_equal_after_sync"], row
    return row


def vtrace_learning(config, device, *, iters: int = 25) -> dict:
    """The reference's learning gate (tests/test_rllib.py: APPO
    `:485-504`, IMPALA `:538-563`) with the learner on the card: 2 x 8 x
    64, minibatch 256, 25 iterations, late > max(40, early + 15); IMPALA
    also delivers some iteration from the async pipeline."""
    algo = (config().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                         rollout_fragment_length=64)
            .learners(device=device)
            .training(lr=5e-4, minibatch_size=256)
            .debugging(seed=0).build())
    try:
        t0 = time.perf_counter()
        res = with_deadline(120.0, lambda: [algo.train()
                                            for _ in range(iters)],
                            "rllib learning")
        early = next(r["episode_return_mean"] for r in res
                     if "episode_return_mean" in r)
        late = res[-1]["episode_return_mean"]
        out = {"iters": iters, "early": early, "late": late,
               "wall_s": time.perf_counter() - t0,
               "gate": "late > max(40, early + 15)"}
        assert np.isfinite(res[-1]["total_loss"]), out
        assert late > max(40.0, early + 15.0), out
        if "num_async_batches" in res[-1]:
            out["max_async_batches"] = max(r.get("num_async_batches", 0)
                                           for r in res)
            assert out["max_async_batches"] >= 1, out
        return out
    finally:
        algo.stop()


def rllib_vtrace(device, smi: str, which: str, *, runners=8, envs=16,
                 rollout=64, iters=4, learn_iters=25) -> dict:
    """rllib_impala / rllib_appo: BASELINE config #3's fleet
    (`rllib/bench.py`'s: CartPole, 8 runners x 16 envs x 64 steps, seed
    0) with each algorithm's own defaults (lr 5e-4, minibatch 256;
    IMPALA's async pipeline with 4 batches a step at most, APPO's one
    epoch), the learner on the card in a gang of 1: 1 warm-up + `iters`
    + 1 profiled iteration (`vtrace_run`), then the learning gate."""
    from ray_tpu_torch.rllib import APPOConfig, IMPALAConfig
    from ray_tpu_torch.rllib.algorithms import appo

    config = {"impala": IMPALAConfig, "appo": APPOConfig}[which]
    out = {"phase": f"rllib_{which}", "env": "CartPole-v1",
           "runners": runners, "envs_per_runner": envs, "rollout": rollout,
           "minibatch": 256, "lr": 5e-4, "gang_devices": 1}
    rt.init(num_workers=runners + 2, num_cpus=max(16, 2 * runners))
    try:
        algo = (config().environment("CartPole-v1")
                .env_runners(num_env_runners=runners,
                             num_envs_per_env_runner=envs,
                             rollout_fragment_length=rollout)
                .learners(num_learner_devices=1, device=device)
                .debugging(seed=0).build())
        timers = []
        try:
            if which == "impala":
                out["max_batches_per_step"] = algo.config.max_batches_per_step
                timers = [HostTimer(algo, "_vtrace_batch")]
            else:
                out["epochs"] = algo.config.num_epochs
                timers = [HostTimer(algo, "_current_forward"),
                          HostTimer(appo, "compute_vtrace")]
            probe = LearnerProbe(algo.learner_group._local)
            out["fleet"] = vtrace_run(algo, probe, smi, iters=iters,
                                      deadline=120.0, vtrace_timers=timers)
        finally:
            for t in timers:
                t.restore()
            algo.stop()
        out["learning"] = vtrace_learning(config, device, iters=learn_iters)
    finally:
        rt.shutdown()
    return out


def replay_run(algo, smi: str, *, iters: int, target: str, deadline: float,
               stop=None) -> tuple:
    """`iters` iterations of DQN or SAC with the learner on the card
    (fewer when `stop(results)` says so): updates/s over the whole run,
    the learner's split, the no-grad target forward's ms a call (CUDA
    events around `target`) and `_td_targets`' (the `next_obs` upload,
    the forwards and the targets' download), exact accounting, the
    runners' weights bit-equal to the learner's, and the first update
    against the CPU learner.  Returns (line, results)."""
    group = algo.env_runner_group
    probe = LearnerProbe(algo.learner_group._local)
    fwd = CudaTimer(algo, target)
    tds = CudaTimer(algo, "_td_targets")
    torch.cuda.reset_peak_memory_stats()
    led0 = group.ledger.snapshot()

    def run():
        res = []
        t0 = time.perf_counter()
        for _ in range(iters):
            res.append(algo.train())
            if stop is not None and stop(res):
                break
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    results, wall_s = with_deadline(deadline, run, "rllib replay run")
    led1 = group.ledger.snapshot()
    steps = sum(int(r["num_env_steps_sampled"]) for r in results)
    updates = len(probe.spans["fwd_bwd"])
    line = {
        "iters": len(results), "updates": updates, "wall_s": wall_s,
        "updates_per_s": updates / wall_s, "env_steps": steps,
        "target_forward": fwd.read(), "td_targets": tds.read(),
        "accounting_exact": float(
            steps == int(led1["env_steps"] - led0["env_steps"])),
        "replacements": group.num_replacements,
        "weights_bit_equal": published_weights_equal(algo),
        **rllib_learner_line(algo, probe, smi),
    }
    assert line["accounting_exact"] == 1.0 and line["replacements"] == 0, \
        line
    assert line["weights_bit_equal"], line
    return line, results


def rllib_replay(device, smi: str, *, dqn_iters=30, sac_iters=20,
                 cont_iters=30) -> dict:
    """DQN, discrete SAC and continuous SAC at the shapes of the
    reference's tests (BASELINE has no fleet config for them), the
    learner on the card, each with its learning gate: DQN
    (tests/test_rllib.py:435-455: 1 x 8 x 32, lr 1e-3, learn batch 64,
    32 updates an iteration, epsilon over 15 iterations, 30 iterations,
    late > max(35, early + 10)); discrete SAC (`:719-745`: 1 x 8 x 64,
    lr 3e-3, 20 iterations, late > max(40, early + 15), alpha > 0);
    continuous SAC on `ContinuousTargetEnv` (`:1347-1376`: 1 x 16 x 8,
    lr 3e-3, 64 updates an iteration, up to 30 iterations, best >
    -0.15, alpha < 0.9)."""
    from ray_tpu_torch.rllib import DQNConfig, SACConfig
    from ray_tpu_torch.rllib.env.envs import ContinuousTargetEnv

    out = {"phase": "rllib_replay", "gang_devices": 1}
    rt.init(num_workers=4, num_cpus=16)
    try:
        algo = (DQNConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                             rollout_fragment_length=32)
                .learners(num_learner_devices=1, device=device)
                .training(lr=1e-3, learn_batch_size=64,
                          num_updates_per_iter=32, epsilon_decay_iters=15)
                .debugging(seed=0).build())
        try:
            line, res = replay_run(algo, smi, iters=dqn_iters,
                                   target="_target_q", deadline=150.0)
            early = res[2].get("episode_return_mean", 15.0)
            late = res[-1]["episode_return_mean"]
            line["learning"] = {"early": early, "late": late,
                                "gate": "late > max(35, early + 10)"}
            assert np.isfinite(res[-1]["td_error_mean"]), line
            assert late > max(35.0, early + 10.0), line
            out["dqn"] = line
        finally:
            algo.stop()

        algo = (SACConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                             rollout_fragment_length=64)
                .learners(num_learner_devices=1, device=device)
                .training(lr=3e-3).debugging(seed=0).build())
        try:
            line, res = replay_run(algo, smi, iters=sac_iters,
                                   target="_target_terms", deadline=150.0)
            early = next(r["episode_return_mean"] for r in res
                         if "episode_return_mean" in r)
            late = res[-1]["episode_return_mean"]
            line["learning"] = {"early": early, "late": late,
                                "alpha": res[-1]["alpha"],
                                "gate": "late > max(40, early + 15), "
                                        "alpha > 0"}
            assert np.isfinite(res[-1]["critic_loss"]), line
            assert res[-1]["alpha"] > 0, line
            assert late > max(40.0, early + 15.0), line
            out["sac_discrete"] = line
        finally:
            algo.stop()

        # the package's class: a factory of this script would make every
        # runner import the script
        cfg = (SACConfig().environment(ContinuousTargetEnv)
               .env_runners(num_env_runners=1, num_envs_per_env_runner=16,
                            rollout_fragment_length=8)
               .learners(num_learner_devices=1, device=device)
               .debugging(seed=0))
        cfg.lr = 3e-3
        cfg.num_updates_per_iter = 64
        algo = cfg.build()
        try:
            def best(res):
                rets = [r["episode_return_mean"] for r in res
                        if np.isfinite(r.get("episode_return_mean", np.nan))]
                return max(rets, default=-10.0)

            line, res = replay_run(algo, smi, iters=cont_iters,
                                   target="_target_terms", deadline=180.0,
                                   stop=lambda res: best(res) > -0.05)
            line["learning"] = {"best": best(res), "alpha": res[-1]["alpha"],
                                "gate": "best > -0.15, alpha < 0.9"}
            assert best(res) > -0.15, line
            assert res[-1]["alpha"] < 0.9, line
            out["sac_continuous"] = line
        finally:
            algo.stop()
    finally:
        rt.shutdown()
    return out


def cartpole_heuristic_dataset(n_episodes: int = 60, seed: int = 0) -> dict:
    """The reference's offline CartPole log (tests/test_rllib.py:743-775):
    a scripted policy (pole angle + 0.5 angular velocity) with 20%
    random actions, from a seed, in the port's CartPole."""
    from ray_tpu_torch.rllib.env.envs import make_vector_env

    env = make_vector_env("CartPole-v1", 1, seed=seed)
    rng = np.random.default_rng(seed)
    data = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                            "terminated")}
    for _ep in range(n_episodes):
        obs = env.reset()
        for _t in range(500):
            if rng.random() < 0.2:
                a = rng.integers(0, 2)
            else:
                a = 1 if (obs[0][2] + 0.5 * obs[0][3]) > 0 else 0
            nobs, r, term, trunc, _ = env.step(np.array([a], np.int32))
            data["obs"].append(obs[0])
            data["actions"].append(a)
            data["rewards"].append(float(r[0]))
            data["next_obs"].append(nobs[0])
            data["terminated"].append(bool(term[0]))
            obs = nobs
            if bool(term[0] or trunc[0]):
                break
    return {"obs": np.asarray(data["obs"], np.float32),
            "actions": np.asarray(data["actions"], np.int32),
            "rewards": np.asarray(data["rewards"], np.float32),
            "next_obs": np.asarray(data["next_obs"], np.float32),
            "terminated": np.asarray(data["terminated"], np.bool_)}


def offline_run(algo, smi: str, *, iters: int, deadline: float,
                target: str = None) -> tuple:
    """`iters` iterations of an offline algorithm with the learner on
    the card: updates/s, the learner's split, the first update against
    the CPU learner (and CQL's target forward ms).  Returns (line,
    results)."""
    probe = LearnerProbe(algo.learner_group._local)
    fwd = CudaTimer(algo, target) if target else None
    torch.cuda.reset_peak_memory_stats()

    def run():
        t0 = time.perf_counter()
        res = [algo.train() for _ in range(iters)]
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    results, wall_s = with_deadline(deadline, run, "rllib offline run")
    updates = len(probe.spans["fwd_bwd"])
    line = {"iters": iters, "updates": updates, "wall_s": wall_s,
            "updates_per_s": updates / wall_s,
            **rllib_learner_line(algo, probe, smi)}
    if fwd is not None:
        line["target_forward"] = fwd.read()
    return line, results


def rllib_offline(device, smi: str, *, bc_iters=5, marwil_iters=4,
                  cql_iters=12) -> dict:
    """BC, MARWIL and CQL from datasets made in the phase from seeds, as
    the reference's tests make them, the learner on the card: BC
    (tests/test_rllib.py:507-535: 4,096 expert rows, minibatch 256, 64
    updates an iteration, action accuracy > 0.95 in 5 iterations);
    MARWIL (`:846-888`: 2,048 rows, half relabelled against the expert
    with reward 0, beta 2, lr 2e-3, 4 iterations: agreement with the
    expert > 0.8, the high-advantage actions up-weighted); CQL
    (`:778-806`: the scripted CartPole log through an .npz, 12
    iterations of 64 updates of 256, evaluation over 3 greedy episodes
    an iteration: the conservatism gap falls, evaluation > 60)."""
    from ray_tpu_torch.rllib import BCConfig, CQLConfig, MARWILConfig

    out = {"phase": "rllib_offline", "gang_devices": 1}
    rt.init(num_workers=2, num_cpus=4)
    try:
        rng = np.random.default_rng(0)
        obs = rng.uniform(-0.2, 0.2, size=(4096, 4)).astype(np.float32)
        actions = ((obs[:, 2] + 0.5 * obs[:, 3]) > 0).astype(np.int32)
        algo = (BCConfig().environment("CartPole-v1")
                .offline_data(input_={"obs": obs, "actions": actions})
                .learners(num_learner_devices=1, device=device)
                .training(lr=1e-3, minibatch_size=256,
                          num_updates_per_iter=64)
                .debugging(seed=0).build())
        try:
            line, res = offline_run(algo, smi, iters=bc_iters,
                                    deadline=120.0)
            line["learning"] = {"action_accuracy":
                                res[-1]["action_accuracy"],
                                "gate": "action_accuracy > 0.95"}
            assert res[-1]["action_accuracy"] > 0.95, line
            out["bc"] = line
        finally:
            algo.stop()

        rng = np.random.default_rng(1)
        n = 2048
        obs = rng.uniform(-0.2, 0.2, size=(n, 4)).astype(np.float32)
        expert = ((obs[:, 2] + 0.5 * obs[:, 3]) > 0).astype(np.int32)
        flip = rng.random(n) < 0.5
        algo = (MARWILConfig().environment("CartPole-v1")
                .offline_data(input_={
                    "obs": obs, "actions": np.where(flip, 1 - expert, expert),
                    "rewards": np.where(flip, 0.0, 1.0).astype(np.float32),
                    "dones": np.ones(n, bool)})
                .learners(num_learner_devices=1, device=device)
                .training(beta=2.0, lr=2e-3, minibatch_size=256,
                          num_updates_per_iter=64)
                .debugging(seed=0).build())
        try:
            line, res = offline_run(algo, smi, iters=marwil_iters,
                                    deadline=120.0)
            logits, _ = algo.module.forward_numpy(
                algo.learner_group.get_weights_numpy(), obs)
            agree = float((logits.argmax(axis=-1) == expert).mean())
            line["learning"] = {"expert_agreement": agree,
                                "mean_weight": res[-1]["mean_weight"],
                                "gate": "expert_agreement > 0.8"}
            assert agree > 0.8, line
            out["marwil"] = line
        finally:
            algo.stop()

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "cartpole_offline.npz")
            np.savez(path, **cartpole_heuristic_dataset())
            cfg = CQLConfig()
            cfg.offline_data(input_=path)
            cfg.evaluation(evaluation_env="CartPole-v1",
                           evaluation_episodes=3)
            cfg.training(lr=1e-3, cql_alpha=1.0)
            cfg.learners(num_learner_devices=1, device=device)
            cfg.debugging(seed=0)
            algo = cfg.build()
            try:
                line, res = offline_run(algo, smi, iters=cql_iters,
                                        deadline=150.0, target="_q")
                line["learning"] = {
                    "cql_gap_first": res[0]["cql_gap"],
                    "cql_gap_last": res[-1]["cql_gap"],
                    "evaluation_return_mean":
                        res[-1]["evaluation_return_mean"],
                    "gate": "cql_gap falls, evaluation > 60"}
                assert np.isfinite(res[-1]["td_loss"]), line
                assert res[-1]["cql_gap"] < res[0]["cql_gap"], line
                assert res[-1]["evaluation_return_mean"] > 60.0, line
                out["cql"] = line
            finally:
                algo.stop()
    finally:
        rt.shutdown()
    return out


def rllib_algo_phases(device, smi: str) -> None:
    """rllib_impala, rllib_appo, rllib_replay and rllib_offline; each
    boots the port's runtime and shuts it down."""
    for phase in (functools.partial(rllib_vtrace, which="impala"),
                  functools.partial(rllib_vtrace, which="appo"),
                  rllib_replay, rllib_offline):
        t0 = time.perf_counter()
        emit({**phase(device, smi), "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# rllib: multi-agent PPO and DreamerV3 with the learners on the card;
# the examples
# ----------------------------------------------------------------------
def _pol_ab(agent_id: str) -> str:
    return "pol_a" if agent_id == "agent_0" else "pol_b"


class RolloutCheck:
    """Holds multi-agent PPO's runners to the learners' weights at every
    iteration: each batch the training step hands to the GAE
    (`multi_agent_gae`, wrapped) is recomputed row by row with the numpy
    forward the runners run, from the weights the learners published at
    the last sync; its `logp` and `values` must equal one module's bit
    for bit.  `seconds` is the checks' own time, left out of the
    rates."""

    def __init__(self, algo):
        from ray_tpu_torch.rllib.algorithms import multi_agent_ppo as mappo

        self.algo, self.mappo, self.gae = algo, mappo, mappo.multi_agent_gae
        self.weights = algo._weights()  # what setup synced
        self.matched = []
        self.seconds = 0.0
        sync = algo._sync_weights

        def synced():
            sync()
            self.weights = algo._weights()

        def checked(batch, gamma, lambda_):
            t0 = time.perf_counter()
            hits = [mid for mid, params in self.weights.items()
                    if self._same(mid, params, batch)]
            assert len(hits) == 1, hits
            self.matched.append(hits[0])
            self.seconds += time.perf_counter() - t0
            return self.gae(batch, gamma, lambda_)

        algo._sync_weights = synced
        mappo.multi_agent_gae = checked

    def _same(self, mid, params, batch) -> bool:
        module = self.algo.modules[mid]
        for o, a, lp, v in zip(batch["obs"], batch["actions"],
                               batch["logp"], batch["values"]):
            logits, value = module.forward_numpy(params, o[None])
            z = logits[0] - logits[0].max()
            probs = np.exp(z) / np.exp(z).sum()
            if (np.float32(np.log(probs[a] + 1e-10)) != lp
                    or np.float32(value[0]) != v):
                return False
        return True

    def restore(self) -> None:
        self.mappo.multi_agent_gae = self.gae


def rllib_multi_agent(device, smi: str, *, iters=15) -> dict:
    """Multi-agent PPO at the reference test's configuration
    (tests/test_rllib.py:675-695: the coordination game of 10 rounds, 2
    runners x 200 steps, lr 3e-3, minibatch 128, 4 epochs, modules
    `pol_a` / `pol_b`, the default 64-64 MLP), both learners on the
    card: agent steps/s, each module's updates/s and learner split over
    iterations 2-15, peak memory, the idle share over one more
    profiled iteration.  Held: each module's first update against the
    plain CPU learner (`RLLIB_TOL`); at every iteration the runners'
    rollouts recomputed from each learner's published weights, bit for
    bit (`RolloutCheck`); the reference's gate (late > 7.0, both
    modules' metrics).  Then its shared-policy case (`:698-712`, 1
    runner x 100 steps: 2 x 100 agent steps on one "shared" module)."""
    from ray_tpu_torch.rllib import MultiAgentPPOConfig

    out = {"phase": "rllib_multi_agent", "env": "coordination",
           "episode_len": 10, "runners": 2, "rollout": 200, "lr": 3e-3,
           "minibatch": 128, "epochs": 4, "policies": ["pol_a", "pol_b"],
           "hidden": [64, 64], "nvidia_smi": smi}
    rt.init(num_workers=4, num_cpus=16)
    try:
        cfg = MultiAgentPPOConfig()
        cfg.environment("coordination", env_config={"episode_len": 10})
        cfg.env_runners(num_env_runners=2, rollout_fragment_length=200)
        cfg.training(lr=3e-3, minibatch_size=128, num_epochs=4)
        cfg.multi_agent(policies=["pol_a", "pol_b"],
                        policy_mapping_fn=_pol_ab)
        cfg.learners(device=device)
        algo = cfg.build()
        check = None
        try:
            learners = {mid: lg._local for mid, lg in algo.learners.items()}
            assert all(lg.device.type == "cuda"
                       for lg in algo.learners.values()), out
            probes = {mid: LearnerProbe(lr) for mid, lr in learners.items()}
            check = RolloutCheck(algo)
            torch.cuda.reset_peak_memory_stats()

            def run():
                res = [algo.train()]  # primes the card; the first updates
                for p in probes.values():
                    p.reset()
                check_s = check.seconds
                t0 = time.perf_counter()
                res += [algo.train() for _ in range(iters - 1)]
                torch.cuda.synchronize()
                return res, time.perf_counter() - t0 - (check.seconds
                                                        - check_s)

            results, wall_s = with_deadline(180.0, run, "multi-agent PPO")
            steps = sum(int(r["num_env_steps_sampled"]) for r in results[1:])
            line = {"iters": iters, "timed_iters": iters - 1,
                    "wall_s": wall_s, "agent_steps_per_s": steps / wall_s,
                    "agent_steps": steps,
                    "rollout_check_s": check.seconds,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            for mid, probe in probes.items():
                line[mid] = {
                    "updates_per_s": len(probe.spans["fwd_bwd"]) / wall_s,
                    "learner": probe.split(),
                    "update_vs_cpu": update_vs_cpu(
                        algo, probe.first, learner=learners[mid])}
            # every iteration: one batch a runner a module, each matched
            assert (sorted(check.matched)
                    == sorted(["pol_a", "pol_b"] * 2 * iters)), check.matched
            line["rollouts_bit_equal_to_published_weights"] = len(
                check.matched)
            early = results[0].get("episode_return_mean")
            late = results[-1]["episode_return_mean"]
            line["learning"] = {"early": early, "late": late,
                                "gate": "late > 7.0, pol_a/ and pol_b/ "
                                        "metrics"}
            assert late > 7.0, line
            assert any(k.startswith("pol_a/") for k in results[-1]), line
            assert any(k.startswith("pol_b/") for k in results[-1]), line
            line.update(with_deadline(60.0, lambda: device_idle_share(algo),
                                      "multi-agent profiled iteration"))
            out["coordination"] = line
        finally:
            if check is not None:
                check.restore()
            algo.stop()

        cfg = MultiAgentPPOConfig()
        cfg.environment("coordination")
        cfg.env_runners(num_env_runners=1, rollout_fragment_length=100)
        cfg.training(minibatch_size=64, num_epochs=2)
        cfg.learners(device=device)
        algo = cfg.build()
        try:
            r = with_deadline(60.0, algo.train, "shared-policy iteration")
            out["shared"] = {
                "num_env_steps_sampled": r["num_env_steps_sampled"],
                "modules": list(algo.learners),
                "learner_device": str(algo.learners["shared"].device),
                "gate": "num_env_steps_sampled == 2 x 100, shared/ metrics"}
            assert r["num_env_steps_sampled"] == 2 * 100, out["shared"]
            assert any(k.startswith("shared/") for k in r), out["shared"]
        finally:
            algo.stop()
    finally:
        rt.shutdown()
    return out


class _NoRunners:
    """A Dreamer twin's runner group: nothing to sync or restore."""

    def sync_weights(self, weights) -> None:
        pass

    def restore_connector_state(self, state) -> None:
        pass

    def connector_state(self):
        return None


def dreamer_twin(algo, device):
    """`algo`'s model, config, optimizers (copies) and state with the
    learner on `device` and no runners."""
    from ray_tpu_torch.rllib.algorithms.dreamer import Dreamer

    twin = Dreamer.__new__(Dreamer)
    twin.config, twin.model = algo.config, algo.model
    twin.device = torch.device(device)
    twin.env_runner_group = _NoRunners()
    twin.wm_opt, twin.actor_opt, twin.critic_opt = (
        copy.copy(o) for o in (algo.wm_opt, algo.actor_opt, algo.critic_opt))
    twin._gen = torch.Generator(device=twin.device)
    twin.iteration = 0
    twin._ret_std = algo._ret_std
    twin.set_state(algo.get_state())
    return twin


def _record_grads(opt) -> list:
    """The gradients (as numpy) each call of `opt.update` receives."""
    seen = []
    update = opt.update

    def recording(grads, state, params):
        seen.append([g.detach().cpu().numpy().copy() for g in grads])
        return update(grads, state, params)

    opt.update = recording
    return seen


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def _grad_rel(got: list, want: list) -> float:
    g = np.concatenate([x.ravel() for x in got]).astype(np.float64)
    w = np.concatenate([x.ravel() for x in want]).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _stepped_vs_cpu(got_tree, want_tree, cpu_grads, lr: float) -> dict:
    """Params after one Adam step, card against CPU: `RLLIB_TOL` where
    the CPU gradient is 0 or above `RLLIB_NOISE` of its leaf's largest,
    within `noisy_atol_lr` lr elsewhere.  Relative to the leaf, not
    absolute as `update_vs_cpu`'s: the actor's whole gradient is ~1e-7
    (its advantages are small), and Adam's first step is ~lr x sign(g)
    there too, so only a gradient at the leaf's rounding level can turn
    its step around."""
    from ray_tpu_torch.models.bridge import tree_leaves

    held = noisy = 0
    worst = 0.0
    for got, want, g in zip(tree_leaves(got_tree), tree_leaves(want_tree),
                            cpu_grads):
        a = np.abs(g)
        mask = (a > RLLIB_NOISE * a.max()) | (g == 0)
        np.testing.assert_allclose(got[mask], want[mask],
                                   rtol=RLLIB_TOL["rtol"],
                                   atol=RLLIB_TOL["atol"])
        np.testing.assert_allclose(got[~mask], want[~mask], rtol=0,
                                   atol=RLLIB_TOL["noisy_atol_lr"] * lr)
        held += int(mask.sum())
        noisy += int((~mask).sum())
        worst = max(worst, float(np.abs(got - want).max()))
    return {"params_held_strictly": held, "params_noisy_grad": noisy,
            "params_max_abs_err": worst}


def _moments_vs_cpu(got: dict, want: dict) -> float:
    from ray_tpu_torch.models.bridge import tree_leaves

    assert int(got["count"]) == int(want["count"])
    worst = 0.0
    for part in ("mu", "nu"):
        for g, w in zip(tree_leaves(got[part]), tree_leaves(want[part])):
            np.testing.assert_allclose(g, w, rtol=RLLIB_TOL["rtol"],
                                       atol=RLLIB_TOL["atol"])
            worst = max(worst, float(np.abs(g - w).max()))
    return worst


def dreamer_updates_vs_cpu(algo, seed: int = 0) -> dict:
    """One `_wm_update` and one `_ac_update` on the card against the
    CPU, each pair from one state (`dreamer_twin`s of `algo`), on a
    batch of `algo`'s replay and the same Gumbel noise (drawn on the
    CPU, copied to the card): the losses 1e-5 relative, each gradient
    1e-5 by the relative norm of the difference, the stepped params,
    the target critic and Adam's moments at `RLLIB_TOL`, `ret_std`
    1e-5 relative.  The actor-critic pair starts from the CPU's stepped
    world model and posterior states on both sides."""
    from ray_tpu_torch.rllib.algorithms.dreamer import gumbel

    cfg, dev = algo.config, algo.device
    card, cpu = dreamer_twin(algo, dev), dreamer_twin(algo, "cpu")
    grads = {name: (_record_grads(getattr(card, name)),
                    _record_grads(getattr(cpu, name)))
             for name in ("wm_opt", "actor_opt", "critic_opt")}
    batch = algo._sample_segments()
    L, B = batch["prev_actions"].shape
    G, C = cfg.stoch_groups, cfg.stoch_classes
    gen = torch.Generator().manual_seed(seed)
    post = gumbel((L, B, G, C), gen, "cpu")
    m_card, h_card, z_card = card._wm_update(batch, post.to(dev))
    m_cpu, h_cpu, z_cpu = cpu._wm_update(batch, post)
    s_card, s_cpu = card.get_state(), cpu.get_state()
    wm = {"loss_rel": {k: _rel(float(m_card[k]), float(m_cpu[k]))
                       for k in m_cpu},
          "grad_rel_norm": _grad_rel(grads["wm_opt"][0][0],
                                     grads["wm_opt"][1][0]),
          "start_h_max_abs_err": float((h_card.cpu() - h_cpu).abs().max()),
          **_stepped_vs_cpu(s_card["wm"], s_cpu["wm"],
                            grads["wm_opt"][1][0], cfg.lr),
          "moments_max_abs_err": _moments_vs_cpu(s_card["wm_opt"],
                                                 s_cpu["wm_opt"])}
    np.testing.assert_allclose(h_card.cpu().numpy(), h_cpu.numpy(),
                               rtol=RLLIB_TOL["rtol"],
                               atol=RLLIB_TOL["atol"])
    assert wm["loss_rel"]["wm_loss"] <= RLLIB_TOL["loss"], wm
    assert wm["grad_rel_norm"] <= RLLIB_TOL["grad_rel"], wm

    card.set_state(s_cpu)
    N = L * B
    noise = (gumbel((cfg.horizon, N, algo.model.num_actions), gen, "cpu"),
             gumbel((cfg.horizon, N, G, C), gen, "cpu"))
    ac_card, std_card = card._ac_update(
        h_cpu.to(dev), z_cpu.to(dev), algo._ret_std,
        tuple(n.to(dev) for n in noise))
    ac_cpu, std_cpu = cpu._ac_update(h_cpu, z_cpu, algo._ret_std, noise)
    s_card, s_cpu = card.get_state(), cpu.get_state()
    ac = {"loss_rel": {k: _rel(float(ac_card[k]), float(ac_cpu[k]))
                       for k in ac_cpu},
          "ret_std_rel": _rel(float(std_card), float(std_cpu)),
          "ret_scale": algo._ret_std}
    for part, lr in (("actor", cfg.actor_lr), ("critic", cfg.critic_lr)):
        g_card, g_cpu = grads[f"{part}_opt"][0][0], grads[f"{part}_opt"][1][0]
        ac[part] = {"grad_rel_norm": _grad_rel(g_card, g_cpu),
                    **_stepped_vs_cpu(s_card[part], s_cpu[part], g_cpu, lr),
                    "moments_max_abs_err": _moments_vs_cpu(
                        s_card[f"{part}_opt"], s_cpu[f"{part}_opt"])}
        assert ac[part]["grad_rel_norm"] <= RLLIB_TOL["grad_rel"], ac
    from ray_tpu_torch.models.bridge import tree_leaves

    for got, want in zip(tree_leaves(s_card["target_critic"]),
                         tree_leaves(s_cpu["target_critic"])):
        np.testing.assert_allclose(got, want, rtol=RLLIB_TOL["rtol"],
                                   atol=RLLIB_TOL["atol"])
    for k in ("actor_loss", "critic_loss"):
        assert ac["loss_rel"][k] <= RLLIB_TOL["loss"], ac
    assert ac["ret_std_rel"] <= RLLIB_TOL["loss"], ac
    return {"wm_update": wm, "ac_update": ac, "tolerance": RLLIB_TOL,
            "batch": [L, B], "imagined_starts": N}


def dreamer_sync_cost(algo, n: int = 8) -> dict:
    """What the updates' host reads cost: `n` update pairs on a card
    twin as `training_step` runs them (the return scale and the metrics
    read back as floats after every pair) against the same pairs read
    back once at the end; ms a pair each way."""
    twin = dreamer_twin(algo, algo.device)
    batches = [algo._sample_segments() for _ in range(n)]

    def pairs(read_each: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kept = []
        for b in batches:
            m, h, z = twin._wm_update(b)
            ac, std = twin._ac_update(h, z, 1.0)
            if read_each:
                float(std)
                [float(v) for v in (*m.values(), *ac.values())]
            else:
                kept.append((m, ac, std))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    pairs(True)  # warm-up
    each, once = pairs(True), pairs(False)
    return {"pair_ms_reads_each": each, "pair_ms_reads_once": once,
            "sync_cost_ms_per_pair": each - once, "pairs": n}


def dreamer_run(algo, smi: str, *, iters: int, deadline: float) -> tuple:
    """1 warm-up + `iters` iterations of a built Dreamer on the card:
    each update's device ms (CUDA events around `_wm_update` and
    `_ac_update`) and host ms (the launches), updates/s over the wall,
    the replay's rows, the policy weights' device-to-host ms an
    iteration (`_policy_weights`), peak memory.  Returns (line, the
    iterations' results)."""
    assert algo.device.type == "cuda", algo.device
    wm_t, ac_t = CudaTimer(algo, "_wm_update"), CudaTimer(algo, "_ac_update")
    hosts = {name: HostTimer(algo, name) for name in (
        "_wm_update", "_ac_update", "_sample_segments", "_policy_weights")}

    def run():
        res = [algo.train()]  # warm-up: primes the card and the replay
        for t in (wm_t, ac_t, *hosts.values()):
            t.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res += [algo.train() for _ in range(iters)]
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    try:
        results, wall_s = with_deadline(deadline, run, "dreamer iterations")
    finally:
        for t in hosts.values():
            t.restore()
    updates = iters * algo.config.num_updates_per_iter
    line = {"iters": iters, "updates": updates, "wall_s": wall_s,
            "updates_per_s": updates / wall_s,
            "wm_update": wm_t.read(), "ac_update": ac_t.read(),
            "wm_update_host_ms": hosts["_wm_update"].seconds / updates * 1e3,
            "ac_update_host_ms": hosts["_ac_update"].seconds / updates * 1e3,
            "sample_segments_ms":
                hosts["_sample_segments"].seconds / updates * 1e3,
            "policy_weights_d2h_ms":
                hosts["_policy_weights"].seconds / iters * 1e3,
            "replay_rows": results[-1]["replay_rows"],
            "final": {k: results[-1][k] for k in (
                "wm_loss", "recon_loss", "kl_loss", "actor_loss",
                "critic_loss", "imagined_return_mean")},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "learner_device": str(algo.device), "nvidia_smi": smi}
    return line, results


def rllib_dreamer(device, smi: str, *, iters=3) -> dict:
    """DreamerV3 on CartPole with the learner on the card.  First at
    `DreamerConfig()`'s own widths (deter 128, 8 x 8 categoricals, embed
    and head 128, segments 16 x 16, horizon 15, 8 updates an iteration;
    1 runner x 4 envs x 32 steps): one `_wm_update` and one `_ac_update`
    against the CPU (`dreamer_updates_vs_cpu`), then 1 + `iters`
    iterations (`dreamer_run`), the host reads' cost, the idle share
    over one more profiled iteration.  Then the reference test's
    configuration (tests/test_rllib.py:1114-1139: deter 64, 4 x 4,
    widths 64, 2 updates of 8 segments) with its gate: 3 iterations,
    every metric finite, replay_rows >= 384, wm_loss falling."""
    from ray_tpu_torch.rllib.algorithms.dreamer import DreamerConfig

    def config():
        cfg = DreamerConfig()
        cfg.environment("CartPole-v1")
        cfg.env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                        rollout_fragment_length=32)
        cfg.debugging(seed=0)
        cfg.learners(device=device)
        return cfg

    out = {"phase": "rllib_dreamer", "env": "CartPole-v1", "runners": 1,
           "envs_per_runner": 4, "rollout": 32, "nvidia_smi": smi}
    rt.init(num_workers=3, num_cpus=8)
    try:
        algo = config().build()
        try:
            c = algo.config
            out["defaults"] = {"deter": c.deter_size,
                               "stoch": [c.stoch_groups, c.stoch_classes],
                               "embed": list(c.embed_hidden),
                               "head": list(c.head_hidden),
                               "segments": [c.batch_segments, c.batch_length],
                               "horizon": c.horizon,
                               "updates_per_iter": c.num_updates_per_iter}
            line, _ = dreamer_run(algo, smi, iters=iters, deadline=180.0)
            line["update_vs_cpu"] = dreamer_updates_vs_cpu(algo)
            line["host_reads"] = dreamer_sync_cost(algo)
            line.update(with_deadline(60.0, lambda: device_idle_share(algo),
                                      "dreamer profiled iteration"))
            out["default_widths"] = line
        finally:
            algo.stop()

        cfg = config()
        cfg.deter_size, cfg.stoch_groups, cfg.stoch_classes = 64, 4, 4
        cfg.embed_hidden = cfg.head_hidden = (64,)
        cfg.num_updates_per_iter = 2
        cfg.batch_segments = 8
        algo = cfg.build()
        try:
            results = with_deadline(60.0, lambda: [algo.train()
                                                   for _ in range(3)],
                                    "dreamer reference case")
            last = results[-1]
            gate = {k: last[k] for k in ("wm_loss", "actor_loss",
                                         "critic_loss",
                                         "imagined_return_mean",
                                         "replay_rows")}
            gate.update(first_wm_loss=results[0]["wm_loss"],
                        gate="metrics finite, replay_rows >= 384, "
                             "wm_loss falls")
            out["reference_case"] = gate
            for k in ("wm_loss", "actor_loss", "critic_loss",
                      "imagined_return_mean"):
                assert np.isfinite(last[k]), gate
            assert last["replay_rows"] >= 3 * 4 * 32, gate
            assert last["wm_loss"] < results[0]["wm_loss"], gate
        finally:
            algo.stop()
    finally:
        rt.shutdown()
    return out


def rllib_dreamer_pixels(device, smi: str, *, iters=2, rows=84,
                         cols=84) -> dict:
    """DreamerV3 in pixel mode with the learner on the card.  First the
    reference's pixel case (tests/test_rllib.py:1402-1430: Catch at 10 x
    5, 1 runner x 16 envs x 16 steps, filters ((8, 3, 2), (16, 3, 2)),
    deter 64, lr 1e-3, segments 16 x 9, 16 updates an iteration) with
    its gates over 20 iterations: recon_loss below 0.95 of the first
    iteration's and below 1.9, best return above -0.55.  Then
    `DreamerConfig()`'s default filters ((16, 4, 2), (32, 4, 2)) and
    widths on `CatchPixelEnv` at 84 x 84 (1 runner x 8 envs x 32 steps)
    for 1 + `iters` iterations: the updates' ms, the decoder's output
    shape against the frame, and `decode` on the card against the CPU
    (`RLLIB_TOL`) on the same params and features."""
    from ray_tpu_torch.models.bridge import params_from_numpy
    from ray_tpu_torch.rllib.algorithms.dreamer import DreamerConfig
    from ray_tpu_torch.rllib.core.learner import _full_f32
    from ray_tpu_torch.rllib.env.envs import CatchPixelEnv

    out = {"phase": "rllib_dreamer_pixels", "nvidia_smi": smi}
    rt.init(num_workers=3, num_cpus=8)
    try:
        cfg = DreamerConfig()
        cfg.environment("Catch-v0")
        cfg.env_runners(num_env_runners=1, num_envs_per_env_runner=16,
                        rollout_fragment_length=16)
        cfg.debugging(seed=0)
        cfg.learners(device=device)
        cfg.conv_filters = ((8, 3, 2), (16, 3, 2))
        cfg.deter_size = 64
        cfg.lr = 1e-3
        cfg.batch_length = 9
        cfg.batch_segments = 16
        cfg.num_updates_per_iter = 16
        algo = cfg.build()
        try:
            assert algo.model.pixel and algo.device.type == "cuda"
            wm_t = CudaTimer(algo, "_wm_update")
            ac_t = CudaTimer(algo, "_ac_update")
            torch.cuda.reset_peak_memory_stats()

            def run():
                t0 = time.perf_counter()
                res = [algo.train() for _ in range(20)]
                torch.cuda.synchronize()
                return res, time.perf_counter() - t0

            results, wall_s = with_deadline(180.0, run, "dreamer pixels")
            first, r = results[0], results[-1]
            best = max((x["episode_return_mean"] for x in results[1:]
                        if np.isfinite(x.get("episode_return_mean",
                                             np.nan))), default=-1.0)
            line = {"env": "Catch-v0", "obs_shape": [10, 5, 1],
                    "conv_filters": cfg.conv_filters, "iters": 20,
                    "wall_s": wall_s, "updates_per_s": 20 * 16 / wall_s,
                    "wm_update": wm_t.read(), "ac_update": ac_t.read(),
                    "first_recon_loss": first["recon_loss"],
                    "recon_loss": r["recon_loss"], "best_return": best,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "gate": "recon_loss < 0.95 first and < 1.9, best > "
                            "-0.55"}
            line.update(with_deadline(60.0, lambda: device_idle_share(algo),
                                      "dreamer pixels profiled iteration"))
            out["reference_case"] = line
            assert r["recon_loss"] < first["recon_loss"] * 0.95, line
            assert r["recon_loss"] < 1.9, line
            assert best > -0.55, line
        finally:
            algo.stop()

        cfg = DreamerConfig()
        cfg.environment(functools.partial(CatchPixelEnv, rows=rows,
                                          cols=cols))
        cfg.env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                        rollout_fragment_length=32)
        cfg.debugging(seed=0)
        cfg.learners(device=device)
        algo = cfg.build()
        try:
            model = algo.model
            assert model.pixel and model.obs_shape == (rows, cols, 1)
            line, _ = dreamer_run(algo, smi, iters=iters, deadline=180.0)
            line.update(obs_shape=[rows, cols, 1],
                        conv_filters=algo.config.conv_filters,
                        conv_dims=model.conv_dims)
            gen = torch.Generator().manual_seed(0)
            feats = torch.randn((2, 4, model.feat_size), generator=gen)
            wm_cpu = params_from_numpy(algo.get_state()["wm"], "cpu")
            with torch.no_grad(), _full_f32():
                got = model.decode(algo.wm_params, feats.to(algo.device))
                want = model.decode(wm_cpu, feats)
            line["decode_shape"] = list(got.shape)
            assert tuple(got.shape) == (2, 4, rows, cols, 1), line
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=RLLIB_TOL["rtol"],
                                       atol=RLLIB_TOL["atol"])
            line["decode_max_abs_err_vs_cpu"] = float(
                (got.cpu() - want).abs().max())
            line["decode_max_abs"] = float(want.abs().max())
            line.update(with_deadline(60.0, lambda: device_idle_share(algo),
                                      "dreamer 84x84 profiled iteration"))
            out["atari_frame"] = line
        finally:
            algo.stop()
    finally:
        rt.shutdown()
    return out


def examples_phase(device, smi: str) -> dict:
    """The two examples through their entry points on the card, with
    the reference tests' gates (tests/test_examples.py): `ppo_pixels.
    run(target_return=0.35, seed=0)` (`:60-80`: loss finite, env steps,
    best return >= 0.35; under the profiler, for the card's idle share
    over the run) and `mnist.run(num_workers=2, epochs=4)` (`:15-24`:
    no error, epoch 3, accuracy > 0.5), its two workers sharing the card
    (`GPU` 0.5 each), each worker's peak memory from its reports."""
    from ray_tpu_torch.examples import mnist, ppo_pixels

    out = {"phase": "examples", "nvidia_smi": smi}
    rt.init(num_workers=3, num_cpus=8)
    try:
        torch.cuda.reset_peak_memory_stats()
        res, wall_ms, busy_ms = with_deadline(300.0, lambda: profile_call(
            lambda: ppo_pixels.run(iterations=45, target_return=0.35,
                                   seed=0, device=device)), "ppo_pixels")
        line = {"iterations": res["training_iteration"],
                "best_return": res["best_return"],
                "total_loss": res["total_loss"],
                "num_env_steps_sampled": res["num_env_steps_sampled"],
                "wall_s": wall_ms / 1e3, "device_busy_ms": busy_ms,
                "device_idle_share": (1.0 - busy_ms / wall_ms) if busy_ms
                else None,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "gate": "loss finite, env steps > 0, best >= 0.35"}
        out["ppo_pixels"] = line
        assert np.isfinite(res["total_loss"]), line
        assert res["num_env_steps_sampled"] > 0, line
        assert res["best_return"] >= 0.35, line

        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            result = with_deadline(300.0, lambda: mnist.run(
                num_workers=2, epochs=4, storage_path=d, device=device),
                "mnist")
            wall_s = time.perf_counter() - t0
        m = result.metrics
        line = {"error": None if result.error is None else str(result.error),
                "epoch": m.get("epoch"), "accuracy": m.get("accuracy"),
                "loss": m.get("loss"), "wall_s": wall_s,
                "worker_peak_gb": m.get("peak_mem_gb"),
                "device_idle_share": "not measured: the card's work is in "
                                     "the two workers' processes",
                "gate": "no error, epoch 3, accuracy > 0.5"}
        out["mnist"] = line
        assert result.error is None, line
        assert m["epoch"] == 3 and m["accuracy"] > 0.5, line
        assert len(m["peak_mem_gb"]) == 2 and min(m["peak_mem_gb"]) > 0, line
    finally:
        rt.shutdown()
    return out


def rllib_last_phases(device, smi: str) -> None:
    """rllib_multi_agent, rllib_dreamer and rllib_dreamer_pixels; each
    boots the port's runtime and shuts it down."""
    for phase in (rllib_multi_agent, rllib_dreamer, rllib_dreamer_pixels):
        t0 = time.perf_counter()
        emit({**phase(device, smi), "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()


def examples_phases(device, smi: str) -> None:
    """The examples' phase; it boots the port's runtime and shuts it
    down."""
    t0 = time.perf_counter()
    emit({**examples_phase(device, smi), "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the operations plane: a GPU node scaled up on demand runs a durable
# GPT-2 workflow, beside submitted jobs, read through the dashboard
# ----------------------------------------------------------------------
OPS_BATCH, OPS_SEQ, OPS_STEPS = 8, 1024, 3
# the GPU node type: scaled up for the workflow's `num_gpus=1` step and
# down once it has idled this long
OPS_IDLE_S = 5.0
# a stopped job's card memory must come back to within this of the
# reading taken before it started
OPS_MEM_SLACK_MIB = 512


def gpt2_workflow_steps(device: str, cfg_kw: dict, steps: int):
    """The workflow's three steps, made here so that they pickle by
    value: `make_batch` (CPU) draws `[batch, seq + 1]` int32 tokens from
    a seed; `train` (`num_gpus=1`) takes `steps` GPT-2 steps on
    `device` with flash attention and returns host values only: the
    losses, each step's ms, the K1-K4 launches and plain dispatches read
    in its own process, a digest of the final params, the devices the
    process sees and where it ran; `report` (CPU) fails while a flag
    file exists and otherwise passes on what `train` returned."""

    @rt.remote(num_cpus=1)
    def make_batch(seed: int, batch: int, seq: int, vocab: int):
        rng = np.random.default_rng(seed)
        return rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)

    @rt.remote(num_gpus=1, num_cpus=1)
    def train(tokens):
        import hashlib
        import os as os_
        import time as time_

        import torch as torch_

        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.core.runtime import get_runtime
        from ray_tpu_torch.models import gpt2 as gpt2_
        from ray_tpu_torch.ops import attention as fa_

        t_start = time_.time()
        torch_.backends.cuda.matmul.allow_tf32 = False
        torch_.backends.cudnn.allow_tf32 = False
        dev = resolve_device(device)
        seen = {"cuda_visible_devices":
                os_.environ.get("CUDA_VISIBLE_DEVICES"),
                "device_count": torch_.cuda.device_count(),
                "device": (torch_.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}
        cfg = gpt2_.GPT2Config(attention="flash",
                               logits_dtype=torch_.bfloat16, **cfg_kw)
        params = gpt2_.init_params(cfg, 0, device=dev)
        opt = gpt2_.default_optimizer(total_steps=1000)
        opt_state = opt.init(params)
        step = gpt2_.make_train_step(cfg, opt)
        toks = torch_.tensor(tokens, device=dev)
        names = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                 "flash_bwd_dkv")
        for n in names:
            getattr(fa_, n).launches = 0
        fa_.flash_attention.plain_dispatches = 0
        losses, step_ms = [], []
        for _ in range(steps):
            t0 = time_.perf_counter()
            params, opt_state, m = step(params, opt_state, toks)
            losses.append(float(m["loss"]))
            if dev.type == "cuda":
                torch_.cuda.synchronize(dev)
            step_ms.append((time_.perf_counter() - t0) * 1e3)
        h = hashlib.sha256()
        for leaf in gpt2_._leaves(params):
            h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
        rt_ = get_runtime()
        return {"losses": losses, "step_ms": step_ms,
                "launches": {n: getattr(fa_, n).launches for n in names},
                "plain_dispatches": fa_.flash_attention.plain_dispatches,
                "digest": h.hexdigest(), "seen": seen,
                "node_id": rt_.node_id, "pid": os_.getpid(),
                "t_start": t_start, "t_end": time_.time(),
                "n_layer": cfg.n_layer, "vocab": cfg.vocab_size,
                "tokens_per_step": int(toks.shape[0] * (toks.shape[1] - 1)),
                "peak_mem_gb": (torch_.cuda.max_memory_allocated(dev) / 1e9
                                if dev.type == "cuda" else None)}

    @rt.remote(num_cpus=1)
    def report(trained: dict, flag: str):
        import os as os_

        if os_.path.exists(flag):
            raise RuntimeError(f"report: injected failure ({flag} exists)")
        return {k: trained[k] for k in ("losses", "digest", "launches",
                                        "plain_dispatches")}

    return make_batch, train, report


def _http_json(url: str, timings: dict, key: str, timeout: float = 30.0):
    """GET `url`; its JSON, with the ms it took under `timings[key]`."""
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body = r.read()
    timings.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
    return json.loads(body)


def card_mib() -> float:
    """The card's used memory, as `nvidia-smi` reads it (every process)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def _poll(seconds: float, fn, what: str, every: float = 0.2):
    """`fn()` until it returns something truthy; fails past `seconds`."""
    deadline = time.monotonic() + seconds
    while True:
        got = fn()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {seconds} s")
        time.sleep(every)


def profile_train(base: str, gpu_node: str, timings: dict) -> dict:
    """The flamegraph of the GPU node's busy worker, taken while `train`
    runs there: the worker's id and whether `train`'s frame is in it."""
    def busy_worker():
        for w in _http_json(base + "/api/workers", timings, "workers"):
            if (w.get("node_id") == gpu_node and w.get("kind") == "worker"
                    and not w.get("idle") and not w.get("actor_id")):
                return w
        return None

    w = _poll(120.0, busy_worker, "a busy worker on the GPU node", 0.1)
    t0 = time.perf_counter()
    url = (f"{base}/api/profile?node_id={gpu_node}&worker_id="
           f"{w['worker_id']}&mode=flamegraph&duration=2")
    with urllib.request.urlopen(url, timeout=60) as r:
        folded = r.read().decode()
    timings.setdefault("profile", []).append(
        (time.perf_counter() - t0) * 1e3)
    lines = [ln for ln in folded.splitlines() if ln.strip()]
    frames = {f.split(" (", 1)[0] for ln in lines
              for f in ln.rsplit(" ", 1)[0].split(";")}
    return {"worker_id": w["worker_id"], "pid": w["pid"],
            "stacks": len(lines), "train_frame": "train" in frames,
            "folded_head": lines[:2]}


def ops_plane(device, smi: str, *, cfg_kw=None, batch=OPS_BATCH,
              seq=OPS_SEQ, steps=OPS_STEPS) -> dict:
    """The operations plane on the card, through the port's entry
    points.  The head starts with no GPU (`num_gpus=0`), so the
    workflow's `num_gpus=1` step is pending demand that only a new node
    can serve; the dashboard runs on the head; `AutoscalerV2` over the
    local provider (one type, `gpu_worker`: 4 CPUs, `{"GPU": 1}`, at
    most one node, `OPS_IDLE_S` idle timeout) reconciles every 0.5 s in
    a thread.

    1. workflow `gpt2_wf`: make_batch -> train (`num_gpus=1`, GPT-2
       124M at full width and depth by default, `steps` steps on the
       card) -> report (fails on its first run through a flag file).
       While `train` runs, its worker is profiled over `/api/profile`.
       Then `resume` reruns only `report`.
    2. while the GPU node is up: `/api/nodes`, `/api/cluster_status`
       and `cluster_status()` show it with `GPU` 1; `/api/timeline`
       equals `timeline()` over the same window, with the three steps
       as complete slices and `train` on the GPU node's worker lane;
       `summarize_tasks()` counts them.
    3. the node idles and is terminated: its daemon exits and no `GPU`
       is left in the cluster.
    4. jobs (after the scale-down, so the card's memory readings are
       this process's and the jobs' alone): `scripts/train_gpt2.py` as a
       submitted job, followed to SUCCEEDED through `follow_job_logs`;
       a second one stopped after its first line, STOPPED within
       `stop_bound_s`, the card's memory back within
       `OPS_MEM_SLACK_MIB`; `/api/jobs` lists both with their statuses.
    """
    from ray_tpu_torch import job, workflow
    from ray_tpu_torch.autoscaler import (AutoscalerV2, AutoscalerV2Config,
                                          LocalNodeProvider,
                                          NodeTypeConfigV2)
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.util import state

    cfg_kw = cfg_kw or {}
    job_args = "--batch 8 --steps 2 --warmup 1"
    stop_bound_s = 30.0
    out = {"phase": "ops_plane", "nvidia_smi": smi,
           "model": "gpt2_124m" if not cfg_kw else f"gpt2 {cfg_kw}",
           "batch": batch, "seq": seq, "steps": steps,
           "gpu_node_type": {"num_cpus": 4, "resources": {"GPU": 1},
                             "max_nodes": 1, "idle_timeout_s": OPS_IDLE_S}}
    ms: dict = {}
    t_phase = time.perf_counter()
    info = rt.init(num_workers=2, num_cpus=4, num_gpus=0)
    stop = threading.Event()
    store = tempfile.mkdtemp(prefix="rtt_ops_wf_")
    provider = loop = head = None
    try:
        head, (host, port) = start_dashboard()
        base = f"http://{host}:{port}"
        provider = LocalNodeProvider(info["controller_addr"])
        scaler = AutoscalerV2(provider, AutoscalerV2Config(
            node_types={"gpu_worker": NodeTypeConfigV2(
                num_cpus=4, resources={"GPU": 1}, num_workers=2,
                max_slices=1)},
            max_hosts=1, idle_timeout_s=OPS_IDLE_S))
        loop = threading.Thread(target=scaler.run, name="autoscaler",
                                kwargs={"interval_s": 0.5,
                                        "stop_event": stop}, daemon=True)
        loop.start()
        nodes0 = _http_json(base + "/api/nodes", ms, "nodes")
        assert [n["resources"].get("GPU", 0) for n in nodes0] == [0], nodes0

        # -- 1. the workflow, its first run failing at `report`
        workflow.init_storage(store)
        flag = os.path.join(store, "report.fail")
        open(flag, "w").close()
        make_batch, train, report = gpt2_workflow_steps(
            str(device), cfg_kw, steps)
        vocab = gpt2.GPT2Config(**cfg_kw).vocab_size
        dag = report.bind(train.bind(make_batch.bind(0, batch, seq, vocab)),
                          flag)
        t0 = time.perf_counter()
        fut = workflow.run_async(dag, workflow_id="gpt2_wf")

        def gpu_node():
            live = provider.non_terminated_nodes()
            try:
                return live and provider.runtime_node_id(live[0])
            except KeyError:
                return None

        gpu_node_id = _poll(180.0, gpu_node, "the GPU node's launch")
        out["profile"] = profile_train(base, gpu_node_id, ms)
        err = fut.exception(timeout=600)
        if err is None or "injected failure" not in str(err):
            raise AssertionError("the first run did not fail at report's "
                                 "injected failure") from err
        first_run_s = time.perf_counter() - t0
        assert workflow.get_status("gpt2_wf") == "FAILED"
        meta1 = workflow.get_metadata("gpt2_wf")
        key = {s["name"]: k for k, s in meta1["steps"].items()}
        assert meta1["steps"][key["train"]]["status"] == "SUCCESSFUL", meta1
        assert meta1["steps"][key["report"]]["status"] == "FAILED", meta1
        with open(os.path.join(store, "gpt2_wf", "tasks",
                               key["train"] + ".pkl"), "rb") as f:
            stored = cloudpickle.load(f)
        train_mtime = os.path.getmtime(os.path.join(
            store, "gpt2_wf", "tasks", key["train"] + ".pkl"))

        # -- 2. the GPU node, seen through the dashboard and the state API
        nodes = _http_json(base + "/api/nodes", ms, "nodes")
        gpu_rows = [n for n in nodes if n["alive"]
                    and n["resources"].get("GPU")]
        status = _http_json(base + "/api/cluster_status", ms,
                            "cluster_status")
        total = state.cluster_status()["total_resources"]
        out["gpu_node"] = {"node_id": gpu_node_id,
                           "resources": gpu_rows[0]["resources"]
                           if gpu_rows else None,
                           "nodes_alive": status["nodes_alive"],
                           "cluster_gpu": total.get("GPU")}
        assert [n["node_id"] for n in gpu_rows] == [gpu_node_id], nodes
        assert gpu_rows[0]["resources"]["GPU"] == 1.0, gpu_rows
        assert status["nodes_alive"] == 2 and total.get("GPU") == 1.0, (
            status, total)
        assert stored["node_id"] == gpu_node_id, stored["node_id"]
        seen = stored["seen"]
        if device.type == "cuda":
            assert seen["device_count"] == 1, seen
            assert len((seen["cuda_visible_devices"] or "").split(",")) \
                == 1, seen

        # -- resume: only `report` reruns
        os.remove(flag)
        t0 = time.perf_counter()
        resumed = with_deadline(120.0, lambda: workflow.resume("gpt2_wf"),
                                "workflow.resume")
        resume_s = time.perf_counter() - t0
        t_resumed = time.time()
        meta2 = workflow.get_metadata("gpt2_wf")
        assert meta2["status"] == "SUCCESSFUL", meta2
        assert meta2["steps"][key["train"]] == meta1["steps"][key["train"]]
        assert meta2["steps"][key["make_batch"]] == \
            meta1["steps"][key["make_batch"]]
        assert meta2["steps"][key["report"]]["status"] == "SUCCESSFUL"
        assert os.path.getmtime(os.path.join(
            store, "gpt2_wf", "tasks", key["train"] + ".pkl")) == train_mtime
        assert resumed == {k: stored[k] for k in resumed}, (resumed, stored)
        assert workflow.get_output("gpt2_wf") == resumed

        losses = stored["losses"]
        ln_v = math.log(vocab)
        want = {"flash_fwd": steps * stored["n_layer"] * 2,
                "flash_bwd_fused": steps * stored["n_layer"],
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        out["train"] = {
            "losses": losses, "step_ms": stored["step_ms"],
            "tokens_per_s": stored["tokens_per_step"] * (steps - 1)
            / (sum(stored["step_ms"][1:]) / 1e3) if steps > 1 else None,
            "launches": stored["launches"], "launches_want": want,
            "plain_dispatches": stored["plain_dispatches"],
            "digest": stored["digest"], "seen": seen,
            "peak_mem_gb": stored["peak_mem_gb"],
            "wall_s": stored["t_end"] - stored["t_start"]}
        assert all(math.isfinite(x) for x in losses), losses
        assert abs(losses[0] - ln_v) < 0.5, (losses[0], ln_v)
        assert losses[-1] < losses[0], losses
        assert stored["launches"] == want, (stored["launches"], want)
        assert stored["plain_dispatches"] == 0, stored["plain_dispatches"]
        assert out["profile"]["train_frame"], out["profile"]

        # the demand appears when the executor submits `train`; it runs
        # once the scaled-up node's worker starts it
        out["scale_up_s"] = (stored["t_start"]
                             - meta1["steps"][key["train"]]["start_ts"])

        # -- the timeline: three complete step slices, `train` on the
        # GPU node's worker lane, and the endpoint equal to timeline()
        def settled():
            doc = _http_json(base + "/api/timeline", ms, "timeline")
            slices = [e for e in doc["traceEvents"]
                      if e.get("cat") == "task" and e["ph"] == "X"]
            # the failed first `report` leaves no complete slice (an
            # owner records a failure without a duration)
            if not {"make_batch", "train", "report"} <= {
                    e["name"] for e in slices}:
                return None
            if doc["traceEvents"] != rt.timeline():
                return None
            return doc, slices

        doc, slices = _poll(60.0, settled, "the timeline")
        [train_slice] = [e for e in slices if e["name"] == "train"]
        # the owner records a task's end without its worker (as the JAX
        # package does), so a complete slice sits on the owner's lane;
        # the worker's own RUNNING event for that task names its lane
        lanes = {(e.get("node_id"), e.get("worker_id"))
                 for e in state.list_tasks(name="train", state="RUNNING")
                 if e["task_id"] == train_slice["args"]["task_id"]}
        assert lanes == {(gpu_node_id, out["profile"]["worker_id"])}, lanes
        out["timeline"] = {"events": len(doc["traceEvents"]),
                           "task_slices": len(slices),
                           "train_slice_ms": train_slice["dur"] / 1e3,
                           "train_lane": sorted(lanes)[0],
                           "truncated": doc["truncated"]}
        finished = [e["name"] for e in state.list_tasks(state="FINISHED")]
        runs = {n: finished.count(n) for n in key}
        assert runs == {"make_batch": 1, "train": 1, "report": 1}, runs
        out["workflow"] = {"first_run_s": first_run_s, "resume_s": resume_s,
                           "executions": runs,
                           "steps": {n: meta2["steps"][k]["status"]
                                     for n, k in key.items()}}
        out["task_summary"] = state.summarize_tasks()

        # -- 3. scale-down after the idle timeout
        proc = provider._nodes[provider.non_terminated_nodes()[0]]["proc"]
        _poll(OPS_IDLE_S + 60.0, lambda: not provider.non_terminated_nodes(),
              "the GPU node's scale-down")
        out["scale_down_s"] = time.time() - t_resumed
        _poll(30.0, lambda: proc.poll() is not None, "the node's exit")

        def head_alone():
            st = _http_json(base + "/api/cluster_status", ms,
                            "cluster_status")
            return st if st["nodes_alive"] == 1 else None

        status = _poll(30.0, head_alone, "the head alone")
        total = state.cluster_status()["total_resources"]
        assert "GPU" not in total, total
        out["after_scale_down"] = {"nodes_alive": status["nodes_alive"],
                                   "total_resources": total,
                                   "daemon_exit": proc.returncode}

        # -- 4. jobs
        if device.type == "cuda":
            torch.cuda.empty_cache()
        entry = (f"{sys.executable} -m ray_tpu_torch.scripts.train_gpt2 "
                 f"{job_args}")
        repo = os.path.dirname(os.path.abspath(__file__))
        t0 = time.time()
        jid = job.submit_job(entry, working_dir=repo,
                             metadata={"phase": "ops_plane"})
        text = "".join(with_deadline(
            600.0, lambda: list(job.follow_job_logs(jid, poll_s=0.2)),
            "follow_job_logs"))
        ji = job.get_job_info(jid)
        assert ji["status"] == "SUCCEEDED", (ji, text[-2000:])
        rows = [json.loads(ln) for ln in text.splitlines()
                if ln.startswith("{")]
        got = {r.get("phase"): r for r in rows}
        run = got["train_gpt2"]
        assert abs(run["warmup_losses"][0] - ln_v) < 0.5, run
        out["job"] = {
            "entrypoint": entry, "status": ji["status"],
            "submit_to_running_s": ji["start_time"] - ji["submit_time"],
            "running_to_succeeded_s": ji["end_time"] - ji["start_time"],
            "submit_to_succeeded_s": ji["end_time"] - ji["submit_time"],
            "follow_s": time.time() - t0,
            "seen": got["train_gpt2_device"],
            "warmup_losses": run["warmup_losses"],
            "losses": run["losses"], "step_ms": run["step_ms"],
            "tokens_per_s": run["tokens_per_s"]}
        if device.type == "cuda":
            assert got["train_gpt2_device"]["device_count"] == 1, got

        mib0 = card_mib() if device.type == "cuda" else None
        jid2 = job.submit_job(
            f"{sys.executable} -u -m ray_tpu_torch.scripts.train_gpt2 "
            f"{job_args.replace('--steps 2', '--steps 100000')}",
            working_dir=repo)
        _poll(300.0, lambda: "train_gpt2_device" in job.get_job_logs(jid2),
              "the long job's first line")
        mib_running = card_mib() if device.type == "cuda" else None
        t0 = time.perf_counter()
        assert job.stop_job(jid2)
        status2 = job.wait_job(jid2, timeout=stop_bound_s)
        stop_s = time.perf_counter() - t0
        assert status2 == "STOPPED", status2

        def back():
            now = card_mib()
            return now if now - mib0 <= OPS_MEM_SLACK_MIB else None

        mib_after = (_poll(30.0, back, "the card's memory back")
                     if device.type == "cuda" else None)
        out["stopped_job"] = {
            "status": status2, "stop_s": stop_s,
            "stop_bound_s": stop_bound_s, "mib_before": mib0,
            "mib_running": mib_running, "mib_after": mib_after,
            "mib_returned": (mib_running - mib_after)
            if mib_after is not None else None,
            "slack_mib": OPS_MEM_SLACK_MIB}
        jobs = {j.get("job_id"): j.get("status")
                for j in _http_json(base + "/api/jobs", ms, "jobs")}
        assert jobs.get(jid) == "SUCCEEDED" and jobs.get(jid2) == "STOPPED", \
            jobs
        out["jobs_listed"] = {jid: jobs[jid], jid2: jobs[jid2]}
    finally:
        stop.set()
        if loop is not None:
            loop.join(timeout=10)
        if provider is not None:
            for pid in provider.non_terminated_nodes():
                provider.terminate_node(pid)
        if head is not None:
            try:
                rt.kill(head)
            except Exception:  # the runtime is shut down next anyway
                pass
        rt.shutdown()
        shutil.rmtree(store, ignore_errors=True)
    out["endpoint_ms"] = {k: {"n": len(v), "median": statistics.median(v),
                              "max": max(v)} for k, v in ms.items()}
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# the GPU pool's items: GPT-2's attention (B, H, T, D) at bf16, causal
CLI_POOL_SHAPE = (4, 12, 1024, 64)
CLI_POOL_ITEMS = 8
# the object the driver holds while `memory --json` reads the store:
# bf16 [8, 1,024, 4,096], 64 MiB
CLI_PUT_SHAPE = (8, 1024, 4096)
CLI_JOB_ARGS = "--batch 8 --steps 3 --warmup 1"


def cli(address: str, *args, timings: dict) -> str:
    """One command of the port's CLI in a fresh interpreter, as an
    operator runs it from a shell; its standard output, with its wall ms
    under `timings[<the command's words>]`.  A non-zero exit fails the
    phase."""
    key = " ".join(a for a in args[:2] if not a.startswith("-"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
         *(("--address", address) if address else ()), *args],
        capture_output=True, text=True, timeout=600)
    timings.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
    if proc.returncode != 0:
        raise AssertionError(f"cli {args}: exit {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def pool_flash_item(device: str, tol: dict):
    """The pool's work item, made here so that it pickles by value:
    `item((seed, (B, H, T, D)))` runs `flash_attention` forward and
    backward on seeded bf16 q, k, v, dO [B, T, H, D] on `device` (K1 then
    K2 in the calling process), and returns O's, dQ's, dK's and dV's
    (max abs, elementwise ratio, relative norm) against the plain
    versions (`flash_fwd_reference`, then `flash_bwd_fused_reference` on
    its O and LSE) compared in f32 under `tol`, the K1-K4 launches and
    plain dispatches of that call read in this process, the process's
    pid, `CUDA_VISIBLE_DEVICES`, device count and `util.accelerators`
    readings, the call's ms and a sha256 of O's bytes."""

    def item(arg):
        import hashlib
        import os as os_
        import time as time_

        import torch as torch_

        from ray_tpu_torch.ops import attention as fa_
        from ray_tpu_torch.util import accelerators as acc_

        seed, (B, H, T, D) = arg
        dev = torch_.device(device)
        cuda = dev.type == "cuda"
        names = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                 "flash_bwd_dkv")
        gen = torch_.Generator(device=dev)
        gen.manual_seed(seed)
        q, k, v, do = (torch_.randn((B, T, H, D), generator=gen,
                                    device=dev).to(torch_.bfloat16)
                       for _ in range(4))
        before = {n: getattr(fa_, n).launches for n in names}
        plain0 = fa_.flash_attention.plain_dispatches
        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        t0 = time_.perf_counter()
        o = fa_.flash_attention(qg, kg, vg, causal=True)
        dq, dk, dv = torch_.autograd.grad(o, (qg, kg, vg), do)
        if cuda:
            torch_.cuda.synchronize(dev)
        ms = (time_.perf_counter() - t0) * 1e3
        launches = {n: getattr(fa_, n).launches - before[n] for n in names}
        plain = fa_.flash_attention.plain_dispatches - plain0

        def fold(t):
            return t.permute(0, 2, 1, 3).reshape(B * H, T, D)

        scale = D ** -0.5
        o_ref, lse = fa_.flash_fwd_reference(fold(q), fold(k), fold(v),
                                             True, scale)
        ref = dict(zip(("dq", "dk", "dv"), fa_.flash_bwd_fused_reference(
            fold(q), fold(k), fold(v), fold(do), lse, o_ref, True, scale)))
        errs = {}
        for name, got, want in (("o", o, o_ref), ("dq", dq, ref["dq"]),
                                ("dk", dk, ref["dk"]),
                                ("dv", dv, ref["dv"])):
            g, w = fold(got).detach().float(), want.detach().float()
            if not bool(torch_.isfinite(g).all()):
                raise AssertionError(f"{name}: non-finite")
            d = (g - w).abs()
            errs[name] = (
                float(d.max()),
                float((d / (tol["atol"] + tol["rtol"] * w.abs())).max()),
                float(torch_.linalg.vector_norm(g - w)
                      / torch_.linalg.vector_norm(w)))
        raw = o.detach().contiguous().view(torch_.int16).cpu().numpy()
        return {"seed": seed, "pid": os_.getpid(), "errs": errs,
                "launches": launches, "plain_dispatches": plain, "ms": ms,
                "cuda_visible_devices": os_.environ.get(
                    "CUDA_VISIBLE_DEVICES"),
                "device_count": torch_.cuda.device_count() if cuda else 0,
                "visible_chip_ids":
                    acc_.get_current_process_visible_chip_ids(),
                "chips_on_node": acc_.get_num_tpu_chips_on_node(),
                "digest": hashlib.sha256(raw.tobytes()).hexdigest()}

    return item


def cli_plane(device, smi: str) -> dict:
    """The operator's surface on the card: a head that counts the card
    boots here, and from then on the driver asks the cluster everything
    through `python -m ray_tpu_torch.scripts.cli --address <ready.json>`
    in subprocesses (the pool is the user's API, run from the driver).

    1. `status` (a node alive, `GPU` 1), `list nodes`, `list workers`,
       `events`, `grafana-dashboard --out <tmp>` (files written).
    2. `job submit --wait` of `scripts/train_gpt2.py` (GPT-2 124M at
       full width and depth, 8 x 1,024, 1 warm-up + 3 steps: K1 / K2 in
       the job's process, its counts printed by the script), then `job
       status` SUCCEEDED, `job logs` (step-0 loss within 0.5 of ln V,
       falling; 24 K1 and 12 K2 a step, no plain dispatch), `job list`.
       A second, long job is stopped with `job stop` after its first
       line: STOPPED within 30 s, the card's memory back within
       `OPS_MEM_SLACK_MIB`.
    3. `util.multiprocessing.Pool(processes=2, ray_remote_args={"num_gpus":
       0.5})` over `CLI_POOL_ITEMS` seeded `pool_flash_item`s: `map` (chunksize
       2), `imap_unordered` (the same digests as a set), one
       `apply_async` with a callback.  Held: two worker pids, each
       worker pinned to the card (its `CUDA_VISIBLE_DEVICES` one id,
       read back by `util.accelerators`) and seeing one device, one K1
       and one K2 an item, no plain dispatch, O / dQ / dK / dV
       within `FLASH_TOL["bf16"]`, and item 0 recomputed here giving the
       worker's O digest.
    4. `memory --json` while the driver holds `rt.put` of a bf16 tensor
       of `CLI_PUT_SHAPE` on `device`: a driver-owned object of its bytes.
    5. `timeline --output <tmp>`: it parses and holds the pool's tasks.
    """
    tol = FLASH_TOL["bf16"]
    ms: dict = {}
    out = {"phase": "cli_plane", "nvidia_smi": smi, "model": "gpt2_124m",
           "job_args": CLI_JOB_ARGS, "pool_shape": list(CLI_POOL_SHAPE),
           "pool_items": CLI_POOL_ITEMS, "tolerance": tol}
    entry = (f"{sys.executable} -u -m ray_tpu_torch.scripts.train_gpt2 "
             f"{CLI_JOB_ARGS}")
    tmp = tempfile.mkdtemp(prefix="rtt_cli_")
    t_phase = time.perf_counter()
    rt.init(num_workers=2, num_cpus=4)
    try:
        from ray_tpu_torch.api import _session

        address = os.path.join(_session["session_dir"], "ready.json")

        # -- 1. the cluster, read from the shell
        status = json.loads(cli(address, "status", timings=ms))
        assert status["nodes_alive"] >= 1, status
        assert status["total_resources"].get("GPU") == 1.0, status
        nodes = json.loads(cli(address, "list", "nodes", timings=ms))
        assert any(n["alive"] for n in nodes), nodes
        workers = json.loads(cli(address, "list", "workers", timings=ms))
        assert {w["kind"] for w in workers} >= {"driver", "worker"}, workers
        events = json.loads(cli(address, "events", timings=ms))
        assert any(e["event_type"] == "NODE_ADDED" for e in events), events
        dash = cli(None, "grafana-dashboard", "--out",
                   os.path.join(tmp, "grafana"), timings=ms).split()
        assert dash and all(os.path.getsize(p) > 0 for p in dash), dash
        out["cluster"] = {"nodes_alive": status["nodes_alive"],
                          "total_resources": status["total_resources"],
                          "workers": len(workers), "events": len(events),
                          "grafana_files": len(dash)}

        # -- 2. GPT-2 as a job, submitted, read and listed from the shell
        torch.cuda.empty_cache()
        t0 = time.time()
        jid, verdict = cli(address, "job", "submit", "--wait", entry,
                           timings=ms).split()
        assert verdict == "SUCCEEDED", verdict
        assert cli(address, "job", "status", jid,
                   timings=ms).strip() == "SUCCEEDED"
        text = cli(address, "job", "logs", jid, timings=ms)
        got = {r.get("phase"): r for r in (
            json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{"))}
        run = got["train_gpt2"]
        steps = len(run["warmup_losses"]) + len(run["losses"])
        want = {"flash_fwd": steps * run["n_layer"] * 2,
                "flash_bwd_fused": steps * run["n_layer"],
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        ln_v = math.log(gpt2.GPT2Config().vocab_size)
        listed = {j["job_id"]: j for j in json.loads(
            cli(address, "job", "list", timings=ms))}
        assert jid in listed, listed
        ji = listed[jid]
        out["job"] = {
            "entrypoint": entry, "status": ji["status"],
            "submit_to_succeeded_s": ji["end_time"] - ji["submit_time"],
            "wait_s": time.time() - t0,
            "seen": got["train_gpt2_device"],
            "warmup_losses": run["warmup_losses"], "losses": run["losses"],
            "step_ms": run["step_ms"], "tokens_per_s": run["tokens_per_s"],
            "peak_mem_gb": run["peak_mem_gb"],
            "launches": run["launches"], "launches_want": want,
            "plain_dispatches": run["plain_dispatches"]}
        assert ji["status"] == "SUCCEEDED", ji
        assert abs(run["warmup_losses"][0] - ln_v) < 0.5, run
        assert run["losses"][-1] < run["warmup_losses"][0], run
        assert run["launches"] == want, (run["launches"], want)
        assert run["plain_dispatches"] == 0, run
        assert got["train_gpt2_device"]["device_count"] == 1, got

        mib0 = card_mib()
        long_entry = entry.replace(CLI_JOB_ARGS, CLI_JOB_ARGS.replace(
            "--steps 3", "--steps 100000"))
        jid2 = cli(address, "job", "submit", long_entry,
                   timings=ms).strip()
        _poll(300.0, lambda: "train_gpt2_device" in cli(
            address, "job", "logs", jid2, timings=ms), "the long job's "
            "first line", every=0.5)
        mib_running = card_mib()
        t0 = time.perf_counter()
        cli(address, "job", "stop", jid2, timings=ms)
        _poll(30.0, lambda: cli(
            address, "job", "status", jid2, timings=ms).strip()
            == "STOPPED", "the stopped job's STOPPED", every=0.1)
        stop_s = time.perf_counter() - t0

        def back():  # a reading of 0.0 MiB is an answer, not a miss
            mib = card_mib()
            return {"mib": mib} if mib - mib0 <= OPS_MEM_SLACK_MIB else None

        mib_after = _poll(30.0, back, f"the card's memory back within "
                          f"{OPS_MEM_SLACK_MIB} MiB of {mib0} (running: "
                          f"{mib_running})")["mib"]
        out["stopped_job"] = {
            "status": "STOPPED", "stop_s": stop_s,
            "stop_bound_s": 30.0, "mib_before": mib0,
            "mib_running": mib_running, "mib_after": mib_after,
            "mib_returned": mib_running - mib_after,
            "slack_mib": OPS_MEM_SLACK_MIB}

        # -- 3. a GPU pool: flash attention in the pool's processes
        item = pool_flash_item(str(device), tol)
        args = [(1000 + i, CLI_POOL_SHAPE) for i in range(CLI_POOL_ITEMS)]
        from ray_tpu_torch.util.multiprocessing import Pool

        called = []
        t0 = time.perf_counter()
        with Pool(processes=2, ray_remote_args={"num_gpus": 0.5}) as pool:
            start_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            mapped = pool.map(item, args, chunksize=2)
            map_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            unordered = list(pool.imap_unordered(item, args))
            imap_s = time.perf_counter() - t0
            pool.apply_async(item, (args[0],),
                             callback=called.append).get(timeout=300)
        rows = mapped + unordered + called
        mine = item(args[0])  # item 0 on this process's card
        pids = sorted({r["pid"] for r in rows})
        per_item = {"flash_fwd": 1, "flash_bwd_fused": 1,
                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        launches = {n: sum(r["launches"][n] for r in rows)
                    for n in per_item}
        worst = {n: tuple(max(r["errs"][n][i] for r in rows)
                          for i in range(3)) for n in ("o", "dq", "dk", "dv")}
        out["pool"] = {
            "workers": len(pids), "pids": pids, "start_s": start_s,
            "map_s": map_s, "map_ms_an_item": map_s * 1e3 / CLI_POOL_ITEMS,
            "imap_unordered_s": imap_s,
            "item_ms": [r["ms"] for r in mapped],
            "item_ms_unordered": [r["ms"] for r in unordered],
            "launches": launches, "calls": len(rows),
            "plain_dispatches": sum(r["plain_dispatches"] for r in rows),
            "max_abs_elementwise_relnorm": worst,
            "seen": sorted({(r["pid"], r["cuda_visible_devices"],
                             r["device_count"],
                             str(r["visible_chip_ids"]),
                             r["chips_on_node"]) for r in rows}),
            "digest_item0": mapped[0]["digest"],
            "digest_recomputed_here": mine["digest"]}
        assert [r["seed"] for r in mapped] == [a[0] for a in args]
        assert len(pids) == 2, pids
        for r in rows:
            # half a card pins that card: one id in the worker's
            # environment, read back by util.accelerators, one device
            env = r["cuda_visible_devices"]
            assert env is not None and "," not in env, r
            assert r["visible_chip_ids"] == [env], r
            assert r["device_count"] == 1, r
            assert r["launches"] == per_item, r["launches"]
            assert r["plain_dispatches"] == 0, r
            for n, e in r["errs"].items():
                assert e[1] <= 1.0 and e[2] <= tol["rel"], (n, e, tol)
        assert ({r["digest"] for r in unordered}
                == {r["digest"] for r in mapped}), "imap_unordered"
        assert called and called[0]["digest"] == mapped[0]["digest"]
        assert mine["digest"] == mapped[0]["digest"], (
            "item 0's O differs between a pool worker and this process")

        # -- 4. what pins the store, while the driver holds 64 MiB
        held = torch.zeros(CLI_PUT_SHAPE, dtype=torch.bfloat16,
                           device=device)
        nbytes = held.numel() * held.element_size()
        ref = rt.put(held)
        tables = json.loads(cli(address, "memory", "--json", timings=ms))
        rows_ = [r for node in tables for proc in node["processes"]
                 if proc.get("mode") == "driver" for r in proc["refs"]
                 if r["object_id"] == ref.hex()]
        assert rows_ and rows_[0]["kind"] == "owned", rows_
        assert (rows_[0]["size"] or 0) >= nbytes, (rows_, nbytes)
        out["memory"] = {"object_bytes": rows_[0]["size"],
                         "tensor_bytes": nbytes,
                         "where": rows_[0]["where"],
                         "nodes": len(tables)}
        del ref, held

        # -- 5. the timeline, with the pool's tasks
        path = os.path.join(tmp, "timeline.json")

        def pool_slices():
            said = cli(address, "timeline", "--output", path, timings=ms)
            with open(path) as f:
                doc = json.load(f)
            n = sum(1 for e in doc if e.get("ph") == "X"
                    and "run_chunk" in e.get("name", ""))
            return (said, doc, n) if n >= 4 + CLI_POOL_ITEMS + 1 else None

        said, doc, n = _poll(60.0, pool_slices, "the pool's tasks in the "
                             "timeline", every=0.5)
        assert said.startswith(f"wrote {len(doc)} events to "), said
        out["timeline"] = {"events": len(doc), "pool_task_slices": n}
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    out["command_ms"] = {k: {"n": len(v), "median": statistics.median(v),
                             "max": max(v)} for k, v in ms.items()}
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------------------------------
# perf_plane: the port's perf harness on the card
# ----------------------------------------------------------------------
# the harness's engine rows: `LlamaConfig.tiny`'s layers, engines of
# chunk 4
PERF_TINY_LAYERS = llama.LlamaConfig.tiny().n_layers
PERF_TINY_CHUNK = 4


def perf_launches() -> dict:
    return {name: getattr(pa, name).launches for name in PAGED}


def perf_run(argv: list) -> dict:
    """`perf.main(argv)` in this process, the launch counts set to 0 just
    before and read just after: its rows, wall seconds and launches.  A
    row that holds `"error"` (the envelope records a failing row so) fails
    the run."""
    reset_counts()
    t0 = time.perf_counter()
    rows = perf.main(argv)
    out = {"rows": rows, "wall_s": time.perf_counter() - t0,
           "launches": perf_launches()}
    bad = [k for k, v in rows.items() if isinstance(v, dict) and "error" in v]
    if bad:
        raise AssertionError(f"perf {argv}: rows {bad} hold an error")
    return out


def no_own_k5_k6(launches: dict, what: str) -> None:
    if launches["paged_kv_append"] or launches["paged_decode_attention"]:
        raise AssertionError(f"{what} launched K5 / K6 on their own: "
                             f"{launches}")


def engine_trace_gates(rows: dict) -> None:
    """`tests/test_perf_harness.py`'s engine-trace gates."""
    smoke = rows["serve_llm_cb_smoke"]
    ok = (smoke["tokens_per_sec"] > 0 and smoke["ticks"] > 0
          and rows["sized"]["gather_blocks"]
          == rows["overprovisioned"]["gather_blocks"] > 0
          and rows["overprovisioned"]["kv_budget_tokens"]
          > 5 * rows["sized"]["kv_budget_tokens"]
          and rows["prefix_on"]["prefix_hit_tokens"] > 0
          and rows["prefix_on"]["prefill_tokens"]
          < rows["prefix_off"]["prefill_tokens"]
          and rows["prefix_off"]["prefix_hit_tokens"] == 0)
    if not ok:
        raise AssertionError(f"engine-trace gates failed: {rows}")


def decode_row_gates(rows: dict, batches) -> None:
    """`tests/test_perf_harness.py`'s decode gates, `kernel` for the
    reference's `pallas`, at each batch."""
    for b in batches:
        ker, gat = rows[f"decode_b{b}_kernel"], rows[f"decode_b{b}_gather"]
        ok = (ker["decode_kernel"] == "kernel" and ker["kernel_ticks"] > 0
              and ker["fallback_ticks"] == 0
              and gat["decode_kernel"] == "gather"
              and gat["kernel_ticks"] == 0 and gat["fallback_ticks"] > 0
              and ker["tokens_per_sec"] > 0 and gat["tokens_per_sec"] > 0
              and ker["ticks"] == gat["ticks"] > 0)
        if not ok:
            raise AssertionError(f"decode gates failed at B {b}: {ker}, "
                                 f"{gat}")


def decode_kernel_gates(run: dict, batches, *, layers=PERF_TINY_LAYERS,
                        chunk=PERF_TINY_CHUNK) -> int:
    """The decode gates, the int8 pool at half the bf16 payload (its
    scale sidecar priced on int8 only), and the run's fused launches: L
    x chunk for every kernel-route dispatch (`kernel_ticks` is each
    kernel engine's whole count, warm-up included; replays counted) and
    for the one warm-up chunk each kernel-route engine runs when it is
    built (a kernel row's and the two occupancy engines'); the gather
    rows launch none.  Returns the fused launches wanted."""
    rows = run["rows"]
    decode_row_gates(rows, batches)
    occ = rows["kv_pool_occupancy"]
    if not (occ["int8_payload_ratio"] == 0.5
            and occ["kv_scale_bytes_int8"] > 0 == occ["kv_scale_bytes_fp"]):
        raise AssertionError(f"occupancy gates failed: {occ}")
    dispatches = sum(rows[f"decode_b{b}_kernel"]["kernel_ticks"]
                     for b in batches)
    want = layers * chunk * (dispatches + len(batches) + 2)
    got = run["launches"]
    no_own_k5_k6(got, "the decode rows")
    if got["paged_append_decode_attention"] != want:
        raise AssertionError(
            f"decode rows launched {got['paged_append_decode_attention']} "
            f"fused ops, want {want} = {layers} x {chunk} x ({dispatches} "
            f"dispatches + {len(batches) + 2} engines' warm-up chunks)")
    return want


def overload_gates(rows: dict) -> None:
    """`tests/test_perf_harness.py`'s overload gates."""
    storm, ttft = rows["overload_storm"], rows["overload_ttft"]
    ok = (storm["offered"] == storm["admitted"] + storm["rejected"]
          + storm["shed"]
          and storm["rejected"] > 0 and storm["shed"] > 0
          and storm["shed"] == storm["shed_expired"]
          + storm["shed_predicted"]
          and storm["prefill_calls"] == storm["admitted"]
          and storm["queue_peak"] <= storm["queue_cap"]
          and storm["blocks_free_delta"] == 0
          and storm["admitted_tok_s"] > 0
          and 0 < ttft["ttft_p50_ms"] <= ttft["ttft_p99_ms"]
          and ttft["concurrency"] == 8.0)
    if not ok:
        raise AssertionError(f"overload gates failed: {rows}")


def perf_decode_full_width(cfg, params, prompts, device, *, slots=8,
                           chunk=8, block_size=16, max_len=512,
                           n_new=32) -> dict:
    """The harness's decode rows at the main path's width: two engines
    over the main path's params, one after the other, the kernel route
    then the gather route, each through `perf._engine_run` (a warm-up run
    of the same prompts, which captures every width's graph, then the
    measured run, the launch counts set to 0 between them)."""
    rows, launches = {}, {}
    for mode in ("kernel", "gather"):
        name = f"decode_b{len(prompts)}_{mode}"
        eng = LlamaEngine(cfg, params, slots=slots, chunk=chunk,
                          block_size=block_size, max_len=max_len,
                          prefix_cache=False, decode_kernel=mode,
                          device=device)
        try:
            perf._engine_run(eng, prompts, n_new)
            widths = set(eng._chunk_cache)
            reset_counts()
            row = perf._engine_run(eng, prompts, n_new)
            launches[name] = perf_launches()
            s = eng.stats()
            row["decode_kernel"] = s["decode_kernel"]
            row["kernel_ticks"] = s["decode_kernel_dispatch_total"]
            row["fallback_ticks"] = s["decode_fallback_dispatch_total"]
            row["widths_captured_in_run"] = sorted(
                set(eng._chunk_cache) - widths)
            row["chunk_graphs"] = chunk_graphs(eng)
        finally:
            eng.shutdown()
        rows[name] = row
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    decode_row_gates(rows, (len(prompts),))
    ker = rows[f"decode_b{len(prompts)}_kernel"]
    want = cfg.n_layers * chunk * ker["ticks"]
    for name, got in launches.items():
        no_own_k5_k6(got, name)
        fused = want if name.endswith("_kernel") else 0
        if got["paged_append_decode_attention"] != fused:
            raise AssertionError(
                f"{name}: {got['paged_append_decode_attention']} fused "
                f"launches in the measured run, want {fused} "
                f"({cfg.n_layers} x {chunk} x {ker['ticks']} dispatches "
                f"on the kernel row, none on the gather row)")
    captured = {n: r["widths_captured_in_run"] for n, r in rows.items()
                if r["widths_captured_in_run"]}
    if captured:
        raise AssertionError(f"a measured run captured a graph: {captured}")
    on_graphs(ker["chunk_graphs"], "decode_b8_kernel")
    for r in rows.values():
        if r["prefill_tokens"] != sum(len(p) for p in prompts):
            raise AssertionError(f"a row prefilled {r['prefill_tokens']} "
                                 "tokens, not its prompts'")
    return {"phase": "perf_plane", "run": "decode_full_width",
            "model": "llama3_8b", "n_layers": cfg.n_layers, "dim": cfg.dim,
            "slots": slots, "chunk": chunk, "block_size": block_size,
            "requests": len(prompts), "max_new_tokens": n_new,
            "rows": rows, "launches": launches,
            "kernel_x_gather_tokens_per_sec":
                ker["tokens_per_sec"]
                / rows[f"decode_b{len(prompts)}_gather"]["tokens_per_sec"]}


def perf_cli_default(timeout: float = 300.0) -> dict:
    """`python -m ray_tpu_torch.scripts.perf --engine-trace
    --engine-requests 12 --json <file>` in a subprocess with no
    `--device`: the rows come from the card, the file equals the printed
    last line, and the rows pass the engine-trace gates."""
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "perf.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.perf",
             "--engine-trace", "--engine-requests", "12", "--json", out],
            cwd=repo, capture_output=True, text=True, timeout=timeout)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"perf CLI exited {proc.returncode}: "
                                 f"{proc.stderr[-4000:]}")
        printed = json.loads(proc.stdout.strip().splitlines()[-1])
        with open(out) as f:
            saved = json.load(f)
    if saved != printed:
        raise AssertionError("the --json file differs from the last line")
    engine_trace_gates(saved)
    return {"rows": saved, "wall_s": wall, "json_equals_last_line": True}


def perf_plane(device, smi: str) -> dict:
    """The perf harness's runs on the card and the runtime (13m); emits a
    line a run and returns the phase's fused launches and wall s."""
    t_phase = time.perf_counter()
    dev = ["--device", device.type]
    fused = 0

    def line(name, argv, run, **extra):
        emit({"phase": "perf_plane", "run": name, "argv": argv, **run,
              **extra})

    argv = ["--engine-trace", *dev]
    run = perf_run(argv)
    engine_trace_gates(run["rows"])
    no_own_k5_k6(run["launches"], "the engine-trace rows")
    if run["launches"]["paged_append_decode_attention"] <= 0:
        raise AssertionError("the engine-trace rows launched no fused op")
    fused += run["launches"]["paged_append_decode_attention"]
    line("engine_trace", argv, run)

    batches = (16, 32, 64)
    argv = ["--config", "decode_kernel",
            "--decode-batches", ",".join(map(str, batches)), *dev]
    run = perf_run(argv)
    want = decode_kernel_gates(run, batches)
    fused += run["launches"]["paged_append_decode_attention"]
    line("decode_kernel", argv, run, fused_launches_want=want)

    argv = ["--overload", *dev]
    run = perf_run(argv)
    overload_gates(run["rows"])
    no_own_k5_k6(run["launches"], "the overload rows")
    fused += run["launches"]["paged_append_decode_attention"]
    line("overload", argv, run)

    argv = ["--config", "obs_overhead", "--obs-storm-n", "1000",
            "--obs-rounds", "2", *dev]
    run = perf_run(argv)
    rows = run["rows"]
    for k in ("obs_overhead", "serve_obs_overhead"):
        if not (rows[k]["instrumented"] == 1.0
                and -50.0 < rows[k]["overhead_pct"] < 50.0):
            raise AssertionError(f"obs_overhead gates failed: {rows[k]}")
    no_own_k5_k6(run["launches"], "the serve obs rows")
    fused += run["launches"]["paged_append_decode_attention"]
    line("obs_overhead", argv, run)
    torch.cuda.empty_cache()

    argv = ["--rounds", "1", "--round-sec", "0.3", "--storm",
            "--core-split", "--busbw"]
    run = perf_run(argv)
    rows = run["rows"]
    ops = {k: v["ops_per_s"] for k, v in rows.items() if "ops_per_s" in v}
    split = rows["core_split"]
    # the 13 rows of `build_matrix` and busbw
    if not (len(ops) == 14 and "allreduce_busbw_gbps" in ops
            and all(v > 0 for v in ops.values())
            and split["bottleneck"] in ("driver", "noded", "worker_pool")
            and split["noded_us_per_task"] > 0
            and split["worker_us_per_task"] > 0
            and rows["task_storm"]["tasks_per_s"] > 0):
        raise AssertionError(f"runtime matrix gates failed: {rows}")
    line("runtime_matrix", argv, run)

    argv = ["--config", "dag_calls", "--dag-calls-n", "500"]
    run = perf_run(argv)
    row = run["rows"]["dag_calls"]
    if not 0 < row["dag_us_per_call"] < row["actor_us_per_call"]:
        raise AssertionError(f"dag_calls gates failed: {row}")
    line("dag_calls", argv, run)

    argv = ["--config", "rllib_ppo", "--rllib-runners", "2",
            "--rllib-envs-per-runner", "4", "--rllib-rollout-len", "16",
            "--rllib-iters", "2", *dev]
    run = perf_run(argv)
    row = run["rows"]["rllib_ppo"]
    if not (row["accounting_exact"] == 1.0
            and row["env_steps"] == row["ledger_env_steps"] > 0
            and row["gang_devices"] == 2.0
            and row["env_steps_per_s"] > 0 and row["updates_per_s"] > 0):
        raise AssertionError(f"rllib_ppo gates failed: {row}")
    line("rllib_ppo", argv, run)
    torch.cuda.empty_cache()

    cli_run = perf_cli_default()
    emit({"phase": "perf_plane", "run": "cli_default_device",
          "argv": ["--engine-trace", "--engine-requests", "12", "--json"],
          **cli_run})
    wall = time.perf_counter() - t_phase
    emit({"phase": "perf_plane", "run": "summary", "wall_s": wall,
          "fused_launches": fused, "nvidia_smi": smi})
    return {"fused_launches": fused, "wall_s": wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--side"]:
        return run_side(sys.argv[2], sys.argv[3])
    rank_main = {"--shard-rank": shard_rank, "--moe-rank": moe_rank}
    if sys.argv[1:2] and sys.argv[1] in rank_main:
        rank_main[sys.argv[1]](int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.stdout.flush()
        # its readings are written: skip the interpreter's teardown, where
        # gloo's threads can abort the process
        os._exit(0)
    os.environ[RUN_TAG] = f"{os.getpid()}-{time.time_ns()}"
    try:
        return run_all()
    finally:
        # a failed phase's cluster too: nothing the run started outlives it
        if started_processes():
            print(json.dumps({"phase": "processes_at_exit",
                              **stop_processes(grace_s=5.0)}),
                  file=sys.stderr, flush=True)


def run_all() -> int:
    """Every phase in order; the kernels line, the card's line and the
    contract's last line."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    lease_dir = tempfile.mkdtemp(prefix="rtt_lease_")
    os.environ[LEASE_ENV] = os.path.join(lease_dir, "card")
    card_mem, host_cpu = CardMemory(), HostCpu()
    t_sides = time.perf_counter()
    sides = [Side("rllib")]

    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built})

    # K5 and K6 on their own: the decode step no longer launches them (the
    # fused op below does their work in one launch), so the kernels line
    # carries the serve run's 0 for both and this section's own launches
    # go on a line of their own
    reset_counts()
    emit({"phase": "K5_vs_plain", "shape": "L=32 B=8 W=16 BS=16 KV=8 hd=128",
          **check_append(device)})

    for B in (8, 32):
        errs = {}
        for kind_ in ("f32", "bf16", "int8"):
            case = attention_case(kind_, device, B=B, seed=B)
            errs[kind_] = check_attention(case, kind_)
        emit({"phase": "K6_vs_plain", "B": B, "H": 32, "KV": 8, "hd": 128,
              "BS": 16, "max_pos": 1024, "max_abs_err": errs,
              "tolerance": ATTN_TOL})
        del case
    # past the split walk's widths: hd 1,032 (the wide-head kernel) and
    # tables of 65,540 blocks (splits of more than the 1,024 staged
    # entries), each against the plain version; the fused op there too
    for what, kw in (("hd_1032", dict(B=4, max_pos=200, L=1, H=8, KV=2,
                                      hd=1032, BS=16)),
                     ("W_65540", dict(B=2, max_pos=65539, L=1, H=2, KV=1,
                                      hd=64, BS=1))):
        errs, fused_errs = {}, {}
        for kind_ in ("f32", "bf16"):
            case = attention_case(kind_, device, seed=7, **kw)
            errs[kind_] = check_attention(case, kind_)
            gen = torch.Generator(device=device)
            gen.manual_seed(7)
            fused_errs[kind_] = check_fused(with_new_rows(case, kind_, gen),
                                            kind_)
        emit({"phase": "K6_vs_plain_wide", "case": what, **kw,
              "W": int(case["tables"].shape[1]), "splits": k6_splits(case),
              "max_abs_err": errs, "fused_max_abs_err": fused_errs,
              "fused_bit_equal_to_k5_then_k6": True,
              "tolerance": ATTN_TOL})
        del case
    emit({"phase": "K5_K6_checks",
          "check_launches": {name: getattr(pa, name).launches
                             for name in PAGED}})
    case = attention_case("bf16", device, B=32, seed=32)
    bound, by = attention_bound(case)
    ms = time_ms(lambda: _run_attention(pa.paged_decode_attention, case))
    sdpa = time_ms(dense_sdpa(case))
    emit({"phase": "K6_timed", "B": 32, "H": 32, "KV": 8, "hd": 128,
          "BS": 16, "max_pos": 1024, "bf16_ms": ms,
          "bf16_plain_ms": time_ms(lambda: _run_attention(
              pa.paged_decode_attention_reference, case)),
          "bf16_bound_ms": bound, "bf16_bound_by": by,
          "bf16_library_ms": sdpa, "bf16_x_sdpa": ms / sdpa,
          "bf16_x_bound": ms / bound, "splits": k6_splits(case)})
    del case
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, params = _build_model("llama3_8b", seed=0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    served = run_main_path(cfg, params, device)
    emit({**served["line"], "init_s": init_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})

    with torch.no_grad():
        state = mid_decode_state(cfg, params, served["prompts"], device)
        routes = compare_routes(cfg, params, state)
        # K5 / K6 at the main path's shapes, on that state's layer-0 pool
        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        B, KV, hd = state["tok"].shape[0], cfg.n_kv_heads, cfg.head_dim
        app_case = {
            "k_pool": state["k_pool"], "v_pool": state["v_pool"],
            "k_new": torch.randn((B, KV, hd), generator=gen,
                                 device=device).to(cfg.dtype),
            "v_new": torch.randn((B, KV, hd), generator=gen,
                                 device=device).to(cfg.dtype),
            "tables": state["tables"], "pos": state["pos"], "layer": 0,
            "k_scale": None, "v_scale": None, "k_new_scale": None,
            "v_new_scale": None,
        }
        attn_case = {
            "q": torch.randn((B, cfg.n_heads, hd), generator=gen,
                             device=device).to(cfg.dtype),
            "k_pool": state["k_pool"], "v_pool": state["v_pool"],
            "tables": state["tables"], "pos": state["pos"], "layer": 0,
            "k_scale": None, "v_scale": None,
        }
        attn_err = check_attention(attn_case, "bf16")
        timings = time_kernels(app_case, attn_case)
        # K6 with its live KV (~7.6 MB) warm in L2: separates memory
        # latency from the walk's per-step compute and barriers
        k6_warm = time_ms(lambda: _run_attention(pa.paged_decode_attention,
                                                 attn_case), cold=False)
        # K5 folded into K6, against K5 then K6 and its plain version,
        # at the mid-decode state (the real pools in bf16; f32 and int8
        # pools of the same shapes and positions) and at B 32 with rows to
        # 1,024; timed beside the pair, K6 alone and an empty launch
        # fresh new rows: time_kernels already appended app_case's rows
        # into these pools, where a fused op that wrote nothing would
        # still match the pair
        mid = with_new_rows(attn_case, "bf16", gen)
        fused_t = {"launch_floor_ms": launch_floor_ms(device)}
        fused_errs = {}
        for shape in ("mid_decode", "B32"):
            errs = fused_errs[shape] = {}
            ms_ = {}
            for kind_ in ("f32", "bf16", "int8"):
                if shape == "mid_decode" and kind_ == "bf16":
                    case = mid
                else:
                    if shape == "mid_decode":
                        case = attention_case(
                            kind_, device, B=B, seed=8,
                            max_pos=int(state["tables"].shape[1]) * 16 - 1)
                        case["pos"] = state["pos"].clone()
                    else:
                        case = attention_case(kind_, device, B=32, seed=32)
                    case = with_new_rows(case, kind_, gen)
                errs[kind_] = check_fused(case, kind_)
                ms_[kind_] = time_fused(case)
                if kind_ == "bf16":
                    bound = fused_bound(case)
            emit({"phase": "K5K6_fused_vs_pair", "shape": shape,
                  "B": int(case["q"].shape[0]),
                  "W": int(case["tables"].shape[1]), "H": cfg.n_heads,
                  "KV": KV, "hd": hd, "BS": 16,
                  "pos": case["pos"].tolist() if shape == "mid_decode"
                  else "0-1024", "splits": k6_splits(case),
                  "bit_equal_to_k5_then_k6": True,
                  "max_abs_err_vs_plain": errs, "tolerance": ATTN_TOL,
                  "ms": ms_, "bf16_bound_ms": bound[0],
                  "bf16_bound_by": bound[1],
                  "launch_floor_ms": fused_t["launch_floor_ms"]})
            fused_t[shape] = ms_
            del case
        f_bound, f_by = fused_bound(mid)
        timings["paged_append_decode_attention"] = {
            "ms": fused_t["mid_decode"]["bf16"]["fused_ms"],
            "plain_ms": time_ms(lambda: _run_fused(
                pa.paged_append_decode_attention_reference, mid)),
            "bound_ms": f_bound, "bound_by": f_by, "library_ms": None,
        }
    k6 = timings["paged_decode_attention"]
    emit({"phase": "mid_decode_routes", **routes,
          "paged_decode_attention_ms": k6["ms"],
          "paged_decode_attention_warm_l2_ms": k6_warm,
          "paged_decode_attention_x_sdpa": k6["ms"] / k6["library_ms"],
          "paged_decode_attention_x_bound": k6["ms"] / k6["bound_ms"],
          "paged_decode_attention_splits": k6_splits(attn_case),
          "kernel_shapes": {"B": B, "W": int(state["tables"].shape[1]),
                            "pos": state["pos"].tolist()}})
    # the kernels are timed: the other side groups start beside the rest.
    # The serving phases below hold Llama-3-8B (~48 GB with int8_serve's
    # f32 copies) until its params are freed
    serving_lease = contextlib.ExitStack()
    serving_lease.enter_context(card_lease())
    sides += [Side(name) for name in SIDES if name != "rllib"]
    # the chunk as the engine replays it, against its eager chunk
    emit({**graph_vs_eager(cfg, params, state, device), "nvidia_smi": smi})
    # the perf harness's decode rows at the main path's width, on its model
    full_width = perf_decode_full_width(cfg, params, served["prompts"],
                                        device)
    emit({**full_width, "nvidia_smi": smi})
    # the prefill families' graphs against their eager programs, then the
    # int8 configurations served end to end
    emit({**prefill_graphs(cfg, params, served["prompts"], device),
          "nvidia_smi": smi})
    int8_run = int8_serve(cfg, params, served["prompts"], device)
    emit({**int8_run, "nvidia_smi": smi})
    # the replica loads its own Llama-3-8B: free the driver's copy first
    del params, state, app_case, attn_case, mid
    gc.collect()
    torch.cuda.empty_cache()
    serving_lease.close()

    emit(tiny_parity(device))

    emit({**serve_plane(cfg, served["prompts"], served["outs"]),
          "nvidia_smi": smi})
    torch.cuda.empty_cache()

    # K1-K4 against their plain versions
    flash_errs = {}
    for BH, T, D, kind_, causal in (
            [(32 * 12, 1024, 64, k, c) for k in ("f32", "bf16")
             for c in (True, False)]
            + [(64, 512, 128, k, c) for k in ("f32", "bf16")
               for c in (True, False)]
            + [(48, 1000, 64, "bf16", True), (16, 1000, 128, "bf16", True)]
            # a train_plane worker's shape: 4 x 16 heads at T 1,024
            + [(64, 1024, 128, k, True) for k in ("f32", "bf16")]
            # a pipeline_1f1b stage's shape: 1 x 32 heads at T 1,024
            + [(32, 1024, 128, k, True) for k in ("f32", "bf16")]
            + [(2, 256, D, k, True) for D in (712, 1032)
               for k in ("f32", "bf16")]):
        dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kind_]
        case = flash_case(BH, T, D, dt, causal, device, seed=T + D)
        errs_ = check_flash(case, kind_)
        emit({"phase": "K1-K4_vs_plain", "BH": BH, "T": T, "D": D,
              "dtype": kind_, "causal": causal, "ragged": T % 64 != 0,
              "column_slices": D > {"f32": 1024, "bf16": 704}[kind_],
              "max_abs_elementwise_relnorm": errs_,
              "tolerance": {n: flash_tol(n, kind_) for n in FLASH}})
        if (BH, T, D, kind_, causal) == (32 * 12, 1024, 64, "bf16", True):
            flash_errs = {n: e[0] for n, e in errs_.items()}
        del case
    torch.cuda.empty_cache()

    # the training main path, then the split route (K3 + K4)
    t0 = time.perf_counter()
    trained = run_training(device)
    emit({**trained["line"], "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    # the split route at the training shape with blocks of 256, and at the
    # reference's own split route: default blocks (1,024) at T 4,096 with
    # Llama-3-8B's head width
    split = split_route(device)
    emit(split["line"])
    torch.cuda.empty_cache()
    split_llama = split_route(device, B=1, T=4096, H=32, D=128, block=1024)
    emit(split_llama["line"])
    emit(route_parity(device))
    torch.cuda.empty_cache()
    # Llama's training half: the LoRA trainer at the bench's full size
    t0 = time.perf_counter()
    emit({**llama_lora_train(device), "wall_s": time.perf_counter() - t0,
          "nvidia_smi": smi})
    torch.cuda.empty_cache()
    # the train plane (two data-parallel workers sharing the card, a
    # resumed fit, the NCCL mode at one worker), then the sharded step
    # (four gloo ranks, fsdp 2 x tp 2) with sequence-parallel attention
    # on the same ranks
    sharded_launches = run_parallel_phases(device, smi)
    # Mixtral's widths trained
    with card_lease() as waited_s:
        t0 = time.perf_counter()
        emit({**mixtral_train(device, smi), "lease_wait_s": waited_s,
              "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    # the side groups (rllib's algorithms with their learners on the
    # card, compiled graphs with the tensor codec, a token dataset
    # streamed into the trainer's workers and a Tuner over it, expert
    # parallelism over a process group, a 1F1B pipeline of Llama-3-8B
    # blocks over the port's channels) end here: the planes below read
    # the whole card's memory
    walls = {side.name: side.join(timeout=900.0)["wall_s"]
             for side in sides}
    shutil.rmtree(lease_dir, ignore_errors=True)
    emit({"phase": "sides", "groups": {
        name: [f.__name__ for f in fns] for name, (fns, _) in SIDES.items()},
        "nice": {name: SIDE_NICE if yields else 0
                 for name, (_, yields) in SIDES.items()},
        "wall_s": walls, "window_s": time.perf_counter() - t_sides,
        "nvidia_smi": smi})
    # the operations plane: a GPU node scaled up on demand runs a durable
    # GPT-2 workflow, then submitted jobs, read through the dashboard
    ops = ops_plane(device, smi)
    emit(ops)
    torch.cuda.empty_cache()
    # the operator's surface: the cluster read through the CLI, GPT-2 as a
    # job submitted, read, listed and stopped from the shell, and flash
    # attention fanned out over a GPU pool's processes
    cli_run = cli_plane(device, smi)
    emit(cli_run)
    torch.cuda.empty_cache()
    # the port's perf harness: the engine, overload and decode rows on the
    # card, the runtime rows, and its command line's default device
    perf_runs = perf_plane(device, smi)
    torch.cuda.empty_cache()

    case = flash_case(32 * 12, 1024, 64, torch.bfloat16, True, device)
    flash_t, sdpa_bwd = time_flash(case, H=12)
    emit({"phase": "K1-K4_timed", "BH": 32 * 12, "T": 1024, "D": 64,
          "dtype": "bf16", "causal": True, **{
              name: flash_t[name] for name in FLASH},
          "k3_plus_k4_ms": flash_t["flash_bwd_dq"]["ms"]
          + flash_t["flash_bwd_dkv"]["ms"], "sdpa_bwd_ms": sdpa_bwd})
    del case
    torch.cuda.empty_cache()
    case = flash_case(32, 4096, 128, torch.bfloat16, True, device)
    split_t, sdpa_bwd = time_flash(case, H=32,
                                   names=("flash_bwd_dq", "flash_bwd_dkv"))
    emit({"phase": "K3_K4_timed", "BH": 32, "T": 4096, "D": 128,
          "dtype": "bf16", "causal": True, **split_t,
          "k3_plus_k4_ms": split_t["flash_bwd_dq"]["ms"]
          + split_t["flash_bwd_dkv"]["ms"], "sdpa_bwd_ms": sdpa_bwd})
    del case
    timings.update(flash_t)
    torch.cuda.empty_cache()

    # K7-K9 against their plain versions: the GPT-2 124M head (bf16 x with
    # the f32 master w, and all f32), the Llama-3-8B head, a ragged tiny
    xent_errs = {}
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    for N, E, V, x_kind, w_kind in ((32768, 768, 50257, "bf16", "f32"),
                                    (32768, 768, 50257, "f32", "f32"),
                                    (4096, 4096, 128256, "bf16", "bf16"),
                                    (200, 128, 300, "f32", "f32"),
                                    (200, 128, 300, "bf16", "bf16"),
                                    (130, 1032, 515, "bf16", "bf16")):
        case = xent_case(N, E, V, dts[x_kind], dts[w_kind], device,
                         seed=N + V)
        errs_ = check_xent(case, x_kind)
        line = {"phase": "K7-K9_vs_plain", "N": N, "E": E, "V": V,
                "x_dtype": x_kind, "w_dtype": w_kind,
                "max_abs_elementwise_relnorm": errs_,
                "tolerance": XENT_TOL[x_kind]}
        if E == 4096:  # Llama's head: K8 / K9 on the streamed path
            line["timed"] = time_wide_xent(case)
        emit(line)
        if (N, x_kind) == (32768, "bf16"):
            xent_errs = {n: e[0] for n, e in errs_.items()}
        del case
        torch.cuda.empty_cache()

    # the fused cross entropy's main path: GPT-2 124M's full head
    t0 = time.perf_counter()
    xent_run = xent_main_path(device)
    emit({**xent_run["line"], "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    case = xent_case(32768, 768, 50257, torch.bfloat16, torch.bfloat16,
                     device)
    xent_t = time_xent(case)
    emit({"phase": "K7-K9_timed", "N": 32768, "E": 768, "V": 50257,
          "dtype": "bf16", **xent_t})
    del case
    timings.update(xent_t)
    launches = {**served["launches"], **trained["launches"],
                **{n: split["launches"][n] + split_llama["launches"][n]
                   for n in ("flash_bwd_dq", "flash_bwd_dkv")},
                **xent_run["launches"]}
    # the workflow's `train` step, the CLI's job, the pool's workers and
    # the sharded step's ranks launch K1 / K2 in their own processes,
    # which return their counts
    for name in ("flash_fwd", "flash_bwd_fused"):
        launches[name] += (ops["train"]["launches"][name]
                           + cli_run["job"]["launches"][name]
                           + cli_run["pool"]["launches"][name]
                           + sharded_launches[name])
    # perf_plane's fused append + attention launches: its tiny engines' and
    # the measured full-width kernel row's; and the int8 phase's measured
    # runs'
    launches["paged_append_decode_attention"] += (
        perf_runs["fused_launches"]
        + full_width["launches"]["decode_b8_kernel"][
            "paged_append_decode_attention"]
        + sum(int8_run[n]["launches"]["paged_append_decode_attention"]
              for n in ("int8_weights_int8_kv", "int8_kv", "bf16")))

    errs = {"paged_kv_append": 0.0, "paged_decode_attention": attn_err,
            "paged_append_decode_attention": fused_errs["mid_decode"]["bf16"],
            **flash_errs, **xent_errs}
    # the card's memory and the host's CPU from the side groups' start
    emit({"phase": "load", "card_memory": card_mem.stop(),
          "host_cpu": host_cpu.stop(), "nvidia_smi": smi})
    # every process the phases started has ended: the clusters' daemons
    # and workers, jobs, pools and rank processes
    stopped = stop_processes()
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,process_name",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    emit({"phase": "processes", **stopped,
          "card_processes": apps.stdout.strip().splitlines(),
          "started": [[pid, cmd[:100], first, last] for pid, (cmd, first, last)
                      in sorted(_SEEN.items())]})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], **timings[name]}
        for name in (*PAGED, *FLASH, *XENT)
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


# ----------------------------------------------------------------------
# side groups: phases that run in a process of their own beside the main
# sequence
# ----------------------------------------------------------------------
# name -> (its phases in order, whether it yields the CPU to the main
# sequence).  `rllib` needs none of the port's kernels and starts with the
# run; the others start once the main path's kernels are timed
SIDES = {
    "rllib": ((rllib_phases, rllib_algo_phases, examples_phases), True),
    "rllib_last": ((rllib_last_phases, data_tune_phases), True),
    "graph": ((graph_phases, compiled_dag_phase), False),
}
# the nice value of a group that yields: the main sequence's phases, on
# the way to the groups' end, take the CPU first
SIDE_NICE = 10


def run_side(name: str, out_path: str) -> int:
    """One side group's phases in order (this process: `--side`); each
    emits its lines, which the main sequence relays.  A group that
    yields lowers its priority, and that of every process it starts."""
    phases, yields = SIDES[name]
    if yields:
        os.nice(SIDE_NICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = card_line()
    t0 = time.perf_counter()
    for phase in phases:
        phase(device, smi)
    with open(out_path, "w") as f:
        json.dump({"wall_s": time.perf_counter() - t0}, f)
    return 0


class Side:
    """A side group started now in a process of its own (it inherits
    the run's tag); its standard output is relayed line by line."""

    def __init__(self, name: str):
        self.name = name
        self.out = os.path.join(tempfile.mkdtemp(prefix="rtt_side_"),
                                "side.json")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--side", name,
             self.out], stdout=subprocess.PIPE, text=True,
            env={**os.environ, T0_ENV: repr(_T0), GROUP_ENV: name})
        self.relay = threading.Thread(target=self._relay, daemon=True)
        self.relay.start()

    def _relay(self) -> None:
        for line in self.proc.stdout:
            with _OUT_LOCK:
                sys.stdout.write(line)
                sys.stdout.flush()

    def join(self, timeout: float) -> dict:
        """Waits for the group's end; its readings, or raises if one of
        its phases failed (its traceback is on stderr)."""
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise AssertionError(f"side group {self.name} outlived "
                                 f"{timeout} s")
        self.relay.join()
        if rc != 0:
            raise AssertionError(f"side group {self.name} exited {rc}")
        with open(self.out) as f:
            got = json.load(f)
        shutil.rmtree(os.path.dirname(self.out), ignore_errors=True)
        return got


class CardMemory:
    """`nvidia-smi` reads the card's used MiB every 0.5 s until `stop`."""

    def __init__(self):
        self.samples = []  # (elapsed s, used MiB)
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=memory.used,memory.total",
             "--format=csv,noheader,nounits", "-lms", "500"],
            stdout=subprocess.PIPE, text=True)
        self.total_mib = None
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            try:
                used, total = (float(v) for v in line.split(","))
            except ValueError:
                continue
            self.total_mib = total
            self.samples.append((time.perf_counter() - _T0, used))

    def stop(self) -> dict:
        self.proc.terminate()
        self.proc.wait(timeout=30)
        self.thread.join(timeout=30)
        if not self.samples:
            raise AssertionError("nvidia-smi read no used memory")
        t_peak, peak = max(self.samples, key=lambda s: s[1])
        # the most a 10 s window held, window by window
        windows = {}
        for t, used in self.samples:
            k = int(t // 10) * 10
            windows[k] = max(windows.get(k, 0.0), used)
        return {"samples": len(self.samples), "total_mib": self.total_mib,
                "peak_used_mib": peak, "peak_at_elapsed_s": t_peak,
                "used_mib_max_per_10s": sorted(windows.items())}


# a side group's processes, and every process those start, carry its
# name here; the main sequence's carry none
GROUP_ENV = "CHIP_SMOKE_GROUP"


def _proc_kind(cmd: str) -> str:
    for key, kind in (("--shard-rank", "shard_rank"),
                      ("--moe-rank", "moe_rank"), ("--side", "side"),
                      ("chip_smoke.py", "main"), ("noded", "noded"),
                      ("worker_main", "worker"), ("scripts.cli", "cli"),
                      ("scripts.perf", "perf"), ("nvidia-smi", "nvidia-smi")):
        if key in cmd:
            return kind
    return "other"


class HostCpu:
    """Every second: the CPU seconds of each process this run started
    (utime + stime, by group and by kind of process), until `stop`.  A
    process that ends between two reads loses at most its last second."""

    def __init__(self):
        self.tag = f"{RUN_TAG}={os.environ.get(RUN_TAG, '')}".encode()
        self.hz = os.sysconf("SC_CLK_TCK")
        self.last = {}  # pid -> (group, kind, cpu s)
        self.per_10s = {}  # window -> {group: cpu s}
        self.threads = {}  # group/kind -> the most threads one process had
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _read(self, window: int) -> None:
        for name in os.listdir("/proc"):
            if not name.isdigit():
                continue
            try:
                with open(f"/proc/{name}/environ", "rb") as f:
                    env = f.read().split(b"\0")
                if self.tag not in env and int(name) != os.getpid():
                    continue
                with open(f"/proc/{name}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
                with open(f"/proc/{name}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode(
                        errors="replace")
            except OSError:
                continue
            group = "main"
            for e in env:
                if e.startswith(GROUP_ENV.encode() + b"="):
                    group = e.split(b"=", 1)[1].decode()
            cpu = (int(fields[11]) + int(fields[12])) / self.hz
            pid = int(name)
            kind = _proc_kind(cmd)
            before = self.last.get(pid, (group, None, 0.0))[2]
            self.last[pid] = (group, kind, cpu)
            key = f"{group}/{kind}"
            self.threads[key] = max(self.threads.get(key, 0),
                                    int(fields[17]))
            w = self.per_10s.setdefault(window, {})
            w[group] = w.get(group, 0.0) + cpu - before

    def _run(self) -> None:
        while not self.done.wait(1.0):
            self._read(int((time.perf_counter() - _T0) // 10) * 10)

    def stop(self) -> dict:
        self.done.set()
        self.thread.join(timeout=30)
        by_group, by_kind = {}, {}
        for group, kind, cpu in self.last.values():
            by_group[group] = by_group.get(group, 0.0) + cpu
            key = f"{group}/{kind}"
            by_kind[key] = by_kind.get(key, 0.0) + cpu
        return {"cpus": os.cpu_count(), "processes": len(self.last),
                "cpu_s_by_group": by_group, "cpu_s_by_group_kind": by_kind,
                "max_threads_by_group_kind": self.threads,
                "cpu_s_per_10s_by_group": sorted(self.per_10s.items())}


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run_parallel_phases(device, smi: str) -> dict:
    """The train plane's main path and its NCCL mode, then the sharded
    step over four ranks with ring and Ulysses attention on the same
    ranks; returns the sharded step's K1-K4 launches over its ranks."""
    t0 = time.perf_counter()
    tp = train_plane(device)
    plane, nccl = train_plane_lines(tp, smi)
    emit({**plane, "wall_s": time.perf_counter() - t0})
    emit(nccl)
    torch.cuda.empty_cache()
    with card_lease() as waited_s:
        sharded, sp, sp_train_, moe_, launches = sharded_train(smi)
    emit({**sharded, "lease_wait_s": waited_s})
    emit(sp)
    emit(sp_train_)
    emit(moe_)
    return launches


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:
        import traceback

        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # every process the run started is stopped and every line is written:
    # end here, so that no thread a phase left (an executor's, the
    # profiler's, a collective's) holds the process open in the
    # interpreter's teardown
    os._exit(rc)
