#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths (torcheasyrec_tpu_torch) with seeded random
weights: DLRM-HSTU serving and training at the full width of the repo's
DLRM-HSTU lane (benchmark/bench_dlrm_hstu.py: batch 32, tables
10k x 256 and 100k x 256, STU 512/128/128, 4 heads, 3 layers, histories
up to 4000 tokens and 16 candidates, max_seq_len 4032, BF16, sparse
rowwise_adagrad lr 0.01, dense adam lr 0.001), and DeepFM training on
Criteo-shaped data (the config of the repo's train benchmark, bench.py:
26 id features at dim 16 plus their WIDE copies at dim 4, 13 dense
features, batch 8192, deep 512-256-128, final 128-64, BF16, sparse
rowwise_adagrad and dense adam at lr 0.001) with the tables at the
reference's real bucket sizes, uncapped, fp32 and packed; and the
Criteo ranking, multi-task and retrieval zoo: the port's copies of
twelve of the JAX package's criteo_synth quality-benchmark configs
(Wide&Deep, DLRM, DCN-v2, MaskNet, MMoE, PLE, DBMTL; batch 4096, 26
tables of dim 16 at the configs' buckets, BF16, sparse rowwise_adagrad
lr 0.01, dense adam lr 0.001; MultiTowerDIN, MMoE with a sequence
group, RocketLaunching, DBMTL with the JRC loss; and DSSM two-tower
retrieval with 32 sampled negatives a batch) on the JAX package's
synthetic Criteo data; and the training loop's options (FP16 with the
grad scaler, clipping and accumulation on DLRM-HSTU, the six further
sparse optimizers and BF16/FP16 tables on DeepFM, part optimizers,
train metrics and every eval metric on DBMTL); and the generative-
recommendation family (hstu_synth's DLRM-HSTU at its published width,
DLRM-HSTU with the content/action preprocessors, SLA and attention
truncation, ULTRA-HSTU and HSTU-Match); and the rest of the ranking and
multi-task zoo (xDeepFM, WuKong, PEPNet, DC2VR) on the synthetic Criteo
data; and export and artifact serving; and TDM tree retrieval. Phases,
one JSON line each:

1. env: the card, CUDA and torch versions; every CUDA kernel of the
   paths is built from the sources here (one nvcc per source, in
   parallel), with each kernel's registers, static shared memory and
   spills as ``ptxas -v`` reports them.
2. kernel, kernel_bwd: each attention kernel against its plain PyTorch
   version on the card, at the slice's shapes and over a sweep of every
   mask variant, head-dim pair, lengths at the 64- and 128-row tile
   edges, an SLA window shorter than a tile and batches wider than the
   card, fp32 and bf16, and the generative family's real shapes (B=128,
   H=4, D=V=32 at N=43 and 48, interleaved N=85, truncated N=27, SLA and
   window channels; HSTU-Match's D=V=16 at N=18 in fp32, the one dtype
   whose kernels take head dim 16); and with NaN in the padded rows of every input,
   where the result must be finite and equal to the plain version's on
   the inputs with those rows zero. Tolerance: max|kernel - plain| <=
   1e-4 * max|plain| in fp32 (TF32 off), <= 2e-2 * max|plain| in bf16
   (bf16 keeps ~3 significant digits and the sums run in another order),
   per output or gradient. kernel_bwd also holds both kernels, through
   the autograd Function, against autograd of the plain forward.
   kernel_row_write: the row-write kernel against its plain version,
   bit-equal over the whole table (a copy has no tolerance), at the
   slice's shape (the dim-16 group's table of 29.2 M physical rows of 128
   lanes, 73 728 rows written, >= 30% of them on the scratch row), at the
   real DeepFM step's targets of both packed groups (rebuilt from its
   seeded batch) and over a sweep: unique ids, many duplicates on the
   scratch row, negative and too-large ids, 1, 5, 1003, 2061 and 294 912
   rows, the last real row (past the 2^32-byte line), int32 ids, ids in
   slices off the 16-byte line, a 2-row table, 256 lanes; the step's
   shapes and several others also through the table less its scratch
   row (the writes to it dropped, as the engine calls the kernel).
   Device times (the host's cost per call hidden behind a sleep kernel),
   warm (the rows just written, as in the step) and cold (rows rotated
   over 100 MB, twice the L2 cache), with rate and share of the bound, at
   the slice's shape and the real targets of both groups, each as it is,
   with the scratch writes dropped and with no duplicate on the scratch
   row, and at K = 1024, 8192, 73 728 and 294 912 unique rows; the plain
   version, ``index_copy_`` (on the targets less the scratch entries) and
   a one-row launch at the real dim-16 targets.
3. slice: 4 requests of 32 through the port's eval step, then 2 of them
   again through ``predict_checkpoint`` (parquet in, parquet out, through
   the predict-mode loader; the reserved column ``user_id`` must come
   through unchanged), with
   the kernel launch counts set to 0 just before and read just after;
   outputs must be finite with probabilities in (0, 1), the two entry
   points must agree, and the whole model with the kernel must match the
   whole model with the plain attention on a batch of 8 at the bf16
   tolerance.
4. train: 6 steps of 32 through ``make_train_step``, then 2 steps through
   ``train_and_evaluate`` from a parquet file and a
   ``predict_checkpoint`` of its checkpoint, again with the launch counts
   set to 0 just before and read just after. Every loss must be finite,
   the loss on a repeated batch must fall (all dropout ratios are 0),
   rows the batches never touched must keep their bits and their
   accumulator its initial value, touched rows must change, each kernel
   must launch once per STU layer and step. On a batch of 8, at the
   trained weights, the dense gradients of the whole model with the
   kernels are held against those with the plain attention: in fp32
   within 1e-4 of each gradient's max; in bf16 against the noise floor,
   since two bf16 forwards that differ only in rounding already move these
   gradients by several percent (ReLU gates flip, sums of random signs
   cancel): each gradient's relative distance from the fp32 gradient must
   be at most three times the plain bf16 model's, floored at 2^-8, bf16's
   resolution, plus 1e-3 (the two are equal within a factor of 1.5 when
   the kernels are right, tens apart when they are not; a gradient of one
   element can land far below one ulp from the fp32 one in one model and
   not in the other).
5. timing, timing_train: median request and step time, each kernel's time
   beside the plain version's and the card's bound at the slice's shapes
   (with its TFLOP/s, its share of the bound and the time of the WMMA
   kernel it replaced), and a profile of one forward and of one train step
   by device kernel.
6. train_deepfm: warm-up and 30 timed steps on a resident batch through
   ``make_train_step`` at the uncapped sizes (19.1 GB of packed tables
   with their in-row accumulators), the same with the dense lane off;
   then, with the five 40 M-row tables capped at 10 M so that several
   models fit side by side and the checkpoint stays at 5 GB, 3 steps over
   distinct batches from a parquet file, an eval pass and the checkpoint
   through ``train_and_evaluate``, ``evaluate`` of that checkpoint, and a
   restore into a fresh model. The row-write launch count is set to 0
   before the driven steps and read after them. Checks: finite losses;
   the loss on the repeated batch falls; exactly 2 row-write launches
   per step; sampled physical rows that the batch did not touch keep
   their bits and touched ones change; in fp32 steps from the same
   weights and batches the packed engine agrees with the unpacked one,
   and the dense lane on with off, per table through ``extract_table``
   and ``extract_table_state``: within 1e-5 of each table's largest
   magnitude after 1 step; after 3 steps within 1e-3 of it, with at
   most 1e-5 of all elements beyond 1e-5 (atomic sums make even two
   runs of one layout differ, and rowwise adagrad's first update of a
   row amplifies that where a gradient nearly cancels; a second run of
   the packed engine is reported beside the other layouts; fp32 so that
   bf16 rounding flips add nothing); ``evaluate`` reproduces the AUC of
   ``train_and_evaluate``; the restored model holds the checkpoint's
   tables and row state bit for bit.
7. train_loader: the uncapped DeepFM trained from a directory of nine
   parquet files of uneven row counts (330 811 rows, row groups of
   10 000, ids drawn below the 10 M cap) through the port's loader and
   the training loop's body (``main.train_epoch``): two epochs with the
   thread prefetch, two with 4 worker processes (one with a synchronise
   after every step for the median, one timed as a window). It prints
   the loader alone (examples/s, batches only read, parsed, pinned and
   copied), one batch's host-to-device copy (per tensor as the loader
   copies, from pageable memory, and as one coalesced buffer of the same
   bytes), the loader-fed and the resident-batch step of the same model,
   and the device's idle share over 10 profiled loader-fed steps.
   Checks: each epoch consumes every row once but each shard's final
   remainder (by a row-id column carried as a reserved column), exactly
   2 row-write launches a step. Then, at the capped tables,
   ``train_and_evaluate`` for 10 steps with a save and an eval every 4
   steps, 2 checkpoints kept, a glob as the eval input and an
   ``eval_batch_size`` of 6 000; a second model dir trains 4 steps
   (``edit_config_json``) and resumes with ``continue_train`` to 10.
   Checks: the kept files, one eval line per save, the eval batches, the
   step counts, the watermark of the step-4 checkpoint (mid-file), the
   rows the resumed run reads (those of the straight run's steps 5-10),
   and the resumed tables and row state against the straight run's within
   3x the run-to-run noise (a third run of the same steps in memory),
   floored at 1e-3 of each table's max and 1e-5 of the elements.

8. train_zoo: the criteo_synth data written by the port's generator
   (``benchmark/synthetic.ensure_dataset``: 262 144 train rows from seed
   1, 65 536 eval rows from seed 2, and the sampler's 2 000-item
   table), then for each of the twelve configs, its paths redirected:
   one epoch through ``train_and_evaluate`` (64 steps of 4096 through
   the loader, an eval pass at the end), with the
   row-write count set to 0 just before and read just after; ``evaluate``
   and ``predict_checkpoint`` (the first 2 eval batches) of its
   checkpoint; then its step on a resident batch (median of 6
   synchronised steps after 3 of warm-up, a 6-step window, the idle
   share of 3 profiled steps, peak memory; 10, 5, 10 and 5 before
   train_zch_ranks and train_stream joined). Checks: exactly 64 steps and
   one row-write launch a step per packed group with tables past the
   dense lane (2 for Wide&Deep, 0 for DSSM, 1 for the others), the timed
   steps too; finite losses; every AUC of the config's pinned labels
   (``benchmark/configs/base_eval_metric.json``, from the JAX package on
   a TPU) within 0.02 of its label, the bound the JAX package's own run
   off the TPU uses (the distance to the pinned 0.005/0.006 threshold is
   printed, not checked); DSSM's recall@1 and recall@5 too, and since
   they swing with the initial weights by far more than 0.02, DSSM's
   card run starts from weights drawn on the CPU and is also trained on
   the CPU from them: each recall on the card within 0.02 of the CPU's;
   ``evaluate`` reproduces the trainer's metrics; the
   predicted ``probs_*`` finite in (0, 1) and every column equal to the
   eval step's outputs on those rows (through predict's loader: no
   sampler). For DLRM and MultiTowerDIN, the ``write_rows`` calls of one
   real train step are captured, and the kernel and the plain version
   applied to copies of the table before it must leave tables equal bit
   for bit to each other and to the step's; so must they at one DSSM
   step with the dense lane off (its two packed groups, counted under
   their own path in the ``kernels`` line). Last, DSSMV2 with hard
   negatives and MIND, which no published config runs: one loader batch
   through the forward and backward of the same weights on the CPU and
   on the card, the outputs, loss and dense gradients within 1e-4 of
   each one's max.

9. train_options: the training loop's options. (a) Both attention
   kernels in fp16 against their plain versions (5e-3 of the plain max:
   fp16 keeps 11 bits, the sums run in another order) at the slice's
   shapes and over the mask sweep, and the backward under an upstream
   gradient that overflows fp16 in dz and dv: inf or NaN exactly where
   the plain version has them; their fp16 times beside the plain
   versions' and the bound. The lane's DLRM-HSTU in FP16 with the grad
   scaler, norm clipping at 1.0 and accumulation over 2 steps: 8 steps
   through the options' train step, exactly 3 forward and 3 backward
   launches a step (counts set to 0 just before, read just after), 4
   dense updates, finite losses; the whole model with the kernels
   against the plain attention at the fp16 bound; then ``init_scale``
   2^30 on one repeated batch: the overflowing steps skipped with every
   table bit-equal across each, the scale backing off to finite steps,
   the loss falling. (b) criteo_synth DeepFM at its published width
   (buckets capped at 100 000, batch 4096, fp32 compute so that card and
   CPU can be held close) under each of the six new sparse kinds, with
   rowwise adagrad (the slot-17 reference) and with BF16 and FP16 tables:
   each group's (slot, rows per physical row), 5 steps with one row write
   a step per packed group, one real step's writes bit-equal to the plain
   version, the tables after step 1 within 1e-5 of each table's max of a
   CPU step from the same weights (one unit in the last place for BF16
   and FP16 tables); the row write timed at the slot-48 layout (lamb)
   beside the slot-17 one. (c) criteo_synth DBMTL through
   ``train_and_evaluate`` for one epoch (8 batches of 4096) with part
   optimizers on its towers, train metrics (logged), every eval metric
   kind (a third tower of 3 classes for those that read [B, C]) and a
   table ``init_fn``: each eval metric equal to its recomputation in
   numpy from the predictions ``predict_checkpoint`` writes.

10. train_gr: the generative-recommendation family. The hstu_synth data
   (``benchmark/synthetic.ensure_hstu_dataset``: 20 480 train rows from
   seed 11, 4 096 eval rows from seed 12) and its DLRM-HSTU config at the
   published width (E 128, hidden and attention dim 32, 4 heads, 3
   layers, max_seq_len 48, batch 128, fp32, the model seed 42's weights
   drawn on the CPU, so that a CPU run from them compares): two epochs
   (320 steps) through
   ``train_and_evaluate``, each AUC within 0.02 of its pinned label (the
   distance to the pinned threshold printed), ``evaluate`` equal to the
   trainer's metrics, ``predict_checkpoint`` of the first 2 eval batches
   equal to the eval step's outputs bit for bit. Then three models at
   that width, each 2 fp32 steps on the card and on the CPU from the same
   CPU-drawn weights and loader batches, the training-mode loss, every
   prediction and every dense gradient within 1e-4 of the CPU's max
   before each step (a structural zero gradient must be zero on the
   card): DLRM-HSTU with target interleaving, an MLP content encoder, a
   parameterized content MLP, SLA and truncation after layer 1 to a tail
   of 16; ULTRA-HSTU with two channels (a max_attn_len window, SLA); and
   HSTU-Match (the JAX package's integration config: grouped sequence
   features, the sampler's 32 negatives in sequence mode, the UIH
   preprocessor with an action encoder, the query-time anchor, head dim
   16), after one epoch of it through ``train_and_evaluate`` (recall@1
   and @5). Adam's eps is 1e-4 in the card-against-CPU steps. The
   attention and row-write launches of all this are counted (set to 0
   just before, read just after). Last the hstu_synth step on a resident
   batch (median, window, idle share, peak memory), one epoch through the
   loader, and kernels #1 and #2 at hstu_synth's shape in fp32 (device
   time per launch, the plain version's, the bound of this data's work
   at the fp32 peak, its bytes over each sample's real rows).

11. train_zoo_rest: the rest of the ranking and multi-task zoo on the
   criteo_synth data (65 536 train and 16 384 eval rows), four configs with assumed widths on the port's
   criteo_synth header (no published config of these models is in the
   repository, and none has a pinned label): xDeepFM (CIN 128-128-128 over
   the fm group, deep 512-256-128 with batch norm), WuKong (three layers of
   LCB 24 and FMB 24 over the 26 sparse features and 8 from the dense
   MLP, PReLU in the final MLP, variational dropout), PEPNet (EPNet over
   a domain group, PPNet towers 512-256-128 gated by priors, Pareto loss
   weights) and DC2VR (a Dice bottom, MMoE of 4 experts, the cvr tower
   intervened by the ctr tower within its task space). Each config first
   1 fp32 step on the card against the CPU from the same CPU-drawn
   weights and batches, the variational-dropout noise given to both:
   losses, predictions, dense gradients, and after the steps every
   tensor of the state dict (batch-norm statistics and tables included)
   and the row state, within 1e-4 of each tensor's CPU max. Then as the
   zoo's configs: an epoch through ``train_and_evaluate`` from the
   default seed's CPU-drawn weights (xDeepFM's cut to 4 steps, its CPU
   epoch taking minutes; WuKong's and PEPNet's to 4, DC2VR's to 8), each AUC within
   0.02 of a CPU run of the same config from them, exactly one row write a step per written
   packed group (two for xDeepFM), ``evaluate`` and ``predict_checkpoint``,
   the resident step; xDeepFM's real step's row writes bit-equal to the
   plain version; and ``feature_selection`` on WuKong's checkpoint: each
   drop probability equal to sigmoid(logit_p) of the saved weights.

12. export: export and artifact serving. The lane's DLRM-HSTU (slice
   weights, bf16) saved as a checkpoint and exported (``main.export``:
   weights, config, fg.json, ``predict_fn.pt2``); the program loaded by
   ``torch.export.load`` in a fresh process that imports torch and
   ``torcheasyrec_tpu_torch.ops.hstu`` only, run on the traced batch:
   kernel #1 once per STU layer (the wrapper's count and a profiler trace
   of the forward), the outputs against the eager eval step's (bit-equal
   printed, held at the bf16 bound), its forward ms beside the eager
   one's; ``predict`` from the artifact on two slice requests bit-equal
   to ``predict_checkpoint``. The lane's STU stack decoding: a prefill
   of 2 048 tokens then 4 one-token decodes against the full forward's
   rows (bf16 bound). Per-tower artifacts of criteo_synth dssm and of
   HSTU-Match (whose user tower program holds the attention operator,
   fp32 at head dim 16): each tower's embeddings from its artifact
   against the whole model's on the same rows (1e-4 of the max).
   criteo_synth deepfm trained 4 steps with the delta dump every 2 (row
   writes counted): every shard's ids equal to the ids its batches look
   up (parsed on the host), its rows equal to the step's checkpoint;
   then its fp32 and INT8 artifacts: the INT8 tables bit-equal to a CPU
   quantization of the same weights, the INT8 probabilities within 0.05
   of the fp32 artifact's. Export seconds and bytes per artifact.

13. train_tdm: TDM tree retrieval on the criteo_synth data at assumed
   widths (``tdm_text``; the upstream Taobao example's model, which is
   not in the repository): the tree of the 2 000 items (``init_tree``,
   4 001 nodes, leaves at depth 11); ``TDMSampler.process`` timed on the
   host (a batch of 1 024 rows becomes ~46 800 pairs); the sampler's
   shared table on a synthetic item table of 1 M items (cut to half of
   /dev/shm's free space): the build, the segment's bytes, and the
   memory of 2 spawned workers that attach against one that unpickles a
   private copy (each worker's own growth, and the host's MemAvailable
   while they hold their mappings: the attached workers' growth must be
   under a quarter of the copy's, by the workers' own counters where
   they separate shared memory, else by the host's). 2 fp32 steps on the
   card against
   the CPU from the same CPU-drawn weights and sampled batches, as
   ``train_zoo_rest``'s (1e-4 of each tensor's max, the card's PReLU
   branches replayed on the CPU). TDM_STEPS steps (cut from 64: the CPU
   reference's time) through ``train_and_evaluate``
   from the default seed's CPU-drawn weights with 4 loader workers on the
   shared tables, and an eval of TDM_EVAL_ROWS rows: exactly one row write a step
   (the wrapper's count, and 3 in the trace of steps 3-5), the AUC within
   0.02 of a CPU run from the same weights; the step on a resident
   sampled batch (median, window, idle share, peak memory) with its row
   writes bit-equal to the plain version's, and the loader-fed step.
   ``export``: every tree node's embedding from ``embedding/`` by
   ``predict`` in a process of its own, and its ``tower_fn.pt2`` on its
   batch, bit-equal to ``node_embedding``; ``model/``'s ``predict``
   bit-equal to ``predict_checkpoint``. ``cluster_tree`` over the 2 000
   leaf embeddings from the artifact, TDM_RETRAIN_STEPS steps (cut from
   32) on the new tree from the
   trained weights (one row write a step), and ``tdm_retrieval``
   (recall@50, 2 clusters, TDM_RETRIEVAL_USERS eval users) on each tree, on the card
   within 0.02 of the CPU from the same checkpoint, with its ms per user
   and per beam layer and the host's share.

14. train_sharded: training over ranks on ``torch.distributed``. The
   ranks are spawned here (``dist_util.spawn_ranks``: a ``FileStore``
   under TMPDIR, a time limit a spawn; a rank that raises fails the
   phase). With two cards or more each rank has its own card on NCCL;
   with one, the two ranks share it through gloo, and a one-rank NCCL
   group shows NCCL's init and collectives on the card; the line names
   which ran. Part 1: criteo_synth DeepFM on one NCCL rank with every
   table ``row_wise`` (``embedding_constraints``), 3 steps, every table
   within 1e-5 of its max of an unsharded rank's. Part 2: the uncapped
   Criteo DeepFM (204.2 M rows) at world size 2 under the planner's plan
   (printed with its estimate), global batch 8 192 in BF16, 3 steps,
   against a run at world size 1 on the same global batches whose
   products take the ranks' row blocks (so BF16 rounds each row as a
   rank does), both under PyTorch's deterministic algorithms: after 1
   step the touched rows, their row state, the dense parameters and
   adam's moments within 1e-5 of each tensor's max (the row state and
   the moments carry the gradient's scale); after 3 the rows and row
   state within 3x the distance of a second world-1 run on the rows
   permuted within the blocks (floored at 1e-5); a sample of
   untouched rows bit-equal to the init, the init equal to world size
   1's; the dense parameters bit-equal across ranks; kernel #3 once per
   packed group, rank and step, and one step's writes on a rank held
   against the plain version bit for bit; per rank the step median, peak
   memory, exchange bytes a step and the idle share of 5 profiled steps.
   Parts 3 and 5 (one spawn), each against a one-rank run whose
   products take the ranks' row blocks: criteo_synth DeepFM in fp32
   under each of the five layouts, forced, within 1e-5 after 3 steps
   (tables, row state and dense parameters; replicated tables and dense
   parameters equal across ranks), and hstu_synth's DLRM-HSTU (jagged
   candidates, kernels #1/#2 on each rank), DSSM with sampled negatives
   (the ranks share the sampled rows) and with in-batch ones, DeepFM with
   MLP batch norm, within 1e-4; each bound raised to 3x the distance of a
   second one-rank run on the rows permuted within the blocks where that
   is larger. Batch norm is held first where no optimizer amplifies it:
   one step's loss and batch means and variances within 1e-5 of each
   tensor's max, the dense gradients within 1e-4 of the largest, and the
   same step with each rank's own statistics (the fault) outside the
   first bound. Part 4 in the same spawn: one criteo_synth DeepFM epoch
   through ``train_and_evaluate`` at world size 2 (each rank its files,
   2 048 rows a rank), ``evaluate`` at world size 2 equal to world size
   1's to 1e-6 and within 0.02 of the pinned AUC, the checkpoint
   restored at world size 1 bit for bit.

Phase ``train_zch``: criteo_synth DeepFM at
its published width with eight of its 100 000-bucket features as 32 768
slot ZCH (lfu, lru, distance_lfu) and dynamicemb tables (the host spill
tier, frequency admission) and four tables host-offloaded
(``zch_text``). 2 fp32 steps on the card against the CPU after a shared
warm ZCH state: remapped slots, ZCH state, spill keys and restored slots
bit-equal, tables, row state and dense parameters within 1e-4 of each
tensor's max, untouched rows bit-equal, the host tables within 1e-5 of a
run with them on the card; an epoch cut to ZCH_STEPS through
``train_and_evaluate`` (BF16) with kernel #3 once per written packed
group and step (and once per spill restore into it), spills and
restores, its AUC within 0.02 of a CPU run
from the same weights, its loop's step times, ``evaluate`` and
``predict_checkpoint``; a resume bit-equal to the straight run; the export's ``predict`` in a
fresh process and its loaded program bit-equal; the TensorBoard tags; the
step, its host work and the remap's device time beside the same config
without ZCH.

Phase ``train_sid``: semantic-ID generation
at the widths of TIGER's RQ-VAE (Rajput et al., "Recommender Systems
with Generative Retrieval", NeurIPS 2023: 768-d item content vectors,
an encoder 512-256-128 to a latent of 32, 3 levels of 256 codes, batch
1 024) on 32 768 synthetic clustered items (``sid_items``). 2 fp32
steps on the card against the CPU from the same CPU-drawn weights and
batches, the CPU's codes replayed on the card where its two least
distances lie within SID_TIE_GAP (``CodeReplay``, flips counted): loss,
outputs, gradients and the state dict within 1e-4 of each tensor's
max, the codebooks' gradients 0; an epoch through ``train_and_evaluate``
with ``unique_ratio`` and ``rel_loss`` within 0.02 of a CPU run from
the same weights, ``evaluate`` equal to it, ``predict_checkpoint``'s
``codes`` through both SID tools with CSV output (the quality tool's
unique share equal to ``unique_ratio``); the resident step, its idle
share, and the host ms of the 768-wide list column's parse. RQ-KMeans
(codebooks 256 x 3, ``train_sample_size`` 32 768): the fit's seconds on
the card, and a fit on SID_KMEANS_CHECK samples against the CPU's with
the CPU's assignments replayed (codebooks within 1e-4, codes equal).
criteo_synth deepfm.config at its published width read from CSV, its
int_0..int_11 through AutoDis (16 channels, assumed), int_12 through an
MLP embedding, cat_1's table sized by a vocab file: 3 fp32 steps card
against CPU (1e-4), 12 BF16 steps through ``train_and_evaluate`` with
kernel #3 once per written packed group and step and the AUC within
0.02 of a CPU run, one real step's row writes bit-equal to the plain
version, and the CSV loader's examples/s beside the parquet loader's.

Phase ``train_fg``: feature generation from
raw columns. The FG library (``fg/csrc/fg_ops.cc``) is built with g++
beside the CUDA kernels. (a) The Criteo DeepFM at full width (tables
capped at 10 M, BF16, batch 8 192) fed raw log columns: C1..C26 as
8-hex-digit strings hashed into the tables, I1..I13 as integer strings
through log10. FG's host ms per batch through the native DAG at
fg_threads 1 and 4 and through the plain per-feature parses, each DAG
batch bit-equal to the plain one; the loader alone with FG and with
FG_NONE on the same rows; the loader-fed step over 4 workers with its
idle share (5 profiled steps) against the resident step, kernel #3 once
per written packed group and step; 3 fp32 steps card against CPU (1e-4,
tables capped at 100 000). (b) A MultiTowerDIN with one feature of every
kind (``benchmark/fg_synth.py``; widths assumed), 4 096 rows a batch,
fp32: each kind's host ms, 3 steps card against CPU (1e-4), 8 steps
through ``train_and_evaluate`` with kernel #3 once per written group
and step and the AUC within 0.02 of a CPU run from the same weights.
(c) Its export (the artifact's fg.json equal to
``tools/create_fg_json``'s) and ``predict`` on requests of 1 user x 512
items with INPUT_TILE=2, bit-equal to predict without it, the user-side
features parsed once a request, the request times tiled and untiled.

Phase ``train_zch_ranks``: ZCH and dynamicemb tables over two ranks on
the one card (gloo, as ``train_sharded``). criteo_synth DeepFM with four
of its 100 000-bucket features as dynamicemb tables of 1 048 576 slots,
``row_wise`` and packed (``zr_text``), 3 steps of global batches of
4 096 (2 048 a rank): the ZCH mappings bit-equal on both ranks, to a CPU
remap of the global batches and to a one-rank card run; every table's
touched rows within 1e-5 of each table's max of that run, whose products
take the ranks' row blocks (``row_blocks``); kernel #3 once per packed
block, rank and step; the checkpoint (its save checks the mappings equal
on the ranks) evaluated at world sizes 2 and 1; a resume from it at
world size 2 bit-equal to the trained model's next step; the step at
world sizes 2 and 1; and a restore probe (``zr_restore_probe``): a key
written into an 8-slot ``row_wise`` packed table, flooded out, stored by
the rank that holds its slot, readmitted and written back by kernel #3,
read back bit for bit. Its ranks then run phase ``train_pipelined``'s
part (a), whose phase checks and prints it.

Phase ``train_stream``: the criteo_synth
DeepFM fed from Kafka, an in-memory broker standing in for
``confluent_kafka`` (no broker, no network; printed): two partitions of
the synthetic Criteo rows as JSON messages. 8 steps on the card through
``train_and_evaluate`` with kernel #3 once per written group and step,
the AUC within 0.02 of a CPU run from the same weights and broker; a
resume at step 4 that continues each partition at offset + 1, bit-equal
to the straight run; the loop's step beside the same steps fed from the
parquet file. Then a TF-EasyRec DeepFM config over the Criteo columns
through ``tools/convert_easyrec_config``, 4 steps on the card (kernel #3
counted) and its checkpoint listed whole by ``tools/list_ckpt_param``.

Phase ``train_pipelined``: the training
loop's two overlaps, each against the loop without it from the same
weights and input. (a) ``sparse_dist_overlap`` over two ranks on the
card (gloo, as ``train_sharded``): criteo_synth deepfm.config at its
published widths, BF16, packed, every cat table ``row_wise``, global
batch 4 096 from a train file a rank, ``PIPE_STEPS`` steps through
``train_and_evaluate`` once unpipelined (a rank's first run is slower
throughout: not timed against), then pipelined (the next batch's id
exchange staged on the side group while the step runs) and unpipelined
in turns, twice each, on the ranks of ``train_zch_ranks`` after their
own work where that phase ran (``PIPE_DONE``; a spawned rank's first
``train_and_evaluate`` pays ~15 s of start-up), else on ranks of its
own: results, eval
and the checkpoint (tables, row and dense optimizer state) 0.0 apart,
every step staging the next batch's route; each run's step median, the
main thread's routing or staged-route wait a step, kernel #3's launches
a rank. (b) The host-offloaded ZCH DeepFM of ``train_zch`` (``zch_text``)
with the host-row prefetcher off and on in turns, twice each
(``TZREC_HOST_PREFETCH``): results and checkpoints 0.0 apart, the
prefetch serving every step but
the first; each run's step median and the host wait a step (the rows'
gather or the prefetch's join, the host apply, the repair).

Phase ``train_global_reductions`` (last before the timeline): the
reductions over the global batch at world size 2 (gloo, as
``train_sharded``; its ranks those of ``train_zch_ranks`` after their
other work, ``GRS_DONE``, else a spawn of its own) against one rank on
the card over the same global batches (products over the ranks' row
blocks, ``row_blocks``; both ``deterministic``), GRS_STEPS steps each.
Through ``train_and_evaluate``: criteo_synth dbmtl_jrc.config (BF16,
packed, every cat table ``row_wise``: jrc_loss's session matrix over the
global batch), TIGER's RQ-VAE with Sinkhorn and with the contrastive loss
and RQ-KMeans (the fit on the ranks' samples in global batch order, the
cap inside the last step), and criteo_synth deepfm.config ``row_wise``
with a delta dump every 2 steps: the checkpoints, the dump files' names
and ids equal and their rows. Through the train step: MIND at the
mind_concat widths and HSTU-Match at the JAX integration config (fp32,
D = V = 16: kernels #1 and #2), a rank's batch [its positives | its
GRS_NEG negatives]: the states. Each within GRS_TOL (1e-5; HSTU-Match
1e-4) of each tensor's max. Kernels #1 and #2 are held against
their plain versions at HSTU-Match's first attention call cut to a rank's
rows, kernel #3 at each rank's first two writes of dbmtl_jrc's packed
blocks; the three kernels' launches on the ranks are counted.

Then a ``timeline`` line (each phase's seconds), a ``kernels`` line, the
card's name and power limit as nvidia-smi
prints them, and as the last line the device record. Any failure raises
and exits non-zero; without CUDA it exits non-zero before any result.
"""

import atexit
import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# --- the bench_dlrm_hstu.py lane ------------------------------------------
BATCH = 32
MAX_SEQ = 4000
N_CAND = 16
VOCAB = 100_000
N_USERS = 10_000
N_REQUESTS = 4
N_TRAIN_STEPS = 6
N_FILE_STEPS = 2
SEED = 7

# published dense peaks of one H100 SXM (bf16 and fp16 tensor cores, fp32
# outside the tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16",
               torch.float16: "fp16"}
FP32_TOL = 1e-4
BF16_TOL = 2e-2
BF16_ULP = 2.0 ** -8  # bf16's relative spacing at the top of a binade

KERNELS = ["hstu_attention_fwd", "hstu_attention_bwd", "row_write"]
# the attention kernels' times at the slice's shapes before their Hopper
# redesign (WMMA fragments, scores through shared memory), as this script
# read them on an NVIDIA H100 80GB HBM3 at 700 W, for the timing lines
WMMA_FWD_MS, WMMA_BWD_MS = 2.18, 6.76

# --- the DeepFM lane: the config of the repo's train benchmark --------------
# Criteo-Terabyte bucket sizes of the reference config, uncapped
CRITEO_RAW = [
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
    3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000, 40000000,
    40000000, 590152, 12973, 108, 36,
]
CRITEO_CAP = 10_000_000  # for the phases that hold several models
DEEPFM_BATCH = 8192
DEEPFM_DIM = 16
DEEPFM_WARMUP = 5
DEEPFM_STEPS = 30
LAYOUT_TOL = 1e-5
LAYOUT_TOL_3_STEPS = 1e-3

_CONFIG = """
train_input_path: "{train_path}"
eval_input_path: "unused"
model_dir: "{model_dir}"
train_config {{
    sparse_optimizer {{
        rowwise_adagrad_optimizer {{ lr: 0.01 }}
        constant_learning_rate {{}}
    }}
    dense_optimizer {{
        adam_optimizer {{ lr: 0.001 }}
        constant_learning_rate {{}}
    }}
    num_steps: {num_steps}
    mixed_precision: "{mixed_precision}"
{train_extra}
}}
data_config {{
    batch_size: {batch}
    dataset_type: ParquetDataset
    fg_mode: FG_NONE
    label_fields: "unused_label"
}}
feature_configs {{
    id_feature {{ feature_name: "user_id" num_buckets: {users}
                  embedding_dim: 256 }}
}}
feature_configs {{
    sequence_id_feature {{ feature_name: "video_id" num_buckets: {vocab}
                           embedding_dim: 256 sequence_length: {max_seq} }}
}}
feature_configs {{
    sequence_id_feature {{ feature_name: "item_video_id"
                           num_buckets: {vocab} embedding_dim: 256
                           sequence_length: {n_cand}
                           embedding_name: "video_id_emb" }}
}}
feature_configs {{
    sequence_raw_feature {{ feature_name: "action_weight"
                            sequence_length: {max_seq} }}
}}
feature_configs {{
    sequence_raw_feature {{ feature_name: "action_timestamp"
                            sequence_length: {max_seq} }}
}}
feature_configs {{
    sequence_raw_feature {{ feature_name: "item_query_time"
                            sequence_length: {n_cand} }}
}}
feature_configs {{
    sequence_raw_feature {{ feature_name: "item_action_weight"
                            sequence_length: {n_cand} }}
}}
model_config {{
    kernel: {kernel}
    feature_groups {{
        group_name: "contextual"
        feature_names: "user_id"
        group_type: DEEP
    }}
    feature_groups {{
        group_name: "uih"
        feature_names: "video_id"
        group_type: JAGGED_SEQUENCE
    }}
    feature_groups {{
        group_name: "candidate"
        feature_names: "item_video_id"
        group_type: JAGGED_SEQUENCE
    }}
    feature_groups {{
        group_name: "uih_action"
        feature_names: "action_weight"
        group_type: JAGGED_SEQUENCE
    }}
    feature_groups {{
        group_name: "uih_timestamp"
        feature_names: "action_timestamp"
        group_type: JAGGED_SEQUENCE
    }}
    feature_groups {{
        group_name: "candidate_timestamp"
        feature_names: "item_query_time"
        group_type: JAGGED_SEQUENCE
    }}
    dlrm_hstu {{
        hstu {{
            stu {{
                embedding_dim: 512
                hidden_dim: 128
                attention_dim: 128
                num_heads: 4
                num_layers: 3
                recompute_uvqk: false
                recompute_y: false
            }}
            input_dropout_ratio: {input_dropout}
            positional_encoder {{
                num_position_buckets: 8192
                num_time_buckets: 2048
                use_time_encoding: true
            }}
            input_preprocessor {{
                contextual_preprocessor {{
                    action_encoder {{
                        simple_action_encoder {{
                            action_embedding_dim: 8
                            action_weights: [1, 2]
                        }}
                    }}
                }}
            }}
            output_postprocessor {{
                layernorm_postprocessor {{}}
            }}
        }}
        fusion_mtl_tower {{
            mlp {{ hidden_units: [512] }}
            task_configs {{
                task_name: "is_click"
                label_name: "item_action_weight"
                task_bitmask: 1
                losses {{ binary_cross_entropy {{}} }}
            }}
            task_configs {{
                task_name: "is_like"
                label_name: "item_action_weight"
                task_bitmask: 2
                losses {{ binary_cross_entropy {{}} }}
            }}
        }}
        max_seq_len: {total_seq}
        item_embedding_hidden_dim: 512
    }}
}}
"""

# the mask family of ops/pallas/hstu_attention.py:_mask_block
MASK_CASES = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, max_attn_len=16),
    dict(causal=True, contextual_seq_len=4),
    dict(causal=True, targets=True),
    dict(causal=True, max_attn_len=16, min_full_attn_seq_len=8),
    dict(causal=False, max_attn_len=16, targets=True),
    dict(causal=True, contextual_seq_len=2, targets=True),
    dict(causal=True, sla_k1=8, sla_k2=4),
    dict(causal=True, sla_k1=8, contextual_seq_len=3, targets=True),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def config_text(kernel: str, input_dropout: float = 0.2,
                model_dir: str = "unused", train_path: str = "unused",
                num_steps: int = 1, mixed_precision: str = "BF16",
                train_extra: str = "") -> str:
    """The lane's config. ``input_dropout`` defaults to the proto's 0.2;
    the training phases set it to 0 (the STU's output dropout and the
    MLP's are 0 in the lane already). An empty ``mixed_precision`` runs
    the dense stack in fp32. ``train_extra`` adds train_config fields."""
    return _CONFIG.format(
        batch=BATCH, users=N_USERS, vocab=VOCAB, max_seq=MAX_SEQ,
        n_cand=N_CAND, total_seq=MAX_SEQ + N_CAND * 2, kernel=kernel,
        input_dropout=input_dropout, model_dir=model_dir,
        train_path=train_path, num_steps=num_steps,
        mixed_precision=mixed_precision, train_extra=train_extra,
    )


def synth_cols(n: int, seed: int, min_len: int = 512,
               max_len: int = MAX_SEQ - 100):
    """Kuairand-shaped Arrow columns with long histories: the port's own
    copy of benchmark/bench_dlrm_hstu._synth_cols."""
    import pyarrow as pa

    r = np.random.default_rng(seed)
    cols = {
        "user_id": pa.array(r.integers(0, N_USERS, n)),
        "unused_label": pa.array(np.zeros(n, np.float32)),
    }
    lens = r.integers(min_len, max_len, n)
    hists, acts, tss = [], [], []
    for lu in lens:
        hists.append(";".join(map(str, r.integers(0, VOCAB, lu))))
        acts.append(";".join(map(str, r.integers(0, 4, lu))))
        tss.append(";".join(map(str, np.sort(r.integers(0, 10**6, lu)))))
    cands, qts, ws = [], [], []
    for _ in range(n):
        lc = int(r.integers(4, N_CAND))
        cands.append(";".join(map(str, r.integers(0, VOCAB, lc))))
        qts.append(";".join(["1000000"] * lc))
        ws.append(";".join(map(str, r.integers(0, 4, lc))))
    cols["video_id"] = pa.array(hists)
    cols["action_weight"] = pa.array(acts)
    cols["action_timestamp"] = pa.array(tss)
    cols["item_video_id"] = pa.array(cands)
    cols["item_query_time"] = pa.array(qts)
    cols["item_action_weight"] = pa.array(ws)
    return cols


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    """(max |got - ref|, max |ref|)."""
    return (float((got.float() - ref.float()).abs().max()),
            float(ref.float().abs().max()))


def check(name: str, got, ref, tol: float) -> float:
    err, scale = rel_err(got, ref)
    ok = bool(np.isfinite(err)) and err <= tol * max(scale, 1e-30)
    if not ok:
        raise AssertionError(
            f"{name}: max|kernel - plain| {err} > {tol} * max|plain| {scale}"
        )
    return err


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attn_inputs(b, n, h, d, vd, dtype, lengths, targets, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, n, h, d, device="cuda", generator=g).to(dtype)
    k = torch.randn(b, n, h, d, device="cuda", generator=g).to(dtype)
    v = torch.randn(b, n, h, vd, device="cuda", generator=g).to(dtype)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    if targets is not None:
        targets = torch.as_tensor(targets, dtype=torch.int32, device="cuda")
    return q, k, v, lengths, targets


def slice_attention_inputs(dtype=torch.bfloat16):
    """q, k, v at the slice's shapes, lengths drawn like the request
    data: 1 contextual token + 512..3899 history + 4..15 candidates."""
    r = np.random.default_rng(SEED)
    lc = r.integers(4, N_CAND, BATCH)
    lengths = 1 + r.integers(512, MAX_SEQ - 100, BATCH) + lc
    n = 1 + MAX_SEQ + N_CAND
    return attn_inputs(BATCH, n, 4, 128, 128, dtype, lengths, lc, seed=SEED)


def slice_upstream_grad(v):
    """A seeded upstream gradient of the attention output, at the scale
    the loss sends back (small against the activations)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    return (torch.randn(v.shape, device="cuda", generator=g) * 0.01).to(
        v.dtype)


GR_SWEEP_SHAPES = ("B=128 H=4 D=V=32 N=43, 48, 85, 27 (hstu_synth, "
                   "interleaved, truncated, ULTRA-HSTU's SLA and window "
                   "channels); B=32 N=18 H=2 D=V=16 (HSTU-Match, fp32)")


def gr_sweep(r):
    """The generative family's real attention shapes, as (case, D, V, B,
    N, H, lengths, targets, name): hstu_synth's (B=128, H=4, D=V=32, one
    contextual token, 8-31 history tokens and 2-9 targets, so N=43 and
    48, the max_seq_len; both below the 16-bit kernels' 128-row tile),
    its interleaved layout (N=85, targets twice) and its truncated one
    (a tail of 16: N=27), ULTRA-HSTU's channels (SLA; a max_attn_len
    window), and HSTU-Match's user tower (B=32, H=2, D=V=16, two
    contextual tokens and no targets, fp32 only)."""
    b = 128
    lc = r.integers(2, 10, b)
    lu = r.integers(8, 32, b)
    lens = 1 + lu + lc
    full = lens.copy()
    full[:4] = 48  # rows at the max_seq_len
    ctx_tg = dict(causal=True, contextual_seq_len=1, targets=True)
    return [
        (ctx_tg, 32, 32, b, 43, 4, lens, lc, "hstu_synth"),
        (ctx_tg, 32, 32, b, 48, 4, full, lc, "hstu_synth N=max_seq_len"),
        (ctx_tg, 32, 32, b, 85, 4, 1 + 2 * lu + 2 * lc, 2 * lc,
         "interleaved"),
        (ctx_tg, 32, 32, b, 27, 4, 1 + np.minimum(lu, 16) + lc, lc,
         "truncated"),
        (dict(ctx_tg, sla_k1=8, sla_k2=4), 32, 32, b, 43, 4, lens, lc,
         "ULTRA-HSTU SLA channel"),
        (dict(ctx_tg, max_attn_len=16), 32, 32, b, 43, 4, lens, lc,
         "ULTRA-HSTU max_attn_len channel"),
        (dict(causal=True), 16, 16, 32, 18, 2, 2 + r.integers(5, 13, 32),
         None, "HSTU-Match user tower"),
    ]


def mask_sweep(dtypes=((torch.float32, FP32_TOL),
                       (torch.bfloat16, BF16_TOL))):
    """(name, tolerance, q, k, v, lengths, targets, mask arguments), in each
    of ``dtypes`` (fp32 then bf16): every mask variant and head-dim pair at B=3, N=300, H=2 with
    ragged lengths; then at the bf16 kernels' 128-row tile edges and the
    fp32 kernels' 64-row ones, lengths 127, 128, 129, 255, 256 and 1000 in
    N=1000; an SLA window shorter than a tile (sla_k1=64, sla_k2=16, with
    targets) at N=1000; 70 samples x 2 heads (more blocks per tile index
    than the card has SMs) and 300 samples (more than the kernels' in-block
    ranking by length takes); then the generative family's shapes
    (``gr_sweep``; head dim 16 in fp32 only)."""
    ctx_tg = dict(causal=True, contextual_seq_len=1, targets=True)
    sweep = [(case, 64, 64, 3, 300, 2, None, None, "")
             for case in MASK_CASES] + [
        (ctx_tg, d, vd, 3, 300, 2, None, None, "")
        for d, vd in ((32, 32), (128, 128), (32, 128), (128, 64))
    ] + [
        (ctx_tg, 128, 128, 6, 1000, 2, [127, 128, 129, 255, 256, 1000], None,
         ""),
        (dict(causal=True, sla_k1=64, sla_k2=16, targets=True), 128, 128, 3,
         1000, 2, None, None, ""),
        (ctx_tg, 64, 64, 70, 200, 2, None, None, ""),
        (dict(causal=True), 32, 32, 300, 130, 1, None, None, ""),
    ] + gr_sweep(np.random.default_rng(SEED))
    r = np.random.default_rng(1)
    for dtype, tol in dtypes:
        for i, (case, d, vd, b, n, h, lens, tg, label) in enumerate(sweep):
            if min(d, vd) < 32 and dtype != torch.float32:
                continue  # the 16-bit kernels start at head dim 32
            if lens is None:
                lens = r.integers(1, n + 1, b)
                lens[0] = n
            lens = np.asarray(lens)
            if tg is None and case.get("targets"):
                tg = np.minimum(lens // 4 + 1, lens)
            q, k, v, lengths, targets = attn_inputs(b, n, h, d, vd, dtype,
                                                    lens, tg, seed=100 + i)
            m = {key: case.get(key, 0) for key in (
                "max_attn_len", "contextual_seq_len",
                "min_full_attn_seq_len", "sla_k1", "sla_k2")}
            m["causal"] = case.get("causal", True)
            yield (f"{dtype} B={b} N={n} H={h} D={d} V={vd} {case} {label}",
                   tol, q, k, v, lengths, targets, m)


def nan_padded_inputs(dtype):
    """q, k, v, do at B=3, N=1000, H=2, D=V=128 with lengths 1000, 700,
    129 and targets, whose rows at or past the length hold NaN; and the
    same with those rows zero, for the plain version."""
    lens = np.array([1000, 700, 129])
    q, k, v, lengths, targets = attn_inputs(3, 1000, 2, 128, 128, dtype,
                                            lens, lens // 8 + 1, seed=77)
    do = torch.randn(v.shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(78)
                     ).to(dtype)
    padded = (torch.arange(1000, device="cuda")[None, :]
              >= lengths[:, None])[:, :, None, None]
    nan = [t.masked_fill(padded, float("nan")) for t in (q, k, v, do)]
    zero = [t.masked_fill(padded, 0.0) for t in (q, k, v, do)]
    return nan, zero, lengths, targets


def check_finite(name: str, *tensors) -> None:
    for t in tensors:
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"{name}: non-finite values")


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_env():
    from torcheasyrec_tpu_torch.ops import cuda_build

    smi = nvidia_smi()
    t0 = time.perf_counter()
    seconds = cuda_build.build(KERNELS)
    build_s = time.perf_counter() - t0
    # registers per thread, static shared memory and spills of every kernel,
    # as ptxas -v reported them (dynamic shared memory is set at launch)
    ptxas = {
        row.pop("kernel"): row
        for name in KERNELS for row in cuda_build.ptxas_usage(name)
    }
    emit({
        "phase": "env", "nvidia_smi": smi,
        "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc_s": seconds, "build_s": build_s, "ptxas": ptxas,
    })
    return smi


def phase_kernel():
    """hstu_attention_fwd against _torch_hstu_mha on the card."""
    from torcheasyrec_tpu_torch.ops import hstu

    alpha = 128 ** -0.5
    scale = MAX_SEQ + 2 * N_CAND
    q, k, v, lengths, targets = slice_attention_inputs()
    kw = dict(causal=True, max_attn_len=0, contextual_seq_len=1,
              min_full_attn_seq_len=0, scaling_seqlen=scale)
    out = hstu.hstu_attention_fwd(q, k, v, lengths, targets, alpha,
                                  kw["causal"], kw["max_attn_len"],
                                  kw["contextual_seq_len"],
                                  kw["min_full_attn_seq_len"], scale)
    torch.cuda.synchronize()
    n_cmp = 8
    ref = hstu._torch_hstu_mha(
        q[:n_cmp], k[:n_cmp], v[:n_cmp], lengths[:n_cmp], alpha,
        kw["causal"], targets[:n_cmp], kw["max_attn_len"],
        kw["contextual_seq_len"], kw["min_full_attn_seq_len"], scale,
    )
    slice_err = check("slice shapes bf16", out[:n_cmp], ref, BF16_TOL)
    emit({"phase": "kernel", "case": "slice", "shape": list(q.shape),
          "dtype": "bf16", "samples_compared": n_cmp,
          "max_abs_err": slice_err, "max_abs_plain": rel_err(ref, ref)[1],
          "tol_rel": BF16_TOL})
    del ref

    worst, cases = {}, {}
    for name, tol, q, k, v, lengths, targets, m in mask_sweep():
        got = hstu.hstu_attention_fwd(
            q, k, v, lengths, targets, 0.1, m["causal"], m["max_attn_len"],
            m["contextual_seq_len"], m["min_full_attn_seq_len"], 500,
            m["sla_k1"], m["sla_k2"])
        ref = hstu._torch_hstu_mha(
            q, k, v, lengths, 0.1, m["causal"], targets, m["max_attn_len"],
            m["contextual_seq_len"], m["min_full_attn_seq_len"], 500,
            m["sla_k1"], m["sla_k2"])
        err = check(name, got, ref, tol)
        worst[str(q.dtype)] = max(worst.get(str(q.dtype), 0.0), err)
        cases[DTYPE_NAMES[q.dtype]] = cases.get(DTYPE_NAMES[q.dtype], 0) + 1
    torch.cuda.synchronize()
    emit({"phase": "kernel", "case": "mask sweep", "cases": cases,
          "shapes": "B=3 N=300 H=2 over D, V; B=6, 3 N=1000; B=70 N=200; "
                    "B=300 N=130; " + GR_SWEEP_SHAPES, "max_abs_err": worst,
          "tol_rel": {"fp32": FP32_TOL, "bf16": BF16_TOL}})

    # padded rows of q, k and v hold NaN: the output must be finite and
    # equal to the plain version's on the same inputs with those rows zero
    nan_errs = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        nan, zero, lengths, targets = nan_padded_inputs(dtype)
        args = (0.1, True, 0, 1, 0, 1000)
        got = hstu.hstu_attention_fwd(*nan[:3], lengths, targets, *args)
        check_finite(f"NaN-padded {dtype}", got)
        ref = hstu._torch_hstu_mha(*zero[:3], lengths, 0.1, True, targets,
                                   0, 1, 0, 1000)
        nan_errs[str(dtype)] = check(f"NaN-padded {dtype}", got, ref, tol)
    emit({"phase": "kernel", "case": "NaN in padded rows of q, k, v",
          "shape": [3, 1000, 2, 128, 128], "lengths": [1000, 700, 129],
          "max_abs_err": nan_errs,
          "tol_rel": {"fp32": FP32_TOL, "bf16": BF16_TOL}})
    return slice_err


def phase_kernel_bwd():
    """hstu_attention_bwd against _torch_hstu_mha_bwd on the card."""
    from torcheasyrec_tpu_torch.ops import hstu

    alpha = 128 ** -0.5
    scale = MAX_SEQ + 2 * N_CAND
    q, k, v, lengths, targets = slice_attention_inputs()
    do = slice_upstream_grad(v)
    got = hstu.hstu_attention_bwd(q, k, v, do, lengths, targets, alpha,
                                  True, 0, 1, 0, scale)
    torch.cuda.synchronize()
    n_cmp, chunk = 8, 4  # the plain version holds [B, H, N, N] several times
    slice_errs = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    plain_max = dict(slice_errs)
    for s in range(0, n_cmp, chunk):
        e = s + chunk
        ref = hstu._torch_hstu_mha_bwd(
            q[s:e], k[s:e], v[s:e], do[s:e], lengths[s:e], alpha, True,
            targets[s:e], 0, 1, 0, scale)
        for name, g, r_ in zip(("dq", "dk", "dv"), got, ref):
            err = check(f"slice shapes bf16 {name}", g[s:e], r_, BF16_TOL)
            slice_errs[name] = max(slice_errs[name], err)
            plain_max[name] = max(plain_max[name], rel_err(r_, r_)[1])
        del ref
    emit({"phase": "kernel_bwd", "case": "slice", "shape": list(q.shape),
          "dtype": "bf16", "samples_compared": n_cmp,
          "max_abs_err": slice_errs, "max_abs_plain": plain_max,
          "tol_rel": BF16_TOL})

    worst, cases = {}, {}
    for name, tol, q, k, v, lengths, targets, m in mask_sweep():
        g = torch.Generator(device="cuda").manual_seed(sum(cases.values()))
        do = torch.randn(v.shape, device="cuda", generator=g).to(v.dtype)
        args = (m["causal"], m["max_attn_len"], m["contextual_seq_len"],
                m["min_full_attn_seq_len"], 500, m["sla_k1"], m["sla_k2"])
        got = hstu.hstu_attention_bwd(q, k, v, do, lengths, targets, 0.1,
                                      *args)
        ref = hstu._torch_hstu_mha_bwd(q, k, v, do, lengths, 0.1,
                                       m["causal"], targets, *args[1:])
        for gname, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
            err = check(f"{name} {gname}", g_, r_, tol)
            key = f"{q.dtype} {gname}"
            worst[key] = max(worst.get(key, 0.0), err)
        cases[DTYPE_NAMES[q.dtype]] = cases.get(DTYPE_NAMES[q.dtype], 0) + 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_bwd", "case": "mask sweep", "cases": cases,
          "shapes": "B=3 N=300 H=2 over D, V; B=6, 3 N=1000; B=70 N=200; "
                    "B=300 N=130; " + GR_SWEEP_SHAPES, "max_abs_err": worst,
          "tol_rel": {"fp32": FP32_TOL, "bf16": BF16_TOL}})

    # padded rows of q, k, v and do hold NaN: finite gradients, equal to
    # the plain version's on the same inputs with those rows zero
    nan_errs = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        nan, zero, lengths, targets = nan_padded_inputs(dtype)
        args = (0.1, True, 0, 1, 0, 1000)
        got = hstu.hstu_attention_bwd(*nan, lengths, targets, *args)
        check_finite(f"NaN-padded {dtype}", *got)
        ref = hstu._torch_hstu_mha_bwd(*zero, lengths, 0.1, True, targets,
                                       0, 1, 0, 1000)
        for gname, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
            nan_errs[f"{dtype} {gname}"] = check(
                f"NaN-padded {dtype} {gname}", g_, r_, tol)
    emit({"phase": "kernel_bwd", "case": "NaN in padded rows of q, k, v, do",
          "shape": [3, 1000, 2, 128, 128], "lengths": [1000, 700, 129],
          "max_abs_err": nan_errs,
          "tol_rel": {"fp32": FP32_TOL, "bf16": BF16_TOL}})

    # both kernels through the autograd Function against autograd of the
    # plain forward, at a small shape
    fn_errs = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        q, k, v, lengths, targets = attn_inputs(
            2, 200, 2, 64, 64, dtype, [200, 131], [5, 3], seed=11)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = hstu.hstu_mha(*leaves, lengths, 0.1, num_targets=targets,
                            contextual_seq_len=1, scaling_seqlen=256)
        do = torch.randn_like(out)
        got = torch.autograd.grad(out, leaves, do)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref_out = hstu._torch_hstu_mha(*leaves, lengths, 0.1, True, targets,
                                       0, 1, 0, 256)
        ref = torch.autograd.grad(ref_out, leaves, do)
        for gname, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
            fn_errs[f"{dtype} {gname}"] = check(
                f"Function {dtype} {gname}", g_, r_, tol)
    emit({"phase": "kernel_bwd", "case": "autograd Function vs autograd of "
          "the plain forward", "shape": [2, 200, 2, 64, 64],
          "max_abs_err": fn_errs,
          "tol_rel": {"fp32": FP32_TOL, "bf16": BF16_TOL}})
    return max(slice_errs.values())


def phase_slice():
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.ops import hstu
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(config_text("PALLAS"))
    model, features = port_main.build_model(cfg, "cuda", seed=SEED)
    parser = DataParser(features, labels=["unused_label"])
    eval_step = port_main.make_eval_step(model, with_loss=False)
    requests = [synth_cols(BATCH, SEED + i) for i in range(N_REQUESTS + 1)]
    n_tokens = [
        sum(len(s.as_py().split(";")) for s in c["video_id"]) for c in requests
    ]

    def answer(cols):
        batch = parser.parse_to_batch(cols).to("cuda")
        preds, _ = eval_step(batch)
        return {k: v.float().cpu() for k, v in preds.items()}

    answer(requests[0])  # warm-up: cuBLAS handles, allocator
    with tempfile.TemporaryDirectory() as tmp:
        # the batch-predict entry point reads the first two requests back
        # from parquet with the same weights
        cfg_path = os.path.join(tmp, "pipeline.config")
        with open(cfg_path, "w") as f:
            f.write(config_text("PALLAS"))
        ckpt = os.path.join(tmp, "model.pt")
        torch.save(model.state_dict(), ckpt)
        inp = os.path.join(tmp, "requests.parquet")
        pq.write_table(pa.concat_tables(
            [pa.table(requests[1]), pa.table(requests[2])]), inp)
        out_path = os.path.join(tmp, "predictions.parquet")
        torch.cuda.synchronize()

        hstu.hstu_attention_fwd.launches = 0
        times, outs = [], []
        for cols in requests[1:]:
            t0 = time.perf_counter()
            outs.append(answer(cols))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        n_rows = port_main.predict_checkpoint(
            cfg_path, inp, out_path, checkpoint_path=ckpt,
            reserved_columns="user_id", device="cuda")
        launches = hstu.hstu_attention_fwd.launches
        written = pq.read_table(out_path)

    n_layers = len(model.transducer.stack.layers)
    n_batches = N_REQUESTS + 2
    if n_rows != 2 * BATCH or launches != n_layers * n_batches:
        raise AssertionError(
            f"kernel launched {launches} times for {n_batches} batches of "
            f"{n_layers} STU layers ({n_rows} rows through predict_checkpoint)"
        )
    # the predict-mode loader carries the reserved column through unchanged
    user_ids = np.concatenate([requests[1]["user_id"].to_numpy(),
                               requests[2]["user_id"].to_numpy()])
    if written.column_names[0] != "user_id" or not np.array_equal(
            written["user_id"].to_numpy(), user_ids):
        raise AssertionError("predict_checkpoint: the reserved column "
                             "user_id did not come through unchanged")
    predict_errs = {}
    for key in ("probs_is_click", "probs_is_like"):
        col = torch.from_numpy(
            np.stack(written[key].to_numpy(zero_copy_only=False)))
        ref = torch.cat([outs[0][key], outs[1][key]])
        predict_errs[key] = check(f"predict_checkpoint {key}", col, ref,
                                  BF16_TOL)
    for preds in outs:
        for key in ("probs_is_click", "probs_is_like", "logits_is_click",
                    "logits_is_like"):
            v = preds[key]
            if v.shape != (BATCH, N_CAND) or not torch.isfinite(v).all():
                raise AssertionError(f"{key}: shape {tuple(v.shape)} or "
                                     "non-finite values")
            if key.startswith("probs") and not ((v > 0) & (v < 1)).all():
                raise AssertionError(f"{key} outside (0, 1)")

    # the same weights with the plain attention, on a batch of 8
    plain_model, _ = port_main.build_model(
        parse_pipeline_config(config_text("PYTORCH")), "cuda", seed=SEED)
    plain_model.load_state_dict(model.state_dict())
    small = parser.parse_to_batch(synth_cols(8, SEED + 100)).to("cuda")
    with torch.inference_mode():
        got = model(small)
        ref = plain_model(small)
    errs = {k: check(f"model {k}", got[k], ref[k], BF16_TOL)
            for k in got if k.startswith(("probs_", "logits_"))}
    del plain_model, got, ref
    # the device-side forward alone (parse and copy done beforehand)
    dev_batch = parser.parse_to_batch(requests[1]).to("cuda")
    fwd_ms = cuda_ms(lambda: eval_step(dev_batch), 5)
    emit({"phase": "slice", "requests": N_REQUESTS, "batch": BATCH,
          "n_padded": 1 + MAX_SEQ + N_CAND,
          "history_tokens": n_tokens[1:], "request_ms": times,
          "median_request_ms": float(np.median(times)),
          "forward_ms": fwd_ms, "kernel_launches": launches,
          "predict_checkpoint_rows": n_rows,
          "predict_checkpoint_reserved_column": "user_id, unchanged",
          "predict_checkpoint_vs_eval_step_max_abs_err": predict_errs,
          "model_vs_plain_max_abs_err": errs, "tol_rel": BF16_TOL,
          "forward_profile": profile_forward(lambda: eval_step(dev_batch))})
    return launches, float(np.median(times))


def build_trainer(cfg, seed=SEED, device="cuda", **engine_options):
    """(model, features, dense optimizer, state, train step) of the port
    on the card (or ``device``), from the config's optimizers and train
    options (clipping, part optimizers, accumulation, the grad scaler);
    ``engine_options`` are the embedding engine's (``packed``,
    ``dense_lane_rows``)."""
    from torcheasyrec_tpu_torch import main as port_main

    tc = cfg.train_config
    model, features, sparse_sched = port_main._build_model_and_optim(
        cfg, device, for_train=True, seed=seed, **engine_options)
    tx, dense_sched = port_main._dense_optimizer(model, tc)
    accum = int(tc.gradient_accumulation_steps or 1)
    scaler = tc.grad_scaler if tc.HasField("grad_scaler") else None
    state = port_main._init_state(model, tx, accum, scaler)
    step = port_main.make_train_step(model, tx, sparse_sched, dense_sched,
                                     accum, scaler)
    return model, features, tx, state, step


def train_mode_outputs(model, batch):
    """(loss, predictions, {dense parameter: gradient}) of the train
    step's own forward (lookup, assemble, variational dropout, predict,
    loss) in training mode, without any update of the weights (the batch
    norms' running statistics move, as in a step)."""
    eg = model.embedding_group
    model.train()
    with torch.no_grad():
        emb_out, _ = eg.lookup(batch)
    grouped, vd_losses = model.build_input(
        eg.assemble(emb_out, batch, model.compute_dtype), batch)
    preds = model.predict(grouped, batch)
    losses = model.loss(preds, batch)
    losses.update(vd_losses)
    total = model.total_loss(losses)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return (total.detach(), {k: v.detach() for k, v in preds.items()
                             if isinstance(v, torch.Tensor)},
            {n: g for n, g in zip(names, grads) if g is not None})


def dense_grads(model, batch):
    """Loss and gradients of the dense parameters, by the train step's own
    forward without any update."""
    total, _, grads = train_mode_outputs(model, batch)
    return float(total), grads


class CpuComparison:
    """Holds one model's tensors on the card against the same model's on
    the CPU: each within ``tol`` of the CPU's max abs value, the worst
    relative error kept per key; a gradient at or below ``zero_share`` of
    the largest on the CPU must be so on the card, and is not compared
    otherwise."""

    def __init__(self, name: str, tol: float, zero_share: float) -> None:
        self.name, self.tol, self.zero_share = name, tol, zero_share
        self.errs, self.zero = {}, set()

    def compare(self, key, ref, got) -> None:
        ref, got = ref.detach().float().cpu(), got.detach().float().cpu()
        if ref.shape != got.shape:
            raise AssertionError(f"{self.name}: {key} {tuple(got.shape)} on "
                                 f"the card, {tuple(ref.shape)} on the CPU")
        scale = float(ref.abs().max()) or 1.0
        err = float((got - ref).abs().max()) / scale
        self.errs[key] = max(self.errs.get(key, 0.0), err)
        if not err <= self.tol:
            raise AssertionError(f"{self.name}: {key} off by {err:.3g} of its "
                                 "max on the card")

    def compare_grads(self, ref_grads, grads) -> None:
        if set(grads) != set(ref_grads):
            raise AssertionError(f"{self.name}: gradients of {sorted(grads)} "
                                 f"on the card, {sorted(ref_grads)} on the CPU")
        top = max(float(g.abs().max()) for g in ref_grads.values())
        card_top = max(float(g.abs().max()) for g in grads.values())
        for k in ref_grads:
            if float(ref_grads[k].abs().max()) <= self.zero_share * top:
                self.zero.add(k)
                if float(grads[k].abs().max()) > self.zero_share * card_top:
                    raise AssertionError(f"{self.name}: {k}'s gradient is 0 "
                                         "on the CPU, not on the card")
            else:
                self.compare(f"grad:{k}", ref_grads[k], grads[k])


def batch_row_ids(model, batch) -> torch.Tensor:
    """Rows of the model's one fused table that ``batch`` looks up."""
    with torch.no_grad():
        _, residuals = model.embedding_group.lookup(batch)
    (flat_ids, _), = residuals.values()
    return flat_ids[flat_ids >= 0]


def phase_train():
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.ops import hstu
    from torcheasyrec_tpu_torch.utils import checkpoint_util
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(config_text("PALLAS", input_dropout=0.0))
    model, features, tx, state, train_step = build_trainer(cfg)
    parser = DataParser(features, labels=["unused_label"])
    n_layers = len(model.transducer.stack.layers)
    # three different batches, then the first one again and again: its
    # loss must fall
    cols = [synth_cols(BATCH, SEED + 200 + i) for i in range(3)]
    order = [0, 1, 2] + [0] * (N_TRAIN_STEPS - 3)
    batches = [parser.parse_to_batch(c).to("cuda") for c in cols]
    (gk, table), = model.embedding_group.engine_tables().items()
    table_before = table.clone()
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device="cuda")
    for b in batches:
        touched[batch_row_ids(model, b)] = True
    acc_init = float(state["sparse_opt"][gk]["acc"][0, 0])
    torch.cuda.synchronize()

    hstu.hstu_attention_fwd.launches = 0
    hstu.hstu_attention_bwd.launches = 0
    losses, step_ms = [], []
    for i in order:
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in metrics.items()})
    step_launches = (hstu.hstu_attention_fwd.launches,
                     hstu.hstu_attention_bwd.launches)

    # the trainer entry point: 2 steps from a parquet file, then a batch
    # predict of the checkpoint it wrote
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "train.parquet")
        pq.write_table(pa.concat_tables([pa.table(c) for c in cols[:2]]), inp)
        cfg_path = os.path.join(tmp, "pipeline.config")
        with open(cfg_path, "w") as f:
            f.write(config_text(
                "PALLAS", input_dropout=0.0, train_path=inp,
                model_dir=os.path.join(tmp, "model"), num_steps=N_FILE_STEPS))
        result = port_main.train_and_evaluate(cfg_path, device="cuda")
        ckpt = checkpoint_util.latest_checkpoint(os.path.join(tmp, "model"))
        out_path = os.path.join(tmp, "predictions.parquet")
        n_rows = port_main.predict_checkpoint(cfg_path, inp, out_path,
                                              device="cuda")
        written = pq.read_table(out_path)
    fwd_launches = hstu.hstu_attention_fwd.launches
    bwd_launches = hstu.hstu_attention_bwd.launches

    n_steps = N_TRAIN_STEPS + N_FILE_STEPS
    n_predict = n_rows // BATCH
    if step_launches != (n_layers * N_TRAIN_STEPS,) * 2:
        raise AssertionError(
            f"(forward, backward) kernels launched {step_launches} times in "
            f"{N_TRAIN_STEPS} steps of {n_layers} STU layers")
    if (bwd_launches != n_layers * n_steps
            or fwd_launches != n_layers * (n_steps + n_predict)):
        raise AssertionError(
            f"kernels launched {fwd_launches} (forward) and {bwd_launches} "
            f"(backward) times for {n_steps} steps and {n_predict} predict "
            f"batches of {n_layers} STU layers")
    if result["step"] != N_FILE_STEPS or not ckpt or n_rows != 2 * BATCH:
        raise AssertionError(
            f"train_and_evaluate: {result}, checkpoint {ckpt}, {n_rows} "
            "rows predicted")
    for key in ("probs_is_click", "probs_is_like"):
        col = np.stack(written[key].to_numpy(zero_copy_only=False))
        if col.shape != (2 * BATCH, N_CAND) or not (
                np.isfinite(col).all() and (col > 0).all() and (col < 1).all()):
            raise AssertionError(f"predict_checkpoint {key}: bad values")
    flat = [v for step in losses for v in step.values()] + [
        v for k, v in result.items() if k != "step"]
    if not np.isfinite(flat).all():
        raise AssertionError(f"non-finite loss: {losses} {result}")
    repeated = [l["total_loss"] for l, i in zip(losses, order) if i == 0]
    if not repeated[-1] < repeated[0]:
        raise AssertionError(f"loss on the repeated batch did not fall: "
                             f"{repeated}")

    same = (table == table_before).all(dim=1)
    acc = state["sparse_opt"][gk]["acc"][:, 0]
    changed_share = float((~same[touched]).float().mean())
    if not same[~touched].all() or not (acc[~touched] == acc_init).all():
        raise AssertionError("rows no batch touched changed, or their "
                             "accumulator did")
    if changed_share < 0.999 or not (acc[touched] > acc_init).all():
        raise AssertionError(
            f"only {changed_share} of the touched rows changed")
    del table_before

    # the whole model's dense gradients on a batch of 8: kernels against
    # plain attention, same weights, fp32 then bf16
    weights = model.state_dict()
    small_cols = synth_cols(8, SEED + 300)
    hstu_counts = (hstu.hstu_attention_fwd.launches,
                   hstu.hstu_attention_bwd.launches)

    def grads_of(kernel: str, mixed_precision: str):
        m, feats, _, _, _ = build_trainer(parse_pipeline_config(config_text(
            kernel, input_dropout=0.0, mixed_precision=mixed_precision)))
        m.load_state_dict(weights)
        small = DataParser(feats, labels=["unused_label"]).parse_to_batch(
            small_cols).to("cuda")
        return dense_grads(m, small)

    loss32_k, g32_k = grads_of("PALLAS", "")
    loss32_p, g32_p = grads_of("PYTORCH", "")
    loss16_k, g16_k = grads_of("PALLAS", "BF16")
    loss16_p, g16_p = grads_of("PYTORCH", "BF16")
    hstu.hstu_attention_fwd.launches, hstu.hstu_attention_bwd.launches = (
        hstu_counts)  # comparisons do not count
    if not set(g32_k) == set(g32_p) == set(g16_k) == set(g16_p):
        raise AssertionError("the models' gradients differ in names")
    fp32_errs = {
        n: check(f"fp32 dense gradient {n}", g32_k[n], g32_p[n], FP32_TOL)
        / max(rel_err(g32_p[n], g32_p[n])[1], 1e-30) for n in g32_p}

    def dist(a, b):  # relative L2 distance from the fp32 gradient b
        return float((a.float() - b).norm() / b.norm().clamp(min=1e-30))

    noise = {n: (dist(g16_k[n], g32_p[n]), dist(g16_p[n], g32_p[n]))
             for n in g32_p}
    # the plain model's distance, floored at bf16's resolution: a gradient
    # of a few elements (a bias of one) can land by rounding luck far
    # closer to the fp32 one than a distance of one ulp
    bound = {n: 3.0 * max(d_plain, BF16_ULP) + 1e-3
             for n, (_, d_plain) in noise.items()}
    for n, (d_kernel, d_plain) in noise.items():
        if not d_kernel <= bound[n]:
            raise AssertionError(
                f"bf16 dense gradient {n}: {d_kernel} from the fp32 gradient "
                f"with the kernels, {d_plain} with the plain attention")
    worst32 = max(fp32_errs, key=fp32_errs.get)
    worst16 = max(noise, key=lambda n: noise[n][0] / max(noise[n][1], 1e-30))
    tightest = max(noise, key=lambda n: noise[n][0] / bound[n])
    grad_report = {
        "batch": 8, "tensors": len(noise),
        "fp32": {"loss_kernels": loss32_k, "loss_plain": loss32_p,
                 "worst_err_rel_to_max": fp32_errs[worst32],
                 "worst_tensor": worst32, "tol_rel": FP32_TOL},
        "bf16": {"loss_kernels": loss16_k, "loss_plain": loss16_p,
                 "l2_distance_from_fp32_gradient": {
                     "kernels_median": float(np.median(
                         [v[0] for v in noise.values()])),
                     "plain_median": float(np.median(
                         [v[1] for v in noise.values()])),
                     "worst_ratio_tensor": worst16,
                     "worst_ratio": noise[worst16][0]
                     / max(noise[worst16][1], 1e-30),
                     "worst_ratio_kernels_plain": noise[worst16],
                     "worst_ratio_elements": g16_p[worst16].numel(),
                     "nearest_bound_tensor": tightest,
                     "nearest_bound_share": noise[tightest][0]
                     / bound[tightest]},
                 "kernels_vs_plain_worst_err_rel_to_max": max(
                     rel_err(g16_k[n], g16_p[n])[0]
                     / max(rel_err(g16_p[n], g16_p[n])[1], 1e-30)
                     for n in g16_p),
                 "bound": "kernels <= 3 x max(plain, 2^-8) + 1e-3, per "
                          "tensor"}}
    del g32_k, g32_p, g16_k, g16_p, weights

    emit({"phase": "train", "steps": N_TRAIN_STEPS, "batch": BATCH,
          "batch_order": order, "losses": losses, "step_ms": step_ms,
          "repeated_batch_total_loss": repeated,
          "kernel_launches": {"forward": fwd_launches,
                              "backward": bwd_launches},
          "train_and_evaluate": result, "predict_checkpoint_rows": n_rows,
          "rows_touched": int(touched.sum()), "rows": int(table.shape[0]),
          "touched_rows_changed_share": changed_share,
          "untouched_rows_bit_equal": True,
          "dense_gradients_vs_plain": grad_report})
    return (fwd_launches, bwd_launches, float(np.median(step_ms[1:])),
            (model, state, train_step, batches))


def bwd_times(dtype=torch.bfloat16) -> dict:
    """The backward kernel at the slice's shapes in ``dtype``: its time,
    the plain version's and the card's bound for this data's work."""
    from torcheasyrec_tpu_torch.ops import hstu

    q, k, v, lengths, targets = slice_attention_inputs(dtype)
    do = slice_upstream_grad(v)
    alpha, scale = 128 ** -0.5, MAX_SEQ + 2 * N_CAND
    args = (alpha, True, 0, 1, 0, scale)
    kernel_ms = cuda_ms(
        lambda: hstu.hstu_attention_bwd(q, k, v, do, lengths, targets, *args),
        10)

    # the plain version materializes [B, H, N, N] several times over: run
    # it in chunks of 4 samples and sum
    def plain():
        for s in range(0, BATCH, 4):
            e = s + 4
            hstu._torch_hstu_mha_bwd(q[s:e], k[s:e], v[s:e], do[s:e],
                                     lengths[s:e], alpha, True, targets[s:e],
                                     0, 1, 0, scale)
    plain_ms = cuda_ms(plain, 2)
    # work this run's data needs: five products over the unmasked (row,
    # column) pairs; bytes: q, k, v, do read once over the real rows, dq,
    # dk, dv written once (attn_bytes)
    pairs = unmasked_pairs(q.shape[1], lengths, targets)
    h, d, vd = q.shape[2], q.shape[3], v.shape[3]
    flops = 2.0 * pairs * h * (3 * d + 2 * vd)
    nbytes = attn_bytes(q, v, lengths, backward=True)
    bound_ms, bound_by = card_bound(flops, nbytes)
    return {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "plain_note": "8 calls of 4 samples", "flops": flops,
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_tflops": flops / kernel_ms / 1e9,
            "bound_share": bound_ms / kernel_ms}


def timing_tuple(t: dict):
    return t["kernel_ms"], t["plain_ms"], t["bound_ms"], t["bound_by"]


def phase_timing_train(trainer, step_median_ms):
    model, state, train_step, batches = trainer
    times = bwd_times()

    def one_step():
        train_step(state, batches[0])
    emit({"phase": "timing_train", "median_step_ms": step_median_ms,
          **times, "wmma_kernel_ms": WMMA_BWD_MS,
          "dq": "fp32 atomics into a zeroed buffer, cast afterwards",
          "step_profile": profile_forward(one_step)})
    return timing_tuple(times)


def profile_forward(fn) -> dict:
    """Device time of one call by kernel, from torch.profiler's CUDA
    activity; busy share = summed kernel time / host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    if not by_name:
        return {"device_time": "not measured (no CUDA events traced)"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "top_kernels_ms": {k[:80]: v for k, v in top}}


def attn_bytes(q, v, lengths, backward: bool = False) -> float:
    """Bytes the attention must move for this data: q, k and v (and the
    upstream gradient) read over each sample's real rows only, which is
    all the kernels read; the output (dq, dk and dv) written at the
    padded N, since the kernels write the padded rows' zeros too."""
    b, n, h, d = q.shape
    vd = v.shape[3]
    rows = float(lengths.clamp(max=n).sum())
    if backward:
        reads, writes = rows * h * (2 * d + 2 * vd), b * n * h * (2 * d + vd)
    else:
        reads, writes = rows * h * (2 * d + vd), b * n * h * vd
    return q.element_size() * (reads + writes)


def unmasked_pairs(n, lengths, targets) -> int:
    """Unmasked (row, column) pairs of the slice's mask (causal, one
    contextual token, num_targets) summed over the samples."""
    from torcheasyrec_tpu_torch.ops import hstu

    return sum(
        int(hstu.valid_attn_mask(n, lengths[s:s + 1], True,
                                 targets[s:s + 1], 0, 1).sum())
        for s in range(lengths.shape[0])
    )


def card_bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least ms the card could take, what bounds it): the larger of the
    operations over ``peak`` (their type's) and the bytes over the memory
    rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def fwd_times(dtype=torch.bfloat16) -> dict:
    """The forward kernel at the slice's shapes in ``dtype``: its time,
    the plain version's and the card's bound for this data's work."""
    from torcheasyrec_tpu_torch.ops import hstu

    q, k, v, lengths, targets = slice_attention_inputs(dtype)
    alpha, scale = 128 ** -0.5, MAX_SEQ + 2 * N_CAND
    args = (alpha, True, 0, 1, 0, scale)
    kernel_ms = cuda_ms(
        lambda: hstu.hstu_attention_fwd(q, k, v, lengths, targets, *args), 10)
    # the plain version materializes [B, H, N, N] scores: run it in
    # chunks of 8 samples and sum
    def plain():
        for s in range(0, BATCH, 8):
            hstu._torch_hstu_mha(q[s:s + 8], k[s:s + 8], v[s:s + 8],
                                 lengths[s:s + 8], alpha, True,
                                 targets[s:s + 8], 0, 1, 0, scale)
    plain_ms = cuda_ms(plain, 2)
    # work this run's data needs: the two products over the unmasked
    # (row, column) pairs; bytes: q, k, v read once over the real rows,
    # out written once (attn_bytes)
    pairs = unmasked_pairs(q.shape[1], lengths, targets)
    h, d, vd = q.shape[2], q.shape[3], v.shape[3]
    flops = 2.0 * pairs * h * (d + vd)
    nbytes = attn_bytes(q, v, lengths)
    bound_ms, bound_by = card_bound(flops, nbytes)
    return {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "plain_note": "4 calls of 8 samples", "flops": flops,
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_tflops": flops / kernel_ms / 1e9,
            "bound_share": bound_ms / kernel_ms}


def phase_timing():
    times = fwd_times()
    emit({"phase": "timing", **times, "wmma_kernel_ms": WMMA_FWD_MS})
    return timing_tuple(times)


# --- the DeepFM lane: config and data ----------------------------------------

def deepfm_config_text(buckets, model_dir: str = "unused",
                       train_path: str = "unused", eval_path: str = "unused",
                       num_steps: int = 0, mixed_precision: str = "BF16",
                       train_extra: str = "", data_extra: str = ""):
    """The Criteo DeepFM config of the repo's train benchmark (the port's
    own copy of bench.py:build_config), with ``buckets`` rows per id
    feature; ``train_extra`` and ``data_extra`` are lines added to
    ``train_config`` and ``data_config``."""
    lines = [
        f'train_input_path: "{train_path}"',
        f'eval_input_path: "{eval_path}"',
        f'model_dir: "{model_dir}"',
        "train_config {",
        "  sparse_optimizer { rowwise_adagrad_optimizer { lr: 0.001 }"
        " constant_learning_rate {} }",
        "  dense_optimizer { adam_optimizer { lr: 0.001 }"
        " constant_learning_rate {} }",
        f"  num_steps: {num_steps}" if num_steps else "  num_epochs: 1",
        f'  mixed_precision: "{mixed_precision}"',
        train_extra,
        "}",
        "data_config {",
        f"  batch_size: {DEEPFM_BATCH}",
        "  dataset_type: ParquetDataset",
        "  fg_mode: FG_NONE",
        '  label_fields: "label"',
        data_extra,
        "}",
    ]
    for i in range(13):
        lines.append(
            f'feature_configs {{ raw_feature {{ feature_name: "int_{i}" }} }}')
    for i, n in enumerate(buckets):
        lines.append(
            f'feature_configs {{ id_feature {{ feature_name: "cat_{i}" '
            f"num_buckets: {n} embedding_dim: {DEEPFM_DIM} }} }}")
    cat_names = "".join(
        f'    feature_names: "cat_{i}"\n' for i in range(len(buckets)))
    int_names = "".join(f'    feature_names: "int_{i}"\n' for i in range(13))
    lines.append(
        "model_config {\n"
        '  feature_groups {\n    group_name: "wide"\n' + cat_names +
        "    group_type: WIDE\n  }\n"
        '  feature_groups {\n    group_name: "fm"\n' + cat_names +
        "    group_type: DEEP\n  }\n"
        '  feature_groups {\n    group_name: "deep"\n' + cat_names + int_names +
        "    group_type: DEEP\n  }\n"
        "  deepfm {\n"
        "    deep { hidden_units: [512, 256, 128] }\n"
        "    final { hidden_units: [128, 64] }\n"
        "    wide_embedding_dim: 4\n"
        "  }\n"
        "  num_class: 1\n"
        "  losses { binary_cross_entropy {} }\n"
        "  metrics { auc {} }\n"
        "}")
    return "\n".join(lines)


def criteo_cols(buckets, seed: int, n: int = DEEPFM_BATCH):
    """Criteo-shaped Arrow columns (bench.py's synthetic batch): a coin
    label, 13 normal dense features, 26 uniform ids."""
    import pyarrow as pa

    r = np.random.default_rng(seed)
    cols = {"label": pa.array((r.random(n) > 0.5).astype(np.float32))}
    for i in range(13):
        cols[f"int_{i}"] = pa.array(r.normal(size=n).astype(np.float32))
    for i, b in enumerate(buckets):
        cols[f"cat_{i}"] = pa.array(r.integers(0, b, n))
    return cols


# --- the row-write kernel: layout, shapes, checks, times --------------------
ROW_WRITE_SWEEP = (1024, 8192, 73_728, 294_912)
# the cold times rotate the rows over at least this many bytes: twice the
# card's 50 MB L2 cache
COLD_BYTES = 100e6


def deepfm_engine(buckets=CRITEO_RAW, lookups=()):
    """The embedding engine of the DeepFM lane (its layout only, no table
    is allocated): one packed group per dim, dim 16 (slot 17, 7 logical
    rows per physical row) and the WIDE dim 4 (slot 5, 25 per row), the
    Criteo tables uncapped, the dense lane at its 32768 rows."""
    from torcheasyrec_tpu_torch.parallel.emb_engine import (
        EmbeddingEngine,
        TableSpec,
    )
    from torcheasyrec_tpu_torch.parallel.sparse_optim import SparseOptimizer

    return EmbeddingEngine(
        [TableSpec(f"cat_{i}_dim{d}", n, d) for d in (DEEPFM_DIM, 4)
         for i, n in enumerate(buckets)],
        lookups, SparseOptimizer("rowwise_adagrad", {"lr": 0.001}))


def step_row_write_targets(buckets=CRITEO_RAW, batch=DEEPFM_BATCH,
                           device="cuda"):
    """{dim: (physical rows, targets)} of the DeepFM step's two row writes,
    built as ``EmbeddingEngine._packed_update`` builds them from the seeded
    batch that phase train_deepfm trains on (``criteo_cols(CRITEO_RAW,
    0)``): the ids of the tables above the dense lane, offset into the
    group, deduplicated in sorted order; the first id of each physical row
    targets that row, every later one the scratch row (the last)."""
    cols = criteo_cols(buckets, 0, batch)
    out = {}
    for g in deepfm_engine(buckets).groups.values():
        flat = torch.cat([
            torch.tensor(cols[t.name.rsplit("_", 1)[0]].to_numpy())
            + g.offsets[t.name]
            for t in g.specs if t.name not in g.dense_tables]).to(device)
        pid = torch.div(torch.unique(flat), g.spr, rounding_mode="floor")
        head = torch.ones_like(pid, dtype=torch.bool)
        head[1:] = pid[1:] != pid[:-1]
        out[g.dim] = (g.p_rows,
                      torch.where(head, pid, pid.new_full((), g.p_rows - 1)))
    return out


def without_scratch(ids, scratch, gen):
    """``ids`` with each entry on the scratch row moved to a row that no
    entry targets: the same K, one write per row, sorted like the step."""
    heads = ids[ids != scratch]
    free = torch.ones(scratch, dtype=torch.bool, device="cuda")
    free[heads] = False
    free_rows = free.nonzero().squeeze(1)
    pick = torch.randperm(free_rows.shape[0], device="cuda", generator=gen)
    extra = free_rows[pick[:ids.shape[0] - heads.shape[0]]]
    return torch.sort(torch.cat([heads, extra]))[0]


def device_ms(fn, iters: int) -> float:
    """Mean device ms per call over ``iters`` back-to-back calls, without
    the host's cost per call: the calls are queued behind a sleep kernel,
    and the window counts only if the card was still asleep when the last
    one was queued."""
    fn()
    torch.cuda.synchronize()
    cycles = 40_000_000  # about 20 ms at the H100's clock
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise RuntimeError("the host did not queue the calls ahead of the card")


def row_write_bytes(table, ids) -> float:
    """Bytes a row write must move for these ids: each row that is
    written read once and written once, and the ids."""
    ok = (ids >= 0) & (ids < table.shape[0])
    return (2.0 * int(ok.sum()) * table.shape[1] * 4
            + ids.shape[0] * ids.element_size())


def write_times(write, table, ids) -> dict:
    """Device ms of ``write(table, ids, rows)`` for one K:
    warm, with one rows tensor, as in the step, whose rows were just
    computed; cold, rotating over copies of the rows that span COLD_BYTES,
    so that the L2 cache cannot hold them. Each with its rate and share
    of the bound."""
    k, lanes = ids.shape[0], table.shape[1]
    copies = max(2, -(-int(COLD_BYTES) // (k * lanes * 4)))
    pool = torch.empty(copies * k, lanes, device="cuda").fill_(0.5)
    iters = min(200, max(20, 4_000_000 // k))
    turn = itertools.count()
    times = {
        "warm": device_ms(
            lambda: write(table, ids, pool[:k]), iters),
        "cold": device_ms(lambda: write(
            table, ids, pool[next(turn) % copies * k:][:k]), iters),
    }
    del pool
    nbytes = row_write_bytes(table, ids)
    bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
    out = {}
    for key, ms in times.items():
        out[f"{key}_ms"] = ms
        out[f"{key}_gb_per_s"] = nbytes / ms / 1e6
        out[f"{key}_bound_share"] = bound_ms / ms
    return out


class RowWriteBench:
    """The row-write kernel's inputs on the card: the dim-16 group's table
    (29.2 M physical rows, 14.93 GB, past the 2^32-byte line) and the
    dim-4 group's (8.2 M, 4.18 GB), each with a copy that the plain
    version writes; the slice's ids and the real step's targets."""

    def __init__(self):
        self.gen = torch.Generator(device="cuda").manual_seed(SEED)
        targets = step_row_write_targets()
        (p16, tgt16), (p4, tgt4) = targets[DEEPFM_DIM], targets[4]
        self.p_rows, self.scratch = p16, p16 - 1
        if (self.scratch - 1) * 512 <= 2 ** 32:
            raise AssertionError("the slice's table does not cross 2^32 bytes")
        self.table = torch.empty(p16, 128, device="cuda").uniform_(
            generator=self.gen)
        self.ref = self.table.clone()
        self.table4 = torch.empty(p4, 128, device="cuda").uniform_(
            generator=self.gen)
        self.ref4 = self.table4.clone()
        self.tgt16, self.tgt4 = tgt16, tgt4
        # the slice's shape, as the kernel was first timed: the rows of the
        # tables above the dense lane times the batch, sorted; the
        # duplicates of a step and a random 30% more sent to the scratch row
        self.k = sum(1 for n in CRITEO_RAW if n > 32768) * DEEPFM_BATCH
        g = self.gen
        ids = torch.sort(torch.randint(
            0, self.scratch, (self.k,), device="cuda", generator=g))[0]
        dup = torch.zeros(self.k, dtype=torch.bool, device="cuda")
        dup[1:] = ids[1:] == ids[:-1]
        dup |= torch.rand(self.k, device="cuda", generator=g) < 0.3
        self.step_ids = torch.where(dup, ids.new_full((), self.scratch), ids)
        self.step_rows = self.rand_rows(self.k)
        self.step_rows[dup] = 0.5  # equal rows on the racing target

    def rand_rows(self, n, lanes=128):
        return torch.randn(n, lanes, device="cuda", generator=self.gen)

    def unique_ids(self, n, hi=None):
        hi = self.scratch if hi is None else hi
        return torch.randperm(hi, device="cuda", generator=self.gen)[:n]

    @staticmethod
    def same_row_per_target(ids, lanes=128):
        """Rows that are a function of the target, so that targets that
        repeat carry equal rows and the result does not depend on which
        write wins."""
        base = ids.clamp(min=0).float()[:, None]
        return (base * 1e-3 + torch.arange(lanes, device="cuda")).contiguous()

    def check(self, write):
        """``write(table, ids, rows)`` against _torch_write_rows, bit-equal
        over the whole table, case by case; the "_drop" cases through the
        table less its scratch row, as the engine calls it. Returns the
        names of the cases."""
        from torcheasyrec_tpu_torch.ops.row_write import _torch_write_rows

        scratch = self.scratch
        ids_many_dups = self.unique_ids(5000)
        ids_many_dups[torch.rand(5000, device="cuda", generator=self.gen)
                      < 0.9] = scratch
        ids_bad = self.unique_ids(4000)
        ids_bad[::3] = -1
        ids_bad[1::5] = self.p_rows
        ids_bad[2::7] = self.p_rows + 12345
        ids_bad[3::11] = -(2 ** 40)
        # ids in a slice whose data pointer is off the 16-byte line
        off64 = self.unique_ids(1001)[1:]
        off32 = self.unique_ids(1001).int()[1:]
        if off64.data_ptr() % 16 == 0 or off32.data_ptr() % 16 == 0:
            raise AssertionError("row_write: the id slices are aligned")
        # name: (ids, rows or None for rows by target, writes to the
        # scratch row dropped)
        cases = {
            "slice": (self.step_ids, self.step_rows, False),
            "slice_drop": (self.step_ids, self.step_rows, True),
            "real_step_dim16": (self.tgt16, None, False),
            "real_step_dim16_drop": (self.tgt16, None, True),
            "unique": (self.unique_ids(self.k), None, False),
            "duplicates_on_scratch": (ids_many_dups, None, False),
            "duplicates_on_scratch_drop": (ids_many_dups, None, True),
            "negative_and_too_large": (ids_bad, None, False),
            "negative_and_too_large_drop": (ids_bad, None, True),
            "k_1": (torch.tensor([scratch // 2], device="cuda"), None, False),
            "k_5": (self.unique_ids(5), None, False),
            "k_not_a_block_multiple": (self.unique_ids(1003), None, False),
            "k_2061_not_a_multiple_of_32": (self.unique_ids(2061), None,
                                            False),
            "k_294912": (self.unique_ids(294_912), None, False),
            "last_real_row": (torch.tensor([scratch - 1, 0, scratch, scratch],
                                           device="cuda"), None, True),
            "int32_ids": (self.unique_ids(2048).int(), None, False),
            "int64_ids_off_16_bytes": (off64, None, False),
            "int32_ids_off_16_bytes_drop": (off32, None, True),
        }
        checked = []
        for name, (ids, rows, drop) in cases.items():
            rows = self.same_row_per_target(ids) if rows is None else rows
            end = scratch if drop else self.p_rows
            write(self.table[:end], ids, rows)
            _torch_write_rows(self.ref[:end], ids, rows)
            torch.cuda.synchronize()
            if not torch.equal(self.table, self.ref):
                raise AssertionError(f"row_write {name}: kernel != plain "
                                     "version")
            checked.append(name)
        last_real = scratch - 1
        if not torch.equal(self.table[last_real], self.same_row_per_target(
                torch.tensor([last_real], device="cuda"))[0]):
            raise AssertionError("row_write: the last real row was not "
                                 "written")

        rows4 = self.same_row_per_target(self.tgt4)
        for end in (self.table4.shape[0], self.table4.shape[0] - 1):
            write(self.table4[:end], self.tgt4, rows4)
            _torch_write_rows(self.ref4[:end], self.tgt4, rows4)
            torch.cuda.synchronize()
            if not torch.equal(self.table4, self.ref4):
                raise AssertionError(f"row_write real_step_dim4 (through "
                                     f"{end} rows): kernel != plain version")
        checked += ["real_step_dim4", "real_step_dim4_drop"]

        # racing writes of different rows to the scratch row: every other
        # row is as the plain version leaves it, the scratch row's
        # neighbour too
        race_ids = torch.cat([self.unique_ids(3000),
                              torch.full((20000,), scratch, device="cuda")])
        race_rows = self.rand_rows(race_ids.shape[0])
        write(self.table, race_ids, race_rows)
        _torch_write_rows(self.ref, race_ids, race_rows)
        torch.cuda.synchronize()
        if not torch.equal(self.table[:scratch], self.ref[:scratch]):
            raise AssertionError("row_write: racing scratch writes reached "
                                 "another row")
        checked.append("racing_scratch_row")
        self.ref[scratch] = self.table[scratch]

        # small tables: 2 rows, and 256 lanes
        for name, p, lanes, ids in (
                ("two_row_table", 2, 128,
                 torch.tensor([1, 0, 1], device="cuda")),
                ("256_lanes", 300, 256, self.unique_ids(200, 300))):
            a = torch.randn(p, lanes, device="cuda", generator=self.gen)
            b = a.clone()
            rows = self.same_row_per_target(ids, lanes)
            write(a, ids, rows)
            _torch_write_rows(b, ids, rows)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"row_write {name}: kernel != plain "
                                     "version")
            checked.append(name)
        return checked

    def timing_shapes(self):
        """[(name, table, ids, scratch row)] of the timed shapes: (a) the slice's; (b)
        the real step's targets of both groups; each of those through the
        table less its scratch row, as the engine calls the kernel (the
        writes to it dropped), and (c) with K kept and no duplicate on the
        scratch row; (d) the K sweep over sorted unique rows of the dim-16
        table."""
        shapes = []
        for name, table, ids in (("slice", self.table, self.step_ids),
                                 ("real_dim16", self.table, self.tgt16),
                                 ("real_dim4", self.table4, self.tgt4)):
            scratch = table.shape[0] - 1
            shapes += [
                (name, table, ids, scratch),
                (f"{name}_drop", table[:scratch], ids, scratch),
                (f"{name}_no_scratch", table,
                 without_scratch(ids, scratch, self.gen), scratch)]
        for k in ROW_WRITE_SWEEP:
            shapes.append((f"sweep_{k}", self.table,
                           torch.sort(self.unique_ids(k))[0], self.scratch))
        return shapes

    @staticmethod
    def describe(table, ids, scratch):
        nbytes = row_write_bytes(table, ids)
        return {"rows": ids.shape[0],
                "on_scratch_row": int((ids == scratch).sum()),
                "table_rows": table.shape[0], "bytes": nbytes,
                "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3}


def phase_kernel_row_write(smi):
    """write_rows (the CUDA kernel) against _torch_write_rows on the card,
    bit-equal over the whole table; its times at every timed shape."""
    from torcheasyrec_tpu_torch.ops.row_write import (
        _torch_write_rows,
        write_rows,
    )

    bench = RowWriteBench()
    launches = write_rows.launches
    checked = bench.check(write_rows)
    n_checked = write_rows.launches - launches
    table, step_ids, step_rows = bench.table, bench.step_ids, bench.step_rows
    written = step_ids.clamp(max=bench.scratch)
    written_err = float((table[written] - bench.ref[written]).abs().max())
    del bench.ref, bench.ref4
    torch.cuda.empty_cache()
    before = write_rows.launches
    write_rows(table, step_ids[:0], step_rows[:0])
    if write_rows.launches != before:
        raise AssertionError("row_write: K = 0 launched the kernel")

    timings = {}
    for name, tbl, ids, scratch in bench.timing_shapes():
        timings[name] = {**bench.describe(tbl, ids, scratch),
                         **write_times(write_rows, tbl, ids)}
    # at the real step's dim-16 targets, as the engine calls the kernel
    # (through the table less its scratch row): the plain version (it
    # waits for the host: host clock) and index_copy_ of the same writes
    # (the scratch entries taken out before the timing); a launch of one
    # row, device and host time
    tgt, live = bench.tgt16, table[:bench.scratch]
    rows = torch.empty(tgt.shape[0], 128, device="cuda").fill_(0.5)
    main = timings["real_dim16_drop"]
    plain_ms = cuda_ms(lambda: _torch_write_rows(live, tgt, rows), 20)
    keep = tgt != bench.scratch
    lib_tgt, lib_rows = tgt[keep], rows[keep]
    library_ms = device_ms(lambda: live.index_copy_(0, lib_tgt, lib_rows),
                           50)
    one_id = step_ids[:1].contiguous()
    one_row = step_rows[:1].contiguous()
    bare_launch_ms = device_ms(lambda: write_rows(table, one_id, one_row), 200)
    host_ms_per_call = cuda_ms(lambda: write_rows(table, one_id, one_row), 200)
    write_rows.launches = launches + n_checked  # timing does not count
    emit({"phase": "kernel_row_write", "card": smi,
          "table": [bench.p_rows, 128], "table_gb": bench.p_rows * 512 / 1e9,
          "dim4_table": [bench.table4.shape[0], 128],
          "cases_bit_equal": checked, "launches_checked": n_checked,
          "max_abs_err_on_written_rows": written_err,
          "main_shape": "real_dim16_drop",
          "kernel_ms": main["warm_ms"], "plain_ms": plain_ms,
          "library_ms": library_ms,
          "library": "Tensor.index_copy_ of the rows not on the scratch row",
          "slice_ms": timings["slice"]["warm_ms"],
          "bare_launch_ms": bare_launch_ms,
          "host_ms_per_call": host_ms_per_call,
          "bytes": main["bytes"], "bound_ms": main["bound_ms"],
          "bound_by": "bytes", "kernel_gb_per_s": main["warm_gb_per_s"]})
    emit({"phase": "kernel_row_write", "case": "times by shape",
          "card": smi, "timings": timings})
    del bench, table, rows
    torch.cuda.empty_cache()
    return (written_err, (main["warm_ms"], plain_ms, main["bound_ms"],
                          "bytes"), library_ms, timings["slice"]["warm_ms"])


# --- DeepFM training ---------------------------------------------------------

def timed_steps(train_step, state, batch, n_warmup, n_steps):
    """(losses of every step, ms of each timed step with a synchronise
    after it, ms per step of a second window of ``n_steps`` that
    synchronises only at its end)."""
    losses, step_ms = [], []
    for i in range(n_warmup + n_steps):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
        if i >= n_warmup:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["total_loss"]))
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, metrics = train_step(state, batch)
    losses.append(float(metrics["total_loss"]))  # waits for the window
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    return losses, step_ms, window_ms


def phase_train_deepfm():
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.utils import checkpoint_util
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    cfg = parse_pipeline_config(deepfm_config_text(CRITEO_RAW))
    model, features, _, state, train_step = build_trainer(cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_init
    eg = model.embedding_group
    groups = {gk: {"dim": g.dim, "slot": g.slot, "rows_per_physical_row": g.spr,
                   "physical_rows": g.p_rows, "dense_lane_rows": g.dense_rows,
                   "gb": g.p_rows * 512 / 1e9}
              for gk, g in eg.engine.groups.items()}
    if not all(g.packed for g in eg.engine.groups.values()):
        raise AssertionError("a DeepFM group did not pack")
    batch = DataParser(features, labels=["label"]).parse_to_batch(
        criteo_cols(CRITEO_RAW, 0)).to("cuda")

    # sampled physical rows, to see after the steps which ones changed
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        _, residuals = eg.lookup(batch)
    samples = {}
    for gk, store in eg.engine_tables().items():
        g = eg.engine.groups[gk]
        flat_ids = residuals[gk][0]
        touched = torch.div(flat_ids[flat_ids >= 0], g.spr,
                            rounding_mode="floor")
        # half random rows, half the batch's own rows and their neighbours
        idx = torch.cat([
            torch.randint(0, g.p_rows - 1, (100_000,), device="cuda",
                          generator=gen),
            touched[:50_000], (touched[:50_000] + 1).clamp(max=g.p_rows - 2),
        ])
        is_touched = torch.isin(idx, touched)
        samples[gk] = (idx, is_touched, store[idx].clone())
    torch.cuda.synchronize()

    write_rows.launches = 0
    losses, step_ms, window_ms = timed_steps(
        train_step, state, batch, DEEPFM_WARMUP, DEEPFM_STEPS)
    n_driven = DEEPFM_WARMUP + 2 * DEEPFM_STEPS
    step_launches = write_rows.launches
    if step_launches != 2 * n_driven:
        raise AssertionError(
            f"row_write launched {step_launches} times in {n_driven} steps "
            "of 2 packed groups")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"DeepFM losses on the repeated batch: {losses}")
    sample_report = {}
    for gk, store in eg.engine_tables().items():
        idx, is_touched, before = samples[gk]
        same = (store[idx] == before).all(dim=1)
        if not same[~is_touched].all():
            raise AssertionError(f"{gk}: physical rows the batch did not "
                                 "touch changed")
        changed = float((~same[is_touched]).float().mean())
        if changed < 0.999:
            raise AssertionError(f"{gk}: only {changed} of the touched "
                                 "physical rows changed")
        sample_report[gk] = {
            "sampled": int(idx.shape[0]),
            "untouched_bit_equal": int((~is_touched).sum()),
            "touched_changed": int(is_touched.sum())}
    del samples

    def one_step():
        train_step(state, batch)
    step_profile = profile_forward(one_step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model, state, train_step, eg
    torch.cuda.empty_cache()

    # the same steps with the dense lane off (every table's ids sorted)
    model_off, _, _, state_off, step_off = build_trainer(
        cfg, dense_lane_rows=0)
    _, off_ms, off_window_ms = timed_steps(
        step_off, state_off, batch, DEEPFM_WARMUP, DEEPFM_STEPS // 2)
    del model_off, state_off, step_off
    torch.cuda.empty_cache()
    main_launches = write_rows.launches  # lane off: 2 a step as well

    # --- capped sizes: several models side by side --------------------------
    capped = [min(n, CRITEO_CAP) for n in CRITEO_RAW]
    cols = [criteo_cols(capped, 10 + i) for i in range(5)]
    cfg32 = parse_pipeline_config(deepfm_config_text(capped,
                                                     mixed_precision=""))
    variants = {
        "packed": build_trainer(cfg32),
        "packed_again": build_trainer(cfg32),
        "unpacked": build_trainer(cfg32, packed=False),
        "dense_lane_off": build_trainer(cfg32, dense_lane_rows=0),
    }
    ref_model = variants["packed"][0]
    weights = ref_model.state_dict()
    for name, (m, _, _, _, _) in variants.items():
        if name != "packed":
            m.load_state_dict(weights)
    del weights
    batches = [DataParser(variants["packed"][1], labels=["label"])
               .parse_to_batch(c).to("cuda") for c in cols[:3]]
    table_names = list(ref_model.embedding_group.engine._specs)

    def per_table(variant):
        m, _, _, st, _ = variants[variant]
        eng = m.embedding_group.engine
        fused = m.embedding_group.engine_tables()
        for name in table_names:
            yield (name, eng.extract_table(fused, name),
                   eng.extract_table_state(fused, st["sparse_opt"], name))

    def layout_err(other):
        """(largest |packed - other| over every table and its row state,
        relative to that tensor's largest magnitude; the share of all
        elements farther apart than LAYOUT_TOL of that magnitude)."""
        worst, beyond, total = 0.0, 0, 0
        for (name, w_a, st_a), (_, w_b, st_b) in zip(per_table("packed"),
                                                     per_table(other)):
            if set(st_a) != set(st_b):
                raise AssertionError(f"{name}: state names differ")
            for a, b in [(w_a, w_b)] + [(st_a[k], st_b[k]) for k in st_a]:
                diff = (a.float() - b.float()).abs()
                scale = max(float(b.float().abs().max()), 1e-30)
                worst = max(worst, float(diff.max()) / scale)
                beyond += int((diff > LAYOUT_TOL * scale).sum())
                total += diff.numel()
        return worst, beyond / total

    # After 1 step the variants differ only by the layouts' rounding and
    # the order of the atomic sums over duplicate ids: 1e-5 holds as it
    # stands. By step 3 even a second run of the same packed engine is
    # farther away than that in a few hundred elements (measured between
    # 8e-6 and 1.2e-4 from run to run): rowwise adagrad's first update of a
    # row is lr * g / (|g| + 1e-10), and a sample whose gradient nearly
    # cancels turns a rounding difference into one of up to lr / 4. So
    # after step 3 the bound is 1e-3 of the table's largest weight (a row
    # updated once too often or not at all is off by lr = 1e-3, about 0.45
    # of that magnitude), and at most 1e-5 of all elements may be farther
    # apart than 1e-5.
    layout_errs = {}
    for i, b in enumerate(batches):
        for m, _, _, st, step in variants.values():
            step(st, b)
        if i not in (0, len(batches) - 1):
            continue
        limit = LAYOUT_TOL if i == 0 else LAYOUT_TOL_3_STEPS
        errs = {}
        for other in variants:
            if other == "packed":
                continue
            err, share = layout_err(other)
            errs[other] = {"max_err": err, "share_beyond_1e-5": share}
            if not (err <= limit and share <= LAYOUT_TOL):
                raise AssertionError(
                    f"packed vs {other} after step {i + 1}: {err} of the "
                    f"table's max (limit {limit}), {share} of the elements "
                    f"beyond {LAYOUT_TOL} (limit {LAYOUT_TOL})")
        layout_errs[f"after_step_{i + 1}"] = errs
    launches_after_compare = write_rows.launches
    del variants, ref_model, batches
    torch.cuda.empty_cache()
    write_rows.launches = main_launches  # comparisons do not count

    # the trainer entry point: 3 steps over distinct batches from a parquet
    # file, an eval pass, the checkpoint; then evaluate() and a restore
    with tempfile.TemporaryDirectory() as tmp:
        train_path = os.path.join(tmp, "train.parquet")
        eval_path = os.path.join(tmp, "eval.parquet")
        pq.write_table(pa.concat_tables([pa.table(c) for c in cols[:3]]),
                       train_path)
        pq.write_table(pa.concat_tables([pa.table(c) for c in cols[3:]]),
                       eval_path)
        model_dir = os.path.join(tmp, "model")
        text = deepfm_config_text(capped, model_dir=model_dir,
                                  train_path=train_path, eval_path=eval_path,
                                  num_steps=3)
        cfg_path = os.path.join(tmp, "pipeline.config")
        with open(cfg_path, "w") as f:
            f.write(text)
        t0 = time.perf_counter()
        result = port_main.train_and_evaluate(cfg_path, device="cuda")
        file_launches = write_rows.launches - main_launches
        train_eval_s = time.perf_counter() - t0
        ckpt = checkpoint_util.latest_checkpoint(model_dir)
        ckpt_gb = os.path.getsize(ckpt) / 1e9
        t0 = time.perf_counter()
        again = port_main.evaluate(cfg_path, device="cuda")
        fresh, _, tx, _, _ = build_trainer(
            parse_pipeline_config(text), seed=SEED + 1)
        restored = checkpoint_util.restore_checkpoint(ckpt, fresh, tx)
        saved = torch.load(ckpt, map_location="cuda", weights_only=True)
        reload_s = time.perf_counter() - t0
    if file_launches != 2 * 3 or result["step"] != 3:
        raise AssertionError(
            f"train_and_evaluate: {result}, {file_launches} row-write "
            "launches for 3 steps")
    wanted = ("total_loss", "auc", "loss_binary_cross_entropy")
    if not all(np.isfinite(result.get(k, np.nan)) for k in wanted) or not (
            0.0 < result["auc"] < 1.0):
        raise AssertionError(f"train_and_evaluate: {result}")
    if again["auc"] != result["auc"]:
        raise AssertionError(
            f"evaluate() of the checkpoint: auc {again['auc']} against "
            f"{result['auc']} at the end of training")
    feg = fresh.embedding_group
    for name in table_names:
        w = feg.engine.extract_table(feg.engine_tables(), name)
        acc = feg.engine.extract_table_state(
            feg.engine_tables(), restored["sparse_opt"], name)["acc"]
        if not (torch.equal(w, saved["model"][f"embedding_group.tables.{name}"])
                and torch.equal(acc, saved["sparse_opt"][name]["acc"])):
            raise AssertionError(f"{name}: the restored model does not hold "
                                 "the checkpoint's bits")
    if restored["step"] != 3 or tx.count != 3:
        raise AssertionError("the restored step counts are not 3")
    del fresh, saved, restored
    torch.cuda.empty_cache()

    launches = write_rows.launches
    step_median = float(np.median(step_ms))
    emit({"phase": "train_deepfm", "batch": DEEPFM_BATCH,
          "buckets": "uncapped", "total_rows": int(sum(CRITEO_RAW)),
          "groups": groups, "init_s": init_s, "losses_first_last":
          [losses[0], losses[-1]], "steps_driven": n_driven,
          "step_ms_median": step_median,
          "step_ms_range": [min(step_ms), max(step_ms)],
          "window_step_ms": window_ms,
          "examples_per_s": DEEPFM_BATCH / window_ms * 1e3,
          "max_memory_allocated_gb": peak_gb,
          "row_write_launches_per_step": step_launches / n_driven,
          "sampled_physical_rows": sample_report,
          "step_profile": step_profile,
          "dense_lane_off": {"step_ms_median": float(np.median(off_ms)),
                             "step_ms_range": [min(off_ms), max(off_ms)],
                             "window_step_ms": off_window_ms},
          "capped_at": CRITEO_CAP,
          "layout_max_err_rel_to_table_max": layout_errs,
          "layout_tol": {"after_step_1": LAYOUT_TOL,
                         "after_step_3": LAYOUT_TOL_3_STEPS,
                         "share_beyond_1e-5": LAYOUT_TOL},
          "layout_dtype": "fp32",
          "layout_compare_launches_not_counted":
          launches_after_compare - main_launches,
          "train_and_evaluate": result, "train_and_evaluate_s": train_eval_s,
          "checkpoint_gb": ckpt_gb, "evaluate_auc": again["auc"],
          "evaluate_and_restore_s": reload_s,
          "restored_bit_equal_tables": len(table_names),
          "row_write_launches": launches})
    return launches, step_median


# --- phase train_loader: DeepFM from a directory of parquet files -----------
# uneven files (none a multiple of the batch) of about 40 batches in all;
# row groups of 10 000 rows, so a batch spans row groups and files
LOADER_FILE_ROWS = (36_001, 41_377, 29_513, 38_211, 45_055, 30_307, 36_919,
                    42_229, 31_199)
LOADER_ROW_GROUP = 10_000
LOADER_WORKERS = 4
# batches before a rate window opens: one from each worker, and one more
LOADER_WARMUP = LOADER_WORKERS + 1
PROFILED_STEPS = 10
EVAL_FILE_ROWS = (9_000, 8_000)
EVAL_BATCH = 6_000  # eval_batch_size, not the train batch: 3 eval batches
# two checkpoint writes of ~4.8 GB fewer than at 10, 4, 4, 2 (for
# train_pipelined's time); pruning, the resume and its watermark as before
RESUME_STEPS, RESUME_AT, SAVE_STEPS, KEEP_MAX = 8, 4, 5, 1


def write_criteo_dir(directory, sizes, buckets, seed: int,
                     row_group_size=None) -> None:
    """``part-<i>.parquet`` files of ``sizes`` rows of ``criteo_cols``, each
    row with a global row id ``rid`` (in file order)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(directory, exist_ok=True)
    start = 0
    for i, n in enumerate(sizes):
        cols = criteo_cols(buckets, seed + i, n)
        cols["rid"] = pa.array(np.arange(start, start + n, dtype=np.int64))
        pq.write_table(pa.table(cols),
                       os.path.join(directory, f"part-{i:02d}.parquet"),
                       row_group_size=row_group_size)
        start += n


def expected_rids(sizes, batch: int, workers: int) -> np.ndarray:
    """The row ids one train epoch consumes, sorted: each shard (whole
    files, file i to shard i % workers, one shard without workers) reads
    its rows in order and drops its own final remainder."""
    k = max(workers, 1)
    starts = np.cumsum((0,) + tuple(sizes))
    kept = []
    for w in range(k):
        rows = np.concatenate([np.arange(starts[i], starts[i + 1])
                               for i in range(len(sizes)) if i % k == w])
        kept.append(rows[:len(rows) // batch * batch])
    return np.sort(np.concatenate(kept))


def check_rids(what: str, rids, want: np.ndarray) -> int:
    got = np.concatenate(rids) if rids else np.zeros(0, np.int64)
    if len(got) != len(np.unique(got)) or not np.array_equal(np.sort(got),
                                                              want):
        raise AssertionError(
            f"{what}: consumed {len(got)} rows ({len(np.unique(got))} "
            f"distinct), want each of {len(want)} rows once")
    return len(got)


def loader_epoch(port_main, train_step, state, dl, synced: bool,
                 n_batches: int):
    """One epoch of ``n_batches`` batches through the training loop's body
    (``main.train_epoch``) fed by the loader ``dl``: (state, row ids
    consumed, per-step ms with a synchronise after each step when
    ``synced``, else the ms per step of the window from step
    LOADER_WARMUP (every worker has started) to the last, synchronised at
    both ends). The loop stops at the last batch, so the workers' exit
    stays out of the window."""
    rids, step_ms, marks = [], [], []
    t = [time.perf_counter()]

    def after_step(st, info):
        rids.append(info.reserved["rid"].to_numpy())
        if synced:
            torch.cuda.synchronize()
            now = time.perf_counter()
            step_ms.append((now - t[0]) * 1e3)
            t[0] = now
        elif len(rids) == LOADER_WARMUP:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

    batches = dl()
    try:
        state, _, _ = port_main.train_epoch(
            train_step, state, batches, {}, state["step"] + n_batches,
            after_step)
        torch.cuda.synchronize()
        end = time.perf_counter()
    finally:
        batches.close()
    if not synced:
        step_ms = [(end - marks[0]) * 1e3 / (len(rids) - LOADER_WARMUP)]
    return state, rids, step_ms


def loader_alone(dl, n_batches: int) -> dict:
    """Examples/s of the loader alone: ``n_batches`` batches read, parsed,
    pinned and copied to the card, timed from batch LOADER_WARMUP (a
    worker pool's start-up left out) to the last copy's end (its exit
    left out)."""
    batches = dl()
    try:
        for _ in range(LOADER_WARMUP):
            next(batches)
        torch.cuda.synchronize()
        t0, rows = time.perf_counter(), 0
        for _, info in itertools.islice(batches, n_batches - LOADER_WARMUP):
            rows += info.batch_size
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        batches.close()
    return {"examples_per_s": rows / seconds, "rows": rows,
            "seconds": seconds}


def copy_times(batch_cpu) -> dict:
    """One batch's host-to-device copy: from pinned memory one tensor at a
    time as the loader copies it (device ms from CUDA events, and the
    host's ms to issue the copies), from pageable memory, and as one
    coalesced pinned buffer of the same bytes (what ``pack.py`` does for
    the TPU)."""
    pinned = batch_cpu.pin_memory()
    nbytes = pinned.nbytes()
    flat = torch.empty(nbytes, dtype=torch.uint8).pin_memory()

    def host_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        return host

    per_tensor = lambda: pinned.to("cuda", non_blocking=True)  # noqa: E731
    coalesced = lambda: flat.to("cuda", non_blocking=True)  # noqa: E731
    return {
        "pinned_bytes_per_batch": nbytes,
        "tensors_per_batch": len(list(pinned.tensors())),
        "copy_ms_per_batch": cuda_ms(per_tensor, 20),
        "copy_host_ms_per_batch": host_ms(per_tensor),
        "pageable_copy_ms_per_batch": cuda_ms(
            lambda: batch_cpu.to("cuda"), 20),
        "coalesced_copy_ms": cuda_ms(coalesced, 20),
        "coalesced_copy_host_ms": host_ms(coalesced),
        "copy_gb_per_s": nbytes / cuda_ms(per_tensor, 20) / 1e6,
    }


def table_err(a: dict, b: dict, names) -> tuple:
    """(largest |a - b| over the tables and their row state, relative to
    that tensor's largest magnitude; the share of elements farther apart
    than LAYOUT_TOL of it) between two checkpoints' contents."""
    worst, beyond, total = 0.0, 0, 0
    for name in names:
        pairs = [(a["model"][f"embedding_group.tables.{name}"],
                  b["model"][f"embedding_group.tables.{name}"])]
        pairs += [(a["sparse_opt"][name][k], b["sparse_opt"][name][k])
                  for k in a["sparse_opt"][name]]
        for x, y in pairs:
            x, y = x.cuda().float(), y.cuda().float()
            diff = (x - y).abs()
            scale = max(float(y.abs().max()), 1e-30)
            worst = max(worst, float(diff.max()) / scale)
            beyond += int((diff > LAYOUT_TOL * scale).sum())
            total += diff.numel()
    return worst, beyond / total


def phase_train_loader():
    """DeepFM at full width trained from a directory of parquet files
    through the port's loader, with the thread prefetch and with worker
    processes; then the checkpointed ``train_and_evaluate`` and its resume
    at the capped sizes."""
    import shutil

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.utils import checkpoint_util
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    capped = [min(n, CRITEO_CAP) for n in CRITEO_RAW]
    out = {"phase": "train_loader", "batch": DEEPFM_BATCH,
           "files": len(LOADER_FILE_ROWS), "rows": sum(LOADER_FILE_ROWS),
           "row_group_rows": LOADER_ROW_GROUP, "buckets": "uncapped",
           "ids_drawn_below": CRITEO_CAP}
    with tempfile.TemporaryDirectory() as tmp:
        out["tmp_free_gb"] = shutil.disk_usage(tmp).free / 1e9
        data_dir = os.path.join(tmp, "train")
        eval_dir = os.path.join(tmp, "eval")
        t0 = time.perf_counter()
        # ids below the cap, so the capped tables below read the same files
        write_criteo_dir(data_dir, LOADER_FILE_ROWS, capped, 100,
                         LOADER_ROW_GROUP)
        write_criteo_dir(eval_dir, EVAL_FILE_ROWS, capped, 200)
        out["write_s"] = time.perf_counter() - t0

        # --- full width: the uncapped tables ------------------------------
        cfg = parse_pipeline_config(deepfm_config_text(CRITEO_RAW))
        model, features, _, state, train_step = build_trainer(cfg)
        state["epoch"] = 0
        with_workers = parse_pipeline_config(deepfm_config_text(
            CRITEO_RAW, data_extra=f"  num_workers: {LOADER_WORKERS}"))
        modes = {"thread": cfg.data_config,
                 "workers": with_workers.data_config}

        def loader(data_config, **kw):
            return create_dataloader(data_config, features, data_dir,
                                     mode="train", reserved_columns=["rid"],
                                     device="cuda", **kw)

        dls = {m: loader(dc) for m, dc in modes.items()}
        if [dl.mp_workers for dl in dls.values()] != [0, LOADER_WORKERS]:
            raise AssertionError("the loaders' worker counts are wrong")
        wants = {m: expected_rids(LOADER_FILE_ROWS, DEEPFM_BATCH,
                                  LOADER_WORKERS if m == "workers" else 0)
                 for m in modes}
        n_batches = {m: len(w) // DEEPFM_BATCH for m, w in wants.items()}
        out["loader_alone"] = {m: loader_alone(dl, n_batches[m])
                               for m, dl in dls.items()}
        batch_cpu = DataParser(features, labels=["label"]).parse_to_batch(
            criteo_cols(capped, 300))
        out["copy"] = copy_times(batch_cpu)

        write_rows.launches = 0
        fed, steps = {}, 0
        for m, dl in dls.items():
            runs = {}
            for synced in (True, False):
                state, rids, ms = loader_epoch(port_main, train_step, state,
                                               dl, synced, n_batches[m])
                check_rids(f"{m} loader", rids, wants[m])
                runs[synced] = ms
                steps += len(rids)
            fed[m] = {"steps_per_epoch": n_batches[m],
                      "rows_per_epoch": len(wants[m]),
                      "step_ms_median": float(np.median(runs[True])),
                      "step_ms_range": [min(runs[True]), max(runs[True])],
                      "window_step_ms": runs[False][0],
                      "examples_per_s": DEEPFM_BATCH / runs[False][0] * 1e3}
        out["loader_fed"] = fed

        # the device's idle share over loader-fed steps (thread loader)
        batches = dls["thread"]()
        try:
            for _ in range(LOADER_WARMUP):
                batch, _ = next(batches)
                train_step(state, batch)
            resident = batch

            def loader_fed_steps():
                for b, _ in itertools.islice(batches, PROFILED_STEPS):
                    train_step(state, b)
            out["loader_fed_profile"] = profile_forward(loader_fed_steps)
            steps += LOADER_WARMUP + PROFILED_STEPS
        finally:
            batches.close()
        launches = write_rows.launches
        if launches != 2 * steps:
            raise AssertionError(f"row_write launched {launches} times in "
                                 f"{steps} loader-fed steps")
        out["row_write_launches_per_step"] = launches / steps
        # the resident-batch step of the same model, side by side
        losses, res_ms, res_window = timed_steps(
            train_step, state, resident, DEEPFM_WARMUP, DEEPFM_STEPS)
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite losses: {losses}")
        out["resident"] = {"step_ms_median": float(np.median(res_ms)),
                           "step_ms_range": [min(res_ms), max(res_ms)],
                           "window_step_ms": res_window,
                           "examples_per_s": DEEPFM_BATCH / res_window * 1e3}
        del model, state, train_step, dls, batches, resident
        torch.cuda.empty_cache()

        # --- checkpoints, evals and the resume, capped tables -------------
        eval_glob = os.path.join(eval_dir, "part-*.parquet")

        def trainer_config(name):
            model_dir = os.path.join(tmp, name)
            path = os.path.join(tmp, f"{name}.config")
            with open(path, "w") as f:
                f.write(deepfm_config_text(
                    capped, model_dir=model_dir, train_path=data_dir,
                    eval_path=eval_glob, num_steps=RESUME_STEPS,
                    train_extra=f"  save_checkpoints_steps: {SAVE_STEPS}\n"
                    f"  keep_checkpoint_max: {KEEP_MAX}",
                    data_extra=f"  eval_batch_size: {EVAL_BATCH}"))
            return path, model_dir

        def eval_steps(model_dir):
            with open(os.path.join(model_dir,
                                   "train_eval_result_v2.txt")) as f:
                return [json.loads(line)["global_step"] for line in f]

        def kept(model_dir):
            return checkpoint_util.list_checkpoints(model_dir)

        write_rows.launches = 0
        t0 = time.perf_counter()
        straight_cfg, straight_dir = trainer_config("straight")
        straight = port_main.train_and_evaluate(straight_cfg, device="cuda")
        out["straight_s"] = time.perf_counter() - t0
        resumed_cfg, resumed_dir = trainer_config("resumed")
        first = port_main.train_and_evaluate(
            resumed_cfg, device="cuda", edit_config_json=json.dumps(
                {"train_config.num_steps": RESUME_AT}))
        mid = torch.load(checkpoint_util.checkpoint_path(resumed_dir,
                                                         RESUME_AT),
                         map_location="cpu", weights_only=True)
        t0 = time.perf_counter()
        resumed = port_main.train_and_evaluate(resumed_cfg, device="cuda",
                                               continue_train=True)
        out["resume_s"] = time.perf_counter() - t0
        trainer_launches = write_rows.launches
        a = torch.load(checkpoint_util.checkpoint_path(straight_dir,
                                                       RESUME_STEPS),
                       map_location="cpu", weights_only=True)
        b = torch.load(checkpoint_util.checkpoint_path(resumed_dir,
                                                       RESUME_STEPS),
                       map_location="cpu", weights_only=True)
        out["checkpoint_gb"] = os.path.getsize(checkpoint_util.checkpoint_path(
            straight_dir, RESUME_STEPS)) / 1e9
        checks = {
            "straight steps": (straight["step"], RESUME_STEPS),
            "first steps": (first["step"], RESUME_AT),
            "resumed steps": (resumed["step"], RESUME_STEPS),
            "resumed step and adam count": ((b["step"], b["dense_opt"][
                "count"]), (RESUME_STEPS, RESUME_STEPS)),
            "straight kept": (kept(straight_dir), [8]),
            "resumed kept": (kept(resumed_dir), [8]),
            "straight evals": (eval_steps(straight_dir), [5, 8]),
            "resumed evals": (eval_steps(resumed_dir), [4, 5, 8]),
            "watermark at the end": (b["dataloader_state"],
                                     a["dataloader_state"]),
            # step 4 stops inside the first file (36 001 rows)
            "watermark at the resume": (mid["dataloader_state"],
                                        {0: RESUME_AT * DEEPFM_BATCH - 1}),
            "row_write launches": (trainer_launches, 2 * 2 * RESUME_STEPS),
        }
        # the rows the resumed run reads: those of the straight run's steps
        # after RESUME_AT, read with the checkpoint's watermark
        rcfg = parse_pipeline_config(open(resumed_cfg).read())
        from torcheasyrec_tpu_torch.features import create_features

        cfeatures = create_features(list(rcfg.feature_configs))

        def rids_of(resume_state, skip):
            dl = create_dataloader(rcfg.data_config, cfeatures, data_dir,
                                   mode="train", reserved_columns=["rid"],
                                   resume_state=resume_state, device="cpu")
            batches = dl()
            try:
                return [info.reserved["rid"].to_numpy() for _, info in
                        itertools.islice(batches, skip, skip + RESUME_STEPS
                                         - RESUME_AT)]
            finally:
                batches.close()
        after = np.concatenate(rids_of(None, RESUME_AT))
        checks["rows after the resume"] = (
            np.concatenate(rids_of(mid["dataloader_state"], 0)).tolist(),
            after.tolist())
        eval_dl = create_dataloader(rcfg.data_config, cfeatures, eval_glob,
                                    mode="eval", device="cpu")
        batches = eval_dl()
        n_eval = sum(EVAL_FILE_ROWS)
        checks["eval batch sizes"] = (
            [i.batch_size for _, i in batches],
            [EVAL_BATCH] * (n_eval // EVAL_BATCH) + [n_eval % EVAL_BATCH])
        batches.close()
        for what, (got, want) in checks.items():
            if got != want:
                raise AssertionError(f"train_and_evaluate {what}: {got}, "
                                     f"want {want}")
        wanted = ("total_loss", "auc", "loss_binary_cross_entropy")
        for result in (straight, resumed):
            if not all(np.isfinite(result.get(k, np.nan)) for k in wanted):
                raise AssertionError(f"train_and_evaluate: {result}")

        # run-to-run noise: the straight run's steps again, in memory
        # (train_and_evaluate builds its model with seed 42)
        noise_model, noise_features, _, noise_state, noise_step = (
            build_trainer(rcfg, seed=42))
        noise_dl = create_dataloader(rcfg.data_config, noise_features,
                                     data_dir, mode="train", device="cuda")
        batches = noise_dl()
        try:
            noise_state["epoch"] = 0
            noise_state, _, _ = port_main.train_epoch(
                noise_step, noise_state, batches, {}, RESUME_STEPS)
        finally:
            batches.close()
        eg = noise_model.embedding_group
        noise = {"model": noise_model.state_dict(),
                 "sparse_opt": eg.opt_state_dict(noise_state["sparse_opt"])}
        names = list(eg.engine._specs)
        noise_err, noise_share = table_err(noise, a, names)
        del noise_model, noise_state, noise_step, noise, eg
        torch.cuda.empty_cache()
        err, share = table_err(b, a, names)
        limit = max(3 * noise_err, LAYOUT_TOL_3_STEPS)
        share_limit = max(3 * noise_share, LAYOUT_TOL)
        if not (err <= limit and share <= share_limit):
            raise AssertionError(
                f"resumed vs straight after {RESUME_STEPS} steps: {err} of "
                f"the table's max (limit {limit}), {share} of the elements "
                f"beyond {LAYOUT_TOL} (limit {share_limit})")
        out["resume"] = {
            "steps": RESUME_STEPS, "resumed_at": RESUME_AT,
            "capped_at": CRITEO_CAP, "save_checkpoints_steps": SAVE_STEPS,
            "keep_checkpoint_max": KEEP_MAX, "eval_batch_size": EVAL_BATCH,
            "kept": kept(resumed_dir), "evals": eval_steps(resumed_dir),
            "watermark_at_resume": mid["dataloader_state"],
            "max_err_rel_to_table_max": err, "share_beyond_1e-5": share,
            "noise_max_err": noise_err, "noise_share_beyond_1e-5": noise_share,
            "limit": limit, "share_limit": share_limit,
            "straight": straight, "resumed": resumed,
            "row_write_launches": trainer_launches}
        del a, b, mid
    out["row_write_launches"] = launches + trainer_launches
    emit(out)
    return launches + trainer_launches, fed


# --- phase train_zoo: the criteo_synth ranking, multi-task and retrieval
# configs: the port's copies of the JAX package's quality benchmark
# configs, each at its published width, on the JAX package's synthetic
# Criteo data; multi_tower_din to dbmtl_jrc add target attention over the
# click history (DIN), a sequence group the model ignores, the booster
# and light nets, and the session-wise JRC loss; dssm is two-tower
# retrieval with 32 sampled negatives a batch and recall@k
ZOO_CONFIGS = ["wide_and_deep", "dlrm", "dcn_v2", "masknet", "mmoe", "ple",
               "dbmtl", "multi_tower_din", "mmoe_has_sequence",
               "rocket_launching", "dbmtl_jrc", "dssm"]
# packed groups with tables past the dense lane, each one row write a
# step; dssm's three tables (at most 2 000 rows) all take the dense lane
ZOO_WRITTEN_GROUPS = {"wide_and_deep": 2, "xdeepfm": 2, "dssm": 0}
# one real step's writes held bit for bit against the plain version
# (xdeepfm: train_zoo_rest's)
ZOO_CAPTURED = ("dlrm", "multi_tower_din", "xdeepfm")
# the same, at one step of a model built with the dense lane off: every
# packed group then takes the row write (dssm: its two groups)
ZOO_LANE_OFF = ("dssm",)
# dssm's recall after its one epoch moves with the initial weights far
# more than 0.02 (PERF.md §6: recall@1 sd 0.06 over seeds on the CPU), so
# its label alone cannot tell a wrong device path. Its card run starts
# from weights drawn on the CPU and is held, beside its labels, against a
# CPU run of the same weights within ZOO_CPU_BOUND. At the default seed
# five card runs read at most 0.009 from the CPU's (sums over duplicate
# ids differ run to run); over 22 seeds the gap reached 0.025 at one, so
# the bound is this seed's, not any seed's (PERF.md §6)
ZOO_CPU_REFERENCE = ("dssm",)
ZOO_CPU_BOUND = 0.02
ZOO_TRAIN_ROWS, ZOO_EVAL_ROWS = 262_144, 65_536  # ensure_dataset's sizes
ZOO_AUC_BOUND = 0.02  # the JAX package's bound for a run off the TPU
ZOO_PREDICT_BATCHES = 2
# the resident step's timing: 20 timed and 10 profiled steps until
# train_sid joined the script
# 5, 10 and 5 before train_zch_ranks and train_stream joined
ZOO_WARMUP, ZOO_TIMED_STEPS, ZOO_PROFILED_STEPS = 3, 6, 3
ZOO_BATCH = 4096
ZOO_SUMMARY = ("metrics", "step_ms_median", "examples_per_s",
               "idle_share_profiled_steps", "max_memory_allocated_gb",
               "evaluate_s", "train_and_evaluate_s", "row_write_launches")


_DATA_ROOT = []


def criteo_synth_data(train_rows: int, eval_rows: int) -> dict:
    """The criteo_synth rows (``synthetic.ensure_dataset``) in one
    directory for the whole run, so that the phases that read the same
    sizes generate them once; the directory goes at exit."""
    from torcheasyrec_tpu_torch.benchmark import synthetic

    if not _DATA_ROOT:
        root = tempfile.TemporaryDirectory()
        atexit.register(root.cleanup)
        _DATA_ROOT.append(root)
    return synthetic.ensure_dataset(_DATA_ROOT[0].name, train_rows,
                                    eval_rows)


def zoo_config_dir() -> str:
    import torcheasyrec_tpu_torch

    return os.path.join(os.path.dirname(torcheasyrec_tpu_torch.__file__),
                        "benchmark", "configs")


def write_targets(model, step, state, batch):
    """(table before the write, targets, rows, table after) of every
    ``write_rows`` call of one real train step, in call order."""
    from torcheasyrec_tpu_torch.ops import row_write

    calls, real = [], row_write.write_rows

    def capture(table, ids, rows):
        before = table.clone()
        real(table, ids, rows)  # counts on the module's name, ``capture``
        calls.append((before, ids.clone(), rows.clone(), table.clone()))
        return table

    capture.launches = real.launches
    row_write.write_rows = capture
    try:
        step(state, batch)
    finally:
        row_write.write_rows = real
        real.launches = capture.launches
    return calls


def item_emb_traffic(eng, batch, calls) -> dict:
    """What the shared ``item_emb`` table (``tgt_item`` and ``click_seq``)
    brings to one step's row writes: its ids in the batch, the distinct
    ones, and the written targets that fall in its physical rows (none
    where the table takes the dense lane)."""
    gk, off, rows = eng.table_rows("item_emb")
    g = eng.groups[gk]
    ids = torch.cat([batch.sparse_features["tgt_item"].values.reshape(-1),
                     batch.sequence_sparse_features["click_seq"]
                     .values.reshape(-1)])
    ids = ids[ids >= 0]
    lo, hi = off // g.spr, -(-(off + rows) // g.spr)
    targets = sum(int(((c[1] >= lo) & (c[1] < hi)).sum()) for c in calls)
    return {"ids": int(ids.numel()), "distinct_ids": int(ids.unique().numel()),
            "table_rows": rows, "dense_lane": "item_emb" in g.dense_tables,
            "row_write_targets": targets}


def check_step_writes(name, calls) -> None:
    """The kernel against the plain version at one real step's captured
    row writes, on copies of each table before the write: a copy has no
    tolerance. These launches do not count."""
    from torcheasyrec_tpu_torch.ops.row_write import (
        _torch_write_rows,
        write_rows,
    )

    kept = write_rows.launches
    for before_t, tgt, rows, after_t in calls:
        a, b = before_t.clone(), before_t.clone()
        write_rows(a, tgt, rows)
        _torch_write_rows(b, tgt, rows)
        if not (torch.equal(a, b) and torch.equal(a, after_t)):
            raise AssertionError(
                f"{name}: the row write and its plain version leave "
                "different tables at a real step's targets")
    write_rows.launches = kept


def lane_off_step(name, cfg, batch) -> dict:
    """One real train step of the config's model built with the dense lane
    off, every packed group through the row write: its launches, and per
    call the group's ids in the batch, the distinct ones and the written
    targets, the writes held bit for bit against the plain version."""
    from torcheasyrec_tpu_torch.ops.row_write import write_rows

    model, _, _, state, step = build_trainer(cfg, dense_lane_rows=0)
    eng = model.embedding_group.engine
    with torch.no_grad():
        _, residuals = model.embedding_group.lookup(batch)
    groups = [gk for gk in residuals if eng.groups[gk].packed]
    write_rows.launches = 0
    calls = write_targets(model, step, state, batch)
    torch.cuda.synchronize()
    launches = write_rows.launches
    if launches != len(groups) or len(calls) != len(groups):
        raise AssertionError(f"{name}: {launches} row writes at a lane-off "
                             f"step of the packed groups {groups}")
    check_step_writes(name, calls)
    per_call = []
    for gk, call in zip(groups, calls):
        ids = residuals[gk][0]
        ids = ids[ids >= 0]
        per_call.append({
            "group": gk, "tables": [t.name for t in eng.groups[gk].specs],
            "ids": int(ids.numel()), "distinct_ids": int(ids.unique().numel()),
            "targets": int(call[1].shape[0]),
            "table_rows": int(call[0].shape[0])})
    del model, state, step
    torch.cuda.empty_cache()
    return {"launches": launches, "bit_equal": True, "calls": per_call}


def zoo_edits(src, model_dir, paths, num_steps=None) -> str:
    """``edit_config_json`` for a zoo config: its model_dir, where it has
    a negative sampler the sampler's item file, and ``num_steps`` where
    the run is cut short of its epoch."""
    from torcheasyrec_tpu_torch.utils.config_util import load_pipeline_config

    edits = {"model_dir": model_dir}
    sampler = load_pipeline_config(src).data_config.WhichOneof("sampler")
    if sampler is not None:
        edits[f"data_config.{sampler}.input_path"] = paths["items"]
    if num_steps:
        edits["train_config.num_steps"] = num_steps
    return json.dumps(edits)


def cpu_init(src, path) -> str:
    """The config's initial weights (the default seed), drawn on the CPU
    and saved as a state_dict file for ``fine_tune_checkpoint``."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.utils.config_util import load_pipeline_config

    model, _ = port_main.build_model(load_pipeline_config(src), "cpu")
    torch.save(model.state_dict(), path)
    return path


def cpu_reference(name, src, paths, tmp, init, result, metric_names,
                  num_steps=None) -> dict:
    """The config trained on the CPU from the card run's initial weights
    ``init`` (for ``num_steps`` where the card run was cut to them); each
    metric of the card's ``result`` must lie within ZOO_CPU_BOUND of the
    CPU run's."""
    from torcheasyrec_tpu_torch import main as port_main

    t0 = time.perf_counter()
    cpu = port_main.train_and_evaluate(
        src, train_input_path=paths["train"], eval_input_path=paths["eval"],
        edit_config_json=zoo_edits(src, os.path.join(tmp, f"{name}_cpu"),
                                   paths, num_steps),
        fine_tune_checkpoint=init, device="cpu")
    out = {"train_and_evaluate_cpu_s": time.perf_counter() - t0,
           "cpu_steps": cpu["step"], "bound": ZOO_CPU_BOUND}
    for m in metric_names:
        dist = result[m] - cpu[m]
        out[m] = {"card": result[m], "cpu": cpu[m], "card_minus_cpu": dist}
        if not abs(dist) <= ZOO_CPU_BOUND:
            raise AssertionError(
                f"{name}: {m} {result[m]} on the card is {dist:+.4f} from "
                f"{cpu[m]} on the CPU from the same weights (bound "
                f"{ZOO_CPU_BOUND})")
    return out


def zoo_model(name, paths, pred_in, tmp, labels, src=None,
              num_steps=None) -> dict:
    """One criteo_synth config through the entry points: an epoch of
    ``train_and_evaluate`` (``num_steps`` where it is cut shorter),
    ``evaluate`` and ``predict_checkpoint`` of its checkpoint; then the
    step timed on a resident batch. ``src`` is the config file (the
    repo's copy of the name by default). ``labels`` are its pinned labels;
    a config without them (``labels`` {"metrics": [names]}) is held
    against a CPU run from the same CPU-drawn weights, as those of
    ``ZOO_CPU_REFERENCE`` are beside their labels."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.utils import checkpoint_util
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    model_dir = os.path.join(tmp, name)
    src = src or os.path.join(zoo_config_dir(), "criteo_synth",
                              f"{name}.config")
    pinned = isinstance(labels["metrics"], dict)
    init = None
    if name in ZOO_CPU_REFERENCE or not pinned:
        init = cpu_init(src, os.path.join(tmp, f"{name}_init.pt"))
    write_rows.launches = 0
    t0 = time.perf_counter()
    result = port_main.train_and_evaluate(
        src, train_input_path=paths["train"], eval_input_path=paths["eval"],
        edit_config_json=zoo_edits(src, model_dir, paths, num_steps),
        fine_tune_checkpoint=init, device="cuda")
    torch.cuda.synchronize()
    train_eval_s = time.perf_counter() - t0
    launches = write_rows.launches
    cfg_path = os.path.join(model_dir, "pipeline.config")
    cfg = parse_pipeline_config(open(cfg_path).read())
    batch_size = cfg.data_config.batch_size
    steps = num_steps or ZOO_TRAIN_ROWS // batch_size
    if result["step"] != steps:
        raise AssertionError(f"{name}: {result['step']} steps, not {steps}")
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError(f"{name}: not finite: {result}")

    # the pinned labels, from the JAX package's run on a TPU
    metrics = {}
    for m in ([] if pinned else labels["metrics"]):
        if m not in result:
            raise AssertionError(f"{name}: no metric {m} in {result}")
        metrics[m] = {"value": result[m]}
    for m, spec in (labels["metrics"].items() if pinned else ()):
        if m not in result:
            raise AssertionError(f"{name}: no metric {m} in {result}")
        dist = result[m] - spec["value"]
        metrics[m] = {"value": result[m], "label": spec["value"],
                      "distance": dist, "threshold": spec["threshold"],
                      "within_threshold": abs(dist) <= spec["threshold"]}
        if abs(dist) > ZOO_AUC_BOUND:
            raise AssertionError(
                f"{name}: {m} {result[m]} is {dist:+.4f} from its label "
                f"{spec['value']} (bound {ZOO_AUC_BOUND})")

    t0 = time.perf_counter()
    again = port_main.evaluate(cfg_path, eval_input_path=paths["eval"],
                               device="cuda")
    eval_s = time.perf_counter() - t0
    for m in metrics:
        if again[m] != result[m]:
            raise AssertionError(f"{name}: evaluate() {m} {again[m]} against "
                                 f"{result[m]} at the end of training")

    pred_out = os.path.join(tmp, f"{name}_pred.parquet")
    t0 = time.perf_counter()
    n_pred = port_main.predict_checkpoint(cfg_path, pred_in, pred_out,
                                          device="cuda")
    predict_s = time.perf_counter() - t0
    pred = pq.read_table(pred_out)
    model, features = port_main.build_model(cfg, "cuda")
    checkpoint_util.load_model_weights(
        checkpoint_util.latest_checkpoint(model_dir), model)
    eval_step = port_main.make_eval_step(model, with_loss=False)
    # predict's loader: no negative sampler, one item row a user
    dl = create_dataloader(cfg.data_config, features, pred_in,
                           mode="predict", device="cuda")
    outs = {}
    for batch, _ in dl():
        for k, v in eval_step(batch)[0].items():
            if not k.startswith("__"):  # predict writes no hidden layer
                outs.setdefault(k, []).append(v.float().cpu().numpy())
    outs = {k: np.concatenate(v) for k, v in outs.items()}
    probs = [k for k in outs if k.startswith("probs")]
    scores = probs or [k for k in outs if k == "similarity"]
    if n_pred != ZOO_PREDICT_BATCHES * batch_size or not scores or (
            sorted(pred.column_names) != sorted(outs)):
        raise AssertionError(f"{name}: predicted {n_pred} rows, columns "
                             f"{pred.column_names} against {sorted(outs)}")
    for k, v in outs.items():
        col = pred.column(k).to_numpy(zero_copy_only=False)
        if v.ndim > 1:  # [B, C] logits: a list column
            col = np.stack(col)
        if not np.array_equal(col, v):
            raise AssertionError(f"{name}: predict_checkpoint {k} differs "
                                 "from the eval step's")
        if k in probs and not (np.isfinite(col).all() and (col > 0).all()
                               and (col < 1).all()):
            raise AssertionError(f"{name}: {k} not finite in (0, 1)")
    del model, eval_step

    cpu_ref = None
    if init is not None:
        cpu_ref = cpu_reference(name, src, paths, tmp, init, result,
                                list(labels["metrics"]), num_steps)

    # the step on a resident batch: groups, timing, idle share, memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, features, tx, state, step = build_trainer(cfg)
    eng = model.embedding_group.engine
    written = sorted(gk for gk, g in eng.groups.items() if g.packed and any(
        t.name not in g.dense_tables for t in g.specs))
    if len(written) != ZOO_WRITTEN_GROUPS.get(name, 1):
        raise AssertionError(f"{name}: written packed groups {written}")
    if launches != steps * len(written):
        raise AssertionError(
            f"{name}: {launches} row-write launches in {steps} steps of "
            f"{len(written)} written packed groups {written}")
    train_dl = create_dataloader(cfg.data_config, features, paths["train"],
                                 mode="train", device="cuda")
    batches = train_dl()
    batch = next(iter(batches))[0]
    batches.close()
    before = write_rows.launches
    losses, step_ms, window_ms = timed_steps(step, state, batch, ZOO_WARMUP,
                                             ZOO_TIMED_STEPS)

    def profiled_steps():
        for _ in range(ZOO_PROFILED_STEPS):
            step(state, batch)

    profile = profile_forward(profiled_steps)
    driven = ZOO_WARMUP + 2 * ZOO_TIMED_STEPS + ZOO_PROFILED_STEPS
    timed_launches = write_rows.launches - before
    if timed_launches != driven * len(written):
        raise AssertionError(f"{name}: {timed_launches} row-write launches "
                             f"in {driven} timed steps")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: timed losses not finite: {losses}")
    out = {
        "config": os.path.relpath(src), "batch": batch_size,
        "steps": steps, "train_and_evaluate_s": train_eval_s,
        "train_and_evaluate": result, "metrics": metrics,
        "evaluate_s": eval_s, "predict_rows": n_pred, "predict_s": predict_s,
        "written_packed_groups": written,
        "groups": {gk: {"packed": g.packed, "slot": g.slot,
                        "physical_rows": g.p_rows}
                   for gk, g in eng.groups.items()},
        "row_write_launches": launches,
        "timed_row_write_launches_not_counted": timed_launches,
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_range": [min(step_ms), max(step_ms)],
        "window_step_ms": window_ms,
        "examples_per_s": batch_size / window_ms * 1e3,
        "idle_share_profiled_steps": profile.get("device_idle_share"),
        "step_profile": profile,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if "similarity" in outs:
        out["predict_similarity_shape"] = list(outs["similarity"].shape)
    if cpu_ref is not None:
        out["cpu_reference"] = cpu_ref
    if name in ZOO_CAPTURED:
        # one real step's writes, the kernel against the plain version
        calls = write_targets(model, step, state, batch)
        check_step_writes(name, calls)
        out["row_write_at_step_targets"] = {
            "calls": len(calls), "bit_equal": True,
            "targets": [int(c[1].shape[0]) for c in calls],
            "table_rows": [int(c[0].shape[0]) for c in calls]}
        if "item_emb" in eng._specs:
            out["row_write_at_step_targets"]["item_emb"] = item_emb_traffic(
                eng, batch, calls)
    del model, tx, state, step
    torch.cuda.empty_cache()
    if name in ZOO_LANE_OFF:
        out["dense_lane_off_step"] = lane_off_step(name, cfg, batch)
    del batch
    return out


# retrieval models that the published configs do not run, each one
# forward and backward on the card against the same model and batch on
# the CPU: DSSMV2 with hard negatives (their scatter into the similarity)
# and MIND (capsule routing, masked softmax, label-aware attention)
MATCH_ON_CARD_BATCH, MATCH_ON_CARD_ITEMS, MATCH_ON_CARD_SEQ = 512, 2000, 20
MATCH_ON_CARD_TOL = 1e-4  # fp32: max abs error over the CPU's max abs
# a gradient below this share of the largest one is at rounding level
MATCH_ZERO_GRAD = 1e-5
_MATCH_SAMPLER = ('num_sample: 32 attr_fields: "item_id" attr_fields: '
                  '"item_cluster" item_id_field: "item_id"')
MATCH_ON_CARD = {
    "dssm_v2_hard": (
        "hard_negative_sampler_v2 { user_input_path: \"unused\" "
        "item_input_path: \"{items}\" pos_edge_input_path: \"{pos}\" "
        "hard_neg_edge_input_path: \"{hard}\" num_hard_sample: 4 "
        + _MATCH_SAMPLER + ' user_id_field: "user_taste" }',
        'dssm_v2 { user_tower { input: "user" mlp { hidden_units: [64, 32] '
        '} } item_tower { input: "item" mlp { hidden_units: [64, 32] } } '
        "output_dim: 16 temperature: 0.2 }"),
    "mind": (
        "negative_sampler { input_path: \"{items}\" " + _MATCH_SAMPLER + " }",
        'mind { user_tower { input: "user" history_input: "hist" '
        "user_mlp { hidden_units: [32] } user_seq_combine: CONCAT "
        "capsule_config { max_k: 4 max_seq_len: "
        f"{MATCH_ON_CARD_SEQ} high_dim: 16 }} "
        "concat_mlp { hidden_units: [32] } } "
        'item_tower { input: "item" mlp { hidden_units: [32] } } '
        "output_dim: 16 simi_pow: 10 temperature: 0.2 }"),
}


def match_on_card_files(root) -> dict:
    """Retrieval data from a seed: the sampler's item table (id, weight,
    ``id:cluster`` attrs), positive and hard-negative edge files, and a
    parquet of user taste, a dense feature, the positive item, its
    cluster and a click history."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    r = np.random.default_rng(SEED)
    n, n_items = 2 * MATCH_ON_CARD_BATCH, MATCH_ON_CARD_ITEMS
    ids = np.arange(n_items)
    paths = {k: os.path.join(root, f"match_{k}.parquet")
             for k in ("items", "pos", "hard", "data")}
    pq.write_table(pa.table({
        "id": ids, "weight": r.uniform(0.5, 2.0, n_items),
        "attrs": [f"{i}:{i // 40}" for i in ids]}), paths["items"])
    users = np.repeat(np.arange(50), 20)
    pq.write_table(pa.table({
        "user": users, "item": r.integers(0, n_items, users.size),
        "weight": np.ones(users.size)}), paths["pos"])
    hard_u = np.repeat(np.arange(0, 50, 2), 3)
    pq.write_table(pa.table({
        "user": hard_u, "item": r.integers(0, n_items, hard_u.size),
        "weight": np.ones(hard_u.size)}), paths["hard"])
    taste = r.integers(0, 50, n)
    item = np.where(r.random(n) < 0.8, taste * 40 + r.integers(0, 40, n),
                    r.integers(0, n_items, n))
    lens = r.integers(1, MATCH_ON_CARD_SEQ + 5, n)
    pq.write_table(pa.table({
        "user_taste": taste, "int_0": r.normal(size=n).astype(np.float32),
        "item_id": item, "item_cluster": item // 40,
        "click_seq": [";".join(map(str, taste[i] * 40 + r.integers(0, 40, k)))
                      for i, k in enumerate(lens)],
        "pos_label": np.ones(n, np.float32)}), paths["data"])
    return paths


def match_on_card_config(sampler, block, paths):
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    seq = "hist" in block
    groups = [("user", ["user_taste", "int_0"], "DEEP"),
              ("item", ["item_id", "item_cluster"], "DEEP")]
    if seq:
        groups.append(("hist", ["click_seq"], "SEQUENCE"))
    feats = [
        'id_feature { feature_name: "user_taste" expression: '
        '"user:user_taste" num_buckets: 50 embedding_dim: 16 }',
        'raw_feature { feature_name: "int_0" expression: "user:int_0" }',
        'id_feature { feature_name: "item_id" expression: "item:item_id" '
        f"num_buckets: {MATCH_ON_CARD_ITEMS} embedding_dim: 16 }}",
        'id_feature { feature_name: "item_cluster" expression: '
        '"item:item_cluster" num_buckets: 50 embedding_dim: 8 }']
    if seq:
        feats.append(
            'sequence_id_feature { feature_name: "click_seq" expression: '
            '"user:click_seq" num_buckets: '
            f"{MATCH_ON_CARD_ITEMS} embedding_dim: 16 sequence_length: "
            f'{MATCH_ON_CARD_SEQ} embedding_name: "item_id_emb" }}')
    text = "\n".join(
        ["train_config {",
         "  sparse_optimizer { adagrad_optimizer { lr: 0.05 }"
         " constant_learning_rate {} }",
         "  dense_optimizer { adam_optimizer { lr: 0.001 }"
         " constant_learning_rate {} }", "}",
         "data_config {", f"  batch_size: {MATCH_ON_CARD_BATCH}",
         "  dataset_type: ParquetDataset", "  fg_mode: FG_NONE",
         '  label_fields: "pos_label"',
         "  " + sampler.replace("{items}", paths["items"]).replace(
             "{pos}", paths["pos"]).replace("{hard}", paths["hard"]), "}"]
        + [f"feature_configs {{ {f} }}" for f in feats]
        + ["model_config {"]
        + [f'  feature_groups {{ group_name: "{g}" '
           + " ".join(f'feature_names: "{f}"' for f in fs)
           + f" group_type: {kind} }}" for g, fs, kind in groups]
        + ["  " + block, "  metrics { recall_at_k { top_k: 1 } }",
           "  losses { softmax_cross_entropy {} }", "}"])
    return parse_pipeline_config(text)


def match_models_on_card(tmp) -> dict:
    """``MATCH_ON_CARD``'s models: one batch from the loader (its sampled
    negatives, hard ones included) through the forward and the backward
    of the same weights on the CPU and on the card; predictions, losses
    and the dense gradients must agree within MATCH_ON_CARD_TOL of the
    CPU's max abs value, but a gradient at rounding level on the CPU
    (MATCH_ZERO_GRAD), which must be so on the card too. Launches no row
    write (no update)."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader

    paths = match_on_card_files(tmp)
    out = {}
    for name, (sampler, block) in MATCH_ON_CARD.items():
        cfg = match_on_card_config(sampler, block, paths)
        cpu_model, features, _ = port_main._build_model_and_optim(cfg, "cpu")
        card_model, _, _ = port_main._build_model_and_optim(cfg, "cuda")
        card_model.load_state_dict(cpu_model.state_dict())
        batches = create_dataloader(cfg.data_config, features, paths["data"],
                                    mode="train", device="cpu")()
        batch = next(iter(batches))[0]
        batches.close()
        card_batch = batch.to("cuda")
        cmp = CpuComparison(name, MATCH_ON_CARD_TOL, MATCH_ZERO_GRAD)
        with torch.no_grad():
            ref_preds = cpu_model.eval()(batch)
            preds = card_model.eval()(card_batch)
        for k in ref_preds:
            cmp.compare(k, ref_preds[k], preds[k])
        ref_loss, ref_grads = dense_grads(cpu_model, batch)
        loss, grads = dense_grads(card_model, card_batch)
        cmp.compare("loss", torch.tensor(ref_loss), torch.tensor(loss))
        # a gradient at rounding level on the CPU is 0 by construction
        # (the item tower's output bias under a softmax over item rows):
        # the card's must be at rounding level too, not equal
        cmp.compare_grads(ref_grads, grads)
        errs, zero = cmp.errs, sorted(cmp.zero)
        sim = ref_preds["similarity"]
        out[name] = {"similarity_shape": list(sim.shape),
                     "item_rows": int(ref_preds["item_tower_emb"].shape[0]),
                     "max_rel_err": max(errs.values()), "compared": len(errs),
                     "zero_gradients": zero, "tol": MATCH_ON_CARD_TOL}
    return out


def phase_train_zoo():
    """The twelve criteo_synth configs through the port's entry points,
    then ``MATCH_ON_CARD``'s models on the card against the CPU; returns
    the row-write launches of the epochs and those of the dense-lane-off
    steps (``ZOO_LANE_OFF``)."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.ops.row_write import write_rows

    with open(os.path.join(zoo_config_dir(), "base_eval_metric.json")) as f:
        pinned = json.load(f)
    out = {"phase": "train_zoo", "models": {}}
    launches, lane_off = 0, 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = criteo_synth_data(ZOO_TRAIN_ROWS, ZOO_EVAL_ROWS)
        out["data_s"] = time.perf_counter() - t0
        pred_in = os.path.join(tmp, "predict_in.parquet")
        pq.write_table(pq.read_table(paths["eval"]).slice(
            0, ZOO_PREDICT_BATCHES * ZOO_BATCH), pred_in)
        for name in ZOO_CONFIGS:
            t0 = time.perf_counter()
            key = ("torcheasyrec_tpu_torch/benchmark/configs/criteo_synth/"
                   f"{name}.config")
            res = zoo_model(name, paths, pred_in, tmp, pinned[key])
            if res["batch"] != ZOO_BATCH:
                raise AssertionError(f"{name}: batch {res['batch']}")
            res["model_s"] = time.perf_counter() - t0
            launches += res["row_write_launches"]
            if "dense_lane_off_step" in res:
                lane_off += res["dense_lane_off_step"]["launches"]
            out["models"][name] = res
            emit({"phase": "train_zoo_model", "model": name, **res})
        before = write_rows.launches
        out["match_on_card"] = match_models_on_card(tmp)
        if write_rows.launches != before:
            raise AssertionError("the retrieval models' card checks launched "
                                 "row writes")
    out["row_write_launches"] = launches
    emit({"phase": "train_zoo", "data_s": out["data_s"],
          "row_write_launches": launches,
          "match_on_card": out["match_on_card"],
          "dense_lane_off_row_write_launches": lane_off,
          "models": {n: {k: r[k] for k in ZOO_SUMMARY}
                     for n, r in out["models"].items()}})
    return launches, lane_off


# --- train_options: the training loop's options ----------------------------
FP16_TOL = 5e-3  # the fp16 kernels: max|kernel - plain| <= tol * max|plain|
OPTIONS_STEPS = 8
# the lane's training with the loop options the DLRM-HSTU path can take
OPTIONS_EXTRA = """    grad_scaler {}
    grad_clipping { clipping_type: "norm" max_gradient: 1.0 }
    gradient_accumulation_steps: 2"""
OVERFLOW_SCALE = 2.0 ** 30
OVERFLOW_MAX_STEPS = 40
OVERFLOW_FINITE_STEPS = 6  # finite steps wanted after the backoff
OVERFLOW_DO_SCALE = 1e3  # an upstream gradient whose dz and dv pass 65504
OPTIONS_ROWS = 8 * 4096, 2 * 4096  # criteo_synth rows: train, eval
OPTIONS_KIND_STEPS = 5
# the six sparse kinds of the optimizer slice, as the CPU tests run them
# (rmsprop at eps 1e-4: rows whose gradient nearly cancels would take
# lr-sized steps of rounding noise at 1e-8, which no two summation
# orders share)
OPTIONS_KINDS = {
    "lars_sgd": "lars_sgd_optimizer { lr: 0.5 momentum: 0.8 eta: 0.01 }",
    "lamb": "lamb_optimizer { lr: 0.01 }",
    "partial_rowwise_lamb":
        "partial_rowwise_lamb_optimizer { lr: 0.01 weight_decay: 0.01 }",
    "partial_rowwise_adam":
        "partial_rowwise_adam_optimizer { lr: 0.01 weight_decay: 0.01 }",
    "adadelta": "adadelta_optimizer { lr: 1.0 rho: 0.9 }",
    "rmsprop": "rmsprop_optimizer { lr: 0.01 alpha: 0.9 eps: 1e-4 }",
}
# card against CPU tables after 1 step (fp32 compute), relative to each
# table's max: 1e-5 for fp32 tables; for BF16 and FP16 tables one unit in
# the last place at the max (a flip of the rounding to nearest where the
# two fp32 updates differ by an ulp); the slot-17 run (rowwise adagrad,
# the row write's timing reference) is not compared: its first update
# divides each row by its own gradient's norm, which lifts the two
# devices' rounding far above 1e-5 of the max where a row's gradient
# nearly cancels (the run prints the distance)
OPTIONS_CPU_TOL = {"BF16_tables": 2.0 ** -7, "FP16_tables": 2.0 ** -10,
                   "rowwise_adagrad_slot_17": None}
OPTIONS_CPU_TOL_FP32 = 1e-5
# the row write timed at the slot-48 layout beside the slot-17 one
SLOT_TIMED = ("lamb", "rowwise_adagrad_slot_17")
# every eval metric kind: on the binary ctr tower, and on a third tower of
# 3 classes (softmax) for the ones that read [B, C] predictions
_CTR_METRICS = (
    'metrics { auc {} } metrics { grouped_auc { grouping_key: "cat_12" } }'
    ' metrics { xauc { sample_ratio: 0.01 } }'
    ' metrics { grouped_xauc { grouping_key: "cat_12" } }'
    " metrics { normalized_entropy {} } metrics { accuracy {} }"
    " metrics { mean_absolute_error {} } metrics { mean_squared_error {} }"
    " train_metrics { auc {} decay_step: 4 }"
    " train_metrics { mean_squared_error {} decay_step: 4 }")
_CLS3_TOWER = (
    '  task_towers { tower_name: "cls3" label_name: "conversion"\n'
    "    num_class: 3 mlp { hidden_units: [64] }\n"
    "    losses { softmax_cross_entropy {} } metrics { multiclass_auc {} }"
    " metrics { accuracy {} } metrics { recall_at_k { top_k: 1 } }"
    " }\n")
_PARTS = (
    '  part_optimizers { adagrad_optimizer { lr: 0.01 }'
    ' regex_pattern: "towers/ctr/.*" }\n'
    '  part_optimizers { sgd_optimizer { lr: 0.01 }'
    ' regex_pattern: "towers/cvr/.*" exponential_decay_learning_rate'
    " { decay_size: 4 decay_factor: 0.5 } }\n")


def scale_of(state) -> float:
    return float(state["scaler"]["scale"])


def fp16_kernel_checks() -> dict:
    """Both attention kernels in fp16 against their plain versions: at the
    slice's shapes (8 samples), over the mask sweep, and the backward
    under an upstream gradient that overflows fp16 in dz and dv, where
    the kernel must give inf or NaN exactly where the plain version does.
    These launches do not count."""
    from torcheasyrec_tpu_torch.ops import hstu

    counts = (hstu.hstu_attention_fwd.launches,
              hstu.hstu_attention_bwd.launches)
    f16 = torch.float16
    alpha, scale = 128 ** -0.5, MAX_SEQ + 2 * N_CAND
    q, k, v, lengths, targets = slice_attention_inputs(f16)
    do = slice_upstream_grad(v)
    n_cmp = min(8, BATCH)
    out = hstu.hstu_attention_fwd(q[:n_cmp], k[:n_cmp], v[:n_cmp],
                                  lengths[:n_cmp], targets[:n_cmp], alpha,
                                  True, 0, 1, 0, scale)
    ref = hstu._torch_hstu_mha(q[:n_cmp], k[:n_cmp], v[:n_cmp],
                               lengths[:n_cmp], alpha, True, targets[:n_cmp],
                               0, 1, 0, scale)
    errs = {"slice fwd": check("fp16 slice fwd", out, ref, FP16_TOL)
            / rel_err(ref, ref)[1]}
    for s in range(0, n_cmp, 4):
        e = s + 4
        got = hstu.hstu_attention_bwd(q[s:e], k[s:e], v[s:e], do[s:e],
                                      lengths[s:e], targets[s:e], alpha, True,
                                      0, 1, 0, scale)
        ref = hstu._torch_hstu_mha_bwd(q[s:e], k[s:e], v[s:e], do[s:e],
                                       lengths[s:e], alpha, True,
                                       targets[s:e], 0, 1, 0, scale)
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            errs[f"slice bwd {name}"] = max(
                errs.get(f"slice bwd {name}", 0.0),
                check(f"fp16 slice bwd {name}", g, r, FP16_TOL)
                / rel_err(r, r)[1])
    del q, k, v, do, out, ref, got
    n_cases = 0
    for name, tol, q, k, v, lengths, targets, m in mask_sweep(
            ((f16, FP16_TOL),)):
        args = (m["causal"], m["max_attn_len"], m["contextual_seq_len"],
                m["min_full_attn_seq_len"], 500, m["sla_k1"], m["sla_k2"])
        got = hstu.hstu_attention_fwd(q, k, v, lengths, targets, 0.1, *args)
        ref = hstu._torch_hstu_mha(q, k, v, lengths, 0.1, args[0], targets,
                                   *args[1:])
        errs["sweep fwd"] = max(errs.get("sweep fwd", 0.0), check(
            name, got, ref, tol) / rel_err(ref, ref)[1])
        do = torch.randn(v.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(n_cases)).to(f16)
        got = hstu.hstu_attention_bwd(q, k, v, do, lengths, targets, 0.1,
                                      *args)
        ref = hstu._torch_hstu_mha_bwd(q, k, v, do, lengths, 0.1, args[0],
                                       targets, *args[1:])
        for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
            errs[f"sweep bwd {gname}"] = max(
                errs.get(f"sweep bwd {gname}", 0.0),
                check(f"{name} {gname}", g, r, tol) / rel_err(r, r)[1])
        n_cases += 1
    # overflow: alpha 1, no 1/N, an upstream gradient of thousands
    lens = np.array([300, 200, 77])
    q, k, v, lengths, targets = attn_inputs(3, 300, 2, 64, 64, f16, lens,
                                            lens // 8 + 1, seed=5)
    do = (torch.randn(v.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(9)) * OVERFLOW_DO_SCALE).to(f16)
    got = hstu.hstu_attention_bwd(q, k, v, do, lengths, targets, 1.0, True,
                                  0, 1, 0, 1)
    ref = hstu._torch_hstu_mha_bwd(q, k, v, do, lengths, 1.0, True, targets,
                                   0, 1, 0, 1)
    overflow = {}
    for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
        fg, fr = torch.isfinite(g), torch.isfinite(r)
        if not torch.equal(fg, fr) or fr.all():
            raise AssertionError(
                f"fp16 overflow {gname}: {int((~fg).sum())} non-finite "
                f"values from the kernel, {int((~fr).sum())} from the plain "
                f"version, {int((fg != fr).sum())} apart")
        both = fg & fr
        err = float((g.float() - r.float())[both].abs().max())
        mx = float(r.float()[fr].abs().max())
        if not err <= FP16_TOL * mx:
            raise AssertionError(f"fp16 overflow {gname}: finite values "
                                 f"{err} apart, max {mx}")
        overflow[gname] = {"non_finite": int((~fr).sum()),
                           "elements": fr.numel(),
                           "finite_err_rel": err / mx}
    torch.cuda.synchronize()
    hstu.hstu_attention_fwd.launches, hstu.hstu_attention_bwd.launches = (
        counts)
    return {"max_abs_err_rel": errs, "sweep_cases": n_cases,
            "overflow": {"shape": [3, 300, 2, 64, 64],
                         "do_scale": OVERFLOW_DO_SCALE,
                         "non_finite_equal": True, **overflow},
            "tol_rel": FP16_TOL}


def hstu_options_run(parser, batches) -> dict:
    """The lane's DLRM-HSTU in FP16 with the grad scaler, norm clipping
    and accumulation over 2 steps: OPTIONS_STEPS steps through the
    options' train step (3 batches, then the first again), the attention
    launches counted; then the whole model with the kernels against the
    plain attention on a batch of 8 at the fp16 bound."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.ops import hstu
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(config_text(
        "PALLAS", input_dropout=0.0, mixed_precision="FP16",
        train_extra=OPTIONS_EXTRA))
    model, features, tx, state, step = build_trainer(cfg)
    n_layers = len(model.transducer.stack.layers)
    order = [0, 1, 2] + [0] * (OPTIONS_STEPS - 3)
    torch.cuda.synchronize()
    hstu.hstu_attention_fwd.launches = 0
    hstu.hstu_attention_bwd.launches = 0
    losses, scales, step_ms = [], [], []
    for i in order:
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["total_loss"]))
        scales.append(scale_of(state))
    launches = (hstu.hstu_attention_fwd.launches,
                hstu.hstu_attention_bwd.launches)
    if launches != (n_layers * OPTIONS_STEPS,) * 2:
        raise AssertionError(f"FP16 options run: (forward, backward) kernels "
                             f"launched {launches} times in {OPTIONS_STEPS} "
                             f"steps of {n_layers} STU layers")
    if not np.isfinite(losses).all() or tx.count > OPTIONS_STEPS // 2:
        raise AssertionError(f"FP16 options run: losses {losses}, "
                             f"{tx.count} dense updates")

    # the same weights with the plain attention, on a batch of 8
    plain, _ = port_main.build_model(parse_pipeline_config(config_text(
        "PYTORCH", input_dropout=0.0, mixed_precision="FP16")), "cuda",
        seed=SEED)
    plain.load_state_dict(model.state_dict())
    small = parser(features).parse_to_batch(
        synth_cols(8, SEED + 100)).to("cuda")
    with torch.inference_mode():
        got, ref = model.eval()(small), plain(small)
    model_errs = {k: check(f"FP16 model {k}", got[k], ref[k], FP16_TOL)
                  / rel_err(ref[k], ref[k])[1]
                  for k in got if k.startswith(("probs_", "logits_"))}
    return {"steps": OPTIONS_STEPS, "batch_order": order, "losses": losses,
            "scales": scales, "dense_updates": tx.count,
            "step_ms_median": float(np.median(step_ms[1:])),
            "kernel_launches": {"forward": launches[0],
                                "backward": launches[1]},
            "model_vs_plain_err_rel": model_errs, "tol_rel": FP16_TOL}


def hstu_overflow_run(batch) -> dict:
    """The same FP16 trainer with ``init_scale`` 2^30 on one repeated
    batch: the overflowing steps (the first, and any later one) are
    skipped with every table bit-equal across each, the scale backs off
    until steps are finite, and the loss then falls."""
    from torcheasyrec_tpu_torch.ops import hstu
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(config_text(
        "PALLAS", input_dropout=0.0, mixed_precision="FP16",
        train_extra=OPTIONS_EXTRA.replace(
            "grad_scaler {}", f"grad_scaler {{ init_scale: {OVERFLOW_SCALE} }}")))
    model, _, tx, state, step = build_trainer(cfg)
    counts = (hstu.hstu_attention_fwd.launches,
              hstu.hstu_attention_bwd.launches)
    eg = model.embedding_group
    skipped, finite_losses, scales = 0, [], [scale_of(state)]
    for _ in range(OVERFLOW_MAX_STEPS):
        before = {gk: t.clone() for gk, t in eg.engine_tables().items()}
        scale = scale_of(state)
        state, metrics = step(state, batch)
        scales.append(scale_of(state))
        if scales[-1] < scale:  # backed off: the step was skipped
            skipped += 1
            for gk, t in eg.engine_tables().items():
                if not torch.equal(t, before[gk]):
                    raise AssertionError(f"overflow run: table group {gk} "
                                         "changed on a skipped step")
        else:
            finite_losses.append(float(metrics["total_loss"]))
            if len(finite_losses) == OVERFLOW_FINITE_STEPS:
                break
        del before
    hstu.hstu_attention_fwd.launches, hstu.hstu_attention_bwd.launches = (
        counts)  # this run is a check, not the main path
    if (not skipped or len(finite_losses) < OVERFLOW_FINITE_STEPS
            or not finite_losses[-1] < finite_losses[0]
            or not np.isfinite(finite_losses).all()):
        raise AssertionError(f"overflow run: {skipped} skipped steps, "
                             f"finite losses {finite_losses}, scales {scales}")
    return {"init_scale": OVERFLOW_SCALE, "skipped_steps": skipped,
            "tables_bit_equal_across_skipped_steps": True,
            "scales": scales, "finite_losses": finite_losses,
            "dense_updates": tx.count}


def criteo_text(name: str, model_dir: str, paths, replace=(), add="") -> str:
    """A criteo_synth config's text with its paths, ``replace`` (pairs of
    old, new) applied, and ``add`` at the end of its train_config."""
    with open(os.path.join(zoo_config_dir(), "criteo_synth",
                           f"{name}.config")) as f:
        text = f.read()
    text = text.replace("criteo_synth_data/criteo_synth_train_262144_v3"
                        ".parquet", paths["train"])
    text = text.replace("criteo_synth_data/criteo_synth_eval_65536_v3"
                        ".parquet", paths["eval"])
    text = text.replace(f"criteo_synth_model/{name}", model_dir)
    for old, new in replace:
        if old not in text:
            raise AssertionError(f"{name}.config has no {old!r}")
        text = text.replace(old, new)
    return text.replace("train_config {", "train_config {\n" + add, 1)


def parquet_batches(path, features, n, batch_size):
    """The first ``n`` batches of a parquet file, parsed on the CPU."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser

    table = pq.read_table(path)
    parser = DataParser(features, labels=["label", "conversion"])
    out = []
    for i in range(n):
        part = table.slice(i * batch_size, batch_size)
        out.append(parser.parse_to_batch(
            {c: part[c].combine_chunks() for c in part.column_names}))
    return out


def deepfm_kind_run(label, text, batches_cpu) -> dict:
    """criteo_synth DeepFM (fp32 compute, so that the card and the CPU may
    be held within 1e-5) under one sparse optimizer or table dtype:
    OPTIONS_KIND_STEPS steps on the card with the row writes counted,
    the writes of step 1 held against the plain version bit for bit, and
    the tables after step 1 against a CPU step from the same weights."""
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(text)
    model, _, _, state, step = build_trainer(cfg)
    cpu_model, _, _, cpu_state, cpu_step = build_trainer(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    eng = model.embedding_group.engine
    layouts = {gk: {"slot": g.slot, "spr": g.spr, "packed": g.packed,
                    "dtype": str(g.store_dtype).replace("torch.", "")}
               for gk, g in eng.groups.items()}
    batches = [b.to("cuda") for b in batches_cpu]
    torch.cuda.synchronize()
    write_rows.launches = 0
    calls = write_targets(model, step, state, batches[0])
    cpu_step(cpu_state, batches_cpu[0])
    torch.cuda.synchronize()
    first_launches = write_rows.launches
    check_step_writes(label, calls)
    write_rows.launches = first_launches
    errs = {}
    tol = OPTIONS_CPU_TOL.get(label, OPTIONS_CPU_TOL_FP32)
    card, cpu = model.embedding_group.tables, cpu_model.embedding_group.tables
    for name, t in card.items():
        ref = cpu[name].float()
        err = float((t.float().cpu() - ref).abs().max())
        scale = max(float(ref.abs().max()), 1e-30)
        errs[name] = err / scale
        if tol is not None and not err <= tol * scale:
            raise AssertionError(f"{label}: table {name} after 1 step is "
                                 f"{err} from the CPU's (max {scale})")
    losses = []
    for i in range(1, OPTIONS_KIND_STEPS):
        state, metrics = step(state, batches[i % len(batches)])
        losses.append(float(metrics["total_loss"]))
    torch.cuda.synchronize()
    launches = write_rows.launches
    packed = sum(g.packed for g in eng.groups.values())
    if launches != packed * OPTIONS_KIND_STEPS or not np.isfinite(
            losses).all():
        raise AssertionError(f"{label}: {launches} row writes in "
                             f"{OPTIONS_KIND_STEPS} steps of {packed} packed "
                             f"groups, losses {losses}")
    worst = max(errs, key=errs.get)
    out = {"layouts": layouts, "row_write_launches": launches,
           "row_writes_bit_equal": True, "writes_step_1": len(calls),
           "card_vs_cpu_tables_1_step": {"worst_table": worst,
                                         "err_rel_to_max": errs[worst],
                                         "tol_rel": tol},
           "losses": losses}
    if label in SLOT_TIMED:  # the dim-16 group's write, for its timing
        out["slot_write"] = max(calls, key=lambda c: c[0].shape[0])[:3]
    del calls, model, cpu_model, state, cpu_state, batches
    torch.cuda.empty_cache()
    return out


def dbmtl_options_epoch(paths, tmp) -> dict:
    """criteo_synth DBMTL through ``train_and_evaluate`` for one epoch with
    part optimizers on its towers, train metrics, every eval metric kind
    (a third tower of 3 classes reads the [B, C] ones) and a table
    ``init_fn``; the eval metrics must equal a recomputation in numpy
    from the predictions ``predict_checkpoint`` writes for the eval file."""
    import logging

    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.metrics import create_metric
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    model_dir = os.path.join(tmp, "dbmtl_options")
    text = criteo_text(
        "dbmtl", model_dir, paths, replace=(
            ("losses { binary_cross_entropy {} } metrics { auc {} } }\n"
             "  task_towers { tower_name: \"cvr\"",
             "losses { binary_cross_entropy {} } " + _CTR_METRICS + " }\n"
             "  task_towers { tower_name: \"cvr\""),
            ("    losses { binary_cross_entropy {} } metrics { auc {} } }\n"
             "  }",
             "    losses { binary_cross_entropy {} } metrics { auc {} } }\n"
             + _CLS3_TOWER + "  }"),
            ("adam_optimizer { lr: 0.001 } constant_learning_rate {}",
             "adam_optimizer { lr: 0.001 } constant_learning_rate {}\n"
             + _PARTS),
            ('feature_name: "cat_0" num_buckets: 100000 embedding_dim: 16',
             'feature_name: "cat_0" num_buckets: 100000 embedding_dim: 16 '
             'init_fn: "nn.init.normal_,std=0.01"'),
            ("log_step_count_steps: 20", "log_step_count_steps: 4")))
    cfg_path = os.path.join(tmp, "dbmtl_options.config")
    with open(cfg_path, "w") as f:
        f.write(text)
    logged = []
    handler = logging.Handler()
    handler.emit = lambda rec: logged.append(rec.getMessage())
    log = logging.getLogger("tzrec_tpu_torch")
    log.addHandler(handler)
    old_level = log.level
    log.setLevel(logging.INFO)
    t0 = time.perf_counter()
    try:
        result = port_main.train_and_evaluate(cfg_path, device="cuda")
    finally:
        log.removeHandler(handler)
        log.setLevel(old_level)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    steps = (OPTIONS_ROWS[0]
             // parse_pipeline_config(text).data_config.batch_size)
    train_lines = [x for x in logged if x.startswith("step ")]
    if result["step"] != steps or len(train_lines) != steps // 4 or not all(
            "train_auc_ctr=" in x and "train_mean_squared_error_ctr=" in x
            for x in train_lines):
        raise AssertionError(f"DBMTL options epoch: {result['step']} steps, "
                             f"log lines {train_lines}")
    if not all(np.isfinite(v) for k, v in result.items()
               if not k.startswith("recall")):
        raise AssertionError(f"DBMTL options epoch: {result}")
    pred_out = os.path.join(tmp, "dbmtl_options_pred.parquet")
    port_main.predict_checkpoint(
        os.path.join(model_dir, "pipeline.config"), paths["eval"], pred_out,
        reserved_columns="label,conversion,cat_12", device="cuda")
    pred = pq.read_table(pred_out)
    cols = {c: pred.column(c).to_numpy(zero_copy_only=False)
            for c in pred.column_names}
    # fed batch by batch as the eval loop feeds them (float32 sums of a
    # batch then float64 across batches), the values are equal
    cfg = parse_pipeline_config(text)
    bs = cfg.data_config.eval_batch_size or cfg.data_config.batch_size
    recomputed = {}
    for t in cfg.model_config.dbmtl.task_towers:
        probs = cols[f"probs_{t.tower_name}"]
        if probs.dtype == object:
            probs = np.stack(probs)
        for mc in t.metrics:
            m = create_metric(mc)
            for i in range(0, len(probs), bs):
                m["metric"].update(probs[i:i + bs],
                                   cols[t.label_name][i:i + bs],
                                   grouping_key=cols["cat_12"][i:i + bs])
            name = f"{m['name']}_{t.tower_name}"
            recomputed[name] = m["metric"].compute()
            if result[name] != recomputed[name]:
                raise AssertionError(
                    f"DBMTL options epoch: {name} {result[name]} from the "
                    f"eval, {recomputed[name]} recomputed")
    return {"steps": result["step"], "epoch_s": epoch_s,
            "eval_metrics": {k: v for k, v in result.items()
                             if k in recomputed},
            "eval_equals_recomputed": True,
            "train_log_lines": len(train_lines),
            "last_train_log_line": train_lines[-1],
            "part_optimizers": ["towers/ctr/.*", "towers/cvr/.*"],
            "init_fn": {"cat_0_emb": "nn.init.normal_,std=0.01"}}


def phase_train_options():
    """The training loop's options on the card: (a) the lane's DLRM-HSTU
    in FP16 with the grad scaler, clipping and accumulation, the fp16
    kernels checked and timed; (b) criteo_synth DeepFM under the six new
    sparse kinds and BF16/FP16 tables; (c) criteo_synth DBMTL with part
    optimizers, train metrics, every eval metric kind and an init_fn.
    Returns the fp16 attention launches, the kernels' fp16 times and the
    row-write launches of (b)."""
    from torcheasyrec_tpu_torch.benchmark import synthetic
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    out = {"phase": "train_options"}
    t0 = time.perf_counter()
    out["fp16_kernels"] = fp16_kernel_checks()
    out["fp16_kernels_s"] = time.perf_counter() - t0
    emit({"phase": "train_options_fp16_kernels", **out["fp16_kernels"],
          "seconds": out["fp16_kernels_s"]})

    def parser(features):
        return DataParser(features, labels=["unused_label"])

    t0 = time.perf_counter()
    cfg = parse_pipeline_config(config_text("PALLAS", input_dropout=0.0))
    from torcheasyrec_tpu_torch.main import _create_features
    features = _create_features(cfg)
    batches = [parser(features).parse_to_batch(
        synth_cols(BATCH, SEED + 400 + i)).to("cuda") for i in range(3)]
    out["hstu_fp16"] = hstu_options_run(parser, batches)
    fp16_launches = (out["hstu_fp16"]["kernel_launches"]["forward"],
                     out["hstu_fp16"]["kernel_launches"]["backward"])
    out["hstu_overflow"] = hstu_overflow_run(batches[0])
    del batches
    torch.cuda.empty_cache()
    out["hstu_s"] = time.perf_counter() - t0
    emit({"phase": "train_options_hstu", "fp16": out["hstu_fp16"],
          "overflow": out["hstu_overflow"], "seconds": out["hstu_s"]})

    t0 = time.perf_counter()
    fwd16, bwd16 = fwd_times(torch.float16), bwd_times(torch.float16)
    out["fp16_times"] = {"forward": fwd16, "backward": bwd16}
    out["fp16_times_s"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = synthetic.ensure_dataset(tmp, *OPTIONS_ROWS)
        out["data_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        base = criteo_text("deepfm", os.path.join(tmp, "deepfm"), paths,
                           replace=(('mixed_precision: "BF16"',
                                     'mixed_precision: ""'),))
        base_cfg = parse_pipeline_config(base)
        from torcheasyrec_tpu_torch.main import _create_features
        feats = _create_features(base_cfg)
        batches_cpu = parquet_batches(paths["train"], feats, 2, 4096)
        runs = {}
        sparse_line = ("rowwise_adagrad_optimizer { lr: 0.01 }")
        variants = [(k, base.replace(sparse_line, v))
                    for k, v in OPTIONS_KINDS.items()]
        variants += [("rowwise_adagrad_slot_17", base)]
        variants += [(f"{dt}_tables", base.replace(
            "embedding_dim: 16 }", f'embedding_dim: 16 data_type: "{dt}" }}'))
            for dt in ("BF16", "FP16")]
        kind_launches = 0
        for label, text in variants:
            runs[label] = deepfm_kind_run(label, text, batches_cpu)
            kind_launches += runs[label]["row_write_launches"]
            emit({"phase": "train_options_deepfm", "variant": label,
                  **{k: v for k, v in runs[label].items()
                     if k != "slot_write"}})
        # the row write at the slot-48 layout (lamb) beside the slot-17 one
        # (rowwise adagrad) at one real step's targets of the dim-16 group
        slot_ms = {}
        for label in SLOT_TIMED:
            table, tgt, rows = runs[label].pop("slot_write")
            kept = write_rows.launches
            slot_ms[label] = {
                "ms": device_ms(lambda: write_rows(table, tgt, rows), 20),
                "targets": int(tgt.shape[0]),
                "table_rows": int(table.shape[0]),
                "bytes": row_write_bytes(table, tgt)}
            write_rows.launches = kept
            del table, tgt, rows
        out["deepfm"] = {k: {"layouts": r["layouts"],
                             "row_write_launches": r["row_write_launches"],
                             "err_rel_to_max": r["card_vs_cpu_tables_1_step"][
                                 "err_rel_to_max"]}
                         for k, r in runs.items()}
        out["row_write_slot_ms"] = slot_ms
        out["deepfm_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["dbmtl"] = dbmtl_options_epoch(paths, tmp)
        out["dbmtl_s"] = time.perf_counter() - t0
    emit(out)
    return fp16_launches, (fwd16, bwd16), kind_launches


# --- train_gr: the generative-recommendation family --------------------------
GR_SEED = 42  # the port's default model seed (main._build_model_and_optim)
GR_TRAIN_ROWS, GR_EVAL_ROWS = 20_480, 4_096  # ensure_hstu_dataset's sizes
GR_BATCH, GR_EPOCHS = 128, 2
GR_STEPS = GR_EPOCHS * GR_TRAIN_ROWS // GR_BATCH
GR_PREDICT_BATCHES = 2
GR_CHECK_STEPS = 2  # card against CPU, each model (3 before train_pipelined)
GR_CARD_TOL = 1e-4  # fp32: max abs error over the CPU's max abs, per tensor
# a gradient below this share of the largest one on the CPU is a
# structural zero (interleaved targets' action tokens reach no output):
# it must be so on the card; the small but real ones (item_proj's, about
# 1e-5 of the largest) are compared like the rest
GR_ZERO_GRAD = 1e-9
# adam's eps in the card-vs-CPU steps: at the published 1e-8 a gradient
# element at rounding level becomes a step of lr whose sign the card and
# the CPU need not share (ROADMAP section 3); every other setting is the
# config's
GR_ADAM_EPS = 1e-4
GR_MATCH_ROWS, GR_MATCH_EVAL_ROWS = 2_048, 384
GR_MATCH_ITEMS, GR_MATCH_CLUSTERS = 256, 4

# the options of the generative family at hstu_synth's width: target
# interleaving with an MLP content encoder and a parameterized content
# MLP (contextual dropout 0, so that card and CPU draw nothing), SLA, and
# attention truncation after layer 1 with a tail of 16
GR_INTERLEAVE = """input_preprocessor {
        contextual_interleave_preprocessor {
          action_encoder { simple_action_encoder {
            action_embedding_dim: 16 action_weights: [1, 2] } }
          action_mlp { simple_mlp { hidden_dim: 32 } }
          content_encoder { mlp_content_encoder {
            uih_mlp { hidden_units: [64] } target_mlp { hidden_units: [64] } } }
          content_mlp { parameterized_mlp { hidden_dim: 32
            contextual_dropout_ratio: 0 } }
        }
      }"""
GR_TRUNCATION = ("attn_truncation_split_layer: 1\n"
                 "      attn_truncation_tail_len: 16\n")

# HSTU-Match: the JAX package's integration config
# (tests/test_hstu_match.py): grouped sequence features, the negative
# sampler in sequence mode, the UIH preprocessor with an action encoder,
# the query-time anchor, COSINE at temperature 0.05
GR_MATCH_CONFIG = """
train_input_path: "{train}"
eval_input_path: "{eval}"
model_dir: "{model_dir}"
train_config {{
  sparse_optimizer {{ rowwise_adagrad_optimizer {{ lr: 0.05 }}
                      constant_learning_rate {{}} }}
  dense_optimizer {{ adam_optimizer {{ lr: 0.01 }} constant_learning_rate {{}} }}
  num_epochs: 1
  save_checkpoints_steps: 10000
  log_step_count_steps: 50
}}
eval_config {{}}
data_config {{
  batch_size: 32
  dataset_type: ParquetDataset
  fg_mode: FG_NONE
  label_fields: "cand_seq__action_weight"
  negative_sampler {{
    input_path: "{items}"
    num_sample: 32
    attr_fields: "cand_seq__video_id"
    item_id_field: "cand_seq__video_id"
  }}
}}
feature_configs {{ id_feature {{ feature_name: "user_id"
  expression: "user:user_id" num_buckets: 120 embedding_dim: 16 }} }}
feature_configs {{ id_feature {{ feature_name: "user_degree"
  expression: "user:user_degree" num_buckets: 8 embedding_dim: 16 }} }}
feature_configs {{ sequence_feature {{
  sequence_name: "uih_seq" sequence_length: 16 sequence_delim: ";"
  features {{ id_feature {{ feature_name: "video_id"
    expression: "item:video_id" embedding_name: "video_emb"
    num_buckets: 256 embedding_dim: 32 }} }}
  features {{ raw_feature {{ feature_name: "action_timestamp"
    expression: "user:action_timestamp" }} }}
  features {{ raw_feature {{ feature_name: "action_weight"
    expression: "user:action_weight" }} }} }} }}
feature_configs {{ sequence_feature {{
  sequence_name: "cand_seq" sequence_length: 4 sequence_delim: ";"
  features {{ id_feature {{ feature_name: "video_id"
    expression: "item:video_id" embedding_name: "video_emb"
    num_buckets: 256 embedding_dim: 32 }} }} }} }}
feature_configs {{ raw_feature {{ feature_name: "request_time"
  expression: "user:request_time" }} }}
model_config {{
  feature_groups {{ group_name: "contextual" feature_names: "user_id"
                    feature_names: "user_degree" group_type: DEEP }}
  feature_groups {{ group_name: "uih" feature_names: "uih_seq__video_id"
                    group_type: JAGGED_SEQUENCE }}
  feature_groups {{ group_name: "candidate"
                    feature_names: "cand_seq__video_id"
                    group_type: JAGGED_SEQUENCE }}
  feature_groups {{ group_name: "uih_action"
                    feature_names: "uih_seq__action_weight"
                    group_type: JAGGED_SEQUENCE }}
  feature_groups {{ group_name: "uih_timestamp"
                    feature_names: "uih_seq__action_timestamp"
                    group_type: JAGGED_SEQUENCE }}
  feature_groups {{ group_name: "query_time" feature_names: "request_time"
                    group_type: DEEP }}
  hstu_match {{
    user_tower {{
      input: "uih"
      hstu {{
        stu {{ embedding_dim: 32 hidden_dim: 16 attention_dim: 16
               num_heads: 2 num_layers: 2 }}
        positional_encoder {{ num_position_buckets: 64
                              num_time_buckets: 32 use_time_encoding: true }}
        input_preprocessor {{ uih_preprocessor {{
          action_encoder {{ simple_action_encoder {{
            action_embedding_dim: 8 action_weights: [1, 2] }} }}
          action_mlp {{ simple_mlp {{ hidden_dim: 32 }} }} }} }}
        output_postprocessor {{ l2norm_postprocessor {{}} }}
        input_dropout_ratio: {dropout}
      }}
      max_seq_len: 16
    }}
    item_tower {{ input: "candidate" mlp {{ hidden_units: [32] }} }}
    similarity: COSINE
    temperature: 0.05
  }}
  metrics {{ recall_at_k {{ top_k: 1 }} }}
  metrics {{ recall_at_k {{ top_k: 5 }} }}
  losses {{ softmax_cross_entropy {{}} }}
}}
"""


def gr_config_dir() -> str:
    return os.path.join(zoo_config_dir(), "hstu_synth")


def replace_block(text: str, start: str, new: str) -> str:
    """``text`` with the braced block that begins at ``start`` replaced."""
    s = text.index(start)
    depth = 0
    for i in range(s, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if text[i] == "}" and depth == 0:
            return text[:s] + new + text[i + 1:]
    raise ValueError(f"unbalanced block {start!r}")


def gr_variant_text(name: str) -> str:
    """hstu_synth's config (published width) with the options (``options``)
    or as ULTRA-HSTU with two channels (``ultra``: the base one with a
    max_attn_len window of 16, a second with SLA); input dropout 0 and
    adam at GR_ADAM_EPS, so that the card and the CPU can be held close."""
    with open(os.path.join(gr_config_dir(), "dlrm_hstu.config")) as f:
        text = f.read()
    text = text.replace("adam_optimizer { lr: 0.002 }",
                        f"adam_optimizer {{ lr: 0.002 eps: {GR_ADAM_EPS} }}")
    text = text.replace("    hstu {", "    hstu {\n      input_dropout_ratio: 0",
                        1)
    if name == "options":
        text = replace_block(text, "input_preprocessor {", GR_INTERLEAVE)
        text = text.replace("num_layers: 3", "num_layers: 3 sla_k1: 8 sla_k2: 4")
        # interleaving doubles the tokens a step
        text = text.replace("max_seq_len: 48", "max_seq_len: 96")
    else:
        text = text.replace("num_layers: 3", "num_layers: 3 max_attn_len: 16")
        start = text.index("    hstu {")
        block = text[start:start + len(text) - len(
            replace_block(text, "    hstu {", ""))]
        second = block.replace("max_attn_len: 16", "sla_k1: 8 sla_k2: 4")
        text = (text[:start] + block + "\n" + second
                + text[start + len(block):]).replace("dlrm_hstu {",
                                                     "ultra_hstu {")
    return text.replace("input_preprocessor {",
                        GR_TRUNCATION + "      input_preprocessor {", 1)


def gr_match_files(root) -> dict:
    """HSTU-Match's data, the port's copy of the JAX test's generator:
    users live in one of 4 item clusters; history and 1-3 positives come
    from it; GR_MATCH_EVAL_ROWS of the rows are the eval file; the
    sampler's item table holds the 256 items."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(0)
    per = GR_MATCH_ITEMS // GR_MATCH_CLUSTERS
    cols = {k: [] for k in (
        "user_id", "user_degree", "uih_seq__video_id",
        "uih_seq__action_timestamp", "uih_seq__action_weight",
        "cand_seq__video_id", "cand_seq__action_weight", "request_time")}
    for _ in range(GR_MATCH_ROWS):
        uid = int(rng.integers(0, 120))
        c = uid % GR_MATCH_CLUSTERS
        lu = int(rng.integers(5, 13))
        hist = rng.integers(c * per, (c + 1) * per, lu)
        ts = 1_700_000_000 + int(rng.integers(0, 10_000)) + np.cumsum(
            rng.integers(10, 600, lu))
        aw = rng.choice([1, 2, 3], lu)
        k = int(rng.integers(1, 4))
        pos = rng.integers(c * per, (c + 1) * per, k)
        cols["user_id"].append(uid)
        cols["user_degree"].append(uid % 8)
        cols["uih_seq__video_id"].append(";".join(map(str, hist)))
        cols["uih_seq__action_timestamp"].append(";".join(map(str, ts)))
        cols["uih_seq__action_weight"].append(";".join(map(str, aw)))
        cols["cand_seq__video_id"].append(";".join(map(str, pos)))
        cols["cand_seq__action_weight"].append(";".join(["1"] * k))
        cols["request_time"].append(float(ts[-1] + 60))
    tbl = pa.table({k: pa.array(v) for k, v in cols.items()})
    out = {"train": os.path.join(root, "match_train.parquet"),
           "eval": os.path.join(root, "match_eval.parquet"),
           "items": os.path.join(root, "match_items.parquet")}
    n_train = GR_MATCH_ROWS - GR_MATCH_EVAL_ROWS
    pq.write_table(tbl.slice(0, n_train), out["train"])
    pq.write_table(tbl.slice(n_train), out["eval"])
    pq.write_table(pa.table({
        "id": pa.array(np.arange(GR_MATCH_ITEMS)),
        "weight": pa.array(np.ones(GR_MATCH_ITEMS)),
        "attrs": pa.array([str(i) for i in range(GR_MATCH_ITEMS)])}),
        out["items"])
    return out


def gr_match_text(paths, model_dir, dropout) -> str:
    return GR_MATCH_CONFIG.format(train=paths["train"], eval=paths["eval"],
                                  model_dir=model_dir, items=paths["items"],
                                  dropout=dropout)


def gr_card_vs_cpu(name, text, data_path) -> dict:
    """GR_CHECK_STEPS fp32 train steps of one model on the card and on
    the CPU from the same CPU-drawn weights and the loader's batches (the
    sampler's negatives included): before each step the training-mode
    loss, every prediction and every dense gradient within GR_CARD_TOL of
    the CPU's max abs, but a structural zero on the CPU (below
    GR_ZERO_GRAD of the largest), which must be so on the card; the
    steps' losses too."""
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(text)
    cpu_model, features, _, cpu_state, cpu_step = build_trainer(
        cfg, device="cpu")
    card_model, _, _, card_state, card_step = build_trainer(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    loader = create_dataloader(cfg.data_config, features, data_path,
                               mode="train", device="cpu")()
    batches = [b for _, (b, _) in zip(range(GR_CHECK_STEPS), loader)]
    loader.close()
    cmp = CpuComparison(name, GR_CARD_TOL, GR_ZERO_GRAD)
    losses = []
    for i, batch in enumerate(batches):
        card_batch = batch.to("cuda")
        ref_loss, ref_preds, ref_grads = train_mode_outputs(cpu_model, batch)
        loss, preds, grads = train_mode_outputs(card_model, card_batch)
        cmp.compare("loss", ref_loss, loss)
        for k in ref_preds:
            cmp.compare(k, ref_preds[k], preds[k])
        cmp.compare_grads(ref_grads, grads)
        cpu_state, cpu_m = cpu_step(cpu_state, batch)
        card_state, card_m = card_step(card_state, card_batch)
        cmp.compare(f"step {i + 1} loss", torch.as_tensor(cpu_m["total_loss"]),
                    torch.as_tensor(card_m["total_loss"]))
        losses.append((float(cpu_m["total_loss"]),
                       float(card_m["total_loss"])))
    errs = cmp.errs
    worst_grad = max((v for k, v in errs.items() if k.startswith("grad:")),
                     default=0.0)
    return {"model": type(card_model).__name__, "steps": GR_CHECK_STEPS,
            "batch": batches[0].labels[cfg.data_config.label_fields[0]]
            .shape[0], "losses_cpu_card": losses,
            "max_rel_err": max(errs.values()),
            "max_rel_err_outputs": max(v for k, v in errs.items()
                                       if not k.startswith("grad:")),
            "max_rel_err_gradients": worst_grad,
            "compared": len(errs), "zero_gradients": sorted(cmp.zero),
            "tol": GR_CARD_TOL}


def gr_hstu_synth(paths, tmp, labels) -> dict:
    """hstu_synth's DLRM-HSTU through the entry points at its published
    width: GR_EPOCHS epochs of ``train_and_evaluate``, ``evaluate`` and
    ``predict_checkpoint`` of its checkpoint (the first
    GR_PREDICT_BATCHES eval batches), each AUC within ZOO_AUC_BOUND of its
    pinned label. It starts from GR_SEED's weights drawn on the CPU, as
    dssm's run does, so that its AUCs compare with a CPU run of the same
    seed (``tools/seed_spread.py --config hstu_synth``)."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
    from torcheasyrec_tpu_torch.utils import checkpoint_util
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    src = os.path.join(gr_config_dir(), "dlrm_hstu.config")
    model_dir = os.path.join(tmp, "dlrm_hstu")
    init = cpu_init(src, os.path.join(tmp, "hstu_synth_init.pt"))
    t0 = time.perf_counter()
    result = port_main.train_and_evaluate(
        src, train_input_path=paths["train"], eval_input_path=paths["eval"],
        edit_config_json=json.dumps({"model_dir": model_dir}),
        fine_tune_checkpoint=init, device="cuda")
    torch.cuda.synchronize()
    train_eval_s = time.perf_counter() - t0
    if result["step"] != GR_STEPS or not all(
            np.isfinite(v) for v in result.values()):
        raise AssertionError(f"hstu_synth: {result}, not {GR_STEPS} steps")
    metrics = {}
    for m, spec in labels["metrics"].items():
        if m not in result:
            raise AssertionError(f"hstu_synth: no metric {m} in {result}")
        dist = result[m] - spec["value"]
        metrics[m] = {"value": result[m], "label": spec["value"],
                      "distance": dist, "threshold": spec["threshold"],
                      "within_threshold": abs(dist) <= spec["threshold"],
                      "bound": ZOO_AUC_BOUND}
        if abs(dist) > ZOO_AUC_BOUND:
            raise AssertionError(
                f"hstu_synth: {m} {result[m]} is {dist:+.4f} from its label "
                f"{spec['value']} (bound {ZOO_AUC_BOUND})")
    cfg_path = os.path.join(model_dir, "pipeline.config")
    t0 = time.perf_counter()
    again = port_main.evaluate(cfg_path, eval_input_path=paths["eval"],
                               device="cuda")
    eval_s = time.perf_counter() - t0
    for m in metrics:
        if again[m] != result[m]:
            raise AssertionError(f"hstu_synth: evaluate() {m} {again[m]} "
                                 f"against {result[m]} after training")

    pred_in = os.path.join(tmp, "hstu_predict_in.parquet")
    pq.write_table(pq.read_table(paths["eval"]).slice(
        0, GR_PREDICT_BATCHES * GR_BATCH), pred_in)
    pred_out = os.path.join(tmp, "hstu_pred.parquet")
    n_pred = port_main.predict_checkpoint(cfg_path, pred_in, pred_out,
                                          device="cuda")
    pred = pq.read_table(pred_out)
    cfg = parse_pipeline_config(open(cfg_path).read())
    model, features = port_main.build_model(cfg, "cuda")
    checkpoint_util.load_model_weights(
        checkpoint_util.latest_checkpoint(model_dir), model)
    eval_step = port_main.make_eval_step(model, with_loss=False)
    outs = {}
    for batch, _ in create_dataloader(cfg.data_config, features, pred_in,
                                      mode="predict", device="cuda")():
        for k, v in eval_step(batch)[0].items():
            if not k.startswith("__"):
                outs.setdefault(k, []).append(v.float().cpu().numpy())
    outs = {k: np.concatenate(v) for k, v in outs.items()}
    if n_pred != GR_PREDICT_BATCHES * GR_BATCH or (
            sorted(pred.column_names) != sorted(outs)):
        raise AssertionError(f"hstu_synth: predicted {n_pred} rows, columns "
                             f"{pred.column_names} against {sorted(outs)}")
    for k, v in outs.items():
        col = np.stack(pred.column(k).to_numpy(zero_copy_only=False))
        if not np.array_equal(col, v):
            raise AssertionError(f"hstu_synth: predict_checkpoint {k} "
                                 "differs from the eval step's")
        if k.startswith("probs") and not (np.isfinite(col).all() and (
                (col > 0) & (col < 1)).all()):
            raise AssertionError(f"hstu_synth: {k} not finite in (0, 1)")
    return {"config": os.path.relpath(src), "seed": GR_SEED,
            "init": "drawn on the CPU",
            "batch": cfg.data_config.batch_size, "steps": GR_STEPS,
            "epochs": GR_EPOCHS, "train_and_evaluate_s": train_eval_s,
            "train_and_evaluate": result, "metrics": metrics,
            "evaluate_s": eval_s, "evaluate_equals_trainer": True,
            "predict_rows": n_pred, "predict_equals_eval_step": True,
            "predict_shapes": {k: list(v.shape) for k, v in outs.items()}}


def gr_hstu_synth_timing(paths) -> dict:
    """hstu_synth's step on a resident batch (median of synchronised
    steps, a window, the idle share of profiled steps, peak memory) and
    one epoch through the loader and ``train_epoch``."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
    from torcheasyrec_tpu_torch.utils.config_util import load_pipeline_config

    cfg = load_pipeline_config(os.path.join(gr_config_dir(),
                                            "dlrm_hstu.config"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, features, _, state, step = build_trainer(cfg, seed=GR_SEED)
    dl = create_dataloader(cfg.data_config, features, paths["train"],
                           mode="train", device="cuda")
    batches = dl()
    batch = next(iter(batches))[0]
    batches.close()
    losses, step_ms, window_ms = timed_steps(step, state, batch, ZOO_WARMUP,
                                             ZOO_TIMED_STEPS)

    def profiled_steps():
        for _ in range(ZOO_PROFILED_STEPS):
            step(state, batch)

    profile = profile_forward(profiled_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = dl()
    try:
        state, _, _ = port_main.train_epoch(step, state, batches, {})
    finally:
        batches.close()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    if not np.isfinite(losses).all():
        raise AssertionError(f"hstu_synth: timed losses {losses}")
    return {"step_ms_median": float(np.median(step_ms)),
            "step_ms_range": [min(step_ms), max(step_ms)],
            "window_step_ms": window_ms,
            "examples_per_s": GR_BATCH / window_ms * 1e3,
            "idle_share_profiled_steps": profile.get("device_idle_share"),
            "step_profile": profile, "epoch_s": epoch_s,
            "epoch_steps": GR_TRAIN_ROWS // GR_BATCH,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}


def gr_attention_inputs(paths):
    """q, k, v [B, N, H, 32] fp32 at hstu_synth's real shape: the first
    train batch's lengths (one contextual token, the history, the
    candidates) and candidate counts as targets, N = 1 + 32 + 10."""
    import pyarrow.parquet as pq

    tbl = pq.read_table(paths["train"]).slice(0, GR_BATCH)
    lu = np.array([len(s.split(";")) for s in
                   tbl.column("video_id").to_pylist()])
    lc = np.array([len(s.split(";")) for s in
                   tbl.column("item_video_id").to_pylist()])
    return attn_inputs(GR_BATCH, 1 + 32 + 10, 4, 32, 32, torch.float32,
                       1 + lu + lc, lc, seed=GR_SEED)


def gr_kernel_times(paths) -> tuple:
    """Kernels #1 and #2 at hstu_synth's shape, fp32 as the model runs:
    device time per launch beside the plain version's, and the bound of
    this data's work (the unmasked pairs' FLOPs over the fp32 peak, the
    bytes of ``attn_bytes`` over the memory rate)."""
    from torcheasyrec_tpu_torch.ops import hstu

    q, k, v, lengths, targets = gr_attention_inputs(paths)
    do = slice_upstream_grad(v)
    args = (32 ** -0.5, True, 0, 1, 0, 48)
    pairs = unmasked_pairs(q.shape[1], lengths, targets)
    h, d, vd = q.shape[2], q.shape[3], v.shape[3]
    out = {}
    for name, kernel, plain, flops, nbytes in (
        ("hstu_attention_fwd",
         lambda: hstu.hstu_attention_fwd(q, k, v, lengths, targets, *args),
         lambda: hstu._torch_hstu_mha(q, k, v, lengths, args[0], True,
                                      targets, 0, 1, 0, 48),
         2.0 * pairs * h * (d + vd), attn_bytes(q, v, lengths)),
        ("hstu_attention_bwd",
         lambda: hstu.hstu_attention_bwd(q, k, v, do, lengths, targets,
                                         *args),
         lambda: hstu._torch_hstu_mha_bwd(q, k, v, do, lengths, args[0],
                                          True, targets, 0, 1, 0, 48),
         2.0 * pairs * h * (3 * d + 2 * vd),
         attn_bytes(q, v, lengths, backward=True)),
    ):
        kernel_ms = device_ms(kernel, 50)
        bound_ms, bound_by = card_bound(flops, nbytes, PEAK_FP32_FLOPS)
        out[name] = {
            "kernel_ms": kernel_ms, "plain_ms": device_ms(plain, 10),
            "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
            "dtype": "fp32",
            "shape": [GR_BATCH, q.shape[1], h, d, vd]}
    return out


def gr_hstu_match(tmp) -> dict:
    """HSTU-Match through ``train_and_evaluate`` for one epoch (the
    sampler's 32 negatives a batch in sequence mode; recall@1 and @5 on
    the eval rows), then GR_CHECK_STEPS steps on the card against the
    CPU (input dropout 0)."""
    from torcheasyrec_tpu_torch import main as port_main

    paths = gr_match_files(tmp)
    cfg_path = os.path.join(tmp, "hstu_match.config")
    with open(cfg_path, "w") as f:
        f.write(gr_match_text(paths, os.path.join(tmp, "hstu_match"), 0.1))
    t0 = time.perf_counter()
    result = port_main.train_and_evaluate(cfg_path, device="cuda")
    train_eval_s = time.perf_counter() - t0
    steps = (GR_MATCH_ROWS - GR_MATCH_EVAL_ROWS) // 32
    if result["step"] != steps or not all(
            np.isfinite(v) for v in result.values()) or not all(
            0.0 <= result[m] <= 1.0 for m in ("recall@1", "recall@5")):
        raise AssertionError(f"hstu_match: {result}, not {steps} steps")
    check = gr_card_vs_cpu(
        "hstu_match", gr_match_text(paths, os.path.join(tmp, "m_check"), 0.0),
        paths["train"])
    return {"steps": steps, "batch": 32, "negatives": 32,
            "train_and_evaluate_s": train_eval_s,
            "recall@1": result["recall@1"], "recall@5": result["recall@5"],
            "train_and_evaluate": result, "card_vs_cpu": check}


def phase_train_gr():
    """The generative-recommendation family on the card: hstu_synth's
    DLRM-HSTU through the entry points, DLRM-HSTU with the options and
    ULTRA-HSTU against the CPU, HSTU-Match through ``train_and_evaluate``
    and against the CPU; the kernel launches of all of them counted (the
    counts set to 0 just before, read just after); then the hstu_synth
    step and epoch timed, and kernels #1 and #2 timed at its shape."""
    from torcheasyrec_tpu_torch.benchmark import synthetic
    from torcheasyrec_tpu_torch.ops import hstu
    from torcheasyrec_tpu_torch.ops.row_write import write_rows

    with open(os.path.join(zoo_config_dir(), "base_eval_metric.json")) as f:
        labels = json.load(f)["torcheasyrec_tpu_torch/benchmark/configs/"
                              "hstu_synth/dlrm_hstu.config"]
    out = {"phase": "train_gr", "seed": GR_SEED}
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = synthetic.ensure_hstu_dataset(tmp, GR_TRAIN_ROWS,
                                              GR_EVAL_ROWS)
        seconds["data"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        hstu.hstu_attention_fwd.launches = 0
        hstu.hstu_attention_bwd.launches = 0
        write_rows.launches = 0
        for name, fn in (
            ("hstu_synth", lambda: gr_hstu_synth(paths, tmp, labels)),
            ("dlrm_hstu_options", lambda: gr_card_vs_cpu(
                "dlrm_hstu_options", gr_variant_text("options"),
                paths["train"])),
            ("ultra_hstu", lambda: gr_card_vs_cpu(
                "ultra_hstu", gr_variant_text("ultra"), paths["train"])),
            ("hstu_match", lambda: gr_hstu_match(tmp)),
        ):
            t0 = time.perf_counter()
            out[name] = fn()
            seconds[name] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {"hstu_attention_fwd": hstu.hstu_attention_fwd.launches,
                    "hstu_attention_bwd": hstu.hstu_attention_bwd.launches,
                    "row_write": write_rows.launches}
        # every model of the family ran both attention kernels
        if not (launches["hstu_attention_fwd"] and
                launches["hstu_attention_bwd"]):
            raise AssertionError(f"train_gr: kernel launches {launches}")
        out["kernel_launches"] = launches
        t0 = time.perf_counter()
        out["hstu_synth_timing"] = gr_hstu_synth_timing(paths)
        out["kernel_timing"] = gr_kernel_times(paths)
        seconds["timing"] = time.perf_counter() - t0
    out["seconds"] = seconds
    emit(out)
    return launches, out["kernel_timing"]


# --- train_zoo_rest: the rest of the ranking and multi-task zoo ------------
# xDeepFM, WuKong, PEPNet and DC2VR. No published config of these models is
# in the repository and none has a pinned label: each config takes the
# port's criteo_synth header (deepfm.config: 26 id features at dim 16 with
# the published buckets capped at 100 000, 13 raw features, batch 4096,
# BF16, rowwise adagrad lr 0.01, adam lr 0.001, one epoch) and assumed
# layer widths, and its AUCs are held against a CPU run of the same config
# from the same CPU-drawn weights (ZOO_CPU_BOUND).
ZOO_REST = ("xdeepfm", "wukong", "pepnet", "dc2vr")
ZOO_REST_METRICS = {"xdeepfm": ("auc", "grouped_auc_cat_10"),
                    "wukong": ("auc", "grouped_auc_cat_10"),
                    "pepnet": ("auc_ctr", "auc_cvr"),
                    "dc2vr": ("auc_ctr", "auc_cvr")}
# a config whose epoch on the card's host CPU takes much longer than a
# minute has its card run and its CPU reference both cut to these steps:
# xDeepFM's BF16 CIN took 263.5 s for 64 steps and the eval there, about
# 3.8 s a step (NVIDIA H100 80GB HBM3 host, 700.00 W card; PERF.md §6);
# WuKong's and PEPNet's CPU epochs (37.7-50.1 s) are cut to an eighth to
# keep the whole script near 900 s once phase train_sharded joined it
# dc2vr cut from its epoch of 64 steps (33 s there), for train_zch's time,
# then to 16 for train_sid's
# halved for the time of train_zch_ranks and train_stream: 8, 8, 8 and
# 16 before; dc2vr halved again for train_pipelined's (8 before)
ZOO_REST_STEPS = {"xdeepfm": 4, "wukong": 4, "pepnet": 4, "dc2vr": 4}
# the rows its data holds: enough for DC2VR's 16 steps; the eval set cut
# from 65 536 (the CPU reference's eval of xDeepFM) to 16 384 for
# train_sid's time, then to 8 192 (two predict batches) for train_fg's
ZOO_REST_ROWS = (65_536, 8_192)
# fp32 steps on the card against the CPU (3 before train_zch_ranks and
# train_stream joined, 2 before train_pipelined; TDM takes it too)
ZOO_REST_CHECK_STEPS = 1
ZOO_REST_CARD_TOL = 1e-4  # max abs error over the CPU's max abs, per tensor
# a linear's bias before a batch norm has a gradient of 0 up to rounding
ZOO_REST_ZERO_GRAD = 1e-5
ZOO_CATS = [f"cat_{i}" for i in range(26)]
ZOO_INTS = [f"int_{i}" for i in range(13)]


def _feature_group(name, feats, kind="DEEP") -> str:
    names = " ".join(f'feature_names: "{f}"' for f in feats)
    return f'  feature_groups {{ group_name: "{name}" {names} group_type: ' \
        f"{kind} }}\n"


_REST_RANK_HEAD = ("  num_class: 1\n  losses { binary_cross_entropy {} }\n"
                   "  metrics { auc {} }\n"
                   '  metrics { grouped_auc { grouping_key: "cat_10" } }\n')
_REST_TOWER = ('  task_towers {{ tower_name: "{name}" label_name: "{label}"'
               " {extra}\n    losses {{ binary_cross_entropy {{}} }}"
               " metrics {{ auc {{}} }} }}\n")


def zoo_rest_model_config(name: str) -> str:
    """The model_config block of a ZOO_REST config; the widths are
    assumed (no published config of these models is in the repo)."""
    if name == "xdeepfm":
        return (_feature_group("wide", ZOO_CATS, "WIDE")
                + _feature_group("fm", ZOO_CATS)
                + _feature_group("deep", ZOO_CATS + ZOO_INTS)
                + "  xdeepfm {\n    cin { cin_layer_size: [128, 128, 128] }\n"
                "    deep { hidden_units: [512, 256, 128] use_bn: true }\n"
                "    final { hidden_units: [128, 64] }\n"
                "    wide_embedding_dim: 4\n  }\n" + _REST_RANK_HEAD)
    if name == "wukong":
        layer = ("    wukong_layers { lcb_feature_num: 24 fmb_feature_num: 24"
                 " compressed_feature_num: 16\n"
                 "      feature_num_mlp { hidden_units: [512, 512] } }\n")
        return (_feature_group("sparse", ZOO_CATS)
                + _feature_group("dense", ZOO_INTS)
                + "  wukong {\n    dense_mlp { hidden_units: [512, 128] }\n"
                + layer * 3
                + '    final { hidden_units: [512, 256] activation: "nn.PReLU"'
                " }\n  }\n" + _REST_RANK_HEAD
                + "  variational_dropout { regularization_lambda: 0.01 }\n")
    if name == "pepnet":
        return (_feature_group("all", ZOO_CATS + ZOO_INTS)
                + _feature_group("domain", ["cat_5", "cat_16"])
                + _feature_group("ppnet", ["cat_0", "cat_9"])
                + "  pepnet {\n    epnet_hidden_unit: 512\n"
                "    ppnet_hidden_units: [512, 256, 128]\n"
                + _REST_TOWER.format(name="ctr", label="label", extra="")
                + _REST_TOWER.format(name="cvr", label="conversion",
                                     extra="")
                + "  }\n  use_pareto_loss_weight: true\n")
    if name == "dc2vr":
        return (_feature_group("all", ZOO_CATS + ZOO_INTS)
                + "  dc2vr {\n"
                '    bottom_mlp { hidden_units: [512] activation: "nn.Dice" }\n'
                "    expert_mlp { hidden_units: [256, 128] }\n"
                "    num_expert: 4\n"
                + _REST_TOWER.format(name="ctr", label="label", extra=(
                    "mlp { hidden_units: [64] } low_rank_dim: 32"))
                + _REST_TOWER.format(name="cvr", label="conversion", extra=(
                    'mlp { hidden_units: [64] } intervention_tower_names: '
                    '"ctr" low_rank_dim: 32 task_space_indicator_label: '
                    '"label" out_task_space_weight: 0.1'))
                + "  }\n")
    raise KeyError(name)


def zoo_rest_text(name: str, paths, model_dir: str, fp32: bool = False
                  ) -> str:
    """A ZOO_REST config: deepfm.config's header (both labels) with its
    paths and the model's block. ``fp32``: fp32 compute, adam's and
    rowwise adagrad's eps 1e-4 and every dropout ratio 0, for the
    card-against-CPU steps: both optimizers divide a gradient by its own
    size, so where it is at rounding level (a bias before a batch norm)
    or nearly cancels (a row's sum over its duplicates, which the card
    adds in another order) the default eps turns the rounding into an
    lr-sized step of either sign (ROADMAP §3)."""
    text = criteo_text("deepfm", model_dir, paths)
    head = text[:text.index("model_config {")].replace(
        '  label_fields: "label"\n',
        '  label_fields: "label"\n  label_fields: "conversion"\n')
    text = head + "model_config {\n" + zoo_rest_model_config(name) + "}\n"
    if fp32:
        for old, new in (('mixed_precision: "BF16"', ""),
                         ("adam_optimizer { lr: 0.001 }",
                          "adam_optimizer { lr: 0.001 eps: 1e-4 }"),
                         ("rowwise_adagrad_optimizer { lr: 0.01 }",
                          "rowwise_adagrad_optimizer { lr: 0.01 eps: 1e-4 }"),
                         ("low_rank_dim: 32", "low_rank_dim: 32 "
                          "dropout_ratio: 0.0")):
            if old in text:
                text = text.replace(old, new)
    return text


class GateReplay:
    """The card's ReLU and PReLU gates (x > 0, x >= 0), recorded in call
    order and replayed on the CPU. Two right fp32 runs of one model can
    round a pre-activation within an ulp of 0 to opposite sides: one
    sample's backward then takes another branch, and rowwise adagrad turns
    that sample's rows into steps of either sign (at batch 4096 about one
    such sample a forward; measured on the CPU against fp64: one sample of
    4096 off, by 1.8e-2 of the input gradient's max, every other within
    3.5e-7). Replaying the card's branch makes both runs compute one
    smooth function, held at the bound; every gate where the CPU would
    have branched otherwise is counted, and its pre-activation must lie
    within ``tol`` of the tensor's max abs of 0."""

    def __init__(self, tol: float) -> None:
        self.tol, self.masks, self.record = tol, [], True
        self.at, self.flips, self.worst_flip = 0, 0, 0.0

    def start(self, record: bool) -> None:
        self.record, self.at = record, 0
        if record:
            self.masks = []

    def done(self) -> None:
        if not self.record and self.at != len(self.masks):
            raise AssertionError(f"{self.at} gates on the CPU, "
                                 f"{len(self.masks)} on the card")

    def gate(self, x: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
        if self.record:
            self.masks.append(own)
            return own
        mask = self.masks[self.at].to(own.device)
        self.at += 1
        differ = mask != own
        if bool(differ.any()):
            self.flips += int(differ.sum())
            share = float(x.detach()[differ].abs().max()) / max(
                float(x.detach().abs().max()), 1e-30)
            self.worst_flip = max(self.worst_flip, share)
            if share > self.tol:
                raise AssertionError(f"a gate flips at {share:.3g} of its "
                                     "input's max: not a rounding tie")
        return mask

    def relu(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(self.gate(x, x > 0), x, x.new_zeros(()))


def replay_gates(models, replay: GateReplay):
    """Routes every ReLU (``torch.relu``, ``F.relu``, the MLPs' and
    PPNets' activation functions) and PReLU of ``models`` through
    ``replay``; returns the function that undoes it."""
    import torch.nn.functional as F

    from torcheasyrec_tpu_torch.modules import activation

    relu, f_relu = torch.relu, F.relu
    prelu_forward = activation.PReLU.forward
    swapped = [m for model in models for m in model.modules()
               if getattr(m, "act", None) is f_relu]
    for m in swapped:
        m.act = replay.relu
    torch.relu = F.relu = replay.relu
    activation.PReLU.forward = lambda mod, x: torch.where(
        replay.gate(x, x >= 0), x, mod.alpha * x).to(x.dtype)

    def undo() -> None:
        torch.relu, F.relu = relu, f_relu
        activation.PReLU.forward = prelu_forward
        for m in swapped:
            m.act = f_relu

    return undo


def zoo_rest_card_vs_cpu(name, text, train_path, batches=None) -> dict:
    """ZOO_REST_CHECK_STEPS fp32 train steps on the card and on the CPU
    from the same CPU-drawn weights and batches (the train file's first,
    or ``batches``, CPU batches), the variational-dropout
    noise drawn once on the CPU and given to both and the card's ReLU and
    PReLU branches replayed on the CPU (``GateReplay``): before each step
    the training-mode loss, every prediction and dense gradient within
    ZOO_REST_CARD_TOL of the CPU's max abs (a gradient at rounding level
    on the CPU, below ZOO_REST_ZERO_GRAD of the largest, must be so on the
    card); each step's losses; after the steps every tensor of the state
    dict (dense parameters, batch-norm statistics, the tables) and the
    row state of every table."""
    from torcheasyrec_tpu_torch.modules.variational_dropout import (
        draw_noise,
    )
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(text)
    cpu_model, features, _, cpu_state, cpu_step = build_trainer(
        cfg, device="cpu")
    card_model, _, _, card_state, card_step = build_trainer(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    if batches is None:
        batches = parquet_batches(train_path, features, ZOO_REST_CHECK_STEPS,
                                  cfg.data_config.batch_size)
    cmp = CpuComparison(name, ZOO_REST_CARD_TOL, ZOO_REST_ZERO_GRAD)
    noise_gen = torch.Generator().manual_seed(SEED)
    vds = cpu_model.variational_dropout or {}
    replay = GateReplay(ZOO_REST_CARD_TOL)
    undo = replay_gates((cpu_model, card_model), replay)

    def paired(card_fn, cpu_fn):
        replay.start(record=True)
        got = card_fn()
        replay.start(record=False)
        ref = cpu_fn()
        replay.done()
        return ref, got

    try:
        for i, batch in enumerate(batches):
            noise = {g: draw_noise(vd.n, noise_gen) for g, vd in vds.items()}
            cpu_model.vd_noise = noise
            card_model.vd_noise = {g: u.cuda() for g, u in noise.items()}
            card_batch = batch.to("cuda")
            (ref_loss, ref_preds, ref_grads), (loss, preds, grads) = paired(
                lambda: train_mode_outputs(card_model, card_batch),
                lambda: train_mode_outputs(cpu_model, batch))
            cmp.compare("loss", ref_loss, loss)
            for k in ref_preds:
                cmp.compare(k, ref_preds[k], preds[k])
            cmp.compare_grads(ref_grads, grads)
            (cpu_state, cpu_m), (card_state, card_m) = paired(
                lambda: card_step(card_state, card_batch),
                lambda: cpu_step(cpu_state, batch))
            for k in cpu_m:
                cmp.compare(f"step {i + 1} {k}", torch.as_tensor(cpu_m[k]),
                            torch.as_tensor(card_m[k]))
    finally:
        undo()
    ref_sd, sd = cpu_model.state_dict(), card_model.state_dict()
    if set(ref_sd) != set(sd):
        raise AssertionError(f"{name}: state dicts differ in their keys")
    for k in ref_sd:
        cmp.compare(f"state:{k}", ref_sd[k], sd[k])
    eng, card_eng = (cpu_model.embedding_group.engine,
                     card_model.embedding_group.engine)
    cpu_tables = cpu_model.embedding_group.engine_tables()
    card_tables = card_model.embedding_group.engine_tables()
    for t in cpu_model.embedding_group.tables:
        ref = eng.extract_table_state(cpu_tables, cpu_state["sparse_opt"], t)
        got = card_eng.extract_table_state(card_tables,
                                           card_state["sparse_opt"], t)
        for k in ref:
            cmp.compare(f"row_state:{t}.{k}", ref[k], got[k])
    stats = [k for k in ref_sd if k.endswith((".bn.mean", ".bn.var"))]
    errs = cmp.errs
    out = {"model": type(card_model).__name__, "steps": ZOO_REST_CHECK_STEPS,
           "batch": cfg.data_config.batch_size, "compared": len(errs),
           "max_rel_err": max(errs.values()),
           "max_rel_err_by_kind": {
               kind: max((v for k, v in errs.items() if k.startswith(kind)),
                         default=None)
               for kind in ("grad:", "state:", "row_state:", "step ")},
           "max_rel_err_bn_statistics": max(
               (errs[f"state:{k}"] for k in stats), default=None),
           "bn_statistics": len(stats), "zero_gradients": sorted(cmp.zero),
           "variational_dropout_groups": sorted(vds),
           "gates_replayed_per_forward": len(replay.masks),
           "gate_ties_flipped": replay.flips,
           "worst_flip_share_of_max": replay.worst_flip,
           "tol": ZOO_REST_CARD_TOL}
    del cpu_model, card_model, cpu_state, card_state
    torch.cuda.empty_cache()
    return out


def zoo_rest_feature_selection(model_dir) -> dict:
    """``feature_selection`` on a checkpointed model with variational
    dropout: every feature's drop probability it reports (1 - its keep
    probability) must equal sigmoid(logit_p) of the saved weights."""
    from torcheasyrec_tpu_torch.tools.feature_selection import (
        select_features,
    )
    from torcheasyrec_tpu_torch.utils import checkpoint_util

    cfg_path = os.path.join(model_dir, "pipeline.config")
    ranked = select_features(cfg_path, topk=1000, device="cuda")
    ckpt = torch.load(checkpoint_util.latest_checkpoint(model_dir),
                      map_location="cpu", weights_only=True)["model"]
    want = {}
    for key in ("sparse", "dense"):
        p = torch.sigmoid(ckpt[f"variational_dropout.{key}.logit_p"])
        names = ZOO_CATS if key == "sparse" else ZOO_INTS
        want.update(zip(names, p.tolist()))
    drop = {k: 1.0 - v for k, v in ranked.items()}
    if set(drop) != set(want):
        raise AssertionError(f"feature_selection named {sorted(drop)}")
    err = max(abs(drop[k] - want[k]) for k in want)
    if not err <= 1e-6:
        raise AssertionError(f"feature_selection's drop probabilities are "
                             f"{err:.3g} from sigmoid(logit_p)")
    order = list(ranked)
    return {"features": len(ranked), "max_abs_err": err,
            "most_kept": order[:3], "least_kept": order[-3:],
            "drop_probability_range": [min(drop.values()),
                                       max(drop.values())]}


def phase_train_zoo_rest():
    """ZOO_REST on the card: each config fp32 against the CPU over
    ZOO_REST_CHECK_STEPS steps, then through the entry points as the zoo's
    (``zoo_model``: an epoch with the row writes counted, the AUCs against
    a CPU run from the same weights, ``evaluate``, ``predict_checkpoint``,
    the resident step), xDeepFM's row writes at a real step against the
    plain version, and ``feature_selection`` on WuKong's checkpoint;
    returns the row-write launches of the epochs."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.benchmark import synthetic
    from torcheasyrec_tpu_torch.ops.row_write import write_rows

    out = {"phase": "train_zoo_rest", "models": {}, "card_vs_cpu": {}}
    seconds, launches = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = synthetic.ensure_dataset(tmp, *ZOO_REST_ROWS)
        pred_in = os.path.join(tmp, "predict_in.parquet")
        pq.write_table(pq.read_table(paths["eval"]).slice(
            0, ZOO_PREDICT_BATCHES * ZOO_BATCH), pred_in)
        seconds["data"] = time.perf_counter() - t0
        for name in ZOO_REST:
            t0 = time.perf_counter()
            before = write_rows.launches
            out["card_vs_cpu"][name] = zoo_rest_card_vs_cpu(
                name, zoo_rest_text(name, paths, os.path.join(
                    tmp, f"{name}_check"), fp32=True), paths["train"])
            out["card_vs_cpu"][name]["row_write_launches"] = (
                write_rows.launches - before)
            seconds[f"{name}_card_vs_cpu"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            src = os.path.join(tmp, f"{name}.config")
            with open(src, "w") as f:
                f.write(zoo_rest_text(name, paths, os.path.join(tmp, name)))
            res = zoo_model(name, paths, pred_in, tmp,
                            {"metrics": list(ZOO_REST_METRICS[name])}, src,
                            ZOO_REST_STEPS.get(name))
            launches += res["row_write_launches"]
            if name == "wukong":
                res["feature_selection"] = zoo_rest_feature_selection(
                    os.path.join(tmp, name))
            seconds[name] = time.perf_counter() - t0
            out["models"][name] = res
            emit({"phase": "train_zoo_rest_model", "model": name,
                  "card_vs_cpu": out["card_vs_cpu"][name], **res})
    out["seconds"] = seconds
    out["row_write_launches"] = launches
    emit({"phase": "train_zoo_rest", "seconds": seconds,
          "row_write_launches": launches,
          "card_vs_cpu": {n: {k: r[k] for k in ("max_rel_err", "compared")}
                          for n, r in out["card_vs_cpu"].items()},
          "models": {n: {k: r[k] for k in ZOO_SUMMARY + ("cpu_reference",)}
                     for n, r in out["models"].items()}})
    return launches


# --- export: artifacts, the loaded program, the delta dump, cached decode --
EXPORT_F8_STEPS = 4  # two dumps, as 8 at interval 4 gave before
EXPORT_F8_INTERVAL = 2
EXPORT_PREDICT_ROWS = 4096
EXPORT_QUANT_TOL = 0.05  # INT8 probs against fp32's: the JAX test's bound
EXPORT_TIMED_FORWARDS = 5
DECODE_PREFILL = 2048  # history tokens prefilled, then DECODE_TOKENS one by one
DECODE_TOKENS = 4
# the loaded program runs in a process of its own that imports torch and
# the attention operator's module only, never the model code
LOADED_PROGRAM = r"""
import json, sys
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torcheasyrec_tpu_torch.ops import hstu

program_path, inputs_path, out_path, n_timed = sys.argv[1:5]
torch.backends.cuda.matmul.allow_tf32 = False
leaves = [t.cuda() for t in torch.load(inputs_path, weights_only=True)]
program = torch.export.load(program_path).module()
hstu.hstu_attention_fwd.launches = 0
with torch.inference_mode():
    program(*leaves)  # warm-up
    torch.cuda.synchronize()
    before = hstu.hstu_attention_fwd.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = program(*leaves)
        torch.cuda.synchronize()
    profiled = hstu.hstu_attention_fwd.launches - before
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(int(n_timed)):
        program(*leaves)
    end.record()
    torch.cuda.synchronize()
traced = sum(1 for e in prof.events()
             if e.device_type == DeviceType.CUDA and "hstu_fwd" in e.name)
torch.save({k: v.cpu() for k, v in out.items()}, out_path)
print(json.dumps({
    "launches": hstu.hstu_attention_fwd.launches,
    "profiled_forward_launches": profiled,
    "profiled_forward_traced_kernels": traced,
    "forward_ms": start.elapsed_time(end) / int(n_timed),
    "port_modules": sorted(m for m in sys.modules
                           if m.startswith("torcheasyrec_tpu_torch"))}))
"""


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def timed_export(port_main, cfg_path, export_dir, **kw) -> dict:
    t0 = time.perf_counter()
    port_main.export(cfg_path, export_dir, device="cuda", **kw)
    return {"export_s": time.perf_counter() - t0,
            "artifact_bytes": dir_bytes(export_dir)}


def read_column(path, key) -> torch.Tensor:
    import pyarrow.parquet as pq

    col = pq.read_table(path)[key].to_numpy(zero_copy_only=False)
    return torch.from_numpy(np.stack(col) if col.dtype == object else col)


def equal_columns(what, got_path, ref_path, keys) -> list:
    """Raise unless each column of ``keys`` is bit-equal in two predict
    outputs; returns the columns compared."""
    for key in keys:
        got, ref = read_column(got_path, key), read_column(ref_path, key)
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"{what} {key}: {tuple(got.shape)} vs "
                                 f"{tuple(ref.shape)}, not bit-equal")
    return keys


def export_dlrm_hstu(port_main, hstu, tmp) -> dict:
    """The lane's DLRM-HSTU: checkpoint, export, the program loaded in a
    fresh process, the artifact predict against predict_checkpoint."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg_path = os.path.join(tmp, "dlrm_hstu.config")
    text = config_text("PALLAS", model_dir=os.path.join(tmp, "hstu_model"))
    with open(cfg_path, "w") as f:
        f.write(text)
    cfg = parse_pipeline_config(text)
    model, features = port_main.build_model(cfg, "cuda", seed=SEED)
    ckpt = os.path.join(tmp, "hstu.pt")
    torch.save(model.state_dict(), ckpt)
    export_dir = os.path.join(tmp, "hstu_export")
    before = hstu.hstu_attention_fwd.launches
    res = timed_export(port_main, cfg_path, export_dir, checkpoint_path=ckpt)
    if hstu.hstu_attention_fwd.launches != before:
        raise AssertionError("the export launched the kernel: the trace "
                             "must run on fake tensors")
    program_path = os.path.join(export_dir, port_main.PREDICT_PROGRAM)
    res["program_bytes"] = os.path.getsize(program_path)
    with open(os.path.join(export_dir, port_main.SERVING_SPEC)) as f:
        res["serving_spec"] = {k: v for k, v in json.load(f).items()
                               if k != "input_tree"}

    # the eager eval step on the traced batch
    _, batch = port_main.serving_batch(cfg, features, "cuda")
    leaves = torch.utils._pytree.tree_flatten(batch)[0]
    eval_step = port_main.make_eval_step(model, with_loss=False)
    ref = {k: v for k, v in eval_step(batch)[0].items()
           if not k.startswith("__")}
    res["eager_forward_ms"] = cuda_ms(lambda: eval_step(batch),
                                      EXPORT_TIMED_FORWARDS)
    inputs = os.path.join(tmp, "hstu_inputs.pt")
    torch.save([t.cpu() for t in leaves], inputs)
    outs = os.path.join(tmp, "hstu_loaded_out.pt")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", LOADED_PROGRAM, program_path, inputs, outs,
         str(EXPORT_TIMED_FORWARDS)],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError("the loaded program failed:\n" + proc.stdout
                             + proc.stderr[-4000:])
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    loaded["process_s"] = time.perf_counter() - t0
    n_layers = len(model.transducer.stack.layers)
    allowed = {"torcheasyrec_tpu_torch", "torcheasyrec_tpu_torch.ops",
               "torcheasyrec_tpu_torch.ops.hstu",
               "torcheasyrec_tpu_torch.ops.cuda_build",
               "torcheasyrec_tpu_torch.modules",
               "torcheasyrec_tpu_torch.modules.module"}
    if set(loaded["port_modules"]) - allowed:
        raise AssertionError("the loaded program's process imported model "
                             f"code: {loaded['port_modules']}")
    if (loaded["profiled_forward_launches"] != n_layers
            or loaded["profiled_forward_traced_kernels"] != n_layers):
        raise AssertionError(
            f"the loaded program launched kernel #1 "
            f"{loaded['profiled_forward_launches']} times "
            f"({loaded['profiled_forward_traced_kernels']} in the trace), "
            f"not once per STU layer ({n_layers})")
    got = torch.load(outs, weights_only=True)
    if sorted(got) != sorted(ref):
        raise AssertionError(f"outputs {sorted(got)} vs {sorted(ref)}")
    loaded["bit_equal_to_eager"] = all(
        torch.equal(got[k], ref[k].cpu()) for k in ref)
    loaded["max_abs_err_vs_eager"] = {
        k: check(f"loaded program {k}", got[k], ref[k].cpu(), BF16_TOL)
        for k in ref}
    res["loaded_program"] = loaded

    # predict from the artifact against predict_checkpoint, bit for bit
    requests = os.path.join(tmp, "hstu_requests.parquet")
    pq.write_table(pa.concat_tables([pa.table(synth_cols(BATCH, SEED + i))
                                     for i in (1, 2)]), requests)
    art_out = os.path.join(tmp, "hstu_artifact_preds.parquet")
    ckpt_out = os.path.join(tmp, "hstu_ckpt_preds.parquet")
    before = hstu.hstu_attention_fwd.launches
    n = port_main.predict(requests, art_out, export_dir,
                          reserved_columns="user_id", device="cuda")
    port_main.predict_checkpoint(cfg_path, requests, ckpt_out,
                                 checkpoint_path=ckpt,
                                 reserved_columns="user_id", device="cuda")
    res["predict_launches"] = hstu.hstu_attention_fwd.launches - before
    if n != 2 * BATCH or res["predict_launches"] != 4 * n_layers:
        raise AssertionError(f"predict: {n} rows, "
                             f"{res['predict_launches']} launches")
    res["predict_bit_equal_to_predict_checkpoint"] = equal_columns(
        "artifact predict", art_out, ckpt_out,
        ["user_id", "probs_is_click", "probs_is_like", "logits_is_click",
         "logits_is_like"])
    return res, model


def whole_model_towers(port_main, export_dir, rows) -> dict:
    """Both towers' embeddings of the whole model of an artifact's root
    (its weights, the eval step) over the predict-mode loader's batches
    of ``rows``, on the card."""
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
    from torcheasyrec_tpu_torch.utils import checkpoint_util

    cfg = port_main.config_util.load_pipeline_config(
        os.path.join(export_dir, "pipeline.config"))
    dev = torch.device("cuda")
    model, features = port_main._artifact_model(cfg, dev)
    checkpoint_util.restore_model(os.path.join(export_dir, "model"), model)
    step = port_main.make_eval_step(model, with_loss=False)
    outs = {"user_tower_emb": [], "item_tower_emb": []}
    batches = create_dataloader(cfg.data_config, features, rows,
                                mode="predict", device=dev)()
    try:
        for batch, _ in batches:
            preds = step(batch)[0]
            for k, v in outs.items():
                v.append(preds[k].float().cpu())
    finally:
        batches.close()
    return {k: torch.cat(v) for k, v in outs.items()}


def export_towers(port_main, hstu, tmp) -> dict:
    """criteo_synth dssm at its published width and HSTU-Match at the JAX
    test's config: per-tower artifacts; each tower's embeddings from its
    artifact against the whole model's outputs on the same rows."""
    from torcheasyrec_tpu_torch.utils import test_util
    from torcheasyrec_tpu_torch.utils.config_util import load_pipeline_config

    out = {}
    match_paths = gr_match_files(tmp)
    dssm_src = os.path.join(zoo_config_dir(), "criteo_synth", "dssm.config")
    for name in ("dssm", "hstu_match"):
        cfg_path = os.path.join(tmp, f"{name}.config")
        model_dir = os.path.join(tmp, f"{name}_model")
        if name == "dssm":
            cfg = load_pipeline_config(dssm_src)
            cfg.model_dir = model_dir
            port_main.config_util.save_message(cfg, cfg_path)
            features = port_main._create_features(cfg)
            rows = os.path.join(tmp, "dssm_rows.parquet")
            test_util.write_mock_parquet(rows, features, EXPORT_PREDICT_ROWS,
                                         [], seed=5)
        else:
            with open(cfg_path, "w") as f:
                f.write(gr_match_text(match_paths, model_dir, 0.0))
            rows = match_paths["eval"]
        export_dir = os.path.join(tmp, f"{name}_export")
        before = hstu.hstu_attention_fwd.launches
        res = timed_export(port_main, cfg_path, export_dir)
        whole = whole_model_towers(port_main, export_dir, rows)
        res["towers"] = {}
        for tower in ("user", "item"):
            tdir = os.path.join(export_dir, tower)
            program = torch.export.load(os.path.join(
                tdir, port_main.TOWER_PROGRAM))
            ops = sum(1 for n in program.graph.nodes
                      if n.op == "call_function"
                      and str(n.target).startswith(
                          "tzrec_tpu_torch.hstu_attention_fwd"))
            emb = os.path.join(tmp, f"{name}_{tower}.parquet")
            port_main.predict(rows, emb, tdir, device="cuda")
            key = f"{tower}_tower_emb"
            got = read_column(emb, key)
            res["towers"][tower] = {
                "artifact_bytes": dir_bytes(tdir), "attention_ops": ops,
                "rows": got.shape[0],
                "max_abs_err_vs_whole_model": check(
                    f"{name} {tower} tower", got, whole[key], FP32_TOL),
                "bit_equal": bool(torch.equal(got, whole[key]))}
        want_ops = 2 if name == "hstu_match" else 0
        if (res["towers"]["user"]["attention_ops"] != want_ops
                or res["towers"]["item"]["attention_ops"] != 0):
            raise AssertionError(f"{name}: the tower programs hold "
                                 f"{res['towers']} attention operators")
        res["launches"] = hstu.hstu_attention_fwd.launches - before
        out[name] = res
    return out


def export_f8_and_quant(port_main, write_rows, tmp) -> dict:
    """criteo_synth deepfm: EXPORT_F8_STEPS steps through
    ``train_and_evaluate`` with the delta dump every EXPORT_F8_INTERVAL
    (kernel #3 once a step), each shard's ids against the batches' ids
    parsed on the host and its rows against the step's checkpoint; then
    the fp32 and the INT8 export of the trained weights."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.acc.quant_util import quantize_rowwise
    from torcheasyrec_tpu_torch.benchmark import synthetic
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.utils import checkpoint_util
    from torcheasyrec_tpu_torch.utils.config_util import load_pipeline_config
    from torcheasyrec_tpu_torch.utils.delta_embedding_dump import (
        DeltaEmbeddingDumper,
    )

    paths = synthetic.ensure_dataset(tmp, EXPORT_F8_STEPS * ZOO_BATCH,
                                     EXPORT_PREDICT_ROWS)
    cfg = load_pipeline_config(
        os.path.join(zoo_config_dir(), "criteo_synth", "deepfm.config"))
    model_dir = os.path.join(tmp, "deepfm_model")
    cfg.model_dir = model_dir
    cfg.train_input_path, cfg.eval_input_path = paths["train"], paths["eval"]
    tc = cfg.train_config
    tc.num_steps = EXPORT_F8_STEPS
    tc.save_checkpoints_steps = EXPORT_F8_INTERVAL
    tc.delta_embedding_dump_config.dump_interval_steps = EXPORT_F8_INTERVAL
    if cfg.data_config.shuffle or cfg.data_config.batch_size != ZOO_BATCH:
        raise AssertionError("the ids check reads batches of ZOO_BATCH rows "
                             "in file order")
    cfg_path = os.path.join(tmp, "deepfm.config")
    port_main.config_util.save_message(cfg, cfg_path)
    before = write_rows.launches
    t0 = time.perf_counter()
    port_main.train_and_evaluate(cfg_path, device="cuda")
    res = {"train_s": time.perf_counter() - t0,
           "row_write_launches": write_rows.launches - before}

    # the ids of each dump's batches, parsed from the parquet on the host;
    # the CPU model in the export's layout (the config's sparse optimizer)
    model, features = port_main._artifact_model(cfg, torch.device("cpu"))
    # a row write a step for each packed group with tables past the lane
    res["written_groups"] = sum(
        1 for g in model.embedding_group.engine.groups.values()
        if g.packed and len(g.dense_tables) < len(g.specs))
    dumper = DeltaEmbeddingDumper(os.path.join(tmp, "unused_dump"),
                                  model.embedding_group)
    table = pq.read_table(paths["train"])
    parser = DataParser(features)
    dump_dir = os.path.join(model_dir, "delta_embedding_dump")
    shards = sorted(os.listdir(dump_dir))
    steps = range(EXPORT_F8_INTERVAL, EXPORT_F8_STEPS + 1, EXPORT_F8_INTERVAL)
    res["shards"] = len(shards)
    ids_per_dump = {}
    for step in steps:
        rows = table.slice((step - EXPORT_F8_INTERVAL) * ZOO_BATCH,
                           EXPORT_F8_INTERVAL * ZOO_BATCH)
        batch = parser.parse_to_batch(
            {n: rows.column(n) for n in rows.schema.names})
        want = {}
        for fname, tname in dumper._feature_to_table.items():
            v = batch.sparse_features[fname].values.reshape(-1).numpy()
            want.setdefault(tname, set()).update(v[v >= 0].tolist())
        ckpt_model, _ = port_main.build_model(cfg, "cpu")
        checkpoint_util.load_model_weights(
            checkpoint_util.checkpoint_path(model_dir, step), ckpt_model)
        eg = ckpt_model.embedding_group
        for tname, ids in want.items():
            shard = os.path.join(dump_dir,
                                 f"delta_embedding-{tname}-{step}.parquet")
            t = pq.read_table(shard)
            got_ids = t["id"].to_numpy()
            if not np.array_equal(got_ids, np.array(sorted(ids))):
                raise AssertionError(f"{shard}: {len(got_ids)} ids, the "
                                     f"batches looked up {len(ids)}")
            rows_ref = eg.engine.extract_table(eg.engine_tables(), tname)[
                torch.from_numpy(got_ids)]
            got = torch.from_numpy(np.stack(t["embedding"].to_numpy(
                zero_copy_only=False)))
            if not torch.equal(got, rows_ref):
                raise AssertionError(f"{shard}: rows differ from the step's "
                                     "checkpoint")
            ids_per_dump.setdefault(step, []).append(len(ids))
    res["ids_per_dump"] = {s: {"tables": len(n), "ids": sum(n)}
                           for s, n in ids_per_dump.items()}
    n_checked = sum(len(n) for n in ids_per_dump.values())
    if res["shards"] != n_checked:
        raise AssertionError(f"{res['shards']} shards for {n_checked} "
                             "(table, dump) pairs")

    # the fp32 and the INT8 artifact of the trained weights
    pred_in = os.path.join(tmp, "deepfm_pred_in.parquet")
    pq.write_table(pq.read_table(paths["eval"]), pred_in)
    res["fp32"] = timed_export(port_main, cfg_path,
                               os.path.join(tmp, "deepfm_fp32"))
    os.environ["QUANT_EMB"] = "INT8"
    try:
        res["int8"] = timed_export(port_main, cfg_path,
                                   os.path.join(tmp, "deepfm_int8"))
    finally:
        del os.environ["QUANT_EMB"]
    eg = model.embedding_group
    checkpoint_util.load_model_weights(
        checkpoint_util.latest_checkpoint(model_dir), model)
    qdir = os.path.join(tmp, "deepfm_int8", "quant_tables")
    for gk, w in eg.engine.export_weight_matrices(
            eg.engine_tables()).items():
        want = quantize_rowwise(w, "INT8")
        got = np.load(os.path.join(qdir, f"{gk}.npz"))
        for k in ("values", "scales"):
            if not np.array_equal(got[k], want[k]):
                raise AssertionError(f"INT8 {gk} {k}: not bit-equal to the "
                                     "CPU quantization")
    p32, p8 = (os.path.join(tmp, f"deepfm_{k}.parquet")
               for k in ("fp32", "int8"))
    port_main.predict(pred_in, p32, os.path.join(tmp, "deepfm_fp32"),
                      device="cuda")
    port_main.predict(pred_in, p8, os.path.join(tmp, "deepfm_int8"),
                      device="cuda")
    a, b = read_column(p8, "probs"), read_column(p32, "probs")
    res["int8_vs_fp32_probs_max_abs"] = float((a - b).abs().max())
    if not res["int8_vs_fp32_probs_max_abs"] < EXPORT_QUANT_TOL:
        raise AssertionError(f"INT8 probs {res['int8_vs_fp32_probs_max_abs']}"
                             f" from fp32's (bound {EXPORT_QUANT_TOL})")
    return res


def export_cached_decode(model, hstu) -> dict:
    """The lane's STU stack (bf16): a prefill of DECODE_PREFILL history
    tokens, then DECODE_TOKENS decodes of one token, against the rows of
    the full forward (kernel #1) over the same tokens. Without the
    contextual prefix: its row attends the whole sequence in a full
    forward, so no incremental decode (the JAX package's neither) gives
    the full forward's rows with it."""
    stack = model.transducer.stack
    stack.set_contextual_seq_len(0)
    n_max = MAX_SEQ + N_CAND * 2
    e = stack.layers[0].uvqk_weight.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    total = DECODE_PREFILL + DECODE_TOKENS
    x = torch.randn(BATCH, total, e, device="cuda", generator=gen).to(
        torch.bfloat16)
    caches = stack.init_cache(BATCH, n_max)
    before = hstu.hstu_attention_fwd.launches
    with torch.inference_mode():
        _, caches = stack.cached_forward(
            x[:, :DECODE_PREFILL],
            torch.full((BATCH,), DECODE_PREFILL, dtype=torch.int32,
                       device="cuda"), caches, scaling_seqlen=n_max)
        decoded = []
        for t in range(DECODE_PREFILL, total):
            y, caches = stack.cached_forward(
                x[:, t:t + 1], torch.full((BATCH,), t + 1, dtype=torch.int32,
                                          device="cuda"),
                caches, scaling_seqlen=n_max)
            decoded.append(y)
        if hstu.hstu_attention_fwd.launches != before:
            raise AssertionError("the cached decode launched kernel #1")
        full = stack(x, torch.full((BATCH,), total, dtype=torch.int32,
                                   device="cuda"), scaling_seqlen=n_max)
    launches = hstu.hstu_attention_fwd.launches - before
    got, ref = torch.cat(decoded, 1), full[:, DECODE_PREFILL:]
    err = check("cached decode", got, ref, BF16_TOL)
    return {"batch": BATCH, "prefill": DECODE_PREFILL,
            "decoded": DECODE_TOKENS, "cache_len": n_max,
            "max_abs_err_vs_full": err, "max_abs_full": rel_err(got, ref)[1],
            "tol_rel": BF16_TOL, "launches": launches}


def phase_export(smi):
    """Export and artifact serving: ``export_dlrm_hstu``,
    ``export_towers``, ``export_f8_and_quant``, ``export_cached_decode``;
    returns kernel #1's and kernel #3's launches (the loaded program's in
    its own process included)."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.ops import hstu
    from torcheasyrec_tpu_torch.ops.row_write import write_rows

    seconds = {}
    hstu.hstu_attention_fwd.launches = 0
    write_rows.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dlrm_hstu, model = export_dlrm_hstu(port_main, hstu, tmp)
        seconds["dlrm_hstu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        decode = export_cached_decode(model, hstu)
        del model
        torch.cuda.empty_cache()
        seconds["cached_decode"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        towers = export_towers(port_main, hstu, tmp)
        seconds["towers"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        deepfm = export_f8_and_quant(port_main, write_rows, tmp)
        seconds["deepfm_f8_quant"] = time.perf_counter() - t0
    # the parent's launches, and the loaded program's in its own process
    fwd = (hstu.hstu_attention_fwd.launches
           + dlrm_hstu["loaded_program"]["launches"])
    writes = write_rows.launches
    want = EXPORT_F8_STEPS * deepfm["written_groups"]
    if writes != deepfm["row_write_launches"] or writes != want:
        raise AssertionError(f"{writes} row writes for {EXPORT_F8_STEPS} "
                             f"deepfm steps of {deepfm['written_groups']} "
                             "written groups")
    emit({"phase": "export", "nvidia_smi": smi, "seconds": seconds,
          "dlrm_hstu": dlrm_hstu, "cached_decode": decode, "towers": towers,
          "deepfm": deepfm, "kernel_launches": {
              "hstu_attention_fwd": fwd, "row_write": writes}})
    return fwd, writes


# --- train_tdm: TDM tree retrieval -------------------------------------------
TDM_BATCH = 1024  # input rows a step; the sampler makes ~46 800 pairs of them
TDM_LAYERS = (0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6)  # negatives by depth
# train_and_evaluate on the card and on the CPU: cut from 64 steps, whose
# CPU reference took 137.7 s on the card's host (2.2 s a step; PERF.md
# §6), to keep the whole script near 900 s: 8 steps when phase
# train_sharded joined it, 5 when train_zch did (the trace of steps 3-5
# needs 5)
TDM_STEPS = 5
TDM_RETRAIN_STEPS = 5  # on the rebuilt tree (cut from 32, then 8)
TDM_EVAL_ROWS = 256  # cut from 4 096, then 1 024, then 512
TDM_WORKERS = 4
TDM_SAMPLER_BATCHES = 3  # was 5
TDM_SHM_ITEMS = 1_000_000  # the shared item table (4 M, then 2 M before)
TDM_SHM_WORKERS = 2  # 4 before
TDM_LOADER_STEPS = 4  # the loader-fed window after LOADER_WARMUP (16, 8)
TDM_RECALL_NUM, TDM_N_CLUSTER = 50, 2
TDM_RETRIEVAL_USERS = 64  # cut from 1 024, then 256, 128: the CPU's time
TDM_CPU_BOUND = 0.02  # AUC and recall@50 on the card against the CPU's
TDM_PREDICT_ROWS = 256  # within TDM_EVAL_ROWS (4 096, 1 024, 512 before)
# the node predict from the embedding artifact, in a process of its own
TDM_NODE_PREDICT = r"""
import sys
from torcheasyrec_tpu_torch import main
print(main.predict(sys.argv[1], sys.argv[2], sys.argv[3],
                   reserved_columns="item_id"))
"""


def tdm_text(paths, tree, model_dir, num_steps=None, check=False) -> str:
    """TDM on the criteo_synth data at assumed widths (the upstream Taobao
    example's model, which is not in the repository): the 26 ``cat_*`` at
    dim 16 (the generator's capped buckets) and the 13 ``int_*`` in a DEEP
    group ``user``; ``item_id`` (the query, 4 096 buckets to cover the
    tree's internal nodes) and ``click_seq`` (30 long) on one table
    ``item_emb``; MultiWindowDIN over windows 1, 1, 2, 2, 4, 4, 8, 8 with
    an attention MLP of 36 (PReLU); final 256-128-64-32 with batch norm
    and PReLU; BCE, AUC; batch 1 024, fp32, rowwise adagrad lr 0.01 and
    adam lr 0.001; ``check``: adam's and rowwise adagrad's eps 1e-4, as
    the card-against-CPU steps of ``zoo_rest_text``."""
    from torcheasyrec_tpu_torch.benchmark.synthetic import CRITEO_BUCKETS

    eps = " eps: 1e-4" if check else ""
    num_steps = num_steps or TDM_STEPS
    feats = "".join(
        f'feature_configs {{ id_feature {{ feature_name: "cat_{j}" '
        f"num_buckets: {b} embedding_dim: 16 }} }}\n"
        for j, b in enumerate(CRITEO_BUCKETS))
    feats += "".join(
        f'feature_configs {{ raw_feature {{ feature_name: "int_{i}" }} }}\n'
        for i in range(13))
    layers = ", ".join(map(str, TDM_LAYERS))
    return f"""train_input_path: "{paths['train']}"
eval_input_path: "{paths['tdm_eval']}"
model_dir: "{model_dir}"
train_config {{
  sparse_optimizer {{ rowwise_adagrad_optimizer {{ lr: 0.01{eps} }}
                      constant_learning_rate {{}} }}
  dense_optimizer {{ adam_optimizer {{ lr: 0.001{eps} }}
                     constant_learning_rate {{}} }}
  num_steps: {num_steps}
  save_checkpoints_steps: 100000
  is_profiling: true
}}
eval_config {{}}
data_config {{
  batch_size: {TDM_BATCH}
  dataset_type: ParquetDataset
  fg_mode: FG_NONE
  label_fields: "label"
  num_workers: {TDM_WORKERS}
  tdm_sampler {{
    item_input_path: "{tree}/node_table.parquet"
    edge_input_path: "{tree}/edge_table.parquet"
    predict_edge_input_path: "{tree}/edge_table.parquet"
    attr_fields: "item_id"
    item_id_field: "item_id"
    layer_num_sample: [{layers}]
  }}
}}
{feats}feature_configs {{ id_feature {{ feature_name: "item_id"
  num_buckets: 4096 embedding_dim: 16 embedding_name: "item_emb" }} }}
feature_configs {{ sequence_id_feature {{ feature_name: "click_seq"
  num_buckets: 4096 embedding_dim: 16 sequence_length: 30
  embedding_name: "item_emb" }} }}
model_config {{
{_feature_group("user", ZOO_CATS + ZOO_INTS)}\
  feature_groups {{ group_name: "seq" feature_names: "item_id"
                    feature_names: "click_seq" group_type: SEQUENCE }}
  tdm {{
    multiwindow_din {{ windows_len: [1, 1, 2, 2, 4, 4, 8, 8]
      attn_mlp {{ hidden_units: [36] activation: "nn.PReLU" }} }}
    final {{ hidden_units: [256, 128, 64, 32] use_bn: true
             activation: "nn.PReLU" }}
  }}
  num_class: 1
  losses {{ binary_cross_entropy {{}} }}
  metrics {{ auc {{}} }}
}}
"""


def write_text(path, text) -> str:
    with open(path, "w") as f:
        f.write(text)
    return path


def tdm_tree(items, tree) -> dict:
    """``init_tree`` over the items; its node and edge counts, root and
    leaf depth."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.tools.tdm.gen_tree import init_tree

    t0 = time.perf_counter()
    init_tree(items, tree, branching=2)
    nodes = pq.read_table(os.path.join(tree, "node_table.parquet"))
    edges = pq.read_table(os.path.join(tree, "edge_table.parquet"))
    with open(os.path.join(tree, "root_id.txt")) as f:
        root = int(f.read())
    return {"nodes": nodes.num_rows, "edges": edges.num_rows, "root": root,
            "internal_ids": [int(pq.read_table(items).num_rows) + 1, root],
            "init_tree_s": time.perf_counter() - t0}


def tdm_sampler_host(cfg, features, train_path) -> dict:
    """``TDMSampler.process`` on the card's host: ms per batch of
    TDM_BATCH rows (median of TDM_SAMPLER_BATCHES) and pairs per batch;
    and the parse of the sampled columns into a batch (the loader's next
    step: every user column repeated per pair, the history strings
    included)."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.datasets.dataset import (
        _selected_columns,
        create_sampler,
    )

    sampler = create_sampler(cfg.data_config, "train", features)
    t0 = time.perf_counter()
    sampler.init()
    init_s = time.perf_counter() - t0
    tbl = pq.read_table(train_path, columns=_selected_columns(
        cfg.data_config, features, "train", None))
    parser = DataParser(features, labels=list(cfg.data_config.label_fields))
    ms, parse_ms, pairs, positives = [], [], [], []
    for i in range(TDM_SAMPLER_BATCHES):
        part = tbl.slice(i * TDM_BATCH, TDM_BATCH)
        cols = {c: part[c].combine_chunks() for c in part.column_names}
        t0 = time.perf_counter()
        out = sampler.process(cols)
        t1 = time.perf_counter()
        parser.parse_to_batch(out)
        parse_ms.append((time.perf_counter() - t1) * 1e3)
        ms.append((t1 - t0) * 1e3)
        pairs.append(len(out["item_id"]))
        positives.append(int(out["label"].to_numpy().sum()))
    return {"init_s": init_s, "ms_per_batch_median": float(np.median(ms)),
            "ms_per_batch": ms,
            "parse_ms_per_batch_median": float(np.median(parse_ms)),
            "parse_ms_per_batch": parse_ms, "pairs_per_batch": pairs,
            "positives_per_batch": positives,
            "pairs_per_s": float(np.median(pairs)) / np.median(ms) * 1e3,
            "max_depth": sampler._max_depth}


def proc_memory_kb() -> dict:
    """This process's memory as the kernel reports it, in kB: /proc's
    ``status`` (VmRSS, RssAnon, RssFile, RssShmem), ``statm`` (resident,
    shared) and ``smaps_rollup`` (Rss, Pss, Private_*, Shared_*), each
    key where the system provides it; and ``private``, the first of
    RssAnon, Private_Clean + Private_Dirty and statm's resident - shared
    that it has (``private_source`` names it)."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, val = line.partition(":")
            if key in ("VmRSS", "RssAnon", "RssFile", "RssShmem"):
                out[key] = int(val.split()[0])
    page_kb = os.sysconf("SC_PAGE_SIZE") // 1024
    with open("/proc/self/statm") as f:
        _, resident, shared = (int(v) for v in f.read().split()[:3])
    out["statm_resident"], out["statm_shared"] = (resident * page_kb,
                                                  shared * page_kb)
    try:
        with open("/proc/self/smaps_rollup") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key in ("Rss", "Pss", "Private_Clean", "Private_Dirty",
                           "Shared_Clean", "Shared_Dirty"):
                    out[f"smaps_{key}"] = int(val.split()[0])
    except OSError:
        pass
    if "RssAnon" in out:
        out["private"], out["private_source"] = out["RssAnon"], "RssAnon"
    elif "smaps_Private_Dirty" in out:
        out["private"] = (out["smaps_Private_Clean"]
                          + out["smaps_Private_Dirty"])
        out["private_source"] = "smaps_rollup Private_*"
    else:
        out["private"] = resident * page_kb - shared * page_kb
        out["private_source"] = "statm resident - shared"
    return out


def mem_available_kb() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1])
    raise AssertionError("/proc/meminfo has no MemAvailable")


def tdm_rss_worker(blob, queue, go, done) -> None:
    """A loader worker's view of a pickled sampler: once ``go`` is set,
    its memory (``proc_memory_kb``) before the unpickle and after ``init``
    and a read of every table page; it stays alive until ``done``, so
    that the parent can read the host's memory with every worker's
    mapping in place."""
    import pickle

    import torcheasyrec_tpu_torch.datasets.sampler  # noqa: F401 (its imports)

    queue.put("ready")
    go.wait()
    before = proc_memory_kb()
    sampler = pickle.loads(blob)
    sampler.init()
    touched = sum(float(np.asarray(a).sum()) for a in sampler._tables.values()
                  if a.dtype.kind in "iuf")
    after = proc_memory_kb()
    queue.put({"growth_kb": {k: after[k] - before[k] for k in after
                             if k != "private_source"},
               "private_source": after["private_source"],
               "shared": bool(sampler._shm_name), "touched": touched})
    done.wait()


def tdm_shared_table(tmp) -> dict:
    """``prepare_shared`` on a synthetic item table of TDM_SHM_ITEMS items
    (uniform weights; cut to fit half of /dev/shm's free space): the
    parent's build seconds and the segment's bytes; then
    TDM_SHM_WORKERS spawned workers that attach, against one that
    unpickles a private copy: each worker's own memory growth, and the
    host's (MemAvailable) while all the attached workers hold their
    mapping, then while the copy is made. Where a worker's counters
    separate shared from private memory, an attached worker's private
    growth must be under a quarter of the copy's; else the host's growth
    for the four attached workers must be under a quarter of the copy's."""
    import multiprocessing
    import pickle
    from queue import Empty

    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.datasets.sampler import NegativeSampler
    from torcheasyrec_tpu_torch.protos import sampler_pb2
    from torcheasyrec_tpu_torch.utils import shm_pack
    from google.protobuf import text_format

    st = os.statvfs("/dev/shm")
    shm = {"size_bytes": st.f_blocks * st.f_frsize,
           "free_bytes": st.f_bavail * st.f_frsize}
    per_item = 8 * 7 + 12  # six 8-byte arrays, the attr offsets and bytes
    n = int(min(TDM_SHM_ITEMS, shm["free_bytes"] / 2 / per_item))
    path = os.path.join(tmp, "shm_items.parquet")
    ids = np.arange(n, dtype=np.int64)
    attrs = pc.binary_join_element_wise(
        pa.array(ids).cast(pa.string()),
        pa.array(ids // 40).cast(pa.string()), ":")
    pq.write_table(pa.table({"id": ids, "weight": np.ones(n),
                             "attrs": attrs}), path)
    cfg = text_format.Parse(
        f'input_path: "{path}" num_sample: 32 attr_fields: "item_id" '
        'attr_fields: "item_cluster" item_id_field: "item_id"',
        sampler_pb2.NegativeSampler())
    shared = NegativeSampler(cfg)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    go_shared, go_copy, done = ctx.Event(), ctx.Event(), ctx.Event()
    procs = []

    def collect(n_items):
        got, deadline = [], time.perf_counter() + 300
        while len(got) < n_items:
            try:
                got.append(queue.get(timeout=5))
            except Empty:
                if (time.perf_counter() > deadline or any(
                        p.exitcode not in (None, 0) for p in procs)):
                    raise AssertionError(
                        f"memory workers: {len(got)} of {n_items} messages, "
                        f"exit codes {[p.exitcode for p in procs]}") from None
        return got

    try:
        t0 = time.perf_counter()
        shared.prepare_shared()
        build_s = time.perf_counter() - t0
        seg = shm_pack.segment_bytes(shared._shm_name)
        private = NegativeSampler(cfg)
        private.init()
        blobs = [pickle.dumps(shared)] * TDM_SHM_WORKERS + [
            pickle.dumps(private)]
        del private
        procs = [ctx.Process(target=tdm_rss_worker, args=(
            b, queue, go_shared if i < TDM_SHM_WORKERS else go_copy, done))
            for i, b in enumerate(blobs)]
        for p in procs:
            p.start()
        collect(len(procs))  # every worker started and imported
        host0 = mem_available_kb()
        go_shared.set()
        attached = collect(TDM_SHM_WORKERS)
        host1 = mem_available_kb()
        go_copy.set()
        copied = collect(1)
        host2 = mem_available_kb()
        done.set()
        for p in procs:
            p.join(timeout=60)
    finally:
        done.set()
        for p in procs:
            if p.is_alive():
                p.terminate()
        shared.close_shared()
    if not all(r["shared"] for r in attached) or copied[0]["shared"]:
        raise AssertionError(f"memory workers: {attached + copied}")
    own = [r["growth_kb"]["private"] * 1024 for r in attached]
    copy_own = copied[0]["growth_kb"]["private"] * 1024
    host_attached, host_copy = (host0 - host1) * 1024, (host1 - host2) * 1024
    # a worker's own memory grows by its start-up's few MB when it
    # attaches, by the table's size when it holds a private copy; where
    # its counters show no shared growth, they cannot tell the two apart
    g0 = attached[0]["growth_kb"]
    shared_seen = max(g0.get("RssShmem", 0), g0["statm_shared"],
                      g0.get("smaps_Shared_Clean", 0)
                      + g0.get("smaps_Shared_Dirty", 0)) * 1024
    if shared_seen >= 0.5 * seg and copy_own >= 0.5 * seg:
        check = "each attached worker's own growth < 1/4 of the copy's"
        ok = max(own) < 0.25 * copy_own
    elif host_copy >= 0.5 * seg:
        check = (f"the host's growth for the {TDM_SHM_WORKERS} attached "
                 "workers < 1/4 of the copy's")
        ok = host_attached < 0.25 * host_copy
    else:
        check, ok = "not measured", True
    if not ok:
        raise AssertionError(
            f"attached workers' memory: own {own}, host {host_attached}; "
            f"the private copy's: own {copy_own}, host {host_copy}; "
            f"segment {seg}")
    return {"dev_shm": shm, "items": n, "cut": n < TDM_SHM_ITEMS,
            "prepare_shared_s": build_s, "segment_bytes": seg,
            "pickled_shared_bytes": len(blobs[0]),
            "pickled_private_bytes": len(blobs[-1]),
            "private_memory_source": attached[0]["private_source"],
            "shared_growth_seen_bytes": shared_seen, "check": check,
            "host_mem_available_drop_bytes": {
                "attach_4_workers": host_attached, "private_copy": host_copy},
            "attached_workers_growth_kb": [r["growth_kb"] for r in attached],
            "private_copy_growth_kb": copied[0]["growth_kb"]}


def tdm_loader_batches(cfg, features, path, n, device) -> list:
    """The first ``n`` train batches of the thread loader (the sampler
    applied) on ``device``."""
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader

    cfg.data_config.num_workers = 0
    it = create_dataloader(cfg.data_config, features, path, mode="train",
                           device=device)()
    try:
        return [b for b, _ in itertools.islice(it, n)]
    finally:
        it.close()


def traced_row_writes(model_dir) -> int:
    """Kernel #3's launches in the train loop's profiler trace (steps 3-5
    of ``is_profiling``)."""
    with open(os.path.join(model_dir, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel"
               and "row_write_kernel" in e.get("name", ""))


def tdm_train(port_main, write_rows, text, src, paths, tmp, name,
              num_steps, init) -> dict:
    """``train_and_evaluate`` on the card from ``init`` (4 loader workers
    on the shared tables), with the row writes counted (once a step, by
    the wrapper and in the trace of steps 3-5)."""
    write_rows.launches = 0
    t0 = time.perf_counter()
    result = port_main.train_and_evaluate(
        write_text(src, text), fine_tune_checkpoint=init, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = write_rows.launches
    model_dir = os.path.join(tmp, name)
    traced = traced_row_writes(model_dir)
    if result["step"] != num_steps or launches != num_steps or traced != 3:
        raise AssertionError(f"{name}: {result['step']} steps, {launches} "
                             f"row writes, {traced} in the traced 3 steps")
    if not all(np.isfinite(v) for v in result.values()):
        raise AssertionError(f"{name}: not finite: {result}")
    return {"train_and_evaluate_s": seconds, "result": result,
            "row_write_launches": launches, "traced_row_writes_3_steps":
            traced}


def tdm_resident(port_main, cfg, features, train_path) -> dict:
    """The step on a resident sampled batch (median of ZOO_TIMED_STEPS
    after ZOO_WARMUP, a window, ZOO_PROFILED_STEPS profiled, peak memory),
    one step's row writes against the plain version, and the step fed by
    the loader's TDM_WORKERS workers (a window after LOADER_WARMUP)."""
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
    from torcheasyrec_tpu_torch.ops.row_write import write_rows

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model, _, _, state, step = build_trainer(cfg)
    batch = tdm_loader_batches(cfg, features, train_path, 1, "cuda")[0]
    rows = int(batch.labels["label"].shape[0])
    before = write_rows.launches
    losses, step_ms, window_ms = timed_steps(step, state, batch, ZOO_WARMUP,
                                             ZOO_TIMED_STEPS)

    def profiled_steps():
        for _ in range(ZOO_PROFILED_STEPS):
            step(state, batch)

    profile = profile_forward(profiled_steps)
    calls = write_targets(model, step, state, batch)
    check_step_writes("tdm", calls)
    driven = ZOO_WARMUP + 2 * ZOO_TIMED_STEPS + ZOO_PROFILED_STEPS + 1
    if write_rows.launches - before != driven or len(calls) != 1:
        raise AssertionError(f"tdm: {write_rows.launches - before} row "
                             f"writes in {driven} resident steps")
    if not np.isfinite(losses).all():
        raise AssertionError(f"tdm: timed losses not finite: {losses}")
    out = {"pairs": rows, "input_rows": TDM_BATCH,
           "step_ms_median": float(np.median(step_ms)),
           "step_ms_range": [min(step_ms), max(step_ms)],
           "window_step_ms": window_ms,
           "pairs_per_s": rows / window_ms * 1e3,
           "idle_share_profiled_steps": profile.get("device_idle_share"),
           "busy_ms_per_step": (profile["device_busy_ms"] / ZOO_PROFILED_STEPS
                                if "device_busy_ms" in profile else None),
           "step_profile": profile,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "row_write_at_step_targets": {
               "bit_equal": True, "targets": int(calls[0][1].shape[0]),
               "table_rows": int(calls[0][0].shape[0])}}

    cfg.data_config.num_workers = TDM_WORKERS
    dl = create_dataloader(cfg.data_config, features, train_path,
                           mode="train", device="cuda")
    it = dl()
    pairs = 0
    try:
        for i, (b, _) in enumerate(it):
            state, _ = step(state, b)
            if i == LOADER_WARMUP - 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            elif i >= LOADER_WARMUP:
                pairs += int(b.labels["label"].shape[0])
            if i == LOADER_WARMUP + TDM_LOADER_STEPS - 1:
                break
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        it.close()
    out["loader_fed"] = {"workers": TDM_WORKERS, "steps": TDM_LOADER_STEPS,
                         "step_ms": seconds * 1e3 / TDM_LOADER_STEPS,
                         "pairs_per_s": pairs / seconds}
    del model, state, step, batch
    torch.cuda.empty_cache()
    return out


def tdm_export(port_main, model_dir, tmp, tree) -> dict:
    """Export of the trained model: the node embeddings of every tree node
    from ``embedding/`` by ``predict`` in a process of its own, and from
    the loaded ``tower_fn.pt2`` on its serving batch, each bit-equal to
    the model's ``node_embedding``; ``model/``'s ``predict`` bit-equal to
    ``predict_checkpoint``. Seconds and bytes per artifact."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.utils import checkpoint_util
    from torcheasyrec_tpu_torch.utils.config_util import load_pipeline_config

    cfg_path = os.path.join(model_dir, "pipeline.config")
    export_dir = os.path.join(tmp, "tdm_export")
    res = timed_export(port_main, cfg_path, export_dir)
    emb_dir, whole = (os.path.join(export_dir, d)
                      for d in ("embedding", "model"))
    res["bytes"] = {"embedding": dir_bytes(emb_dir), "model": dir_bytes(whole)}
    res["program_bytes"] = {
        "embedding": os.path.getsize(os.path.join(emb_dir,
                                                  port_main.TOWER_PROGRAM)),
        "model": os.path.getsize(os.path.join(whole,
                                              port_main.PREDICT_PROGRAM))}

    node_ids = pq.read_table(os.path.join(tree, "node_table.parquet"))["id"]
    nodes = os.path.join(tmp, "tdm_nodes.parquet")
    pq.write_table(pa.table({"item_id": node_ids}), nodes)
    node_out = os.path.join(tmp, "tdm_node_emb.parquet")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", TDM_NODE_PREDICT, nodes, node_out, emb_dir],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError("the node predict failed:\n" + proc.stdout
                             + proc.stderr[-4000:])
    res["node_predict_process_s"] = time.perf_counter() - t0
    got = read_column(node_out, "item_emb")
    if not torch.equal(read_column(node_out, "item_id"),
                       torch.from_numpy(node_ids.to_numpy())):
        raise AssertionError("the node predict's item_id column")

    cfg = load_pipeline_config(cfg_path)
    model, features = port_main.build_model(cfg, "cuda")
    checkpoint_util.load_model_weights(
        checkpoint_util.latest_checkpoint(model_dir), model)
    node_features = [f for f in features if f.name == "item_id"]
    batch = DataParser(node_features, labels=[]).parse_to_batch(
        {"item_id": node_ids.combine_chunks()}).to("cuda")
    with torch.inference_mode():
        want = model.embedding_group.node_embedding(
            batch, torch.float32, model.seq_group).float().cpu()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"embedding artifact: {tuple(got.shape)} node "
                             "embeddings, not bit-equal to node_embedding")
    _, sbatch = port_main.serving_batch(cfg, node_features, "cuda")
    program = torch.export.load(os.path.join(
        emb_dir, port_main.TOWER_PROGRAM)).module()
    with torch.inference_mode():
        prog = program(*torch.utils._pytree.tree_flatten(sbatch)[0])
        ref = model.embedding_group.node_embedding(
            sbatch, torch.float32, model.seq_group)
    if not torch.equal(prog["item_emb"], ref):
        raise AssertionError("tower_fn.pt2 differs from node_embedding")
    res["nodes"] = {"rows": int(got.shape[0]), "dim": int(got.shape[1]),
                    "bit_equal_to_node_embedding": True,
                    "program_bit_equal_on_its_batch": True}
    del model, program

    pred_in = os.path.join(tmp, "tdm_predict_in.parquet")
    pq.write_table(pq.read_table(cfg.eval_input_path).slice(
        0, TDM_PREDICT_ROWS), pred_in)
    art_out, ckpt_out = (os.path.join(tmp, f"tdm_{k}.parquet")
                         for k in ("artifact_preds", "ckpt_preds"))
    t0 = time.perf_counter()
    n = port_main.predict(pred_in, art_out, whole, reserved_columns="item_id",
                          device="cuda")
    res["predict_s"] = time.perf_counter() - t0
    port_main.predict_checkpoint(cfg_path, pred_in, ckpt_out,
                                 reserved_columns="item_id", device="cuda")
    if n != TDM_PREDICT_ROWS:
        raise AssertionError(f"model/ predicted {n} rows")
    res["predict_bit_equal_to_predict_checkpoint"] = equal_columns(
        "tdm model/ predict", art_out, ckpt_out, ["item_id", "probs",
                                                  "logits"])
    res["emb_dir"] = emb_dir
    return res


def tdm_cluster(port_main, items, emb_dir, tmp) -> dict:
    """The leaf items' embeddings from the embedding artifact, then
    ``cluster_tree`` over them."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.tools.tdm.gen_tree import cluster_tree

    t0 = time.perf_counter()
    tbl = pq.read_table(items)
    leaf_in, leaf_out = (os.path.join(tmp, f"tdm_leaves_{k}.parquet")
                         for k in ("in", "out"))
    pq.write_table(pa.table({"item_id": tbl.column(0)}), leaf_in)
    port_main.predict(leaf_in, leaf_out, emb_dir, reserved_columns="item_id",
                      device="cuda")
    emb = pq.read_table(leaf_out)
    if not emb["item_id"].equals(tbl.column(0)):
        raise AssertionError("leaf embeddings out of order")
    with_emb = os.path.join(tmp, "tdm_items_emb.parquet")
    pq.write_table(tbl.append_column("embedding", emb["item_emb"]),
                   with_emb)
    tree = os.path.join(tmp, "tdm_tree_cluster")
    cluster_tree(with_emb, tree, branching=2)
    nodes = pq.read_table(os.path.join(tree, "node_table.parquet")).num_rows
    return {"tree": tree, "nodes": nodes, "seconds": time.perf_counter() - t0}


def tdm_retrieve(users, cfg_path) -> dict:
    """``tdm_retrieval`` (recall@TDM_RECALL_NUM) on the card and on the
    CPU from the same checkpoint: recall within TDM_CPU_BOUND, ms per
    user and per beam layer, the host's share."""
    from torcheasyrec_tpu_torch.tools.tdm.retrieval import tdm_retrieval

    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        r = tdm_retrieval(cfg_path, users, recall_num=TDM_RECALL_NUM,
                          n_cluster=TDM_N_CLUSTER, device=dev)
        seconds = time.perf_counter() - t0
        out[dev] = {"recall": r["recall"], "users": r["total"],
                    "seconds": seconds,
                    "ms_per_user": seconds * 1e3 / r["total"],
                    "layer_ms": [s * 1e3 for s in r["layer_s"]],
                    "layers": [r["first_layer"], r["max_level"]],
                    "host_s": r["host_s"], "device_s": r["device_s"],
                    "host_share": r["host_s"] / max(
                        r["host_s"] + r["device_s"], 1e-9)}
    dist = out["cuda"]["recall"] - out["cpu"]["recall"]
    out["card_minus_cpu"] = dist
    if not abs(dist) <= TDM_CPU_BOUND:
        raise AssertionError(f"recall@{TDM_RECALL_NUM} on the card "
                             f"{out['cuda']['recall']} is {dist:+.4f} from "
                             f"the CPU's (bound {TDM_CPU_BOUND})")
    return out


def phase_train_tdm(smi):
    """TDM end to end (``tdm_text``): the tree, the sampler's host cost and
    its shared table, 2 fp32 steps on the card against the CPU, an epoch
    cut to TDM_STEPS through ``train_and_evaluate`` with 4 loader workers
    against a CPU run from the same weights, the resident and loader-fed
    step, export and the artifacts' predict, ``cluster_tree`` over the
    exported leaf embeddings and TDM_RETRAIN_STEPS steps on the new tree,
    ``tdm_retrieval`` on each tree against the CPU. Returns kernel #3's
    launches of the two ``train_and_evaluate`` runs."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.utils import checkpoint_util
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    out, seconds = {"phase": "train_tdm", "nvidia_smi": smi}, {}

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        seconds[key] = time.perf_counter() - t0
        return res

    with tempfile.TemporaryDirectory() as tmp:
        paths = timed("data", criteo_synth_data, ZOO_TRAIN_ROWS,
                      ZOO_EVAL_ROWS)
        paths["tdm_eval"] = os.path.join(tmp, "tdm_eval.parquet")
        evals = pq.read_table(paths["eval"])
        pq.write_table(evals.slice(0, TDM_EVAL_ROWS), paths["tdm_eval"])
        users = os.path.join(tmp, "tdm_users.parquet")
        pq.write_table(evals.slice(0, TDM_RETRIEVAL_USERS), users)
        del evals
        tree = os.path.join(tmp, "tdm_tree")
        out["tree"] = timed("tree", tdm_tree, paths["items"], tree)
        emit({"phase": "train_tdm_tree", **out["tree"]})

        text = tdm_text(paths, tree, os.path.join(tmp, "tdm"))
        cfg = parse_pipeline_config(text)
        features = port_main._create_features(cfg)
        out["sampler"] = timed("sampler", tdm_sampler_host, cfg, features,
                               paths["train"])
        out["shared_table"] = timed("shared_table", tdm_shared_table, tmp)
        emit({"phase": "train_tdm_sampler", "sampler": out["sampler"],
              "shared_table": out["shared_table"]})

        check_text = tdm_text(paths, tree, os.path.join(tmp, "tdm_check"),
                              check=True)
        batches = tdm_loader_batches(parse_pipeline_config(check_text),
                                     features, paths["train"],
                                     ZOO_REST_CHECK_STEPS, "cpu")
        before = write_rows.launches
        out["card_vs_cpu"] = timed("card_vs_cpu", zoo_rest_card_vs_cpu,
                                   "tdm", check_text, None, batches)
        out["card_vs_cpu"]["pairs_per_batch"] = [
            int(b.labels["label"].shape[0]) for b in batches]
        out["card_vs_cpu"]["row_write_launches"] = (write_rows.launches
                                                    - before)
        del batches
        emit({"phase": "train_tdm_card_vs_cpu", **out["card_vs_cpu"]})

        src = os.path.join(tmp, "tdm.config")
        init = cpu_init(write_text(src, text),
                        os.path.join(tmp, "tdm_init.pt"))
        out["train"] = timed("train", tdm_train, port_main, write_rows, text,
                             src, paths, tmp, "tdm", TDM_STEPS, init)
        t0 = time.perf_counter()
        cpu = port_main.train_and_evaluate(
            write_text(os.path.join(tmp, "tdm_cpu.config"),
                       tdm_text(paths, tree, os.path.join(tmp, "tdm_cpu"))),
            fine_tune_checkpoint=init, device="cpu")
        seconds["train_cpu"] = time.perf_counter() - t0
        dist = out["train"]["result"]["auc"] - cpu["auc"]
        out["train"]["cpu_reference"] = {
            "auc": cpu["auc"], "card_minus_cpu": dist, "bound":
            TDM_CPU_BOUND, "steps": cpu["step"]}
        if not abs(dist) <= TDM_CPU_BOUND:
            raise AssertionError(
                f"tdm: auc {out['train']['result']['auc']} on the card is "
                f"{dist:+.4f} from {cpu['auc']} on the CPU")
        out["resident"] = timed("resident", tdm_resident, port_main, cfg,
                                features, paths["train"])
        emit({"phase": "train_tdm_train", "train": out["train"],
              "resident": out["resident"]})

        out["export"] = timed("export", tdm_export, port_main,
                              os.path.join(tmp, "tdm"), tmp, tree)
        out["cluster_tree"] = timed("cluster_tree", tdm_cluster, port_main,
                                    paths["items"], out["export"]["emb_dir"],
                                    tmp)
        tree2 = out["cluster_tree"]["tree"]
        # the trained weights alone: the new tree's run starts at step 0
        trained = os.path.join(tmp, "tdm_trained.pt")
        torch.save(torch.load(checkpoint_util.latest_checkpoint(
            os.path.join(tmp, "tdm")), weights_only=True)["model"], trained)
        out["retrain"] = timed(
            "retrain", tdm_train, port_main, write_rows,
            tdm_text(paths, tree2, os.path.join(tmp, "tdm_cluster"),
                     TDM_RETRAIN_STEPS),
            os.path.join(tmp, "tdm_cluster.config"), paths, tmp,
            "tdm_cluster", TDM_RETRAIN_STEPS, trained)
        emit({"phase": "train_tdm_export", "export": out["export"],
              "cluster_tree": out["cluster_tree"], "retrain": out["retrain"]})

        out["retrieval"] = {
            "init_tree": timed("retrieval_init_tree", tdm_retrieve, users,
                               os.path.join(tmp, "tdm", "pipeline.config")),
            "cluster_tree": timed(
                "retrieval_cluster_tree", tdm_retrieve, users,
                os.path.join(tmp, "tdm_cluster", "pipeline.config"))}
    launches = (out["train"]["row_write_launches"]
                + out["retrain"]["row_write_launches"])
    out["seconds"] = seconds
    out["row_write_launches"] = launches
    emit({"phase": "train_tdm", "seconds": seconds,
          "row_write_launches": launches,
          "retrieval": out["retrieval"],
          "summary": {
              "sampler_ms_per_batch": out["sampler"]["ms_per_batch_median"],
              "pairs_per_batch": out["sampler"]["pairs_per_batch"],
              "segment_bytes": out["shared_table"]["segment_bytes"],
              "card_vs_cpu_max_rel_err": out["card_vs_cpu"]["max_rel_err"],
              "auc": out["train"]["result"]["auc"],
              "auc_card_minus_cpu": out["train"]["cpu_reference"][
                  "card_minus_cpu"],
              "resident_step_ms": out["resident"]["step_ms_median"],
              "loader_fed_step_ms": out["resident"]["loader_fed"]["step_ms"],
              "pairs_per_s": out["resident"]["pairs_per_s"],
              "idle_share": out["resident"]["idle_share_profiled_steps"]}})
    return launches


# --- phase train_sharded: training over two ranks ---------------------------
SHARDED_WORLD = 2
SHARDED_STEPS = 3
SHARDED_TIMEOUT_S = 600  # each spawn's limit: a rank that hangs fails it
SHARDED_TIMED_STEPS = 6  # 10 before train_pipelined joined
SHARDED_PROFILE_STEPS = 3  # 5 before
SHARDED_UNTOUCHED = 2048  # untouched rows sampled a table
SHARDED_TRAP_TOL = 1e-4
SHARDED_LAYOUTS = ("row_wise", "column_wise", "table_wise", "table_row_wise",
                   "data_parallel")
SHARDED_DEVICE = "cuda"  # a rehearsal on the CPU sets "cpu"
SHARDED_BATCH = DEEPFM_BATCH  # the uncapped DeepFM's global batch
SHARDED_BUCKETS = CRITEO_RAW
SHARDED_SYNTH_BATCH = 4096  # criteo_synth's global batch
SHARDED_TRAIN_FILES = 4  # criteo_synth's train file split, a rank's share


def sharded_backend() -> tuple:
    """(what the two-rank parts run on, their backend): one card a rank
    on NCCL where the machine has two cards or more, else both ranks on
    the one card through gloo."""
    if SHARDED_DEVICE == "cuda" and torch.cuda.device_count() >= 2:
        return "nccl, one card a rank", "nccl"
    return "gloo, two ranks on one card", "gloo"


def run_ranks(fn, world, args, backend, tmp):
    from torcheasyrec_tpu_torch.utils import dist_util

    return dist_util.spawn_ranks(fn, world, args, store_dir=tmp,
                                 device=SHARDED_DEVICE, backend=backend,
                                 timeout_s=SHARDED_TIMEOUT_S)


def rank_rows(cols: dict, shard, n_global: int, shared_tail: int = 0):
    """This rank's rows of global columns: row block ``rank`` of ``world``;
    a column of ``n_global + shared_tail`` rows (a sampler's item side)
    keeps its tail, the negatives every rank shares."""
    if shard is None:
        return cols
    import pyarrow as pa

    per = n_global // shard.world
    lo = shard.rank * per
    out = {}
    for k, v in cols.items():
        part = v.slice(lo, per)
        if shared_tail and len(v) == n_global + shared_tail:
            part = pa.concat_arrays([part, v.slice(n_global, shared_tail)])
        out[k] = part
    return out


def sharded_trainer(cfg_text, shard=None, plan=None):
    """``build_trainer`` of a config text on SHARDED_DEVICE, over the
    ranks of ``shard`` where there is one."""
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    kw = {} if shard is None else {"shard": shard, "plan": plan}
    return build_trainer(parse_pipeline_config(cfg_text), device=SHARDED_DEVICE,
                         **kw)


def parse_batch(features, cols, labels):
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser

    return DataParser(features, labels=labels).parse_to_batch(cols).to(
        SHARDED_DEVICE)


def digest(tensors) -> str:
    """A hash of the tensors' bits, for "equal on every rank"."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def dense_digest(model) -> str:
    return digest([p for _, p in sorted(model.named_parameters())]
                  + [b for n, b in sorted(model.named_buffers())
                     if not n.startswith("embedding_group.group_")])


def touched_ids(cols_list, buckets) -> dict:
    """{table: the rows the batches look up, ascending} of the DeepFM
    lane (each cat feature reads its table and its WIDE table)."""
    out = {}
    for i in range(len(buckets)):
        ids = np.unique(np.concatenate(
            [c[f"cat_{i}"].to_numpy() for c in cols_list]))
        out[f"cat_{i}_emb"] = out[f"cat_{i}_emb__wide"] = ids
    return out


def untouched_ids(touched, buckets, seed=SEED) -> dict:
    """{table: up to SHARDED_UNTOUCHED rows no batch looks up}."""
    r = np.random.default_rng(seed)
    out = {}
    for i, n in enumerate(buckets):
        cand = r.integers(0, n, min(n, 4 * SHARDED_UNTOUCHED))
        cand = np.setdiff1d(cand, touched[f"cat_{i}_emb"])[:SHARDED_UNTOUCHED]
        out[f"cat_{i}_emb"] = out[f"cat_{i}_emb__wide"] = cand
    return out


def read_table_rows(model, ids: dict) -> dict:
    """{table: its rows ``ids[table]`` on the host} (collective over the
    ranks of a sharded model)."""
    eg = model.embedding_group
    fused = eg.engine_tables()
    return {t: eg.engine.read_rows(fused, t, torch.from_numpy(v)).cpu()
            for t, v in ids.items()}


def compact_write_capture():
    """(start, stop, calls): between start() and stop() every
    ``write_rows`` call is recorded compactly: the distinct targets in
    the table, their rows before and after the call, the targets and the
    rows written (a whole-table copy of an uncapped table would not fit
    twice)."""
    from torcheasyrec_tpu_torch.ops import row_write

    calls, real = [], row_write.write_rows

    def capture(table, ids, rows):
        ok = ids[(ids >= 0) & (ids < table.shape[0])]
        uniq = torch.unique(ok)
        before = table[uniq].clone()
        real(table, ids, rows)
        calls.append((uniq, ids.clone(), rows.clone(), before,
                       table[uniq].clone(), table.shape[0]))
        return table

    def start():
        capture.launches = real.launches
        row_write.write_rows = capture

    def stop():
        row_write.write_rows = real
        real.launches = capture.launches

    return start, stop, calls


def check_compact_writes(calls) -> int:
    """The kernel against the plain version on each captured call's
    targets and rows, over a table of just the rows it wrote (targets
    renumbered; those past the table's end stay past it): bit for bit,
    and equal to what the step left in the real table. Returns the
    targets checked; these launches do not count."""
    from torcheasyrec_tpu_torch.ops.row_write import (
        _torch_write_rows,
        write_rows,
    )

    kept, n = write_rows.launches, 0
    for uniq, ids, rows, before, after, p in calls:
        local = torch.searchsorted(uniq, ids.clamp(max=p - 1))
        local = torch.where((ids >= 0) & (ids < p), local,
                            local.new_full((), uniq.shape[0]))
        a, b = before.clone(), before.clone()
        write_rows(a, local, rows)
        _torch_write_rows(b, local, rows)
        if not (torch.equal(a, b) and torch.equal(a, after)):
            raise AssertionError(
                "the row write and its plain version disagree at a sharded "
                "step's captured targets")
        n += int(ids.shape[0])
    write_rows.launches = kept
    return n


def packed_written_groups(model) -> int:
    """The packed groups whose rows this rank holds: one row write each a
    step (every rank receives ids of every such group at this batch)."""
    return sum(1 for g in model.embedding_group.engine.groups.values()
               if g.packed)


def read_state_rows(model, state, ids: dict) -> dict:
    """{table.state: its row state at rows ``ids[table]`` on the host}
    (collective over the ranks of a sharded model)."""
    eg = model.embedding_group
    fused = eg.engine_tables()
    return {f"{t}.{k}": v.cpu() for t, r in ids.items() for k, v in
            eg.engine.read_row_state(fused, state["sparse_opt"], t,
                                     torch.from_numpy(r)).items()}


def dense_values(model, tx) -> dict:
    """{name: value} of the dense parameters and of the dense optimizer's
    state (adam's moments move with the gradient's scale, which adam's
    first step and rowwise adagrad's do not)."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {n: p.detach().float().cpu().clone()
           for n, p in model.named_parameters()}
    for p, st in zip(tx.params, tx.state):
        out.update({f"{names[id(p)]}.{k}": v.detach().cpu().clone()
                    for k, v in st.items()})
    return out


def deepfm_world1_run(cfg_text, cols_list, touched, untouched,
                      permute: bool = False) -> dict:
    """The uncapped DeepFM on one rank, its products over the ranks' row
    blocks (``row_blocks``) under PyTorch's deterministic algorithms:
    the touched rows and their row state after step 1 and step 3, the
    dense parameters and optimizer state after step 1, the untouched
    sample before and after. With ``permute`` each batch's rows are
    permuted within those blocks first (``permuted``): the same steps
    with every sum over the batch taken in another order."""
    model, features, tx, state, step = sharded_trainer(cfg_text)
    out = {"untouched_init": read_table_rows(model, untouched)}
    for i, cols in enumerate(cols_list):
        if permute:
            cols = permuted(cols, SHARDED_BATCH, SEED + i, SHARDED_WORLD)
        with deterministic(), row_blocks(SHARDED_WORLD):
            state, _ = step(state, parse_batch(features, cols, ["label"]))
        if i == 0:
            out["after_1"] = read_table_rows(model, touched)
            out["state_1"] = read_state_rows(model, state, touched)
            out["dense_1"] = dense_values(model, tx)
    out["after_3"] = read_table_rows(model, touched)
    out["state_3"] = read_state_rows(model, state, touched)
    out["untouched_after"] = read_table_rows(model, untouched)
    del model, state, step, tx
    if SHARDED_DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def deepfm_sharded_rank(shard, cfg_text, cols_list, touched, untouched):
    """Rank side of the uncapped DeepFM at world size 2: the planner's
    plan, 3 steps on this rank's halves of the global batches (kernel #3
    counted from 0), the rows compared by the parent, the dense
    parameters' digest; then one step's row writes captured and held
    against the plain version, and the step timed and profiled."""
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.parallel import planner

    t0 = time.perf_counter()
    model, features, tx, state, step = sharded_trainer(cfg_text, shard)
    sync()
    out = {"rank": shard.rank, "init_s": time.perf_counter() - t0,
           "plan": model.sharding_plan, "backend": shard.backend}
    specs = model.embedding_group.table_specs()
    hbm = None
    if SHARDED_DEVICE == "cuda" and torch.cuda.device_count() < shard.world:
        hbm = torch.cuda.get_device_properties(
            shard.device).total_memory / shard.world
    out["plan_est_ms"] = planner.plan_cost(  # the model's own inputs
        specs, n_devices=shard.world, batch_size=SHARDED_BATCH // shard.world,
        optimizer_kind="rowwise_adagrad", shards_per_host=shard.world,
        host_excluded={s.name for s in specs}, hbm_budget=hbm)[1] * 1e3
    out["plan_hbm_budget_gb"] = None if hbm is None else hbm / 1e9
    if hbm is not None and "row_wise" not in set(
            model.sharding_plan.values()):
        # at half a card a rank cannot hold every table whole
        raise AssertionError(f"the plan shards no table: "
                             f"{model.sharding_plan}")
    out["groups"] = {gk: {"sharding": g.sharding, "packed": g.packed,
                          "local_rows": g.local_rows,
                          "local_gb": (g.p_rows * 512 if g.packed else
                                       g.local_rows * g.local_dim * 4) / 1e9}
                     for gk, g in model.embedding_group.engine.groups.items()}
    rows = {"untouched_init": read_table_rows(model, untouched)}
    batches = [parse_batch(features, rank_rows(c, shard, SHARDED_BATCH),
                           ["label"]) for c in cols_list]
    sync()
    write_rows.launches = 0
    for i, b in enumerate(batches):
        with deterministic():  # as the one-rank run (its sums in order)
            state, _ = step(state, b)
        if i == 0:
            rows["after_1"] = read_table_rows(model, touched)
            rows["state_1"] = read_state_rows(model, state, touched)
            rows["dense_1"] = dense_values(model, tx)
    sync()
    out["row_write_launches"] = write_rows.launches
    want = SHARDED_STEPS * packed_written_groups(model)
    if out["row_write_launches"] != want:
        raise AssertionError(
            f"rank {shard.rank}: {out['row_write_launches']} row writes in "
            f"{SHARDED_STEPS} steps, {want} expected")
    rows["after_3"] = read_table_rows(model, touched)
    rows["state_3"] = read_state_rows(model, state, touched)
    rows["untouched_after"] = read_table_rows(model, untouched)
    out["dense_digest"] = dense_digest(model)
    # one more step, its row writes captured (not counted)
    start, stop, calls = compact_write_capture()
    start()
    try:
        state, _ = step(state, batches[0])
    finally:
        stop()
    out["captured_targets_checked"] = check_compact_writes(calls)
    out["captured_writes"] = len(calls)
    del calls
    # the step, timed and profiled (not counted)
    kept = write_rows.launches
    if SHARDED_DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats(shard.device)
    before = shard.sent_bytes
    state, _ = step(state, batches[0])
    sync()
    out["exchange_bytes_per_step"] = shard.sent_bytes - before
    losses, step_ms, window_ms = timed_steps(
        step, state, batches[0], 2, SHARDED_TIMED_STEPS)
    out["step_ms_median"] = float(np.median(step_ms))
    out["window_ms_per_step"] = window_ms
    out["examples_per_s_global"] = SHARDED_BATCH / (window_ms / 1e3)
    if SHARDED_DEVICE == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(shard.device) / 1e9

        def steps():
            for _ in range(SHARDED_PROFILE_STEPS):
                step(state, batches[0])
        out["profile_steps"] = profile_forward(steps)
    write_rows.launches = kept
    out["losses_finite"] = bool(np.isfinite(losses).all())
    return out, (rows if shard.rank == 0 else None)


def max_rel_err(got: dict, ref: dict) -> dict:
    """{table: max |got - ref| / max |ref|}."""
    return {t: float((got[t].float() - ref[t].float()).abs().max())
            / max(float(ref[t].float().abs().max()), 1e-30)
            for t in ref if ref[t].numel()}


def rel_report(got: dict, ref: dict) -> dict:
    """The distance of two {name: tensor} dicts: the largest |got - ref|
    relative to each tensor's largest |ref|, its name, and the share of
    all elements farther apart than LAYOUT_TOL of their tensor's max."""
    worst, where, beyond, total = 0.0, None, 0, 0
    for t, r in ref.items():
        if not r.numel():
            continue
        diff = (got[t].float() - r.float()).abs()
        scale = max(float(r.float().abs().max()), 1e-30)
        err = float(diff.max()) / scale
        if err > worst:
            worst, where = err, t
        beyond += int((diff > LAYOUT_TOL * scale).sum())
        total += diff.numel()
    return {"max_err": worst, "table": where,
            "share_beyond_1e-5": beyond / max(total, 1)}


def sharded_deepfm(tmp, backend) -> dict:
    """Part 2: the uncapped Criteo DeepFM at world size 2 against world
    size 1 on the same global batches (the config's batch_size is a
    rank's, the planner's input). The world-1 reference forms its
    products over the ranks' row blocks, as parts 3 and 5 do, so that
    BF16 rounds each row's products as a rank does: after step 1 the
    touched rows, their row state, the dense parameters and the dense
    optimizer's state within 1e-5 of each tensor's max (the row state
    and adam's moments carry the gradient's scale); after step 3 the
    rows and row state within 3x the distance of a second world-1 run on
    the rows permuted within the blocks (floored at 1e-5). Returns the
    report, its ``failures`` listed."""
    text = deepfm_config_text(SHARDED_BUCKETS)
    rank_text = text.replace(f"batch_size: {DEEPFM_BATCH}",
                             f"batch_size: {SHARDED_BATCH // SHARDED_WORLD}")
    cols_list = [criteo_cols(SHARDED_BUCKETS, 100 + i, SHARDED_BATCH)
                 for i in range(SHARDED_STEPS)]
    touched = touched_ids(cols_list, SHARDED_BUCKETS)
    untouched = untouched_ids(touched, SHARDED_BUCKETS)
    t0 = time.perf_counter()
    ref = deepfm_world1_run(text, cols_list, touched, untouched)
    again = deepfm_world1_run(text, cols_list, touched, untouched,
                              permute=True)
    out = {"world_1_two_runs_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ranks = run_ranks(deepfm_sharded_rank, SHARDED_WORLD,
                      (rank_text, cols_list, touched, untouched), backend,
                      tmp)
    out["world_2_s"] = time.perf_counter() - t0
    rows = ranks[0][1]
    failures = []
    for k in ("after_1", "state_1", "dense_1", "after_3", "state_3"):
        got = rel_report(rows[k], ref[k])
        noise = rel_report(again[k], ref[k])
        bound = LAYOUT_TOL if k.endswith("_1") else max(
            3.0 * noise["max_err"], LAYOUT_TOL)
        out[k] = {"world_2_vs_1": got, "permuted_rows_vs_1": noise,
                  "bound": bound}
        if not got["max_err"] <= bound:
            failures.append(f"world 2 vs 1 {k}: {got}, bound {bound}")
    for t in untouched:
        for who, r in (("world 2", rows), ("world 1", ref)):
            if not torch.equal(r["untouched_after"][t],
                               r["untouched_init"][t]):
                failures.append(f"{who} {t}: an untouched row moved")
        if not torch.equal(rows["untouched_init"][t],
                           ref["untouched_init"][t]):
            failures.append(f"{t}: the sharded init differs from world "
                            "size 1's")
    out["untouched_rows_checked"] = sum(len(v) for v in untouched.values())
    if len({r[0]["dense_digest"] for r in ranks}) != 1:
        failures.append("the dense parameters differ across ranks")
    out["ranks"] = [r[0] for r in ranks]
    out["row_write_launches"] = sum(r[0]["row_write_launches"] for r in ranks)
    out["failures"] = failures
    return out


class deterministic:
    """PyTorch's deterministic algorithms inside the block (the card's
    atomic sums, whose order changes from run to run, replaced by ordered
    ones), so that each run of parts 3 and 5 is the same numbers every
    time; ops without a deterministic version run as they are (their
    warnings are not printed)."""

    def __enter__(self):
        import warnings

        self._was = torch.are_deterministic_algorithms_enabled()
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("ignore", UserWarning)
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(self._was)
        self._warnings.__exit__(*exc)
        return False


class row_blocks:
    """Inside the block every ``linear_apply`` of the port forms its
    product over ``n`` row blocks of its input, one product a block,
    concatenated (an input whose rows do not split in ``n`` as it is):
    a one-rank run then rounds each row's products as a run at world size
    ``n`` does, whose ranks hold those row blocks (cuBLAS picks its kernel
    by the shape, so a row's sums round differently at another row
    count, and a ReLU near its kink can flip on that rounding)."""

    def __init__(self, n: int) -> None:
        self.n = n

    def __enter__(self):
        from torcheasyrec_tpu_torch.modules import module

        real, n = module.linear_apply, self.n

        def blocked(layer, x, compute_dtype):
            if x.shape[0] < n or x.shape[0] % n:
                return real(layer, x, compute_dtype)
            return torch.cat([real(layer, part, compute_dtype)
                              for part in x.chunk(n)])

        self._real = real
        self._patched = [m for name, m in list(sys.modules.items())
                         if name.startswith("torcheasyrec_tpu_torch")
                         and getattr(m, "linear_apply", None) is real]
        for m in self._patched:
            m.linear_apply = blocked
        return self

    def __exit__(self, *exc):
        for m in self._patched:
            m.linear_apply = self._real
        return False


def permuted(cols: dict, n_global: int, seed: int, blocks: int = 1) -> dict:
    """The batch's rows in another order within each of ``blocks`` row
    blocks (the same permutation in every column of ``n_global`` rows; a
    sampler's shared tail stays put): the same steps with every sum over
    the batch taken in another order, each block's rows kept in it."""
    import pyarrow as pa

    r = np.random.default_rng(seed)
    per = n_global // blocks
    perm = pa.array(np.concatenate([b * per + r.permutation(per)
                                    for b in range(blocks)]))
    out = {}
    for k, v in cols.items():
        head = v.slice(0, n_global).take(perm)
        out[k] = (head if len(v) == n_global else
                  pa.concat_arrays([head, v.slice(n_global)]))
    return out


def synth_world1(texts: dict, batches_cols: dict, labels: dict,
                 n_global=None, blocks: int = 1) -> dict:
    """{name: the state_dict and sparse state after the global batches on
    one rank}, on the host, the products over ``blocks`` row blocks
    (``row_blocks``); with ``n_global`` ({name: rows}) each batch's rows
    are permuted within those blocks first (``permuted``)."""
    out = {}
    for name, text in texts.items():
        model, features, _, state, step = sharded_trainer(text)
        for i, cols in enumerate(batches_cols[name]):
            if n_global is not None:
                cols = permuted(cols, n_global[name], SEED + i, blocks)
            with deterministic(), row_blocks(blocks):
                state, _ = step(state, parse_batch(features, cols,
                                                   labels[name]))
        out[name] = {
            "model": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()},
            "sparse": {t: {k: v.cpu() for k, v in st.items()} for t, st in
                       model.embedding_group.opt_state_dict(
                           state["sparse_opt"]).items()}}
        del model, state, step
    return out


def state_errs(model, state, ref) -> dict:
    """{tensor: max |port - ref| / max |ref|} of a state_dict and the
    sparse state per table (collective: tables are gathered)."""
    sd = model.state_dict()
    errs = {k: float((sd[k].float().cpu() - v.float()).abs().max())
            / max(float(v.float().abs().max()), 1e-30)
            for k, v in ref["model"].items() if v.numel()}
    sparse = model.embedding_group.opt_state_dict(state["sparse_opt"])
    for t, st in ref["sparse"].items():
        for k, v in st.items():
            if v.dim() == 0:
                continue
            got = sparse[t][k].float().cpu().reshape(v.shape)
            errs[f"{t}.{k}"] = float((got - v.float()).abs().max()) / max(
                float(v.float().abs().max()), 1e-30)
    return errs


def bn_one_step(text, cols, labels, shard=None,
                local_stats: bool = False) -> dict:
    """One train-mode forward and backward of the DeepFM with MLP batch
    norm, no update (``train_mode_outputs``): {name: tensor} of the loss,
    every batch norm's batch mean and variance (momentum 1, so the
    running statistics are the batch's) and the dense gradients. At one
    rank the products take the ranks' row blocks (``row_blocks``); over
    ranks the loss and the gradients are averaged as the train step
    averages them. ``local_stats`` detaches the batch norms from the
    ranks, each then normalising by its own rows' statistics: the fault
    the comparison must catch."""
    from torcheasyrec_tpu_torch.modules.module import BatchNorm

    model, features, _, _, _ = sharded_trainer(text, shard)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 1.0
            if local_stats:
                m.shard = None
    batch = parse_batch(features, cols, labels)
    blocks = (row_blocks(SHARDED_WORLD) if shard is None
              else contextlib.nullcontext())
    with deterministic(), blocks:
        loss, _, grads = train_mode_outputs(model, batch)
    out = {"loss": loss.reshape(1)}
    out.update({f"grad.{n}": g for n, g in sorted(grads.items())})
    if shard is not None:
        out = {k: shard.all_reduce(v.float().contiguous()) / shard.world
               for k, v in out.items()}
    for n, m in model.named_modules():
        if isinstance(m, BatchNorm):
            out[f"{n}.batch_mean"] = m.mean
            out[f"{n}.batch_var"] = m.var
    out = {k: v.detach().float().cpu().clone() for k, v in out.items()}
    del model, features, batch
    return out


def synth_rank(shard, texts, batches_cols, labels, ref_path, n_global,
               shared_tail, plans, entry):
    """Rank side of parts 3-5 at world size 2: batch norm's one step
    (``bn_one_step``) with the ranks' statistics and with each rank's
    own; each config 3 steps on this rank's rows (its held against the
    one-rank run in ``ref_path`` by rank 0, replicated tables and dense
    parameters by digest on every rank; kernels #1, #2 and #3 counted),
    then the entry points (``train_and_evaluate`` over the rank's files,
    ``evaluate``)."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.ops import hstu
    from torcheasyrec_tpu_torch.ops.row_write import write_rows

    ref = torch.load(ref_path, weights_only=True) if shard.rank == 0 else None
    out = {"models": {}}
    # batch norm's one step, with the statistics over the ranks and (the
    # fault) over each rank's own rows
    bn_cols = rank_rows(batches_cols["deepfm_bn"][0], shard,
                        n_global["deepfm_bn"])
    out["bn_one_step"] = {
        which: bn_one_step(texts["deepfm_bn"], bn_cols, labels["deepfm_bn"],
                           shard, local_stats=which == "local")
        for which in ("global", "local")}
    hstu.hstu_attention_fwd.launches = hstu.hstu_attention_bwd.launches = 0
    write_rows.launches = 0
    for name, text in texts.items():
        model, features, _, state, step = sharded_trainer(
            text, shard, plans.get(name))
        for cols in batches_cols[name]:
            with deterministic():
                state, _ = step(state, parse_batch(
                    features, rank_rows(cols, shard, n_global[name],
                                        shared_tail.get(name, 0)),
                    labels[name]))
        sync()
        eng = model.embedding_group.engine
        fused = model.embedding_group.engine_tables()
        replicated = digest(
            [fused[gk] for gk, g in eng.groups.items()
             if g.sharding == "data_parallel"]
            + [v for gk, g in eng.groups.items()
               if g.sharding == "data_parallel"
               for v in state["sparse_opt"][gk].values()])
        # every rank takes part in gathering the tables
        errs = state_errs(model, state, ref[name] if ref else
                          {"model": {}, "sparse": {}})
        out["models"][name] = {
            "groups": {gk: g.sharding for gk, g in eng.groups.items()},
            "dense_digest": dense_digest(model),
            "replicated_digest": replicated,
            "max_err": max(errs.values()) if errs else None,
            "worst": max(errs, key=errs.get) if errs else None,
            "top": sorted(errs.items(), key=lambda kv: -kv[1])[:6]}
        del model, state, step
    out["hstu_launches"] = (hstu.hstu_attention_fwd.launches,
                            hstu.hstu_attention_bwd.launches)
    out["row_write_launches"] = write_rows.launches
    cfg_path, edits = entry
    t0 = time.perf_counter()
    out["train"] = port_main.train_and_evaluate(
        cfg_path, edit_config_json=edits, device=SHARDED_DEVICE, shard=shard)
    out["train_s"] = time.perf_counter() - t0
    out["evaluate"] = port_main.evaluate(cfg_path, device=SHARDED_DEVICE,
                                         shard=shard)
    out["row_write_launches"] = write_rows.launches  # the entry points too
    return out


def synth_texts(paths) -> tuple:
    """({name: config text}, {name: label fields}) of parts 3 and 5: the
    criteo_synth DeepFM in fp32 under each layout (forced by
    ``embedding_constraints``) and with MLP batch norm, DSSM with sampled
    negatives and with in-batch ones (no sampler), hstu_synth's
    DLRM-HSTU."""
    src = os.path.join(zoo_config_dir(), "criteo_synth", "deepfm.config")
    # adam's and rowwise adagrad's eps 1e-4: both normalise a gradient,
    # and at their default eps a gradient at rounding level (two runs of
    # the card's atomic sums, or another GEMM shape at another world
    # size) takes a full step of either sign (ROADMAP section 3)
    with open(src) as f:
        deepfm = f.read().replace(
            'mixed_precision: "BF16"', 'mixed_precision: ""').replace(
            "rowwise_adagrad_optimizer { lr: 0.01 }",
            "rowwise_adagrad_optimizer { lr: 0.01 eps: 1e-4 }").replace(
            "adam_optimizer { lr: 0.001 }",
            "adam_optimizer { lr: 0.001 eps: 1e-4 }")
    if deepfm.count("eps: 1e-4") != 2:
        raise AssertionError("criteo_synth deepfm's optimizers moved")
    texts = {}
    for layout in SHARDED_LAYOUTS:
        if layout == "table_row_wise":
            # on one host the planner offers no table_row_wise (the JAX
            # planner neither) and a constraint naming it alone raises:
            # the plan forces it (``synth_plans``), and the engine lays it
            # out row_wise, as the JAX engine does
            texts[f"deepfm_{layout}"] = deepfm
            continue
        texts[f"deepfm_{layout}"] = deepfm.replace(
            "embedding_dim: 16 }",
            f'embedding_dim: 16 embedding_constraints {{ sharding_types: '
            f'"{layout}" }} }}')
    texts["deepfm_bn"] = deepfm.replace(
        "deep { hidden_units: [512, 256, 128] }",
        "deep { hidden_units: [512, 256, 128] use_bn: true }")
    with open(os.path.join(zoo_config_dir(), "criteo_synth",
                           "dssm.config")) as f:
        dssm = f.read().replace(
            "criteo_synth_data/criteo_synth_items.parquet",
            paths["items"]).replace(
            "adam_optimizer { lr: 0.001 }",
            "adam_optimizer { lr: 0.001 eps: 1e-4 }").replace(
            "adagrad_optimizer { lr: 0.05 }",
            "adagrad_optimizer { lr: 0.05 eps: 1e-4 }")
    texts["dssm_sampled"] = dssm
    start = dssm.index("  negative_sampler {")
    end = dssm.index("}", start) + 1
    texts["dssm_in_batch"] = (dssm[:start] + dssm[end:]).replace(
        "dssm {", "dssm {\n    in_batch_negative: true", 1)
    with open(os.path.join(zoo_config_dir(), "hstu_synth",
                           "dlrm_hstu.config")) as f:
        # no dropout: its masks are drawn per rank over the rank's rows
        texts["dlrm_hstu"] = f.read().replace(
            "    hstu {\n      stu {",
            "    hstu {\n      input_dropout_ratio: 0.0\n      stu {", 1).replace(
            "adam_optimizer { lr: 0.002 }",
            "adam_optimizer { lr: 0.002 eps: 1e-4 }").replace(
            # rowwise adagrad's first step is lr * g / |g|: a row whose
            # gradient is at rounding level takes a full step of either
            # sign at the default eps (1e-10)
            "rowwise_adagrad_optimizer { lr: 0.05 }",
            "rowwise_adagrad_optimizer { lr: 0.05 eps: 1e-4 }")
    if "input_dropout_ratio: 0.0" not in texts["dlrm_hstu"]:
        raise AssertionError("the hstu_synth config's hstu block moved")
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    labels = {n: list(parse_pipeline_config(t).data_config.label_fields)
              for n, t in texts.items()}
    return texts, labels


def synth_plans(ref: dict) -> dict:
    """{name: a plan to build with} of the configs whose layout a plan
    forces: table_row_wise for every table."""
    return {"deepfm_table_row_wise": {
        t: "table_row_wise" for t in ref["deepfm_table_row_wise"]["sparse"]}}


def synth_batches(texts, labels, paths, hstu_paths) -> tuple:
    """({name: 3 global batches' columns}, {name: global rows},
    {name: rows every rank shares at the end of an item column})."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.dataset import create_sampler
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    def take(path, n, i):
        t = pq.read_table(path).slice(i * n, n)
        return {c: t[c].combine_chunks() for c in t.column_names}

    cols, n_global, tail = {}, {}, {}
    for name, text in texts.items():
        if name == "dlrm_hstu":
            cfg = parse_pipeline_config(text)
            n = int(cfg.data_config.batch_size)
            cols[name] = [take(hstu_paths["train"], n, i)
                          for i in range(SHARDED_STEPS)]
        else:
            n = SHARDED_SYNTH_BATCH
            cols[name] = [take(paths["train"], n, i)
                          for i in range(SHARDED_STEPS)]
        n_global[name] = n
        if name == "dssm_sampled":
            cfg = parse_pipeline_config(text)
            features = port_main._create_features(cfg)
            sampler = create_sampler(cfg.data_config, "train", features)
            sampler.init()
            cols[name] = [sampler.process(c) for c in cols[name]]
            tail[name] = int(cfg.data_config.negative_sampler.num_sample)
    return cols, n_global, tail


def split_file(path, n_files, root, name) -> str:
    """A parquet file as ``n_files`` files, comma-joined: each rank reads
    whole files of its own."""
    import pyarrow.parquet as pq

    t = pq.read_table(path)
    per = -(-t.num_rows // n_files)
    out = []
    for i in range(n_files):
        p = os.path.join(root, f"{name}_part_{i}.parquet")
        pq.write_table(t.slice(i * per, per), p)
        out.append(p)
    return ",".join(out)


def one_nccl_rank(shard, text, cols_list):
    """Part 1 on one NCCL rank: the criteo_synth DeepFM with every table
    ``row_wise``, 3 steps; every table, gathered."""
    model, features, _, state, step = sharded_trainer(text, shard)
    for cols in cols_list:
        state, _ = step(state, parse_batch(features, cols, ["label"]))
    eng = model.embedding_group.engine
    fused = model.embedding_group.engine_tables()
    if {g.sharding for g in eng.groups.values()} != {"row_wise"}:
        raise AssertionError("part 1: not every group is row_wise")
    return {t: eng.extract_table(fused, t).cpu() for t in eng._specs}, \
        shard.backend


def sync() -> None:
    if SHARDED_DEVICE == "cuda":
        torch.cuda.synchronize()


def ref_distance(a: dict, b: dict) -> float:
    """The largest distance, relative to the tensor's max, between two
    one-rank runs of ``synth_world1`` (one config): the noise of two runs
    of the same steps."""
    worst = 0.0
    pairs = [(a["model"][k], b["model"][k]) for k in b["model"]]
    pairs += [(a["sparse"][t][k], v) for t, st in b["sparse"].items()
              for k, v in st.items() if v.dim()]
    for x, y in pairs:
        if y.numel():
            worst = max(worst, float((x.float() - y.float()).abs().max())
                        / max(float(y.float().abs().max()), 1e-30))
    return worst


# the world-size-2 criteo_synth DeepFM epoch's AUC, printed by train_zch
SHARDED_AUC = {}


def phase_train_sharded(smi):
    """Training over ranks (``torch.distributed``, ranks spawned with a
    ``FileStore``; docstring item 14). Returns the launches of kernel #3
    and of kernels #1/#2 on the ranks' main paths. Every check's result
    is printed before a failure raises."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.benchmark import synthetic
    from torcheasyrec_tpu_torch.utils import checkpoint_util, config_util

    mode, backend = sharded_backend()
    out = {"phase": "train_sharded", "ranks_on": mode,
           "cards": torch.cuda.device_count() if SHARDED_DEVICE == "cuda"
           else 0, "card": smi}
    seconds, failures = {}, []
    with open(os.path.join(zoo_config_dir(), "base_eval_metric.json")) as f:
        pinned = json.load(f)["torcheasyrec_tpu_torch/benchmark/configs/"
                              "criteo_synth/deepfm.config"]["metrics"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = criteo_synth_data(ZOO_TRAIN_ROWS, ZOO_EVAL_ROWS)
        hstu_paths = synthetic.ensure_hstu_dataset(
            os.path.join(tmp, "hstu"), GR_TRAIN_ROWS, GR_EVAL_ROWS)
        texts, labels = synth_texts(paths)
        cols, n_global, tail = synth_batches(texts, labels, paths, hstu_paths)
        seconds["data"] = time.perf_counter() - t0

        # part 1: one NCCL rank, every table row_wise, against two
        # unsharded runs on the same batches (their distance: the noise)
        t0 = time.perf_counter()
        one_text = texts["deepfm_row_wise"]
        refs = []
        for _ in range(2):
            model, features, _, state, step = sharded_trainer(one_text)
            for c in cols["deepfm_row_wise"]:
                state, _ = step(state, parse_batch(features, c, ["label"]))
            eng = model.embedding_group.engine
            fused = model.embedding_group.engine_tables()
            refs.append({t: eng.extract_table(fused, t).cpu()
                         for t in eng._specs})
            del model, state, step, eng, fused
        ref1 = refs[0]
        noise1 = max(max_rel_err(refs[1], ref1).values())
        del refs
        if SHARDED_DEVICE == "cuda":
            torch.cuda.empty_cache()
        (got1, nccl_backend), = run_ranks(
            one_nccl_rank, 1, (one_text, cols["deepfm_row_wise"]),
            "nccl" if SHARDED_DEVICE == "cuda" else "gloo", tmp)
        err = max(max_rel_err(got1, ref1).values())
        bound1 = max(LAYOUT_TOL, 3.0 * noise1)
        out["one_nccl_rank"] = {"backend": nccl_backend, "max_err": err,
                                "noise_two_runs": noise1, "bound": bound1}
        if not err <= bound1:
            failures.append(f"one NCCL rank vs unsharded: {err}")
        seconds["one_nccl_rank"] = time.perf_counter() - t0

        # part 2: the uncapped DeepFM
        t0 = time.perf_counter()
        out["deepfm_uncapped"] = sharded_deepfm(tmp, backend)
        failures += out["deepfm_uncapped"].pop("failures")
        seconds["deepfm_uncapped"] = time.perf_counter() - t0

        # parts 3-5: the reference is one rank whose products take the
        # ranks' row blocks (``row_blocks``); a second such run on each
        # block's rows permuted gives the noise of summing over the batch
        # in another order (the ranks' partial sums change it too),
        # amplified by the optimizers and batch norm's backward; a plain
        # one-rank run's distance from the reference is printed (the GEMM
        # shape's part); then the ranks' runs (and the entry points on
        # four train files, batch 2048 a rank)
        t0 = time.perf_counter()
        ref_path = os.path.join(tmp, "world1.pt")
        ref = synth_world1(texts, cols, labels, blocks=SHARDED_WORLD)
        again = synth_world1(texts, cols, labels, n_global, SHARDED_WORLD)
        noise = {n: ref_distance(again[n], ref[n]) for n in texts}
        del again
        plain = synth_world1(texts, cols, labels)
        shape_part = {n: ref_distance(plain[n], ref[n]) for n in texts}
        del plain
        bn_ref = bn_one_step(texts["deepfm_bn"], cols["deepfm_bn"][0],
                             labels["deepfm_bn"])
        bn_permuted = bn_one_step(
            texts["deepfm_bn"], permuted(cols["deepfm_bn"][0],
                                         n_global["deepfm_bn"], SEED,
                                         SHARDED_WORLD), labels["deepfm_bn"])
        plans = synth_plans(ref)
        torch.save(ref, ref_path)
        del ref
        if SHARDED_DEVICE == "cuda":
            torch.cuda.empty_cache()
        seconds["world_1_refs"] = time.perf_counter() - t0
        src = os.path.join(zoo_config_dir(), "criteo_synth", "deepfm.config")
        model_dir = os.path.join(tmp, "deepfm_world2")
        edits = json.dumps({
            "model_dir": model_dir,
            "train_input_path": split_file(
                paths["train"], SHARDED_TRAIN_FILES, tmp, "train"),
            "eval_input_path": split_file(
                paths["eval"], SHARDED_WORLD, tmp, "eval"),
            "data_config.batch_size": ZOO_BATCH // SHARDED_WORLD})
        cfg_path = os.path.join(tmp, "deepfm_world2.config")
        cfg = config_util.load_pipeline_config(src)
        config_util.edit_config(cfg, json.loads(edits))
        config_util.save_message(cfg, cfg_path)
        t0 = time.perf_counter()
        ranks = run_ranks(synth_rank, SHARDED_WORLD,
                          (texts, cols, labels, ref_path, n_global, tail,
                           plans, (cfg_path, None)), backend, tmp)
        seconds["world_2_parts_3_5"] = time.perf_counter() - t0
        models = {}
        for name in texts:
            r0 = ranks[0]["models"][name]
            tol = LAYOUT_TOL if name.startswith("deepfm_") and \
                name != "deepfm_bn" else SHARDED_TRAP_TOL
            # the bound: the tolerance or 3x the noise of the permuted
            # run, the larger
            bound = max(tol, 3.0 * noise[name])
            models[name] = {"max_err": r0["max_err"], "worst": r0["worst"],
                            "top": r0["top"],
                            "noise_permuted_rows": noise[name],
                            "plain_one_rank_vs_blocks": shape_part[name],
                            "bound": bound, "groups": r0["groups"]}
            if name.startswith("deepfm_") and name != "deepfm_bn":
                layout = name[len("deepfm_"):]
                want = "row_wise" if layout == "table_row_wise" else layout
                if {v for v in r0["groups"].values()} != {want}:
                    failures.append(f"{name}: groups {r0['groups']}")
            if not r0["max_err"] <= bound:
                failures.append(f"{name} at world 2 vs 1: {r0['max_err']} "
                                f"({r0['worst']}), bound {bound}")
            for key in ("dense_digest", "replicated_digest"):
                if len({r["models"][name][key] for r in ranks}) != 1:
                    failures.append(f"{name}: {key} differs across ranks")
        out["models"] = models
        # batch norm held where no optimizer amplifies it: one step's
        # loss and batch statistics within 1e-5 of each tensor's max, the
        # dense gradients within 1e-4 of the largest (some are sums whose
        # terms cancel at this init: a bias that a batch norm follows,
        # whose mean the norm takes out, is zero but for rounding, and a
        # norm's scale that ReLU and the next norm take out is small;
        # against their own max they read the order of their sums,
        # reported by tensor); the same step with each rank's own
        # statistics must lie outside the first bound; the one-rank run on
        # rows permuted within the blocks reads the order of the sums
        bn = {}
        runs = dict(ranks[0]["bn_one_step"], permuted_rows=bn_permuted)
        for which, got in runs.items():
            stats = {k: v for k, v in got.items() if not k.startswith("grad.")}
            names = sorted(k for k in got if k.startswith("grad."))
            bn[which] = {
                "loss_and_stats": rel_report(stats, {k: bn_ref[k]
                                                     for k in stats}),
                "dense_grads": rel_report(
                    {"all": torch.cat([got[k].reshape(-1) for k in names])},
                    {"all": torch.cat([bn_ref[k].reshape(-1)
                                       for k in names])}),
                "dense_grads_by_tensor": rel_report(
                    {k: got[k] for k in names}, {k: bn_ref[k] for k in names}),
                "largest_grad": max(float(bn_ref[k].abs().max())
                                    for k in names)}
        bn["bounds"] = {"loss_and_stats": LAYOUT_TOL,
                        "dense_grads": SHARDED_TRAP_TOL}
        out["bn_one_step"] = bn
        for key, bound in bn["bounds"].items():
            if not bn["global"][key]["max_err"] <= bound:
                failures.append(f"batch norm's step at world 2 vs 1, {key}: "
                                f"{bn['global'][key]}, bound {bound}")
        if not bn["local"]["loss_and_stats"]["max_err"] > LAYOUT_TOL:
            failures.append("batch norm's check does not tell each rank's "
                            f"statistics from the global ones: {bn['local']}")
        fwd, bwd = ranks[0]["hstu_launches"]
        if not (fwd > 0 and bwd > 0):
            failures.append(f"kernels #1/#2 did not run on rank 0: "
                            f"{fwd}/{bwd}")
        # part 4: the entry points' results
        train = ranks[0]["train"]
        steps = int(train["step"])
        ckpt = checkpoint_util.checkpoint_path(model_dir, steps)
        auc2 = ranks[0]["evaluate"]["auc"]
        SHARDED_AUC["world_2"] = auc2
        t0 = time.perf_counter()
        one = port_main.evaluate(cfg_path, checkpoint_path=ckpt,
                                 device=SHARDED_DEVICE)
        m1, _ = port_main.build_model(cfg, SHARDED_DEVICE)
        restored = checkpoint_util.load_model_weights(ckpt, m1)
        sd = m1.state_dict()
        tables_equal = all(torch.equal(sd[k].cpu(), v.cpu())
                           for k, v in restored["model"].items()
                           if ".tables." in k)
        del m1, sd, restored
        seconds["world_1_evaluate"] = time.perf_counter() - t0
        out["entry_points"] = {
            "steps": steps, "train_s": ranks[0]["train_s"],
            "auc_world_2": auc2, "auc_world_1": one["auc"],
            "auc_train_eval": train.get("auc"),
            "pinned_auc": pinned["auc"]["value"],
            "plan_saved": os.path.exists(os.path.join(
                model_dir, "sharding_plan.json")),
            "restored_tables_bit_equal": tables_equal}
        if not abs(auc2 - one["auc"]) <= 1e-6:
            failures.append(f"evaluate at world 2 {auc2} vs 1 {one['auc']}")
        if not abs(auc2 - pinned["auc"]["value"]) <= ZOO_AUC_BOUND:
            failures.append(f"world-2 AUC {auc2} vs pinned "
                            f"{pinned['auc']['value']}")
        if not (tables_equal and out["entry_points"]["plan_saved"]):
            failures.append(f"entry points: {out['entry_points']}")
        if steps != ZOO_TRAIN_ROWS // ZOO_BATCH:
            failures.append(f"world 2 took {steps} steps")
    launches = {
        "row_write": (out["deepfm_uncapped"]["row_write_launches"]
                      + sum(r["row_write_launches"] for r in ranks)),
        "hstu_attention_fwd": sum(r["hstu_launches"][0] for r in ranks),
        "hstu_attention_bwd": sum(r["hstu_launches"][1] for r in ranks)}
    out["launches_main_path"] = launches
    out["seconds"] = seconds
    out["failures"] = failures
    emit(out)
    if failures:
        raise AssertionError(f"train_sharded: {failures}")
    return launches


# --- train_zch: ZCH, dynamic embeddings and host-offloaded tables ---------
# criteo_synth deepfm.config at its published width with five 100 000-bucket
# features remapped into 32 768-slot ZCH tables (two lfu, two lru, one
# distance_lfu, the proto's eviction interval of 5), three dynamicemb
# tables (two STEP, which bring the host spill tier, one with frequency
# admission at 2) and four tables host-offloaded. The sizes are assumed
# (no published ZCH config is in the repository): 32 768 slots lie well
# below the ~75-85k distinct ids a 100 000-bucket feature draws in an
# epoch, so eviction, spill and readmission all happen.
ZCH_SLOTS = 32768
ZCH_SPECS = {
    "cat_0": f"zch {{ zch_size: {ZCH_SLOTS} lfu {{}} }}",
    "cat_9": f"zch {{ zch_size: {ZCH_SLOTS} lfu {{}} }}",
    "cat_10": f"zch {{ zch_size: {ZCH_SLOTS} lru {{}} }}",
    "cat_11": f"zch {{ zch_size: {ZCH_SLOTS} lru {{}} }}",
    "cat_19": f"zch {{ zch_size: {ZCH_SLOTS} distance_lfu {{}} }}",
    "cat_20": f'dynamicemb {{ max_capacity: {ZCH_SLOTS} score_strategy: "STEP" }}',
    "cat_21": f'dynamicemb {{ max_capacity: {ZCH_SLOTS} score_strategy: "STEP" }}',
    "cat_22": f"dynamicemb {{ max_capacity: {ZCH_SLOTS} "
              "frequency_admission_strategy { threshold: 2 } }",
}
ZCH_HOST = ("cat_2", "cat_4", "cat_14", "cat_23")
# an epoch is 64 steps of 4 096; cut to 12 (both on the card and the
# CPU's reference run: the phase's 60 s set the cut), then to 8 when
# train_global_reductions joined
ZCH_STEPS = 8
ZCH_RESUME_AT = 4
# the fp32 card-against-CPU steps start after ZCH_WARM_STEPS remaps (no
# update) of the train file's first batches, so that they evict, spill
# and restore
ZCH_WARM_STEPS = 16
ZCH_CHECK_STEPS = 2  # 3 before train_pipelined joined
ZCH_TRAIN_ROWS = (ZCH_WARM_STEPS + ZCH_CHECK_STEPS + 1) * 4096  # > ZCH_STEPS
ZCH_EVAL_ROWS = 2 * 4096
ZCH_CARD_TOL = 1e-4  # tables, row state, dense: of each tensor's max
ZCH_HOST_TOL = 1e-5  # host tables against the same tables on the card
ZCH_CPU_BOUND = 0.02  # the epoch's AUC against a CPU run's
ZCH_TIMED_STEPS, ZCH_PROFILED_STEPS = 8, 3
# the loader-fed epoch's steps are timed past its first 2 (warm-up)
ZCH_CLOCK_SKIP = 2


def zch_text(paths, model_dir, fp32=False, host=True) -> str:
    """deepfm.config with ``ZCH_SPECS`` and (``host``) ``ZCH_HOST``
    offloaded; ``fp32``: fp32 compute and adam's and rowwise adagrad's eps
    1e-4, as ``zoo_rest_text`` sets them for the card-against-CPU steps."""
    import re

    text = criteo_text("deepfm", model_dir, paths, replace=[
        (f'feature_name: "{f}" num_buckets: 100000 ',
         f'feature_name: "{f}" {spec} ') for f, spec in ZCH_SPECS.items()])
    if host:
        for f in ZCH_HOST:
            text, n = re.subn(
                rf'(feature_name: "{f}" num_buckets: \d+ embedding_dim: 16)',
                r'\1 embedding_constraints { sharding_types: "host_offload" }',
                text)
            if n != 1:
                raise AssertionError(f"deepfm.config: no line for {f}")
    if fp32:
        for old, new in (('mixed_precision: "BF16"', ""),
                         ("adam_optimizer { lr: 0.001 }",
                          "adam_optimizer { lr: 0.001 eps: 1e-4 }"),
                         ("rowwise_adagrad_optimizer { lr: 0.01 }",
                          "rowwise_adagrad_optimizer { lr: 0.01 eps: 1e-4 }")):
            text = text.replace(old, new)
    return text.replace("save_checkpoints_steps: 100000",
                        f"save_checkpoints_steps: {ZCH_RESUME_AT}")


def _card(batch):
    """``batch`` on the card, keeping the host batch as the loader does."""
    out = batch.to("cuda")
    out.host = batch
    return out


class _ZchLog:
    """Records what a model's ZCH remaps and spill steps produced."""

    def __init__(self, eg) -> None:
        self.slots, self.batches, self.records, self.restores = [], [], [], []
        remap, spill_step = eg.remap_zch, eg.spill_step

        def remap_rec(batch, step, training, collect_spill=False):
            new, sp = remap(batch, step, training, collect_spill)
            self.slots.append({f: new.sparse_features[f].values.clone()
                               for f in eg._zch_features})
            self.batches.append(new)
            return new, sp

        def spill_rec(rec):
            self.records.append({t: {k: v.clone() for k, v in r.items()}
                                 for t, r in rec.items()})
            restores = spill_step(rec)
            self.restores.append(restores)
            return restores

        eg.remap_zch, eg.spill_step = remap_rec, spill_rec


def _touched_rows(eg, batches, restores) -> dict:
    """{table: sorted rows} the batches' lookups (after the remap) and the
    restores reached."""
    rows = {t: [] for t in eg.engine._specs}
    for lks in eg.engine._lookups_by_group.values():
        for lk in lks:
            for b in batches:
                src = (b.sequence_sparse_features if lk.is_sequence
                       else b.sparse_features)
                v = src[lk.feature_name].values.reshape(-1).long()
                rows[lk.table_name].append(v[v >= 0].cpu())
    for r in restores:
        for t, (slots, *_) in r.items():
            rows[t].append(torch.as_tensor(slots, dtype=torch.long))
    return {t: torch.unique(torch.cat(v)) if v else torch.zeros(0, dtype=
            torch.long) for t, v in rows.items()}


def zch_card_vs_cpu(paths, tmp) -> dict:
    """ZCH_CHECK_STEPS fp32 steps of the ZCH DeepFM on the card and on the
    CPU from the same CPU-drawn weights and batches, after both took the
    card's warm ZCH state (ZCH_WARM_STEPS remaps with the spill tier): the
    remapped slots, the whole ZCH state, the spill records' keys and slots
    and the restores' slots equal bit for bit; the records' and restores'
    rows, the tables, row state and dense parameters within ZCH_CARD_TOL of
    each tensor's max (the card's ReLU branches replayed on the CPU,
    ``GateReplay``); rows no id reached bit-equal; then the same steps on
    the card with the host-offloaded tables on the device, those tables and
    their row state within ZCH_HOST_TOL."""
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    cfg = parse_pipeline_config(zch_text(paths, os.path.join(tmp, "zchk"),
                                         fp32=True))
    cpu_model, features, _, cpu_state, cpu_step = build_trainer(
        cfg, device="cpu")
    card_model, _, _, card_state, card_step = build_trainer(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    ceg, peg = card_model.embedding_group, cpu_model.embedding_group
    batches = parquet_batches(paths["train"], features,
                              ZCH_WARM_STEPS + ZCH_CHECK_STEPS, ZOO_BATCH)
    for i, b in enumerate(batches[:ZCH_WARM_STEPS]):
        _, sp = ceg.remap_zch(_card(b), i, True, collect_spill=True)
        ceg.spill_step(ceg.gather_spill_rows(sp))
    init_sd = {k: v.detach().clone() for k, v in
               card_model.state_dict().items()}
    spill_sd = ceg.spill.state_dict()
    cpu_model.load_state_dict(init_sd)
    peg.spill.load_state_dict(spill_sd)
    cpu_state["step"] = card_state["step"] = ZCH_WARM_STEPS
    eng = ceg.engine
    before = {t: eng.extract_table(ceg.engine_tables(), t).detach().cpu()
              for t in eng._specs}
    clog, plog = _ZchLog(ceg), _ZchLog(peg)
    cmp = CpuComparison("train_zch", ZCH_CARD_TOL, MATCH_ZERO_GRAD)
    replay = GateReplay(ZCH_CARD_TOL)
    undo = replay_gates((cpu_model, card_model), replay)
    evictions, counts = 0, {"records": 0, "evicted": 0, "restored": 0}
    try:
        for i in range(ZCH_CHECK_STEPS):
            b = batches[ZCH_WARM_STEPS + i]
            kb = {t: st["keys"].clone() for t, st in ceg.zch_states().items()}
            replay.start(record=True)
            card_state, cm = card_step(card_state, _card(b))
            replay.start(record=False)
            cpu_state, pm = cpu_step(cpu_state, b)
            replay.done()
            evictions += sum(int(((k >= 0) & (k != ceg.zch_states()[t][
                "keys"])).sum()) for t, k in kb.items())
            for f, s in plog.slots[i].items():
                if not torch.equal(clog.slots[i][f].cpu(), s):
                    raise AssertionError(f"train_zch: step {i} {f}'s slots "
                                         "differ on the card")
            for t, st in peg.zch_states().items():
                for k, v in st.items():
                    if not torch.equal(ceg.zch_states()[t][k].cpu(), v):
                        raise AssertionError(f"train_zch: step {i} ZCH state "
                                             f"{t}.{k} differs on the card")
            for t, rec in plog.records[i].items():
                for k, v in rec.items():
                    got = clog.records[i][t][k]
                    if k == "evicted_rows":
                        cmp.compare(f"spill:{t}.{k}", v, got)
                    elif not torch.equal(got.cpu(), v):
                        raise AssertionError(f"train_zch: step {i} spill "
                                             f"record {t}.{k} differs")
                counts["records"] += int(rec["slots"].numel())
                counts["evicted"] += int((rec["evicted_keys"] >= 0).sum())
            if set(plog.restores[i]) != set(clog.restores[i]):
                raise AssertionError("train_zch: restores of other tables")
            for t, (slots, rows, *_) in plog.restores[i].items():
                cs, cr = clog.restores[i][t][:2]
                if not np.array_equal(cs, slots):
                    raise AssertionError(f"train_zch: {t}'s restored slots "
                                         "differ on the card")
                cmp.compare(f"restore:{t}", torch.as_tensor(rows),
                            torch.as_tensor(cr))
                counts["restored"] += len(slots)
            for k in pm:
                cmp.compare(f"step {i + 1} {k}", torch.as_tensor(pm[k]),
                            torch.as_tensor(cm[k]))
    finally:
        undo()
    ref_sd, sd = cpu_model.state_dict(), card_model.state_dict()
    for k in ref_sd:
        if ".zch." in k:
            if not torch.equal(sd[k].cpu(), ref_sd[k]):
                raise AssertionError(f"train_zch: {k} differs on the card")
        else:
            cmp.compare(f"state:{k}", ref_sd[k], sd[k])
    ptables, ctables = peg.engine_tables(), ceg.engine_tables()
    for t in eng._specs:
        ref = peg.engine.extract_table_state(ptables, cpu_state["sparse_opt"],
                                             t)
        got = eng.extract_table_state(ctables, card_state["sparse_opt"], t)
        for k in ref:
            cmp.compare(f"row_state:{t}.{k}", ref[k], got[k])
    # rows no id reached keep their bits
    touched = _touched_rows(ceg, clog.batches, clog.restores)
    untouched = 0
    for t, old in before.items():
        keep = torch.ones(old.shape[0], dtype=torch.bool)
        keep[touched[t]] = False
        now = eng.extract_table(ctables, t).detach().cpu()
        if not torch.equal(now[keep], old[keep]):
            raise AssertionError(f"train_zch: untouched rows of {t} moved")
        untouched += int(keep.sum())
    if not (evictions > 0 and counts["evicted"] > 0
            and counts["restored"] > 0):
        raise AssertionError(f"train_zch: evictions {evictions}, spill "
                             f"{counts} in the checked steps")
    host_tables = sorted(t for t in eng._specs if eng.groups[
        eng._table_group[t]].sharding == "host_offload")
    if len(host_tables) != 2 * len(ZCH_HOST):
        raise AssertionError(f"train_zch: host tables {host_tables}")
    # the host tier against the same tables on the card
    dev_cfg = parse_pipeline_config(zch_text(
        paths, os.path.join(tmp, "zchd"), fp32=True, host=False))
    dev_model, _, _, dev_state, dev_step = build_trainer(dev_cfg)
    dev_model.load_state_dict(init_sd)
    dev_model.embedding_group.spill.load_state_dict(spill_sd)
    dev_state["step"] = ZCH_WARM_STEPS
    for i in range(ZCH_CHECK_STEPS):
        dev_state, _ = dev_step(dev_state, _card(batches[ZCH_WARM_STEPS + i]))
    deg = dev_model.embedding_group
    host_err = 0.0
    for t in host_tables:
        pairs = [(eng.extract_table(ctables, t),
                  deg.engine.extract_table(deg.engine_tables(), t))]
        hst = eng.extract_table_state(ctables, card_state["sparse_opt"], t)
        dst = deg.engine.extract_table_state(deg.engine_tables(),
                                             dev_state["sparse_opt"], t)
        pairs += [(hst[k], dst[k]) for k in hst]
        for got, ref in pairs:
            ref, got = ref.detach().float().cpu(), got.detach().float().cpu()
            err = float((got - ref).abs().max()) / (float(ref.abs().max())
                                                    or 1.0)
            host_err = max(host_err, err)
            if not err <= ZCH_HOST_TOL:
                raise AssertionError(f"train_zch: host table {t} off by "
                                     f"{err:.3g} of the device run's max")
    errs = cmp.errs
    out = {"steps": ZCH_CHECK_STEPS, "warm_remaps": ZCH_WARM_STEPS,
           "batch": ZOO_BATCH, "compared": len(errs),
           "max_rel_err": max(errs.values()),
           "max_rel_err_by_kind": {
               kind: max((v for k, v in errs.items() if k.startswith(kind)),
                         default=None)
               for kind in ("state:", "row_state:", "spill:", "restore:",
                            "step ")},
           "slots_zch_state_spill_keys_bit_equal": True,
           "evictions": evictions, "spill": counts,
           "untouched_rows_bit_equal": untouched,
           "gate_ties_flipped": replay.flips,
           "host_tables": host_tables,
           "host_vs_device_max_rel_err": host_err,
           "tol": ZCH_CARD_TOL, "host_tol": ZCH_HOST_TOL}
    del cpu_model, card_model, dev_model, cpu_state, card_state, dev_state
    torch.cuda.empty_cache()
    return out


def _zch_timers(eg) -> dict:
    """Wraps the host work of a step (the host tier's gather and apply,
    the spill store and the restore write) to sum its wall ms."""
    ms = {"host_gather": 0.0, "host_apply": 0.0, "spill_store": 0.0,
          "spill_restore": 0.0}

    def wrap(obj, name, key):
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                ms[key] += (time.perf_counter() - t0) * 1e3

        setattr(obj, name, timed)

    wrap(eg.engine, "host_gather", "host_gather")
    wrap(eg.engine, "_host_apply", "host_apply")
    wrap(eg.spill, "process", "spill_store")
    wrap(eg, "apply_spill_restores", "spill_restore")
    return ms


def zch_resident(cfg, batches) -> dict:
    """The step over resident batches in turn: median of ZCH_TIMED_STEPS
    synchronised steps, a window, the host work per step and the idle
    share from ZCH_PROFILED_STEPS profiled steps; the device time of one
    step's remaps alone, profiled, and the host's waits in them."""
    model, _, _, state, step = build_trainer(cfg)
    eg = model.embedding_group
    n = len(batches)
    for i in range(2):
        state, _ = step(state, batches[i % n])
    torch.cuda.synchronize()
    ms = _zch_timers(eg) if eg.has_zch else {}
    step_ms = []
    for i in range(ZCH_TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batches[(2 + i) % n])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    host = {k: v / ZCH_TIMED_STEPS for k, v in ms.items()}
    t0 = time.perf_counter()
    for i in range(ZCH_TIMED_STEPS):
        state, m = step(state, batches[i % n])
    float(m["total_loss"])
    torch.cuda.synchronize()
    window = (time.perf_counter() - t0) * 1e3 / ZCH_TIMED_STEPS
    profile_out = profile_forward(lambda: [step(state, batches[i % n])
                                           for i in range(ZCH_PROFILED_STEPS)])
    remap = None
    if eg.has_zch:
        # one step's remaps alone (training, with the spill records): the
        # device time of their kernels, and where the host waits for the
        # card inside them (``set_sync_debug_mode``)
        import warnings

        remap = profile_forward(lambda: [eg.remap_zch(
            batches[i % n], state["step"], True, collect_spill=True)
            for i in range(ZCH_PROFILED_STEPS)])
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eg.remap_zch(batches[0], state["step"], True,
                             collect_spill=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        remap["host_waits"] = sorted({
            str(w.message).splitlines()[0][:120] for w in caught
            if "prototype" not in str(w.message)})
    out = {"step_ms_median": float(np.median(step_ms)),
           "step_ms_range": [min(step_ms), max(step_ms)],
           "window_step_ms": window,
           "examples_per_s": ZOO_BATCH / window * 1e3,
           "idle_share_profiled_steps": profile_out.get("device_idle_share"),
           "busy_ms_per_step": (profile_out.get("device_busy_ms", 0.0)
                                / ZCH_PROFILED_STEPS),
           "step_profile": profile_out}
    if eg.has_zch:
        out["remap_device_ms_per_step"] = (
            remap.get("device_busy_ms", 0.0) / ZCH_PROFILED_STEPS)
        out["remap_profile"] = remap
        out["host_ms_per_step"] = host
        # the copies each way at one step's sizes (the rows a batch
        # gathers, their gradients back)
        hrows = eg.host_gather(batches[0])
        rows = [r for r, _ in hrows.values()]
        dev_rows = [r.to("cuda") for r in rows]
        out["host_rows_bytes"] = sum(r.numel() * 4 for r in rows)
        out["h2d_rows_ms"] = cuda_ms(
            lambda: [r.to("cuda", non_blocking=True) for r in rows], 5)
        t0 = time.perf_counter()
        for _ in range(5):
            [r.cpu() for r in dev_rows]
        out["d2h_grads_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    del model, state, step
    torch.cuda.empty_cache()
    return out


ZCH_PREDICT = r"""
import sys
from torcheasyrec_tpu_torch import main
art, inp, out = sys.argv[1:4]
main.predict(inp, out, art, device="cuda")
"""


def zch_export_start(cfg_path, pred_in, tmp):
    """Export the trained ZCH model, then start a fresh process that runs
    the artifact's ``predict`` (``ZCH_PREDICT``); returns what
    ``zch_export_check`` takes."""
    from torcheasyrec_tpu_torch import main as port_main

    art = os.path.join(tmp, "zch_export")
    t0 = time.perf_counter()
    port_main.export(cfg_path, art, device="cuda")
    export_s = time.perf_counter() - t0
    out = os.path.join(tmp, "zch_art_pred.parquet")
    log = open(os.path.join(tmp, "zch_predict.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", ZCH_PREDICT, art, pred_in, out],
        stdout=log, stderr=subprocess.STDOUT, text=True)
    # stopped at exit where a failure ends the phase before its check
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "log": log, "t0": time.perf_counter(),
            "export_s": export_s, "out": out, "art": art}


def zch_export_check(started, cfg_path, pred_ckpt) -> dict:
    """The exported program, loaded here, on the serving batch against the
    eager forward of the checkpoint; then the fresh process's artifact
    ``predict`` against ``predict_checkpoint``; both bit for bit."""
    import pyarrow.parquet as pq
    import torch.utils._pytree as pytree

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.utils import checkpoint_util, config_util

    t0 = time.perf_counter()
    cfg = config_util.load_pipeline_config(cfg_path)
    model, feats = port_main.build_model(cfg, "cuda")
    checkpoint_util.load_model_weights(
        checkpoint_util.latest_checkpoint(cfg.model_dir), model)
    _, batch = port_main.serving_batch(cfg, feats, "cuda")
    with torch.inference_mode():
        want = model(batch)
    prog = torch.export.load(os.path.join(started["art"],
                                          port_main.PREDICT_PROGRAM))
    got = prog.module()(*pytree.tree_flatten(batch)[0])
    for k, v in got.items():
        if not torch.equal(v, want[k]):
            raise AssertionError(f"train_zch: the loaded program's {k} "
                                 "differs from the eager forward")
    program_s = time.perf_counter() - t0
    del model, prog
    proc, log = started["proc"], started["log"]
    try:
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log.seek(0)
    err = log.read()
    log.close()
    if proc.returncode:
        raise AssertionError(f"train_zch: the artifact's predict failed: "
                             f"{err[-3000:]}")
    process_s = time.perf_counter() - started["t0"]
    a, b = pq.read_table(pred_ckpt), pq.read_table(started["out"])
    if a.num_rows != b.num_rows:
        raise AssertionError(f"train_zch: the artifact predicted "
                             f"{b.num_rows} rows, not {a.num_rows}")
    for col in ("probs", "logits"):
        if not np.array_equal(a[col].to_numpy(), b[col].to_numpy()):
            raise AssertionError(f"train_zch: the artifact's {col} differ "
                                 "from predict_checkpoint's")
    return {"export_s": started["export_s"], "program_check_s": program_s,
            "predict_process_s": process_s, "rows": a.num_rows,
            "predict_bit_equal": True,
            "program_outputs_bit_equal": sorted(got)}


@contextlib.contextmanager
def step_clock(port_main):
    """Stamps the end of every train step of ``train_and_evaluate``'s
    loop (the card synchronised, before the loop's ``after_step``) while
    it is open; yields the list of stamps (perf_counter seconds)."""
    import inspect

    stamps, orig = [], port_main.train_epoch
    sig = inspect.signature(orig)

    def clocked(*a, **k):
        bound = sig.bind(*a, **k)
        inner = bound.arguments.get("after_step")

        def after(state, info):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            if inner is not None:
                inner(state, info)

        bound.arguments["after_step"] = after
        return orig(*bound.args, **bound.kwargs)

    port_main.train_epoch = clocked
    try:
        yield stamps
    finally:
        port_main.train_epoch = orig


def epoch_steps(stamps, skip=ZCH_CLOCK_SKIP) -> dict:
    """The loop's step times from ``step_clock``'s stamps, past the first
    ``skip`` steps: their median and the mean over the window."""
    gaps = np.diff(stamps[skip - 1:]) * 1e3
    return {"steps_timed": len(gaps), "step_ms_median": float(np.median(gaps)),
            "step_ms_range": [float(gaps.min()), float(gaps.max())],
            "window_step_ms": float(gaps.mean()),
            "examples_per_s": ZOO_BATCH / float(gaps.mean()) * 1e3}


def zch_tb_tags(model_dir) -> dict:
    """The TensorBoard tags ``train_and_evaluate`` wrote, where the
    ``tensorboard`` package imports."""
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )
    except ImportError as e:
        return {"tensorboard": f"not importable: {e}"}
    acc = EventAccumulator(os.path.join(model_dir, "tb"))
    acc.Reload()
    return {t: len(acc.Scalars(t)) for t in acc.Tags()["scalars"]}


class restore_writes:
    """Counts, inside the block, the row writes (kernel #3 launches) that
    ``write_logical_rows`` makes: the spill restores into packed
    groups."""

    def __enter__(self):
        from torcheasyrec_tpu_torch.ops.row_write import write_rows
        from torcheasyrec_tpu_torch.parallel.emb_engine import (
            EmbeddingEngine,
        )

        self._cls, self._real = EmbeddingEngine, EmbeddingEngine.__dict__[
            "write_logical_rows"]
        self.counts = {"launches": 0, "calls": 0}
        real, counts = self._real, self.counts

        def counted(engine, *args, **kwargs):
            before = write_rows.launches
            real(engine, *args, **kwargs)
            counts["launches"] += write_rows.launches - before
            counts["calls"] += 1

        EmbeddingEngine.write_logical_rows = counted
        return self.counts

    def __exit__(self, *exc):
        self._cls.write_logical_rows = self._real
        return False


def phase_train_zch(smi, sharded_auc=None):
    """ZCH, dynamic embeddings and host-offloaded tables on criteo_synth
    DeepFM (``zch_text``): card against CPU (``zch_card_vs_cpu``), an
    epoch cut to ZCH_STEPS through ``train_and_evaluate`` (BF16) against a
    CPU run from the same weights (its loop's steps timed by
    ``step_clock``), ``evaluate``, ``predict_checkpoint``, a resume at
    ZCH_RESUME_AT bit-equal to the straight run, the export and
    its artifact in a fresh process (beside the CPU run and the resume),
    the TensorBoard tags, and the step
    with its host work beside the same config without ZCH. Returns kernel
    #3's launches of the straight ``train_and_evaluate``."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.benchmark import synthetic
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.utils import checkpoint_util
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    out, seconds = {"phase": "train_zch", "nvidia_smi": smi}, {}

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        seconds[key] = time.perf_counter() - t0
        return res

    with open(os.path.join(zoo_config_dir(), "base_eval_metric.json")) as f:
        pinned = json.load(f)[
            "torcheasyrec_tpu_torch/benchmark/configs/criteo_synth/"
            "deepfm.config"]["metrics"]["auc"]["value"]
    with tempfile.TemporaryDirectory() as tmp:
        paths = timed("data", synthetic.ensure_dataset, tmp, ZCH_TRAIN_ROWS,
                      ZCH_EVAL_ROWS)
        out["card_vs_cpu"] = timed("card_vs_cpu", zch_card_vs_cpu, paths, tmp)
        emit({"phase": "train_zch_card_vs_cpu", **out["card_vs_cpu"]})

        model_dir = os.path.join(tmp, "zch")
        src = write_text(os.path.join(tmp, "zch.config"),
                         zch_text(paths, model_dir))
        init = cpu_init(src, os.path.join(tmp, "zch_init.pt"))
        edits = json.dumps({"train_config.num_steps": ZCH_STEPS})
        write_rows.launches = 0
        t0 = time.perf_counter()
        with step_clock(port_main) as stamps, restore_writes() as restored:
            result = port_main.train_and_evaluate(
                src, fine_tune_checkpoint=init, edit_config_json=edits,
                device="cuda")
        torch.cuda.synchronize()
        seconds["train"] = time.perf_counter() - t0
        launches = write_rows.launches
        loader_fed = epoch_steps(stamps)
        cfg_path = os.path.join(model_dir, "pipeline.config")
        cfg = parse_pipeline_config(open(cfg_path).read())
        probe, _ = port_main.build_model(cfg, "cpu")
        written = sorted(gk for gk, g in probe.embedding_group.engine.groups
                         .items() if g.packed and any(
                             t.name not in g.dense_tables for t in g.specs))
        del probe
        # one row write a written group and step, and one a spill restore
        # into a packed group
        if result["step"] != ZCH_STEPS or launches != ZCH_STEPS * len(
                written) + restored["launches"]:
            raise AssertionError(
                f"train_zch: {result['step']} steps, {launches} row writes "
                f"for the written packed groups {written} and "
                f"{restored['launches']} restores")
        ck = torch.load(checkpoint_util.latest_checkpoint(model_dir),
                        map_location="cpu", weights_only=True)
        spill = {t: dict(zip(("clock", "stored", "restored", "dropped"),
                             v["meta"].tolist()))
                 for t, v in ck["zch_spill"].items()}
        # frequency admission (cat_22) holds new ids back: its table may
        # not restore within the cut epoch, the others must
        if not (sum(s["stored"] for s in spill.values()) > 0
                and sum(s["restored"] for s in spill.values()) > 0):
            raise AssertionError(f"train_zch: the epoch's spill {spill}")
        occupied = {k.split(".")[2]: int((v >= 0).sum())
                    for k, v in ck["model"].items() if k.endswith(".keys")}
        del ck
        pred_in = os.path.join(tmp, "zch_predict_in.parquet")
        pq.write_table(pq.read_table(paths["eval"]).slice(
            0, ZOO_PREDICT_BATCHES * ZOO_BATCH), pred_in)
        t0 = time.perf_counter()
        again = port_main.evaluate(cfg_path, device="cuda")
        seconds["evaluate"] = time.perf_counter() - t0
        if again["auc"] != result["auc"]:
            raise AssertionError(f"train_zch: evaluate() auc {again['auc']} "
                                 f"against {result['auc']}")
        pred_ckpt = os.path.join(tmp, "zch_pred.parquet")
        n_pred = port_main.predict_checkpoint(cfg_path, pred_in, pred_ckpt,
                                              device="cuda")
        # the fresh process predicts while the CPU run and the resume do
        started = timed("export", zch_export_start, cfg_path, pred_in, tmp)
        t0 = time.perf_counter()
        cpu = port_main.train_and_evaluate(
            write_text(os.path.join(tmp, "zch_cpu.config"),
                       zch_text(paths, os.path.join(tmp, "zch_cpu"))),
            fine_tune_checkpoint=init, edit_config_json=edits, device="cpu")
        seconds["train_cpu"] = time.perf_counter() - t0
        dist = result["auc"] - cpu["auc"]
        if not abs(dist) <= ZCH_CPU_BOUND:
            raise AssertionError(f"train_zch: auc {result['auc']} on the "
                                 f"card is {dist:+.4f} from {cpu['auc']}")
        out["train"] = {
            "result": result, "steps": ZCH_STEPS, "row_write_launches":
            launches, "restore_row_writes": restored["launches"],
            "written_packed_groups": written, "spill": spill,
            "occupied_slots": occupied, "predict_rows": n_pred,
            "cpu_reference": {"auc": cpu["auc"], "card_minus_cpu": dist,
                              "bound": ZCH_CPU_BOUND},
            "auc_beside": {"deepfm_pinned_label_64_steps": pinned,
                           "train_sharded_deepfm_64_steps": sharded_auc},
            "loader_fed_step": loader_fed,
            "tensorboard_tags": zch_tb_tags(model_dir)}
        emit({"phase": "train_zch_train", **out["train"]})

        # a resume at ZCH_RESUME_AT against the straight run
        rdir = os.path.join(tmp, "zch_resumed")
        rsrc = write_text(os.path.join(tmp, "zch_resumed.config"),
                          zch_text(paths, rdir))
        t0 = time.perf_counter()
        port_main.train_and_evaluate(
            rsrc, fine_tune_checkpoint=init, device="cuda",
            edit_config_json=json.dumps(
                {"train_config.num_steps": ZCH_RESUME_AT}))
        port_main.train_and_evaluate(rsrc, continue_train=True,
                                     edit_config_json=edits, device="cuda")
        seconds["resume"] = time.perf_counter() - t0
        a, b = (torch.load(checkpoint_util.latest_checkpoint(d),
                           map_location="cpu", weights_only=True)
                for d in (model_dir, rdir))
        same = [k for k in a["model"] if torch.equal(a["model"][k],
                                                     b["model"][k])]
        if len(same) != len(a["model"]) or a["step"] != b["step"]:
            raise AssertionError(
                f"train_zch: the resumed run differs in "
                f"{sorted(set(a['model']) - set(same))[:8]}")
        for t in a["zch_spill"]:
            for k in a["zch_spill"][t]:
                if not torch.equal(a["zch_spill"][t][k],
                                   b["zch_spill"][t][k]):
                    raise AssertionError(f"train_zch: resumed spill {t}.{k}")
        out["resume"] = {"at": ZCH_RESUME_AT, "to": ZCH_STEPS,
                         "state_dict_bit_equal": len(same)}
        del a, b
        out["export"] = timed("export_wait", zch_export_check, started,
                              cfg_path, pred_ckpt)
        emit({"phase": "train_zch_export", "resume": out["resume"],
              **out["export"]})

        # the step beside the same config without ZCH and host tables
        plain_cfg = parse_pipeline_config(criteo_text(
            "deepfm", os.path.join(tmp, "plain"), paths))
        feats = port_main._create_features(cfg)
        batches = [_card(b) for b in parquet_batches(
            paths["train"], feats, 8, ZOO_BATCH)]
        t0 = time.perf_counter()
        out["resident"] = zch_resident(cfg, batches)
        out["resident_plain_deepfm"] = zch_resident(plain_cfg, batches)
        seconds["resident"] = time.perf_counter() - t0
        del batches
    out["seconds"] = seconds
    c, r, rp = out["card_vs_cpu"], out["resident"], out["resident_plain_deepfm"]
    out["summary"] = {
        "card_vs_cpu_max_rel_err": c["max_rel_err"],
        "host_vs_device_max_rel_err": c["host_vs_device_max_rel_err"],
        "evictions_checked_steps": c["evictions"], "spill": c["spill"],
        "auc": result["auc"], "auc_card_minus_cpu": dist,
        "step_ms": r["step_ms_median"], "examples_per_s": r["examples_per_s"],
        "plain_deepfm_step_ms": rp["step_ms_median"],
        "plain_deepfm_examples_per_s": rp["examples_per_s"],
        "idle_share": r["idle_share_profiled_steps"],
        "remap_device_ms_per_step": r.get("remap_device_ms_per_step"),
        "host_ms_per_step": r.get("host_ms_per_step"),
        "loader_fed_step_ms": loader_fed["step_ms_median"],
        "loader_fed_examples_per_s": loader_fed["examples_per_s"],
        "row_write_launches": launches}
    emit(out)
    return launches


# --- phase train_sid: semantic-ID generation, dense embeddings, CSV --------

SID_DIM = 768  # TIGER's item content vectors (Sentence-T5)
SID_HIDDEN = (512, 256, 128)  # TIGER's RQ-VAE encoder; the decoder mirrors it
SID_LATENT = 32
SID_CODEBOOK = (256, 256, 256)
SID_BATCH = 1024
SID_ITEMS = 32_768  # synthetic items, 32 steps an epoch
SID_EVAL_ITEMS = 4_096
SID_CLUSTERS = 256
SID_CHECK_STEPS = 2  # 3 before train_pipelined joined
SID_CARD_TOL = 1e-4  # fp32: max abs error over the CPU's max abs, per tensor
# a code on the card may differ from the CPU's only where the CPU's two
# least distances lie within this share of the batch's largest distance
SID_TIE_GAP = 1e-5
SID_CPU_BOUND = 0.02  # unique_ratio, rel_loss, AUC against a CPU run
SID_TIMED_STEPS = 20
SID_PROFILED_STEPS = 5
SID_PARSE_BATCHES = 4
SID_KMEANS_CHECK = 4_096  # samples of the card-against-CPU fit: the CPU's time
SID_AUTODIS_CHANNELS = 16  # assumed: no published config sets it
SID_DEEPFM_STEPS = 12
SID_DEEPFM_ROWS = (SID_DEEPFM_STEPS * 4096, 2 * 4096)
SID_VOCAB_FEATURE = "cat_1"  # 39 060 ids: a table past the dense lane
SID_LOADER_BATCHES = 12


class CodeReplay:
    """The codes of ``torch.argmin`` (the quantizer's and the k-means
    fit's), recorded on the CPU in call order and replayed on the card.
    Two right fp32 runs can order two distances that lie within rounding
    differently; replaying the CPU's code makes both runs compute one
    function, held at the bound. A card code that differs is accepted only
    where the CPU's two least distances lie within ``gap`` of the batch's
    largest distance, and is counted."""

    def __init__(self, gap: float) -> None:
        self.gap, self.codes, self.record, self.at = gap, [], True, 0
        self.flips, self.worst = 0, 0.0
        self._argmin = torch.argmin

    def start(self, record: bool) -> None:
        self.record, self.at = record, 0
        if record:
            self.codes = []

    def done(self) -> None:
        if not self.record and self.at != len(self.codes):
            raise AssertionError(f"{self.at} argmins on the card, "
                                 f"{len(self.codes)} on the CPU")

    def argmin(self, x, dim=None, keepdim=False):
        own = self._argmin(x, dim=dim, keepdim=keepdim)
        if self.record:
            x = x.detach()
            two = torch.topk(x, 2, dim=dim, largest=False).values
            gap = two.select(dim, 1) - two.select(dim, 0)
            self.codes.append((own, gap, float(x.abs().max())))
            return own
        ref, gap, scale = self.codes[self.at]
        self.at += 1
        ref = ref.to(own.device)
        differ = (ref != own).cpu()
        if bool(differ.any()):
            self.flips += int(differ.sum())
            share = float(gap[differ].max()) / max(scale, 1e-30)
            self.worst = max(self.worst, share)
            if share > self.gap:
                raise AssertionError(f"a code flips at a gap of {share:.3g} "
                                     "of the largest distance: not a tie")
        return ref

    def __enter__(self):
        torch.argmin = self.argmin
        return self

    def __exit__(self, *exc):
        torch.argmin = self._argmin


def sid_items(path, n: int, seed: int) -> str:
    """``n`` synthetic item content vectors of SID_DIM floats (a
    list<float32> column ``item_emb``) around SID_CLUSTERS fixed centres
    of unit scale, with an ``item_id`` and a zero ``label``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    centres = np.random.default_rng(SEED).normal(
        size=(SID_CLUSTERS, SID_DIM)).astype(np.float32)
    r = np.random.default_rng(seed)
    x = (centres[r.integers(0, SID_CLUSTERS, n)]
         + 0.3 * r.normal(size=(n, SID_DIM)).astype(np.float32))
    emb = pa.ListArray.from_arrays(
        pa.array(np.arange(0, n * SID_DIM + 1, SID_DIM, dtype=np.int32)),
        pa.array(x.reshape(-1)))
    pq.write_table(pa.table({
        "item_id": pa.array(np.arange(n, dtype=np.int64) + seed * 10 ** 6),
        "item_emb": emb, "label": pa.array(np.zeros(n, np.float32))}), path)
    return path


def sid_text(paths, model_dir, model: str) -> str:
    """A SID config over ``item_emb`` (group "all"): TIGER's RQ-VAE
    (``model`` "rqvae": encoder 768-512-256-128-32, 3 levels of 256 codes,
    commitment weight 0.25) or RQ-KMeans on the raw vectors; adam at lr
    1e-3 (TIGER trains with Adagrad at 0.4: assumed here)."""
    block = (
        f"sid_rqvae {{ embed_dim: {SID_LATENT} hidden_dims: "
        f"{list(SID_HIDDEN)} codebook: {list(SID_CODEBOOK)} }}\n"
        "  losses { recon_loss {} }\n"
        "  losses { commitment_loss { latent_weight: [1.0, 0.25] } }"
        if model == "rqvae" else
        f"sid_rqkmeans {{ codebook: {list(SID_CODEBOOK)} "
        f"train_sample_size: {SID_ITEMS} }}\n"
        "  losses { recon_loss {} }")
    return f"""train_input_path: "{paths['train']}"
eval_input_path: "{paths['eval']}"
model_dir: "{model_dir}"
train_config {{
  sparse_optimizer {{ adagrad_optimizer {{ lr: 0.01 }} constant_learning_rate {{}} }}
  dense_optimizer {{ adam_optimizer {{ lr: 0.001 }} constant_learning_rate {{}} }}
  num_epochs: 1
  save_checkpoints_steps: 100000
  log_step_count_steps: 8
}}
data_config {{
  batch_size: {SID_BATCH}
  dataset_type: ParquetDataset
  fg_mode: FG_NONE
  label_fields: "label"
}}
feature_configs {{ raw_feature {{ feature_name: "item_emb" value_dim: {SID_DIM} }} }}
model_config {{
  feature_groups {{ group_name: "all" feature_names: "item_emb" group_type: DEEP }}
  {block}
}}
"""


def sid_card_vs_cpu(cfg, batches) -> dict:
    """SID_CHECK_STEPS fp32 RQ-VAE steps on the card and on the CPU from
    the same CPU-drawn weights and batches, the CPU's codes replayed on
    the card (``CodeReplay``): before each step the loss, the outputs and
    every dense gradient within SID_CARD_TOL of the CPU's max, the
    codebooks' gradients 0 on both; each step's losses; after the steps
    the state dict."""
    cpu_model, _, _, cpu_state, cpu_step = build_trainer(cfg, device="cpu")
    card_model, _, _, card_state, card_step = build_trainer(cfg)
    card_model.load_state_dict(cpu_model.state_dict())
    cmp = CpuComparison("train_sid rqvae", SID_CARD_TOL, 0.0)
    replay = CodeReplay(SID_TIE_GAP)
    books = sorted(n for n, _ in cpu_model.named_parameters()
                   if n.endswith(".codebook"))

    def paired(card_fn, cpu_fn):
        replay.start(record=True)
        ref = cpu_fn()
        replay.start(record=False)
        got = card_fn()
        replay.done()
        return ref, got

    with replay:
        for i, batch in enumerate(batches):
            card_batch = batch.to("cuda")
            (ref_loss, ref_preds, ref_grads), (loss, preds, grads) = paired(
                lambda: train_mode_outputs(card_model, card_batch),
                lambda: train_mode_outputs(cpu_model, batch))
            for b in books:
                for g in (ref_grads, grads):
                    if b in g and bool(g[b].any()):
                        raise AssertionError(f"train_sid: {b} has a gradient")
            ref_grads = {k: v for k, v in ref_grads.items() if k not in books}
            grads = {k: v for k, v in grads.items() if k not in books}
            cmp.compare("loss", ref_loss, loss)
            for k in ("codes", "recon", "__z", "__x"):
                cmp.compare(k, ref_preds[k], preds[k])
            cmp.compare_grads(ref_grads, grads)
            (cpu_state, cpu_m), (card_state, card_m) = paired(
                lambda: card_step(card_state, card_batch),
                lambda: cpu_step(cpu_state, batch))
            for k in cpu_m:
                cmp.compare(f"step {i + 1} {k}", torch.as_tensor(cpu_m[k]),
                            torch.as_tensor(card_m[k]))
    ref_sd, sd = cpu_model.state_dict(), card_model.state_dict()
    for k in ref_sd:
        cmp.compare(f"state:{k}", ref_sd[k], sd[k])
    for b in books:
        # no gradient: the codebooks keep their initial bits
        if not torch.equal(ref_sd[b], sd[b].cpu()):
            raise AssertionError(f"train_sid: {b} moved")
    errs = cmp.errs
    out = {"steps": len(batches), "batch": SID_BATCH, "compared":
           len(errs), "max_rel_err": max(errs.values()),
           "max_rel_err_by_kind": {
               kind: max((v for k, v in errs.items() if k.startswith(kind)),
                         default=None)
               for kind in ("grad:", "state:", "step ", "recon")},
           "codebook_gradients": "exactly 0 (none reaches a codebook)",
           "codes_replayed_per_step": len(replay.codes),
           "code_ties_flipped": replay.flips,
           "worst_flip_gap_share": replay.worst, "tie_gap": SID_TIE_GAP,
           "tol": SID_CARD_TOL}
    del cpu_model, card_model, cpu_state, card_state
    torch.cuda.empty_cache()
    return out


def sid_resident(cfg, batch) -> dict:
    """The RQ-VAE step on a resident batch: median of SID_TIMED_STEPS
    synchronised steps after 3, a window, the idle share of
    SID_PROFILED_STEPS profiled steps."""
    model, _, _, state, step = build_trainer(cfg)
    card = batch.to("cuda")
    for _ in range(3):
        state, _ = step(state, card)
    losses, step_ms, window = timed_steps(step, state, card, 0,
                                          SID_TIMED_STEPS)
    profile = profile_forward(lambda: [step(state, card)
                                       for _ in range(SID_PROFILED_STEPS)])
    del model, state, step
    torch.cuda.empty_cache()
    return {"step_ms_median": float(np.median(step_ms)),
            "step_ms_range": [min(step_ms), max(step_ms)],
            "window_step_ms": window,
            "examples_per_s": SID_BATCH / window * 1e3,
            "idle_share_profiled_steps": profile.get("device_idle_share"),
            "busy_ms_per_step": (profile.get("device_busy_ms", 0.0)
                                 / SID_PROFILED_STEPS),
            "step_profile": profile}


def sid_parse_ms(path) -> dict:
    """Host ms of the 768-wide list<float> column's parse (the rows
    stacked one by one in ``_parse_fg_encoded_dense``) per batch of
    SID_BATCH, beside the whole batch's parse."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.features.feature import (
        _parse_fg_encoded_dense,
    )
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    table = pq.read_table(path).slice(0, SID_PARSE_BATCHES * SID_BATCH)
    cfg = parse_pipeline_config(sid_text({"train": path, "eval": path}, "x",
                                         "rqvae"))
    from torcheasyrec_tpu_torch import main as port_main

    parser = DataParser(port_main._create_features(cfg), labels=["label"])
    col_ms, batch_ms = [], []
    for i in range(SID_PARSE_BATCHES):
        part = table.slice(i * SID_BATCH, SID_BATCH)
        cols = {c: part[c].combine_chunks() for c in part.column_names}
        t0 = time.perf_counter()
        _parse_fg_encoded_dense("item_emb", cols["item_emb"])
        col_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        parser.parse_to_batch(cols)
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    return {"list_column_parse_ms_median": float(np.median(col_ms)),
            "batch_parse_ms_median": float(np.median(batch_ms)),
            "batches": SID_PARSE_BATCHES, "rows_per_batch": SID_BATCH,
            "floats_per_row": SID_DIM}


def sid_tools(pred, tmp) -> dict:
    """Both SID CLIs through their argument parsers on the predicted
    ``codes`` table, writing CSV: the collision map (random strategy: the
    table has no candidate codes), the resolved groups, and the quality
    summary and layer statistics."""
    import dataclasses
    from unittest import mock

    import pyarrow.csv as pacsv

    from torcheasyrec_tpu_torch.tools.sid import (
        evaluate_sid_quality,
        resolve_sid_collisions,
    )

    book = ",".join(map(str, SID_CODEBOOK))
    out_dir = os.path.join(tmp, "sid_tools")
    t0 = time.perf_counter()
    res = resolve_sid_collisions.run(resolve_sid_collisions.build_parser()
                                     .parse_args([
        "--input_path", pred, "--codebook", book,
        "--max_items_per_codebook", "1", "--strategy", "random",
        "--writer_type", "CsvWriter",
        "--output_path", os.path.join(out_dir, "map"),
        "--resolved_sid_groups_output_path",
        os.path.join(out_dir, "resolved")]))
    resolve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with mock.patch.object(sys, "argv", [
            "evaluate_sid_quality", "--input_path", pred, "--codebook", book,
            "--writer_type", "CsvWriter", "--top_sids", "3",
            "--summary_output", os.path.join(out_dir, "summary"),
            "--layer_stats_output", os.path.join(out_dir, "layers")]):
        evaluate_sid_quality.main()
    quality_s = time.perf_counter() - t0
    read = {k: pacsv.read_csv(os.path.join(out_dir, k, "part-0.csv"))
            for k in ("map", "resolved", "summary", "layers")}
    if read["map"].num_rows != SID_EVAL_ITEMS:
        raise AssertionError(f"train_sid: {read['map'].num_rows} mapped items")
    summary = {c: read["summary"].column(c)[0].as_py()
               for c in read["summary"].column_names if c != "view"}
    return {"resolve_s": resolve_s, "quality_s": quality_s,
            "stats": dataclasses.asdict(res.stats),
            "resolved_groups": read["resolved"].num_rows,
            "quality": summary, "layer_rows": read["layers"].num_rows}


def sid_kmeans(paths, tmp) -> dict:
    """RQ-KMeans through ``train_and_evaluate`` on the card (the fit over
    SID_ITEMS samples timed); then the fit on SID_KMEANS_CHECK samples on
    the card against the CPU's from the same samples, the CPU's
    assignments replayed on the card: codebooks within SID_CARD_TOL of
    each one's max, the final codes equal."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.models.sid_models import SidRqkmeans

    src = write_text(os.path.join(tmp, "rqkmeans.config"), sid_text(
        paths, os.path.join(tmp, "rqkmeans"), "rqkmeans"))
    fit_s, orig = [], SidRqkmeans.on_train_end

    def timed_fit(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig(self)
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - t0)

    SidRqkmeans.on_train_end = timed_fit
    try:
        t0 = time.perf_counter()
        result = port_main.train_and_evaluate(src, device="cuda")
        train_s = time.perf_counter() - t0
    finally:
        SidRqkmeans.on_train_end = orig
    if len(fit_s) != 1:
        raise AssertionError("train_sid: the k-means fit did not run once")

    from torcheasyrec_tpu_torch.utils.config_util import load_pipeline_config

    cfg = load_pipeline_config(src)
    models = {side: port_main.build_model(cfg, dev)[0]
              for side, dev in (("cpu", "cpu"), ("card", "cuda"))}
    x = np.stack(pq.read_table(paths["train"], columns=["item_emb"]).column(
        "item_emb").combine_chunks().slice(0, SID_KMEANS_CHECK).to_numpy(
            zero_copy_only=False)).astype(np.float32)
    replay = CodeReplay(SID_TIE_GAP)
    codes = {}
    secs = {}
    with replay:
        for side, record in (("cpu", True), ("card", False)):
            m = models[side]
            m.collect(x)
            replay.start(record=record)
            t0 = time.perf_counter()
            m.on_train_end()
            torch.cuda.synchronize()
            secs[side] = time.perf_counter() - t0
            dev = m.rq.vq_0.codebook.device
            with torch.no_grad():
                _, c, _ = m.rq(torch.from_numpy(x).to(dev))
            codes[side] = c.cpu()
            replay.done()
    cmp = CpuComparison("train_sid rqkmeans", SID_CARD_TOL, 0.0)
    ref_sd, sd = models["cpu"].state_dict(), models["card"].state_dict()
    for k in ref_sd:
        cmp.compare(k, ref_sd[k], sd[k])
    if not torch.equal(codes["cpu"], codes["card"]):
        raise AssertionError("train_sid: the fitted codes differ")
    del models
    torch.cuda.empty_cache()
    return {"result": result, "train_and_evaluate_s": train_s,
            "fit_s_card": fit_s[0], "fit_samples": SID_ITEMS,
            "codebook": list(SID_CODEBOOK), "check_samples":
            SID_KMEANS_CHECK, "check_fit_s": secs,
            "codebook_max_rel_err": max(cmp.errs.values()),
            "assignment_ties_flipped": replay.flips,
            "worst_flip_gap_share": replay.worst,
            "argmins_replayed": len(replay.codes), "tol": SID_CARD_TOL}


def sid_deepfm_text(paths, model_dir, vocab, fp32=False) -> str:
    """criteo_synth deepfm.config at its published width read from CSV:
    int_0..int_11 through AutoDis (SID_AUTODIS_CHANNELS channels, dim
    16), int_12 through an MLP embedding (dim 16), SID_VOCAB_FEATURE's
    table sized by ``vocab``. ``fp32``: fp32 compute, adam's and rowwise
    adagrad's eps 1e-4 (``zoo_rest_text``'s reasons)."""
    from torcheasyrec_tpu_torch.benchmark.synthetic import CRITEO_BUCKETS

    i = int(SID_VOCAB_FEATURE.split("_")[1])
    replace = [(f'raw_feature {{ feature_name: "int_{j}" }}',
                f'raw_feature {{ feature_name: "int_{j}" embedding_dim: 16 '
                f"autodis {{ num_channels: {SID_AUTODIS_CHANNELS} }} }}")
               for j in range(12)]
    replace += [('raw_feature { feature_name: "int_12" }',
                 'raw_feature { feature_name: "int_12" embedding_dim: 16 '
                 "mlp {} }"),
                (f'feature_name: "{SID_VOCAB_FEATURE}" num_buckets: '
                 f"{CRITEO_BUCKETS[i]} ",
                 f'feature_name: "{SID_VOCAB_FEATURE}" vocab_file: "{vocab}" '),
                ("dataset_type: ParquetDataset",
                 "dataset_type: CsvDataset\n  with_header: true")]
    if fp32:
        replace += [('mixed_precision: "BF16"', ""),
                    ("adam_optimizer { lr: 0.001 }",
                     "adam_optimizer { lr: 0.001 eps: 1e-4 }"),
                    ("rowwise_adagrad_optimizer { lr: 0.01 }",
                     "rowwise_adagrad_optimizer { lr: 0.01 eps: 1e-4 }")]
    return criteo_text("deepfm", model_dir, paths, replace)


def sid_deepfm(tmp) -> dict:
    """criteo_synth DeepFM with dense embeddings, a vocab-file table and
    CSV input (``sid_deepfm_text``): 3 fp32 steps card against CPU
    (``zoo_rest_card_vs_cpu``); a BF16 epoch of SID_DEEPFM_STEPS through
    ``train_and_evaluate`` with kernel #3 once per written packed group
    and step, its AUC within SID_CPU_BOUND of a CPU run from the same
    weights; one resident step's row writes bit-equal to the plain
    version's; the CSV loader's examples/s beside the parquet loader's
    on the same rows."""
    import pyarrow.csv as pacsv
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.benchmark import synthetic
    from torcheasyrec_tpu_torch.benchmark.synthetic import CRITEO_BUCKETS
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    seconds = {}
    t0 = time.perf_counter()
    pq_paths = synthetic.ensure_dataset(os.path.join(tmp, "criteo"),
                                        *SID_DEEPFM_ROWS)
    cols = (["label"] + [f"int_{j}" for j in range(13)]
            + [f"cat_{j}" for j in range(26)])
    paths = {}
    for k in ("train", "eval"):
        paths[k] = os.path.join(tmp, f"criteo_{k}.csv")
        pacsv.write_csv(pq.read_table(pq_paths[k], columns=cols), paths[k])
    vocab = os.path.join(tmp, "vocab.txt")
    i = int(SID_VOCAB_FEATURE.split("_")[1])
    with open(vocab, "w") as f:
        f.writelines(f"v{j}\n" for j in range(CRITEO_BUCKETS[i]))
    seconds["data"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fp32_text = sid_deepfm_text(paths, os.path.join(tmp, "x"), vocab, True)
    check = zoo_rest_card_vs_cpu("train_sid deepfm", fp32_text,
                                 pq_paths["train"])
    seconds["card_vs_cpu"] = time.perf_counter() - t0

    model_dir = os.path.join(tmp, "deepfm_dense_emb")
    src = write_text(os.path.join(tmp, "deepfm_dense_emb.config"),
                     sid_deepfm_text(paths, model_dir, vocab))
    cfg = parse_pipeline_config(open(src).read())
    init = cpu_init(src, os.path.join(tmp, "deepfm_dense_emb_init.pt"))
    probe, _ = port_main.build_model(cfg, "cpu")
    eg = probe.embedding_group
    written = sorted(gk for gk, g in eg.engine.groups.items()
                     if g.packed and any(t.name not in g.dense_tables
                                         for t in g.specs))
    dense_emb = {k: type(v).__name__ for k, v in eg.dense_emb.items()}
    vocab_rows = eg.tables[f"{SID_VOCAB_FEATURE}_emb"].shape[0]
    del probe, eg
    if len(dense_emb) != 13 or vocab_rows != CRITEO_BUCKETS[i]:
        raise AssertionError(f"train_sid deepfm: {dense_emb}, {vocab_rows}")
    write_rows.launches = 0
    t0 = time.perf_counter()
    result = port_main.train_and_evaluate(src, fine_tune_checkpoint=init,
                                          device="cuda")
    torch.cuda.synchronize()
    seconds["train"] = time.perf_counter() - t0
    launches = write_rows.launches
    if (result["step"] != SID_DEEPFM_STEPS
            or launches != SID_DEEPFM_STEPS * len(written)):
        raise AssertionError(
            f"train_sid deepfm: {result['step']} steps, {launches} row "
            f"writes for the written packed groups {written}")
    t0 = time.perf_counter()
    cpu = port_main.train_and_evaluate(
        write_text(os.path.join(tmp, "deepfm_dense_emb_cpu.config"),
                   sid_deepfm_text(paths, model_dir + "_cpu", vocab)),
        fine_tune_checkpoint=init, device="cpu")
    seconds["train_cpu"] = time.perf_counter() - t0
    dist = result["auc"] - cpu["auc"]
    if not abs(dist) <= SID_CPU_BOUND:
        raise AssertionError(f"train_sid deepfm: auc {result['auc']} on the "
                             f"card is {dist:+.4f} from {cpu['auc']}")

    # one real step's row writes, the kernel against the plain version
    model, features, _, state, step = build_trainer(cfg)
    batch = parquet_batches(pq_paths["train"], features, 1, 4096)[0]
    calls = write_targets(model, step, state, batch.to("cuda"))
    check_step_writes("train_sid deepfm", calls)
    del model, state, step
    torch.cuda.empty_cache()

    # the loader alone from CSV and from parquet, the same rows
    loaders = {}
    for kind, path, c in (("csv", paths["train"], cfg),
                          ("parquet", pq_paths["train"], parse_pipeline_config(
                              open(src).read().replace(
                                  "dataset_type: CsvDataset\n  with_header: "
                                  "true", "dataset_type: ParquetDataset")))):
        dl = create_dataloader(c.data_config, port_main._create_features(c),
                               path, mode="train", device="cuda")
        loaders[kind] = loader_alone(dl, SID_LOADER_BATCHES)
    return {"card_vs_cpu": check, "result": result, "steps":
            SID_DEEPFM_STEPS, "row_write_launches": launches,
            "written_packed_groups": written, "dense_embeddings": dense_emb,
            "autodis_channels_assumed": SID_AUTODIS_CHANNELS,
            "vocab_file_rows": vocab_rows,
            "cpu_reference": {"auc": cpu["auc"], "card_minus_cpu": dist,
                              "bound": SID_CPU_BOUND},
            "step_writes_bit_equal": len(calls),
            "loader_alone": loaders, "seconds": seconds}


def phase_train_sid(smi):
    """Semantic-ID generation (TIGER's RQ-VAE and RQ-KMeans on synthetic
    768-d item vectors), the SID tools, and criteo_synth DeepFM with
    dense embeddings, a vocab file and CSV input. Returns kernel #3's
    launches of the DeepFM's ``train_and_evaluate``."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.utils.config_util import load_pipeline_config

    out, seconds = {"phase": "train_sid", "nvidia_smi": smi}, {}

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        seconds[key] = time.perf_counter() - t0
        return res

    with tempfile.TemporaryDirectory() as tmp:
        paths = {"train": os.path.join(tmp, "sid_train.parquet"),
                 "eval": os.path.join(tmp, "sid_eval.parquet")}
        t0 = time.perf_counter()
        sid_items(paths["train"], SID_ITEMS, SEED + 1)
        sid_items(paths["eval"], SID_EVAL_ITEMS, SEED + 2)
        seconds["data"] = time.perf_counter() - t0
        model_dir = os.path.join(tmp, "rqvae")
        src = write_text(os.path.join(tmp, "rqvae.config"),
                         sid_text(paths, model_dir, "rqvae"))
        cfg = load_pipeline_config(src)
        features = port_main._create_features(cfg)
        batches = parquet_batches(paths["train"], features, SID_CHECK_STEPS,
                                  SID_BATCH)
        out["card_vs_cpu"] = timed("card_vs_cpu", sid_card_vs_cpu, cfg,
                                   batches)
        emit({"phase": "train_sid_card_vs_cpu", **out["card_vs_cpu"]})

        # an epoch on the card from CPU-drawn weights, against the CPU
        init = cpu_init(src, os.path.join(tmp, "rqvae_init.pt"))
        t0 = time.perf_counter()
        with step_clock(port_main) as stamps:
            result = port_main.train_and_evaluate(
                src, fine_tune_checkpoint=init, device="cuda")
        seconds["train"] = time.perf_counter() - t0
        loader_fed = epoch_steps(stamps)
        loader_fed["examples_per_s"] = (SID_BATCH / loader_fed[
            "window_step_ms"] * 1e3)
        t0 = time.perf_counter()
        cpu = port_main.train_and_evaluate(
            write_text(os.path.join(tmp, "rqvae_cpu.config"),
                       sid_text(paths, model_dir + "_cpu", "rqvae")),
            fine_tune_checkpoint=init, device="cpu")
        seconds["train_cpu"] = time.perf_counter() - t0
        dists = {}
        for k in ("unique_ratio", "rel_loss"):
            dists[k] = result[k] - cpu[k]
            if not abs(dists[k]) <= SID_CPU_BOUND:
                raise AssertionError(f"train_sid: {k} {result[k]} on the card"
                                     f" is {dists[k]:+.4f} from {cpu[k]}")
        cfg_path = os.path.join(model_dir, "pipeline.config")
        again = timed("evaluate", port_main.evaluate, cfg_path, None, None,
                      "eval_result.txt", "cuda")
        for k in ("unique_ratio", "rel_loss"):
            if again[k] != result[k]:
                raise AssertionError(f"train_sid: evaluate() {k} {again[k]}"
                                     f" against {result[k]}")
        pred = os.path.join(tmp, "sid_pred.parquet")
        n_pred = timed("predict", port_main.predict_checkpoint, cfg_path,
                       paths["eval"], pred, None, "item_id", None, None,
                       "cuda")
        tools = timed("tools", sid_tools, pred, tmp)
        q = tools["quality"]
        if q["unique_sid"] / q["total"] != result["unique_ratio"]:
            raise AssertionError(
                f"train_sid: the quality tool's unique share "
                f"{q['unique_sid']} / {q['total']} against the eval's "
                f"unique_ratio {result['unique_ratio']}")
        out["train"] = {
            "result": result, "predict_rows": n_pred,
            "cpu_reference": {**{k: cpu[k] for k in dists},
                              "card_minus_cpu": dists,
                              "bound": SID_CPU_BOUND},
            "loader_fed_step": loader_fed, "tools": tools}
        emit({"phase": "train_sid_rqvae", **out["train"]})
        out["resident"] = timed("resident", sid_resident, cfg, batches[0])
        out["parse"] = timed("parse", sid_parse_ms, paths["train"])
        out["kmeans"] = timed("kmeans", sid_kmeans, paths, tmp)
        emit({"phase": "train_sid_rqkmeans", **out["kmeans"]})
        out["deepfm"] = timed("deepfm", sid_deepfm, tmp)
    out["seconds"] = seconds
    r, d = out["resident"], out["deepfm"]
    out["summary"] = {
        "rqvae_card_vs_cpu_max_rel_err": out["card_vs_cpu"]["max_rel_err"],
        "code_ties_flipped": out["card_vs_cpu"]["code_ties_flipped"],
        "unique_ratio": result["unique_ratio"], "rel_loss":
        result["rel_loss"], "card_minus_cpu": dists,
        "step_ms": r["step_ms_median"], "examples_per_s":
        r["examples_per_s"], "idle_share": r["idle_share_profiled_steps"],
        "list_column_parse_ms": out["parse"]["list_column_parse_ms_median"],
        "kmeans_fit_s_card": out["kmeans"]["fit_s_card"],
        "kmeans_codebook_max_rel_err": out["kmeans"]["codebook_max_rel_err"],
        "deepfm_card_vs_cpu_max_rel_err": d["card_vs_cpu"]["max_rel_err"],
        "deepfm_auc": d["result"]["auc"],
        "deepfm_auc_card_minus_cpu": d["cpu_reference"]["card_minus_cpu"],
        "csv_loader_examples_per_s": d["loader_alone"]["csv"][
            "examples_per_s"],
        "parquet_loader_examples_per_s": d["loader_alone"]["parquet"][
            "examples_per_s"],
        "row_write_launches": d["row_write_launches"]}
    emit(out)
    return d["row_write_launches"]



# --- phase train_fg: feature generation from raw columns ----------------------
# loader batches of DEEPFM_BATCH in the raw file: LOADER_WARMUP,
# FG_FED_STEPS and FG_PROFILED_STEPS of the loader-fed run
FG_CRITEO_BATCHES = 14
FG_PARSE_BATCHES = 3  # batches each FG path's host time is the median of
FG_FED_STEPS = 4  # the 4-worker loader-fed window, after LOADER_WARMUP
FG_PROFILED_STEPS = 5
FG_RESIDENT_STEPS = 10
FG_CHECK_CAP = 100_000  # the fp32 card-against-CPU check's tables
FG_CPU_BOUND = 0.02  # the epoch's AUC against a CPU run's
FG_DIN_BATCH = 4096
FG_DIN_STEPS = 8
FG_DIN_EVAL_ROWS = 8192
FG_DIN_EMB = 16  # assumed widths: no published config of this shape
FG_DIN_HIDDEN = (128, 64)
FG_REQUESTS = 8
FG_REQUEST_ITEMS = 512  # candidate items of one user a request
FG_LOG10 = "method=log10,threshold=1e-10,default=-10"


def fg_criteo_text(buckets, model_dir="unused", train_path="unused",
                   fg=True, fp32=False, threads=1, workers=0) -> str:
    """The Criteo DeepFM of ``deepfm_config_text`` fed raw columns
    (``fg``): cat_i hashes the 8-hex-digit string column C{i+1} into
    ``buckets[i]`` rows; int_i reads the numeric string column I{i+1}
    through the log10 normalizer. Without ``fg`` it reads the encoded
    cat_i / int_i columns (FG_NONE). ``fp32``: fp32 compute, adam's and
    rowwise adagrad's eps 1e-4 (``zoo_rest_text``'s reasons)."""
    extra = f"  fg_threads: {threads}"
    if workers:
        extra += f"\n  num_workers: {workers}"
    text = deepfm_config_text(buckets, model_dir, train_path,
                              mixed_precision="FP32" if fp32 else "BF16",
                              data_extra=extra)
    if fp32:
        text = (text.replace('  mixed_precision: "FP32"\n', "")
                .replace("adam_optimizer { lr: 0.001 }",
                         "adam_optimizer { lr: 0.001 eps: 1e-4 }")
                .replace("rowwise_adagrad_optimizer { lr: 0.001 }",
                         "rowwise_adagrad_optimizer { lr: 0.001 eps: 1e-4 }"))
    if not fg:
        return text
    text = text.replace("fg_mode: FG_NONE", "fg_mode: FG_NORMAL")
    for i, n in enumerate(buckets):
        text = text.replace(
            f'feature_name: "cat_{i}" num_buckets: {n} ',
            f'feature_name: "cat_{i}" expression: "item:C{i + 1}" '
            f"hash_bucket_size: {n} ")
    for i in range(13):
        text = text.replace(
            f'raw_feature {{ feature_name: "int_{i}" }}',
            f'raw_feature {{ feature_name: "int_{i}" expression: '
            f'"item:I{i + 1}" normalizer: "{FG_LOG10}" }}')
    return text


def fg_criteo_cols(n: int, seed: int) -> dict:
    """Raw Criteo-log columns: C1..C26 as 8-hex-digit strings (Criteo's
    hashed categories, some empty), I1..I13 as non-negative integer
    strings (some empty) and a coin ``label``."""
    import pyarrow as pa
    import pyarrow.compute as pc

    r = np.random.default_rng(seed)
    cols = {"label": pa.array((r.random(n) > 0.5).astype(np.float32))}
    for i in range(13):
        v = pa.array(np.floor(r.lognormal(1.5, 1.8, n)).astype(np.int64))
        s = v.cast(pa.string())
        cols[f"I{i + 1}"] = pc.if_else(
            pa.array(r.random(n) < 0.05), "", s)
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    shifts = np.arange(28, -1, -4, dtype=np.uint64)
    for i, b in enumerate(CRITEO_RAW):
        ids = r.integers(0, min(b, 1 << 32), n).astype(np.uint64)
        data = digits[(ids[:, None] >> shifts) & np.uint64(15)]
        keep = r.random(n) >= 0.02  # the others are empty cells
        lengths = np.where(keep, 8, 0)
        offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
        cols[f"C{i + 1}"] = pa.StringArray.from_buffers(
            n, pa.py_buffer(offsets), pa.py_buffer(data[keep].tobytes()))
    return cols


def fg_parsed_equal(name, got: dict, ref: dict) -> int:
    """Every feature's parse in ``got`` equals ``ref``'s bit for bit;
    returns the features compared."""
    if set(got) != set(ref):
        raise AssertionError(f"{name}: parsed {sorted(got)} against "
                             f"{sorted(ref)}")
    for k, r in ref.items():
        g = got[k]
        for field in ("values", "lengths", "weights", "seq_lengths"):
            a, b = getattr(g, field, None), getattr(r, field, None)
            if (a is None) != (b is None) or (
                    a is not None and not (a.shape == b.shape
                                           and a.dtype == b.dtype
                                           and np.array_equal(a, b))):
                raise AssertionError(f"{name}: {k}.{field} differs between "
                                     "the DAG's parse and the plain one")
    return len(ref)


def fg_host_ms(features, cols_list, threads=(1, 4)) -> dict:
    """Host ms per batch of FG (the medians over ``cols_list``): through
    the native DAG at each of ``threads`` (``DataParser.parse``, the
    DAG's features in one C++ call and the others' Python parses) and
    through the plain per-feature parses; each DAG batch held against
    the plain one bit for bit; the DAG's hand-backs."""
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser

    out, dags = {}, {}
    plain_ms, plain = [], []
    for cols in cols_list:
        t0 = time.perf_counter()
        plain.append({f.name: f.parse(cols) for f in features})
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    out["plain_ms"] = float(np.median(plain_ms))
    for t in threads:
        parser = DataParser(features, labels=["label"], fg_threads=t)
        ms = []
        for cols, ref in zip(cols_list, plain):
            t0 = time.perf_counter()
            got = parser.parse(cols)
            ms.append((time.perf_counter() - t0) * 1e3)
            fg_parsed_equal(f"fg_threads {t}",
                            {k: v for k, v in got.items() if k in ref}, ref)
        out[f"dag_ms_threads_{t}"] = float(np.median(ms))
        dags[t] = parser.fg_dag
    dag = dags[threads[0]]
    out.update(dag_features=len(dag.native), features=len(features),
               dag_handbacks=dict(dag.handbacks), dag_routed=dict(dag.routed),
               batches=len(cols_list),
               rows_per_batch=len(next(iter(cols_list[0].values()))),
               dag_equals_plain="bit for bit")
    return out


def fg_written_groups(model) -> list:
    eg = model.embedding_group
    return sorted(gk for gk, g in eg.engine.groups.items()
                  if g.packed and any(t.name not in g.dense_tables
                                      for t in g.specs))


def fg_criteo(tmp) -> dict:
    """(a): the Criteo DeepFM fed raw columns at full width (tables capped
    at CRITEO_CAP, BF16): FG's host ms per batch (DAG at 1 and 4 threads,
    plain), the loader alone with FG and with FG_NONE on the same rows,
    the loader-fed step over LOADER_WORKERS workers with its idle share
    against the resident step, kernel #3 once per written packed group
    and step; 3 fp32 steps on the card against the CPU at FG_CHECK_CAP
    tables."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.datasets.dataset import create_dataloader
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    seconds, out = {}, {"batch": DEEPFM_BATCH, "capped_at": CRITEO_CAP}
    capped = [min(n, CRITEO_CAP) for n in CRITEO_RAW]
    t0 = time.perf_counter()
    raw = fg_criteo_cols(FG_CRITEO_BATCHES * DEEPFM_BATCH, 31)
    cfg = parse_pipeline_config(fg_criteo_text(capped))
    features = port_main._create_features(cfg)
    # the encoded columns of the same rows, for the FG_NONE loader
    parsed = DataParser(features).parse(raw)
    enc = dict(raw)
    for i in range(26):
        # an empty C cell has no id: a null in the encoded column
        p = parsed[f"cat_{i}"]
        ids = np.zeros(len(p.lengths), np.int64)
        ids[p.lengths == 1] = p.values
        enc[f"cat_{i}"] = pa.array(ids, mask=p.lengths == 0)
    for i in range(13):
        enc[f"int_{i}"] = pa.array(parsed[f"int_{i}"].values[:, 0])
    path = os.path.join(tmp, "criteo_raw.parquet")
    pq.write_table(pa.table(enc), path, row_group_size=DEEPFM_BATCH)
    seconds["data"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    table = pq.read_table(path)
    batches = [{c: table[c].slice(i * DEEPFM_BATCH, DEEPFM_BATCH)
                .combine_chunks() for c in table.column_names}
               for i in range(FG_PARSE_BATCHES)]
    out["host_ms_per_batch"] = fg_host_ms(features, batches)
    seconds["host_ms"] = time.perf_counter() - t0

    # the loader alone: FG and FG_NONE (the same rows, encoded)
    t0 = time.perf_counter()
    none_cfg = parse_pipeline_config(fg_criteo_text(capped, fg=False))
    out["loader_alone"] = {}
    for kind, c in (("fg", cfg), ("fg_none", none_cfg)):
        dl = create_dataloader(c.data_config, port_main._create_features(c),
                               path, mode="train", device="cuda")
        out["loader_alone"][kind] = loader_alone(dl, FG_CRITEO_BATCHES)
    seconds["loader_alone"] = time.perf_counter() - t0

    # the loader-fed step over worker processes, and the resident step;
    # the workers start up while the model is built
    t0 = time.perf_counter()
    wcfg = parse_pipeline_config(fg_criteo_text(capped, workers=LOADER_WORKERS))
    dl = create_dataloader(wcfg.data_config, features, path, mode="train",
                           device="cuda")
    if dl.mp_workers != LOADER_WORKERS:
        raise AssertionError(f"train_fg: {dl.mp_workers} loader workers")
    it = dl()
    model, _, _, state, step = build_trainer(cfg)
    written = fg_written_groups(model)
    write_rows.launches = 0
    steps = [0]

    def run(n):
        nonlocal state
        last = None
        for b, _ in itertools.islice(it, n):
            state, _ = step(state, b)
            steps[0] += 1
            last = b
        return last

    try:
        resident = run(LOADER_WARMUP)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        run(FG_FED_STEPS)
        torch.cuda.synchronize()
        fed_ms = (time.perf_counter() - w0) * 1e3 / FG_FED_STEPS
        profile = profile_forward(lambda: run(FG_PROFILED_STEPS))
    finally:
        it.close()
    losses, res_ms, res_window = timed_steps(
        step, state, resident, DEEPFM_WARMUP, FG_RESIDENT_STEPS)
    steps[0] += DEEPFM_WARMUP + 2 * FG_RESIDENT_STEPS
    launches = write_rows.launches
    if steps[0] != FG_CRITEO_BATCHES + DEEPFM_WARMUP + 2 * FG_RESIDENT_STEPS:
        raise AssertionError(f"train_fg: {steps[0]} steps")
    if launches != steps[0] * len(written) or not written:
        raise AssertionError(f"train_fg: row_write launched {launches} times"
                             f" in {steps[0]} steps of {written}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"train_fg: non-finite losses {losses}")
    out["loader_fed_4_workers"] = {
        "window_step_ms": fed_ms,
        "examples_per_s": DEEPFM_BATCH / fed_ms * 1e3,
        "idle_share_profiled_steps": profile.get("device_idle_share"),
        "busy_ms_per_step": (profile.get("device_busy_ms", 0.0)
                             / FG_PROFILED_STEPS),
        "step_profile": profile}
    out["resident"] = {"step_ms_median": float(np.median(res_ms)),
                       "step_ms_range": [min(res_ms), max(res_ms)],
                       "window_step_ms": res_window,
                       "examples_per_s": DEEPFM_BATCH / res_window * 1e3}
    out["row_write"] = {"launches": launches, "steps": steps[0],
                        "written_packed_groups": written}
    del model, state, step, dl, resident
    torch.cuda.empty_cache()
    seconds["fed_and_resident"] = time.perf_counter() - t0

    # 3 fp32 steps on the card against the CPU, at FG_CHECK_CAP tables
    t0 = time.perf_counter()
    check_caps = [min(n, FG_CHECK_CAP) for n in CRITEO_RAW]
    text = fg_criteo_text(check_caps, fp32=True)
    cparser = DataParser(port_main._create_features(
        parse_pipeline_config(text)), labels=["label"])
    out["card_vs_cpu"] = zoo_rest_card_vs_cpu(
        "train_fg criteo", text, None,
        [cparser.parse_to_batch(b) for b in batches])
    out["card_vs_cpu"]["tables_capped_at"] = FG_CHECK_CAP
    seconds["card_vs_cpu"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out, launches


def fg_din_files(tmp) -> dict:
    import pyarrow as pa
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.benchmark import fg_synth

    paths = {"vocab": fg_synth.write_city_vocab(os.path.join(tmp, "v.txt")),
             "spm": fg_synth.write_spm_model(os.path.join(tmp, "s.model"))}
    for name, n, seed, per_user in (
            ("train", FG_DIN_STEPS * FG_DIN_BATCH, 41, 1),
            ("eval", FG_DIN_EVAL_ROWS, 42, 1),
            ("req", FG_REQUESTS * FG_REQUEST_ITEMS, 43, FG_REQUEST_ITEMS)):
        paths[name] = os.path.join(tmp, f"fg_{name}.parquet")
        pq.write_table(pa.table(fg_synth.fg_raw_cols(
            n, seed, rows_per_user=per_user)), paths[name])
    return paths


def fg_din_text(paths, model_dir, fp32_eps=False) -> str:
    from torcheasyrec_tpu_torch.benchmark import fg_synth

    text = fg_synth.fg_din_config_text(
        paths["train"], paths["eval"], model_dir, paths["vocab"],
        paths["spm"], FG_DIN_BATCH, emb=FG_DIN_EMB, hidden=FG_DIN_HIDDEN)
    if fp32_eps:
        text = (text.replace("adam_optimizer { lr: 0.002 }",
                             "adam_optimizer { lr: 0.002 eps: 1e-4 }")
                .replace("rowwise_adagrad_optimizer { lr: 0.02 }",
                         "rowwise_adagrad_optimizer { lr: 0.02 eps: 1e-4 }"))
    return text


def fg_kind_ms(features, cols) -> dict:
    """Host ms of each feature kind's parses on one batch (Python parse of
    each feature, summed by class), and the parser's whole batch."""
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser

    by_kind, names = {}, {}
    parsed = {}
    for f in features:
        if type(f).__name__ == "CombineFeature":
            continue
        t0 = time.perf_counter()
        parsed[f.name] = f.parse(cols)
        ms = (time.perf_counter() - t0) * 1e3
        kind = type(f).__name__
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        names.setdefault(kind, []).append(f.name)
    for f in features:
        if type(f).__name__ == "CombineFeature":
            t0 = time.perf_counter()
            parsed[f.name] = f.combine(parsed)
            by_kind["CombineFeature"] = (by_kind.get("CombineFeature", 0.0)
                                         + (time.perf_counter() - t0) * 1e3)
            names.setdefault("CombineFeature", []).append(f.name)
    parser = DataParser(features, labels=["label"])
    t0 = time.perf_counter()
    got = parser.parse(cols)
    dag_ms = (time.perf_counter() - t0) * 1e3
    n = fg_parsed_equal("train_fg din", {k: got[k] for k in parsed}, parsed)
    return {"plain_ms_by_kind": by_kind, "features_by_kind": names,
            "plain_ms": sum(by_kind.values()), "dag_batch_ms": dag_ms,
            "dag_features": sorted(f.name for f in parser.fg_dag.native),
            "dag_handbacks": dict(parser.fg_dag.handbacks),
            "dag_routed": dict(parser.fg_dag.routed),
            "features_compared_bit_for_bit": n,
            "rows": len(cols["label"])}


def fg_requests(port_main, export_dir, paths) -> dict:
    """(c): ``predict`` of the artifact on FG_REQUESTS requests of one user
    and FG_REQUEST_ITEMS items, with INPUT_TILE=2 and without: bit-equal
    outputs; then each request alone through the artifact's model
    (parse, copy, forward), timed, tiled and untiled (bit-equal), with
    the user-side features' rows recorded: one a request with tiling."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.features import feature as feature_mod
    from torcheasyrec_tpu_torch.utils import checkpoint_util, config_util

    outs = {}
    for tile in ("", "2"):
        os.environ["INPUT_TILE"] = tile
        out = os.path.join(os.path.dirname(export_dir), f"pred{tile}.parquet")
        n = port_main.predict(paths["req"], out, export_dir,
                              batch_size=FG_REQUEST_ITEMS, device="cuda")
        if n != FG_REQUESTS * FG_REQUEST_ITEMS:
            raise AssertionError(f"train_fg: predicted {n} rows")
        outs[tile] = pq.read_table(out)
    os.environ.pop("INPUT_TILE")
    for k in outs[""].column_names:
        if not np.array_equal(np.asarray(outs["2"][k]),
                              np.asarray(outs[""][k])):
            raise AssertionError(f"train_fg: INPUT_TILE's {k} differs")

    cfg = config_util.load_pipeline_config(
        os.path.join(export_dir, "pipeline.config"))
    model, features = port_main._artifact_model(cfg, torch.device("cuda"))
    checkpoint_util.restore_model(os.path.join(export_dir, "model"), model)
    table = pq.read_table(paths["req"])
    user_side = sorted(f.name for f in features if f.is_user_side)
    seen = []
    real_parse = feature_mod.BaseFeature.parse

    def recording(self, data, is_training=False):
        if self.is_user_side:
            seen.append(len(data[self.inputs[0]]))
        return real_parse(self, data, is_training)

    times, untiled = {}, []
    feature_mod.BaseFeature.parse = recording
    try:
        for tile in (False, True):
            parser = DataParser(features, input_tile=tile)
            ms, seen[:] = [], []
            for i in range(FG_REQUESTS):
                part = table.slice(i * FG_REQUEST_ITEMS, FG_REQUEST_ITEMS)
                cols = {c: part[c].combine_chunks()
                        for c in part.column_names}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.inference_mode():
                    probs = model(parser.parse_to_batch(cols).to("cuda"))[
                        "probs"]
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if not tile:
                    untiled.append(probs.cpu())
                elif not torch.equal(probs.cpu(), untiled[i]):
                    raise AssertionError("train_fg: a tiled request's probs "
                                         "differ from the untiled ones")
            if tile and seen != [1] * (FG_REQUESTS * len(user_side)):
                raise AssertionError(f"train_fg: tiled requests parsed the "
                                     f"user-side features over rows {seen}")
            times["tiled" if tile else "untiled"] = {
                "request_ms_median": float(np.median(ms)),
                "request_ms_range": [min(ms), max(ms)]}
    finally:
        feature_mod.BaseFeature.parse = real_parse
    del model
    torch.cuda.empty_cache()
    return {"requests": FG_REQUESTS, "items_per_request": FG_REQUEST_ITEMS,
            "user_side_features": user_side,
            "user_side_rows_parsed_per_request": 1,
            "predict_tiled_equals_untiled": "bit for bit", **times}


def fg_din(tmp) -> tuple:
    """(b) and (c): the MultiTowerDIN with every feature kind
    (``benchmark/fg_synth.py``) at FG_DIN_EMB / FG_DIN_HIDDEN, fp32:
    each kind's host ms; 3 steps on the card against the CPU (1e-4);
    FG_DIN_STEPS steps of FG_DIN_BATCH through ``train_and_evaluate``
    with kernel #3 once per written packed group and step, the AUC within
    FG_CPU_BOUND of a CPU run from the same weights; export, INPUT_TILE
    serving (``fg_requests``) and the artifact's fg.json against
    ``tools/create_fg_json``'s."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.benchmark import fg_synth
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.tools.create_fg_json import write_fg_json
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    seconds, out = {}, {"batch": FG_DIN_BATCH, "steps": FG_DIN_STEPS,
                        "embedding_dim": FG_DIN_EMB,
                        "hidden_units": list(FG_DIN_HIDDEN)}
    t0 = time.perf_counter()
    fg_synth.register_fg_ops()
    paths = fg_din_files(tmp)
    seconds["data"] = time.perf_counter() - t0
    model_dir = os.path.join(tmp, "fg_din")
    src = write_text(os.path.join(tmp, "fg_din.config"),
                     fg_din_text(paths, model_dir))
    cfg = parse_pipeline_config(open(src).read())
    features = port_main._create_features(cfg)
    out["feature_kinds"] = sorted({type(f).__name__ for f in features})
    if len(out["feature_kinds"]) != 12:
        raise AssertionError(f"train_fg: kinds {out['feature_kinds']}")
    table = pq.read_table(paths["train"])
    cols_list = [{c: table[c].slice(i * FG_DIN_BATCH, FG_DIN_BATCH)
                  .combine_chunks() for c in table.column_names}
                 for i in range(3)]
    t0 = time.perf_counter()
    out["host_ms"] = fg_kind_ms(features, cols_list[0])
    seconds["host_ms"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    text = fg_din_text(paths, "unused", fp32_eps=True)
    parser = DataParser(port_main._create_features(
        parse_pipeline_config(text)), labels=["label"])
    out["card_vs_cpu"] = zoo_rest_card_vs_cpu(
        "train_fg din", text, None,
        [parser.parse_to_batch(c) for c in cols_list])
    seconds["card_vs_cpu"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    init = cpu_init(src, os.path.join(tmp, "fg_din_init.pt"))
    probe, _ = port_main.build_model(cfg, "cpu")
    written = fg_written_groups(probe)
    del probe
    write_rows.launches = 0
    result = port_main.train_and_evaluate(src, fine_tune_checkpoint=init,
                                          device="cuda")
    torch.cuda.synchronize()
    launches = write_rows.launches
    seconds["train"] = time.perf_counter() - t0
    if (result["step"] != FG_DIN_STEPS or not written
            or launches != FG_DIN_STEPS * len(written)):
        raise AssertionError(f"train_fg din: {result['step']} steps, "
                             f"{launches} row writes for {written}")
    t0 = time.perf_counter()
    cpu = port_main.train_and_evaluate(
        write_text(os.path.join(tmp, "fg_din_cpu.config"),
                   fg_din_text(paths, model_dir + "_cpu")),
        fine_tune_checkpoint=init, device="cpu")
    seconds["train_cpu"] = time.perf_counter() - t0
    dist = result["auc"] - cpu["auc"]
    if not abs(dist) <= FG_CPU_BOUND:
        raise AssertionError(f"train_fg din: auc {result['auc']} on the card"
                             f" is {dist:+.4f} from {cpu['auc']}")
    out["train"] = {"result": result, "row_write_launches": launches,
                    "written_packed_groups": written,
                    "cpu_reference": {"auc": cpu["auc"],
                                      "card_minus_cpu": dist,
                                      "bound": FG_CPU_BOUND}}

    t0 = time.perf_counter()
    export_dir = os.path.join(tmp, "fg_din_export")
    port_main.export(os.path.join(model_dir, "pipeline.config"), export_dir,
                     device="cuda")
    seconds["export"] = time.perf_counter() - t0
    with open(os.path.join(export_dir, "fg.json")) as a, open(write_fg_json(
            src, os.path.join(tmp, "fg_tool"))) as b:
        if json.load(a) != json.load(b):
            raise AssertionError("train_fg: the artifact's fg.json is not "
                                 "tools/create_fg_json's")
    out["fg_json_equals_tool"] = True
    t0 = time.perf_counter()
    out["input_tile"] = fg_requests(port_main, export_dir, paths)
    seconds["input_tile"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out, launches


def phase_train_fg(smi):
    """Feature generation from raw columns: the Criteo DeepFM at full
    width fed raw log columns (``fg_criteo``), and a MultiTowerDIN with
    every feature kind, its export and INPUT_TILE serving (``fg_din``).
    Returns kernel #3's launches."""
    from torcheasyrec_tpu_torch import fg

    t0 = time.perf_counter()
    lib = fg.build()
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        criteo, criteo_launches = fg_criteo(tmp)
        emit({"phase": "train_fg_criteo", "nvidia_smi": smi, **criteo})
        din, din_launches = fg_din(tmp)
        emit({"phase": "train_fg_din", "nvidia_smi": smi, **din})
    h = criteo["host_ms_per_batch"]
    la = criteo["loader_alone"]
    emit({"phase": "train_fg", "nvidia_smi": smi,
          "fg_library": os.path.basename(lib), "fg_build_s": build_s,
          "summary": {
              "criteo_fg_host_ms_per_8192_rows": {
                  k: h[k] for k in ("dag_ms_threads_1", "dag_ms_threads_4",
                                    "plain_ms")},
              "criteo_dag_handbacks": h["dag_handbacks"],
              "criteo_loader_examples_per_s": {
                  k: v["examples_per_s"] for k, v in la.items()},
              "criteo_loader_fed_4_workers_step_ms":
                  criteo["loader_fed_4_workers"]["window_step_ms"],
              "criteo_resident_step_ms": criteo["resident"]["window_step_ms"],
              "criteo_idle_share_loader_fed":
                  criteo["loader_fed_4_workers"]["idle_share_profiled_steps"],
              "criteo_card_vs_cpu_max_rel_err":
                  criteo["card_vs_cpu"]["max_rel_err"],
              "din_host_ms_by_kind": din["host_ms"]["plain_ms_by_kind"],
              "din_card_vs_cpu_max_rel_err": din["card_vs_cpu"]["max_rel_err"],
              "din_auc": din["train"]["result"]["auc"],
              "din_auc_card_minus_cpu":
                  din["train"]["cpu_reference"]["card_minus_cpu"],
              "request_ms_median": {
                  k: din["input_tile"][k]["request_ms_median"]
                  for k in ("tiled", "untiled")},
              "row_write_launches": criteo_launches + din_launches}})
    return criteo_launches + din_launches


# --- phase train_zch_ranks: ZCH and dynamic embeddings over two ranks ------

ZR_SLOTS = 1 << 20  # each dynamicemb table's capacity: 1 048 576 slots
ZR_FEATURES = ("cat_0", "cat_9", "cat_20", "cat_21")  # 100 000 ids each
ZR_STEPS = 3
ZR_BATCH = 4096  # the global batch: 2 048 rows a rank
ZR_EVAL_ROWS = 2 * ZR_BATCH
ZR_TOL = LAYOUT_TOL  # tables against the row-blocked one-rank run
ZR_EVAL_TOL = 1e-4  # AUC at world size 1 against 2 (BF16 at another shape)
ZR_TIMED_STEPS = 3
ZR_PROBE_WAVES = 40


def zr_text(paths, model_dir) -> str:
    """criteo_synth DeepFM with ``ZR_FEATURES`` as dynamicemb tables of
    ``ZR_SLOTS`` slots (the spill tier on), kept ``row_wise`` (packed:
    kernel #3 writes their rows); the planner lays out the rest."""
    spec = (f'dynamicemb {{ max_capacity: {ZR_SLOTS} score_strategy: "STEP" '
            '} embedding_constraints { sharding_types: "row_wise" }')
    return criteo_text("deepfm", model_dir, paths, replace=[
        (f'feature_name: "{f}" num_buckets: 100000 ',
         f'feature_name: "{f}" {spec} ') for f in ZR_FEATURES])


def zr_zch_numpy(model) -> dict:
    return {f"{t}.{k}": v.cpu().numpy().copy() for t, st in
            model.embedding_group.zch_states().items() for k, v in st.items()}


def zr_restore_probe(shard) -> dict:
    """A dynamicemb table of 8 slots, ``row_wise`` and packed, over the
    ranks on the card: key A admitted and its row written, flooded out
    (stored by the rank that holds its slot), readmitted (its row sent
    to the rank that holds its new slot, written by kernel #3) and read
    back. Each rank's view."""
    from google.protobuf import text_format

    from torcheasyrec_tpu_torch.datasets.utils import Batch, SparseField
    from torcheasyrec_tpu_torch.features import create_features
    from torcheasyrec_tpu_torch.modules.embedding import EmbeddingGroup
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.protos import feature_pb2, model_pb2

    dim, key = 8, 777_001
    feats = create_features([text_format.Parse(
        f"id_feature {{ feature_name: 'dyn' embedding_dim: {dim} "
        "dynamicemb { max_capacity: 8 score_strategy: 'LFU' } }",
        feature_pb2.FeatureConfig())])
    mc = text_format.Parse('feature_groups { group_name: "deep" '
                           'feature_names: "dyn" group_type: DEEP }',
                           model_pb2.ModelConfig())
    eg = EmbeddingGroup(feats, list(mc.feature_groups),
                        torch.Generator(device=shard.device), shard=shard,
                        plan={"dyn_emb": "row_wise"})
    eng = eg.engine
    gk, off, _ = eng.table_rows("dyn_emb")
    g = eng.groups[gk]
    sent = []

    def step(ids, i):
        ids = torch.tensor(ids, dtype=torch.int32)
        per = ids.shape[0] // shard.world
        mine = ids[shard.rank * per:(shard.rank + 1) * per]
        batch = Batch(sparse_features={"dyn": SparseField(
            mine[:, None].to(shard.device))})
        nb, sp = eg.remap_zch(batch, i, True, collect_spill=True)
        got = eg.spill_step(eg.gather_spill_rows(sp))
        sent.extend(int(s) for r in got.values() for s in r[0])
        return eg._global_ids([nb.sparse_features["dyn"].values],
                              shard)[0][0]

    def anywhere(flag) -> bool:
        return any(int(f) for f in shard.all_gather_list(
            torch.tensor([int(flag)])))

    v = torch.linspace(3.0, 4.0, dim)
    slot = int(step([key] * 8, 1)[0])
    eng.write_logical_rows(eg.engine_tables()[gk], g,
                           torch.tensor([off + slot]), v[None])
    store, i, held = eg.spill.stores["dyn_emb"], 2, None
    for wave in range(ZR_PROBE_WAVES):
        for _ in range(3):
            step([5000 + 16 * wave + j for j in range(16)], i)
            i += 1
        if anywhere(key in store):
            held = store.get(key) if key in store else None
            break
    launches = write_rows.launches
    new_slot = -1
    for _ in range(30):
        s = int(step([key] * 8, i)[0])
        i += 1
        if not anywhere(key in store) and s >= 0:
            new_slot = s
            break
    got = eng.read_rows(eg.engine_tables(), "dyn_emb",
                        torch.tensor([max(new_slot, 0)]))[0].cpu()
    owner = lambda s: (off + s) // g.local_rows  # noqa: E731
    return {"rank": shard.rank, "packed_row_wise": g.packed
            and g.sharding == "row_wise", "first_slot": slot,
            "first_owner": owner(slot), "stored_here": held is not None,
            "stored_row_equal": held is not None and bool(
                np.array_equal(held, v.numpy())),
            "new_slot": new_slot, "new_owner": owner(max(new_slot, 0)),
            "restores_sent": len(sent),
            "restore_row_writes": write_rows.launches - launches,
            "read_back_equal": bool(torch.equal(got, v))}


def zr_rank(shard, text, cfg_path, cols_list, touched, ckpt_dir):
    """Rank side of ``phase_train_zch_ranks`` at world size 2."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.utils import checkpoint_util

    model, features, tx, state, step = sharded_trainer(text, shard)
    eng = model.embedding_group.engine
    zgroups = {t: eng.groups[eng.table_rows(f"{t}_emb")[0]]
               for t in ZR_FEATURES}
    out = {"rank": shard.rank, "plan": model.sharding_plan,
           "zch_groups": {t: {"sharding": g.sharding, "packed": g.packed,
                              "local_rows": g.local_rows}
                          for t, g in zgroups.items()}}
    batches = [parse_batch(features, rank_rows(c, shard, ZR_BATCH),
                           ["label"]) for c in cols_list]
    sync()
    write_rows.launches = 0
    with restore_writes() as restored:
        for b in batches[:ZR_STEPS]:
            with deterministic():
                state, _ = step(state, b)
    sync()
    out["row_write_launches"] = write_rows.launches
    out["restore_row_writes"] = restored["launches"]
    want = ZR_STEPS * packed_written_groups(model) + restored["launches"]
    if out["row_write_launches"] != want:
        raise AssertionError(
            f"train_zch_ranks rank {shard.rank}: {write_rows.launches} row "
            f"writes in {ZR_STEPS} steps, {want} expected")
    rows = read_table_rows(model, touched)
    out["zch_digest"] = model.embedding_group.zch_digest()
    zch = zr_zch_numpy(model) if shard.rank == 0 else None
    path = checkpoint_util.save_checkpoint(ckpt_dir, model, tx, state)
    t0 = time.perf_counter()
    out["evaluate"] = port_main.evaluate(cfg_path, checkpoint_path=path,
                                         device=SHARDED_DEVICE, shard=shard)
    out["evaluate_s"] = time.perf_counter() - t0
    # the resume: a fresh world-2 model from the checkpoint and the
    # trained one take the next step alike
    model2, _, tx2, state2, step2 = sharded_trainer(text, shard)
    restored_state = checkpoint_util.restore_checkpoint(path, model2, tx2)
    state2.update({k: v for k, v in restored_state.items()
                   if k != "dataloader_state"})
    with deterministic():
        state, _ = step(state, batches[ZR_STEPS])
        state2, _ = step2(state2, batches[ZR_STEPS])
    a, b = (read_table_rows(m, touched) for m in (model, model2))
    out["resume_bit_equal"] = (
        all(torch.equal(a[t], b[t]) for t in a)
        and model.embedding_group.zch_digest()
        == model2.embedding_group.zch_digest()
        and dense_digest(model) == dense_digest(model2))
    del model2, tx2, state2, step2
    # the step at world size 2 (not counted)
    kept = write_rows.launches
    _, step_ms, window_ms = timed_steps(step, state, batches[0], 1,
                                        ZR_TIMED_STEPS)
    write_rows.launches = kept
    out["step_ms_median"] = float(np.median(step_ms))
    out["window_ms_per_step"] = window_ms
    out["probe"] = zr_restore_probe(shard)
    return out, ((rows, zch) if shard.rank == 0 else None)


def phase_train_zch_ranks(smi):
    """ZCH and dynamicemb tables over two ranks (``zr_text``: four
    dynamicemb tables of ZR_SLOTS slots, ``row_wise`` and packed), the
    ranks on the one card through gloo as in ``train_sharded``: ZR_STEPS
    steps of the global batches. Checks: the ZCH mappings equal, bit for
    bit, on both ranks, to a CPU remap of the global batches and to a
    one-rank card run; the touched rows of every table (the slots the
    remap gave, the other tables' ids) within ZR_TOL of each table's max
    of that one-rank run, whose products are formed over the ranks' row
    blocks (``row_blocks``); kernel #3 once per packed block, rank and
    step; the world-2 checkpoint's mappings equal on the ranks at the
    save, its ``evaluate`` at world size 2 and at 1 within ZR_EVAL_TOL;
    a resume from it at world size 2 bit-equal to the trained model's
    next step; the restore probe (``zr_restore_probe``): the key stored
    by the rank that holds its slot, restored into its new slot by
    kernel #3 and read back bit for bit. Returns kernel #3's launches of
    the counted steps, summed over the ranks."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.benchmark import synthetic
    from torcheasyrec_tpu_torch.datasets.data_parser import DataParser
    from torcheasyrec_tpu_torch.utils.config_util import parse_pipeline_config

    import pyarrow.parquet as pq

    out, seconds = {"phase": "train_zch_ranks", "nvidia_smi": smi}, {}
    what, backend = sharded_backend()
    out["ranks_on"] = what
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = synthetic.ensure_dataset(tmp, (ZR_STEPS + 1) * ZR_BATCH,
                                         ZR_EVAL_ROWS)
        # each rank evaluates a file of its own
        text = zr_text(dict(paths, eval=split_file(
            paths["eval"], SHARDED_WORLD, tmp, "zr_eval")),
            os.path.join(tmp, "zr"))
        cfg_path = write_text(os.path.join(tmp, "zr.config"), text)
        cfg = parse_pipeline_config(text)
        table = pq.read_table(paths["train"])
        cols_list = [{c: table[c].slice(i * ZR_BATCH, ZR_BATCH)
                      .combine_chunks() for c in table.column_names}
                     for i in range(ZR_STEPS + 1)]
        seconds["data"] = time.perf_counter() - t0

        # the CPU remap of the global batches: the slots each table's
        # rows took, and the mappings
        t0 = time.perf_counter()
        cpu_model, features = port_main.build_model(cfg, "cpu")
        eg = cpu_model.embedding_group
        parser = DataParser(features, labels=["label"])
        touched = {}
        for i, cols in enumerate(cols_list[:ZR_STEPS]):
            nb, _ = eg.remap_zch(parser.parse_to_batch(cols), i, True)
            for lks in eg.engine._lookups_by_group.values():
                for lk in lks:
                    v = nb.sparse_features[lk.feature_name].values
                    touched.setdefault(lk.table_name, []).append(
                        v.reshape(-1).long())
        touched = {t: torch.unique(torch.cat(v)).numpy()
                   for t, v in touched.items()}
        touched = {t: v[v >= 0] for t, v in touched.items()}
        cpu_zch = zr_zch_numpy(cpu_model)
        del cpu_model, eg
        seconds["cpu_remap"] = time.perf_counter() - t0

        # the one-rank card run, its products over the ranks' row blocks
        t0 = time.perf_counter()
        model, feats, tx, state, step = sharded_trainer(text)
        for cols in cols_list[:ZR_STEPS]:
            with deterministic(), row_blocks(SHARDED_WORLD):
                state, _ = step(state, parse_batch(feats, cols, ["label"]))
        ref_rows = read_table_rows(model, touched)
        ref_zch = zr_zch_numpy(model)
        _, ref_step_ms, ref_window = timed_steps(
            step, state, parse_batch(feats, cols_list[0], ["label"]), 1,
            ZR_TIMED_STEPS)
        del model, tx, state, step
        torch.cuda.empty_cache()
        seconds["world_1"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        ckpt_dir = os.path.join(tmp, "zr_ckpt")
        os.makedirs(ckpt_dir)
        # the ranks go on to train_pipelined's part (a) (``PIPE_DONE``)
        # and to train_global_reductions' runs (``GRS_DONE``)
        cfgs = pipelined_configs()
        t1 = time.perf_counter()
        grs_cfgs = grs_configs()
        seconds["train_global_reductions_data"] = time.perf_counter() - t1
        both = run_ranks(zr_then_pipelined, SHARDED_WORLD,
                         ((text, cfg_path, cols_list, touched, ckpt_dir),
                          cfgs, grs_cfgs), backend, tmp)
        ranks = [r[0] for r in both]
        pipe = [r[1] for r in both]
        PIPE_DONE.update(cfgs=cfgs, ranks=pipe,
                         seconds=max(sum(p[n]["seconds"] for n, _ in PIPE_RUNS)
                                     for p in pipe))
        GRS_DONE.update(cfgs=grs_cfgs, ranks=[r[2] for r in both])
        grs_s = max(r[2]["seconds"]["all"] for r in both)
        seconds["world_2"] = (time.perf_counter() - t0 - PIPE_DONE["seconds"]
                              - grs_s - seconds["train_global_reductions_data"])
        seconds["train_pipelined_part_a"] = PIPE_DONE["seconds"]
        seconds["train_global_reductions_world_2"] = grs_s
        rows, zch = ranks[0][1]
        reports = [r[0] for r in ranks]

        t0 = time.perf_counter()
        ckpt = os.path.join(ckpt_dir, f"model.ckpt-{ZR_STEPS}.pt")
        one = port_main.evaluate(cfg_path, checkpoint_path=ckpt,
                                 device="cuda")
        seconds["evaluate_world_1"] = time.perf_counter() - t0

    failures = []
    for name, z in (("world 2 rank 0", zch), ("world 1 card", ref_zch)):
        bad = [k for k, v in cpu_zch.items() if not np.array_equal(z[k], v)]
        if bad:
            failures.append(f"{name}: ZCH state differs from the CPU remap "
                            f"of the global batch: {bad}")
    if len({r["zch_digest"] for r in reports}) != 1:
        failures.append("the ZCH mappings differ between the ranks")
    tables = rel_report(rows, ref_rows)
    if not tables["max_err"] <= ZR_TOL:
        failures.append(f"tables at world size 2 against 1: {tables}")
    for r in reports:
        for t, g in r["zch_groups"].items():
            if not (g["sharding"] == "row_wise" and g["packed"]):
                failures.append(f"rank {r['rank']} {t}: {g}")
        if not r["resume_bit_equal"]:
            failures.append(f"rank {r['rank']}: the resumed step differs")
    auc2 = reports[0]["evaluate"]["auc"]
    if reports[1]["evaluate"]["auc"] != auc2 or not abs(
            one["auc"] - auc2) <= ZR_EVAL_TOL:
        failures.append(f"evaluate: world 2 {[r['evaluate']['auc'] for r in reports]}, "
                        f"world 1 {one['auc']}")
    probes = [r["probe"] for r in reports]
    holders = [p["rank"] for p in probes if p["stored_here"]]
    if not (all(p["packed_row_wise"] and p["read_back_equal"]
                and p["new_slot"] >= 0 for p in probes)
            and holders == [probes[0]["first_owner"]]
            and probes[holders[0]]["stored_row_equal"]
            and sum(p["restores_sent"] for p in probes) >= 1
            and probes[probes[0]["new_owner"]]["restore_row_writes"] >= 1):
        failures.append(f"restore probe: {probes}")
    out.update({
        "slots": ZR_SLOTS, "features": list(ZR_FEATURES), "steps": ZR_STEPS,
        "global_batch": ZR_BATCH, "touched_rows": {
            t: int(len(v)) for t, v in touched.items() if t.startswith(
                tuple(f"{f}_emb" for f in ZR_FEATURES))},
        "zch_bit_equal_ranks_cpu_world_1": not any(
            "ZCH" in f for f in failures),
        "tables_world_2_vs_1": tables, "bound": ZR_TOL,
        "evaluate_auc": {"world_2": auc2, "world_1": one["auc"],
                         "bound": ZR_EVAL_TOL},
        "row_write_launches_per_rank": [r["row_write_launches"]
                                        for r in reports],
        "restore_row_writes_per_rank": [r["restore_row_writes"]
                                        for r in reports],
        "step_ms_median": {"world_2_ranks": [r["step_ms_median"]
                                             for r in reports],
                           "world_1": float(np.median(ref_step_ms))},
        "window_ms_per_step": {"world_2_ranks": [r["window_ms_per_step"]
                                                 for r in reports],
                               "world_1": ref_window},
        "probe": probes, "plan": reports[0]["plan"], "seconds": seconds,
        "failures": failures})
    emit(out)
    if failures:
        raise AssertionError(f"train_zch_ranks: {failures}")
    return sum(r["row_write_launches"] + r["probe"]["restore_row_writes"]
               for r in reports)


# --- phase train_stream: a Kafka-fed DeepFM, a converted EasyRec config -----

STREAM_STEPS = 8  # 16 before train_global_reductions joined
STREAM_RESUME_AT = 4
STREAM_BATCH = 4096
STREAM_PARTITIONS = 2
STREAM_TOPIC = "criteo_stream"
STREAM_CPU_BOUND = 0.02  # the AUC against a CPU run's from the same weights
CONVERTED_STEPS = 4
# a TF-EasyRec DeepFM over the Criteo columns (hash buckets of criteo_synth's
# deepfm.config), for tools/convert_easyrec_config
EASYREC_DEEPFM = """
train_config {
  optimizer_config {
    adam_optimizer { learning_rate { constant_learning_rate {
      learning_rate: 0.001 } } }
  }
  num_steps: 4
}
data_config { batch_size: 4096 label_fields: "label" input_type: ParquetInput }
feature_config {
%s}
model_config {
  model_class: "DeepFM"
  feature_groups { group_name: "wide" %s wide_deep: WIDE }
  feature_groups { group_name: "deep" %s %s wide_deep: DEEP }
  deepfm { dnn { hidden_units: [512, 256, 128] }
           final_dnn { hidden_units: [128, 64] } wide_output_dim: 4 }
}
"""


def easyrec_deepfm_text() -> str:
    import re

    with open(os.path.join(zoo_config_dir(), "criteo_synth",
                           "deepfm.config")) as f:
        buckets = [int(b) for b in re.findall(
            r'feature_name: "cat_\d+" num_buckets: (\d+)', f.read())]
    feats = "".join(
        f'  features {{ input_names: "cat_{i}" feature_type: IdFeature '
        f"embedding_dim: 16 hash_bucket_size: {b} }}\n"
        for i, b in enumerate(buckets))
    feats += "".join(f'  features {{ input_names: "int_{i}" '
                     "feature_type: RawFeature }\n" for i in range(13))
    cats = " ".join(f'feature_names: "cat_{i}"' for i in range(len(buckets)))
    ints = " ".join(f'feature_names: "int_{i}"' for i in range(13))
    return EASYREC_DEEPFM % (feats, cats, cats, ints)


class _StreamMessage:
    def __init__(self, partition, offset, ts_ms, value):
        self._p, self._o, self._ts, self._v = partition, offset, ts_ms, value

    def error(self):
        return None

    def value(self):
        return self._v

    def timestamp(self):
        return (1, self._ts)

    def partition(self):
        return self._p

    def offset(self):
        return self._o


class _StreamTopicPartition:
    def __init__(self, topic, partition, offset=-1001):
        self.topic, self.partition, self.offset = topic, partition, offset


class _StreamConsumer:
    """An in-memory broker's consumer: {topic: {partition: [(offset,
    time ms, value)]}}, each assigned partition read in turn; an empty
    poll waits a little, as a broker's waits up to its timeout."""

    topics: dict = {}

    def __init__(self, conf):
        self._cursors = {}

    def list_topics(self, topic, timeout=None):
        import types

        parts = {p: None for p in type(self).topics[topic]}
        return types.SimpleNamespace(
            topics={topic: types.SimpleNamespace(partitions=parts)})

    def offsets_for_times(self, tps, timeout=None):
        out = []
        for tp in tps:
            msgs = type(self).topics[tp.topic][tp.partition]
            out.append(_StreamTopicPartition(tp.topic, tp.partition, next(
                (o for o, ts, _ in msgs if ts >= tp.offset),
                msgs[-1][0] + 1)))
        return out

    def assign(self, tps):
        for tp in tps:
            msgs = type(self).topics[tp.topic][tp.partition]
            pos = 0 if tp.offset == -1001 else next(
                (i for i, (o, _, _) in enumerate(msgs) if o >= tp.offset),
                len(msgs))
            self._cursors[(tp.topic, tp.partition)] = pos

    def consume(self, num_messages, timeout=None):
        out = []
        for (topic, part), pos in sorted(self._cursors.items()):
            msgs = type(self).topics[topic][part]
            take = msgs[pos:pos + num_messages - len(out)]
            self._cursors[(topic, part)] = pos + len(take)
            out.extend(_StreamMessage(part, o, ts, v) for o, ts, v in take)
            if len(out) >= num_messages:
                break
        if not out:
            time.sleep(0.005)
        return out

    def close(self):
        pass


@contextlib.contextmanager
def in_memory_broker(topic: str, table):
    """``confluent_kafka`` replaced, inside the block, by an in-memory
    broker whose ``topic`` holds ``table``'s rows as JSON messages, in
    STREAM_PARTITIONS partitions of consecutive rows (no broker, no
    network)."""
    import types

    cols = {c: table[c].to_pylist() for c in table.column_names
            if c == "label" or c.startswith(("cat_", "int_"))}
    n = table.num_rows
    per = n // STREAM_PARTITIONS
    parts = {}
    for p in range(STREAM_PARTITIONS):
        msgs = []
        for j, i in enumerate(range(p * per, (p + 1) * per)):
            msgs.append((j, 1_700_000_000_000 + i * 10, json.dumps(
                {c: v[i] for c, v in cols.items()}).encode()))
        parts[p] = msgs
    mod = types.ModuleType("confluent_kafka")
    mod.Consumer, mod.TopicPartition = _StreamConsumer, _StreamTopicPartition
    kept = sys.modules.get("confluent_kafka")
    sys.modules["confluent_kafka"] = mod
    _StreamConsumer.topics = {topic: parts}
    try:
        yield {p: len(m) for p, m in parts.items()}
    finally:
        _StreamConsumer.topics = {}
        if kept is None:
            sys.modules.pop("confluent_kafka", None)
        else:
            sys.modules["confluent_kafka"] = kept


def stream_text(paths, model_dir, kafka=True) -> str:
    text = criteo_text("deepfm", model_dir, paths, replace=[
        ("save_checkpoints_steps: 100000",
         f"save_checkpoints_steps: {STREAM_RESUME_AT}")])
    if kafka:
        text = text.replace(f'train_input_path: "{paths["train"]}"',
                            f'train_input_path: "kafka://local/{STREAM_TOPIC}"')
    return text


def written_groups(cfg) -> list:
    """The packed groups a train step writes with kernel #3 (those with a
    table past the dense lane), of a model built on the CPU."""
    from torcheasyrec_tpu_torch import main as port_main

    probe, _ = port_main.build_model(cfg, "cpu")
    out = sorted(gk for gk, g in probe.embedding_group.engine.groups.items()
                 if g.packed and any(t.name not in g.dense_tables
                                     for t in g.specs))
    del probe
    return out


def phase_train_stream(smi):
    """The criteo_synth DeepFM fed from a Kafka topic: an in-memory broker
    (``in_memory_broker``) stands in for ``confluent_kafka``, its topic
    two partitions of the synthetic Criteo rows as JSON. STREAM_STEPS
    steps on the card through ``train_and_evaluate`` (the loop's steps
    timed), beside a CPU run from the same weights and broker (AUC within
    STREAM_CPU_BOUND) and the same steps fed from the parquet file; a
    resume at STREAM_RESUME_AT that continues each partition at offset +
    1, bit-equal to the straight run; kernel #3 once per written group
    and step. Then a TF-EasyRec DeepFM config through
    ``tools/convert_easyrec_config``, trained CONVERTED_STEPS steps on the
    card, its checkpoint listed by ``tools/list_ckpt_param``. Returns
    kernel #3's launches of the two counted card runs."""
    import pyarrow.parquet as pq

    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.benchmark import synthetic
    from torcheasyrec_tpu_torch.ops.row_write import write_rows
    from torcheasyrec_tpu_torch.tools import convert_easyrec_config
    from torcheasyrec_tpu_torch.tools import list_ckpt_param
    from torcheasyrec_tpu_torch.utils import checkpoint_util
    from torcheasyrec_tpu_torch.utils.config_util import (
        parse_pipeline_config,
        save_message,
    )

    emit({"phase": "train_stream", "note": "an in-memory broker stands in "
          "for confluent_kafka (no broker and no network here): topic "
          f"{STREAM_TOPIC}, {STREAM_PARTITIONS} partitions of synthetic "
          "Criteo rows as JSON messages"})
    out, seconds = {"phase": "train_stream", "nvidia_smi": smi}, {}
    failures = []
    edits = json.dumps({"train_config.num_steps": STREAM_STEPS})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = synthetic.ensure_dataset(tmp, STREAM_STEPS * STREAM_BATCH,
                                         2 * STREAM_BATCH)
        table = pq.read_table(paths["train"])

        def run(name, kafka=True, device="cuda", **kw):
            src = write_text(os.path.join(tmp, f"{name}.config"),
                             stream_text(paths, os.path.join(tmp, name),
                                         kafka))
            return src, port_main.train_and_evaluate(
                src, device=device, **kw)

        with in_memory_broker(STREAM_TOPIC, table) as sizes:
            seconds["data"] = time.perf_counter() - t0
            init = cpu_init(write_text(os.path.join(tmp, "init.config"),
                                       stream_text(paths, "unused")),
                            os.path.join(tmp, "stream_init.pt"))
            written = written_groups(parse_pipeline_config(
                stream_text(paths, "unused")))
            t0 = time.perf_counter()
            write_rows.launches = 0
            with step_clock(port_main) as stamps:
                _, card = run("card", fine_tune_checkpoint=init,
                              edit_config_json=edits)
            torch.cuda.synchronize()
            launches = write_rows.launches
            seconds["card"] = time.perf_counter() - t0
            kafka_steps = epoch_steps(stamps)
            if card["step"] != STREAM_STEPS or launches != (
                    STREAM_STEPS * len(written)):
                failures.append(f"{card['step']} steps, {launches} row "
                                f"writes for the written groups {written}")
            t0 = time.perf_counter()
            kept = write_rows.launches
            rsrc, _ = run("resumed", fine_tune_checkpoint=init,
                          edit_config_json=json.dumps(
                              {"train_config.num_steps": STREAM_RESUME_AT}))
            mid = torch.load(checkpoint_util.latest_checkpoint(
                os.path.join(tmp, "resumed")), map_location="cpu",
                weights_only=True)["dataloader_state"]
            port_main.train_and_evaluate(rsrc, continue_train=True,
                                         edit_config_json=edits,
                                         device="cuda")
            write_rows.launches = kept
            seconds["resume"] = time.perf_counter() - t0
            a, b = (torch.load(checkpoint_util.latest_checkpoint(
                os.path.join(tmp, d)), map_location="cpu", weights_only=True)
                for d in ("card", "resumed"))
            same = [k for k in a["model"]
                    if torch.equal(a["model"][k], b["model"][k])]
            resume = {"at": STREAM_RESUME_AT, "watermark_at": mid,
                      "watermark_end": a["dataloader_state"],
                      "state_dict_bit_equal": len(same) == len(a["model"])}
            if not (resume["state_dict_bit_equal"] and a["step"] == b["step"]
                    and a["dataloader_state"] == b["dataloader_state"]):
                failures.append(f"the resumed run differs: {resume}, "
                                f"{sorted(set(a['model']) - set(same))[:8]}")
            # the watermark is the real offsets: partition 0's rows come
            # first, STREAM_RESUME_AT batches of them
            if mid != {0: STREAM_RESUME_AT * STREAM_BATCH - 1}:
                failures.append(f"the watermark at the resume: {mid}")
            del a, b
            t0 = time.perf_counter()
            _, cpu = run("cpu", device="cpu", fine_tune_checkpoint=init,
                         edit_config_json=edits)
            seconds["cpu"] = time.perf_counter() - t0
        dist = card["auc"] - cpu["auc"]
        if not abs(dist) <= STREAM_CPU_BOUND:
            failures.append(f"auc {card['auc']} on the card is {dist:+.4f} "
                            f"from the CPU's {cpu['auc']}")
        t0 = time.perf_counter()
        kept = write_rows.launches
        with step_clock(port_main) as stamps:
            _, pq_fed = run("parquet", kafka=False,
                            fine_tune_checkpoint=init,
                            edit_config_json=edits)
        write_rows.launches = kept
        seconds["parquet"] = time.perf_counter() - t0
        parquet_steps = epoch_steps(stamps)

        # the converted TF-EasyRec DeepFM
        t0 = time.perf_counter()
        converted, warnings = convert_easyrec_config.convert(
            easyrec_deepfm_text())
        cfg = parse_pipeline_config(converted)
        cfg.train_input_path, cfg.eval_input_path = (paths["train"],
                                                     paths["eval"])
        cfg.model_dir = os.path.join(tmp, "converted")
        cfg.train_config.num_steps = CONVERTED_STEPS
        cpath = os.path.join(tmp, "converted.config")
        save_message(cfg, cpath)
        cwritten = written_groups(cfg)
        before = write_rows.launches
        conv = port_main.train_and_evaluate(cpath, device="cuda")
        torch.cuda.synchronize()
        conv_launches = write_rows.launches - before
        ckpt = checkpoint_util.latest_checkpoint(cfg.model_dir)
        listed = list_ckpt_param.list_params(ckpt)
        raw = torch.load(ckpt, map_location="cpu", weights_only=True)
        n_tensors = 0

        def count(node):
            nonlocal n_tensors
            if isinstance(node, dict):
                for v in node.values():
                    count(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    count(v)
            elif isinstance(node, torch.Tensor):
                n_tensors += 1

        count(raw)
        del raw
        seconds["converted"] = time.perf_counter() - t0
        if not (conv["step"] == CONVERTED_STEPS and np.isfinite(conv["auc"])
                and conv_launches == CONVERTED_STEPS * len(cwritten)
                and len(listed) == n_tensors and n_tensors > 0):
            failures.append(f"converted DeepFM: {conv}, {conv_launches} row "
                            f"writes for {cwritten}, {len(listed)} of "
                            f"{n_tensors} tensors listed")
    out.update({
        "partitions": sizes, "steps": STREAM_STEPS, "batch": STREAM_BATCH,
        "auc": {"card": card["auc"], "cpu": cpu["auc"],
                "card_minus_cpu": dist, "bound": STREAM_CPU_BOUND,
                "parquet_fed_card": pq_fed["auc"]},
        "resume": resume, "row_write_launches": launches,
        "written_packed_groups": written,
        "kafka_fed_step": kafka_steps, "parquet_fed_step": parquet_steps,
        "converted": {"warnings": warnings, "result": conv,
                      "row_write_launches": conv_launches,
                      "written_packed_groups": cwritten,
                      "tensors_listed": len(listed),
                      "first_listed": listed[:3]},
        "seconds": seconds, "failures": failures})
    emit(out)
    if failures:
        raise AssertionError(f"train_stream: {failures}")
    return launches + conv_launches


# --- train_pipelined: the training loop's two overlaps -------------------
PIPE_STEPS = 8  # steps a run, each overlap and each way
PIPE_SKIP = 2  # the loop's first steps left out of the step median


@contextlib.contextmanager
def host_waits(port_main):
    """Sums the main thread's host work of a run with host-offloaded
    tables: the rows' gather (the prefetcher's ``rows_for``: a gather now
    or the join of the prefetch), the host apply and the repair; counts
    the steps the prefetch served. Yields the dict."""
    from torcheasyrec_tpu_torch.parallel.emb_engine import EmbeddingEngine

    ms = {"rows_for": 0.0, "host_apply": 0.0, "repair": 0.0, "served": 0,
          "steps": 0}
    pre = port_main._HostRowPrefetcher
    real = {"rows_for": pre.rows_for, "repair": pre.repair,
            "host_apply": EmbeddingEngine._host_apply}

    def timed(key, fn):
        def run(self, *a):
            t0 = time.perf_counter()
            try:
                return fn(self, *a)
            finally:
                ms[key] += (time.perf_counter() - t0) * 1e3
        return run

    def rows_for(self, batch):
        ms["steps"] += 1
        ms["served"] += int(self._batch is batch and (
            self._out is not None or self._thread is not None))
        return timed("rows_for", real["rows_for"])(self, batch)

    pre.rows_for, pre.repair = rows_for, timed("repair", real["repair"])
    EmbeddingEngine._host_apply = timed("host_apply", real["host_apply"])
    try:
        yield ms
    finally:
        pre.rows_for, pre.repair = real["rows_for"], real["repair"]
        EmbeddingEngine._host_apply = real["host_apply"]


@contextlib.contextmanager
def route_waits():
    """Sums the main thread's owner routing of a run (``_owner_route``
    inline) and its waits for staged routes (``StagedRoutes.wait``);
    counts the routes staged. Yields the dict."""
    import threading

    from torcheasyrec_tpu_torch.parallel import emb_engine

    ms = {"inline_route": 0.0, "staged_wait": 0.0, "staged": 0}
    eng, handle = emb_engine.EmbeddingEngine, emb_engine.StagedRoutes
    real_route, real_wait, real_init = (eng._owner_route, handle.wait,
                                        handle.__init__)

    def route(self, *a, **k):
        if threading.current_thread() is not threading.main_thread():
            return real_route(self, *a, **k)
        t0 = time.perf_counter()
        try:
            return real_route(self, *a, **k)
        finally:
            ms["inline_route"] += (time.perf_counter() - t0) * 1e3

    def wait(self):
        t0 = time.perf_counter()
        try:
            return real_wait(self)
        finally:
            ms["staged_wait"] += (time.perf_counter() - t0) * 1e3

    def init(self, *a, **k):
        ms["staged"] += 1
        real_init(self, *a, **k)

    eng._owner_route, handle.wait, handle.__init__ = route, wait, init
    try:
        yield ms
    finally:
        eng._owner_route, handle.wait, handle.__init__ = (
            real_route, real_wait, real_init)


def checkpoint_diff(a_dir, b_dir) -> dict:
    """The latest checkpoints of two model dirs: the largest |a - b| over
    the weights, the sparse and the dense optimizer state, and whether
    step, epoch and watermark agree."""
    from torcheasyrec_tpu_torch.utils import checkpoint_util

    a, b = (torch.load(checkpoint_util.latest_checkpoint(d),
                       map_location="cpu", weights_only=True)
            for d in (a_dir, b_dir))
    pairs = [(a["model"][k], b["model"][k]) for k in b["model"]]
    pairs += [(a["sparse_opt"][t][k], v) for t, st in b["sparse_opt"].items()
              for k, v in st.items()]
    pairs += [(sa[k], v) for sa, sb in zip(a["dense_opt"]["state"],
                                           b["dense_opt"]["state"])
              for k, v in sb.items()]
    worst = 0.0
    for x, y in pairs:
        if x.shape != y.shape:
            return {"max_abs": float("inf"), "shapes_differ": True}
        if y.numel():
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return {"max_abs": worst, "tensors": len(pairs),
            "keys_equal": a["model"].keys() == b["model"].keys(),
            "position_equal": (a["step"], a["epoch"], a["dataloader_state"])
            == (b["step"], b["epoch"], b["dataloader_state"])}


def pipelined_rank(shard, cfg_paths):
    """Rank side of (a): ``train_and_evaluate`` of each config in turn,
    its loop's steps stamped, kernel #3
    counted from 0 just before the run and read just after, the main
    thread's routing timed."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.ops.row_write import write_rows

    out = {"rank": shard.rank, "backend": shard.backend}
    for name, path in cfg_paths.items():
        sync()
        t0 = time.perf_counter()
        write_rows.launches = 0
        with step_clock(port_main) as stamps, route_waits() as ms, \
                deterministic():
            result = port_main.train_and_evaluate(
                path, device=SHARDED_DEVICE, shard=shard)
        sync()
        launches = write_rows.launches
        steps = int(result["step"])
        out[name] = {"result": result, "launches": launches,
                     "seconds": time.perf_counter() - t0,
                     "staged": ms["staged"],
                     "inline_route_ms_per_step": ms["inline_route"] / steps,
                     "staged_wait_ms_per_step": ms["staged_wait"] / steps,
                     **epoch_steps(stamps, PIPE_SKIP)}
    return out


# (run, overlap on): a rank's first run of the loop is slower throughout
# (seen on the CPU and the card), so it goes first, unpipelined, held to
# the same numbers but not timed against; then the two modes in turns
PIPE_RUNS = (("first", False), ("pipelined", True), ("unpipelined", False),
             ("unpipelined_2", False), ("pipelined_2", True))
# (run, TZREC_HOST_PREFETCH), in turns
PREFETCH_RUNS = (("prefetch_off", "0"), ("prefetch_on", "1"),
                 ("prefetch_on_2", "1"), ("prefetch_off_2", "0"))


def runs_in_turns(runs: dict, on: dict) -> dict:
    """Each mode's step medians over its runs in ``runs`` ({name: run},
    ``on`` {name: overlap on}, the first run left out), side by side."""
    out = {}
    for mode, want in (("overlap_on", True), ("overlap_off", False)):
        names = [n for n, v in on.items() if v == want and n != "first"]
        out[mode] = {n: runs[n]["step_ms_median"] for n in names}
    return out


def pipelined_configs() -> dict:
    """(a)'s configs, {run: config path}, in a directory that lasts the
    run (the criteo_synth data's): the same deepfm.config in each, every
    cat table ``row_wise``, the overlap on or off, a model dir each."""
    from torcheasyrec_tpu_torch.utils import config_util

    paths = criteo_synth_data(ZOO_TRAIN_ROWS, ZOO_EVAL_ROWS)
    root = os.path.join(_DATA_ROOT[0].name, "pipelined")
    os.makedirs(root, exist_ok=True)
    src = os.path.join(zoo_config_dir(), "criteo_synth", "deepfm.config")
    with open(src) as f:
        text = f.read()
    text = text.replace(
        "embedding_dim: 16 }",
        'embedding_dim: 16 embedding_constraints { sharding_types: '
        '"row_wise" } }')
    if text.count('sharding_types: "row_wise"') != 26:
        raise AssertionError("criteo_synth deepfm's cat features moved")
    train = split_file(paths["train"], SHARDED_WORLD, root, "pipe_train")
    evals = split_file(paths["eval"], SHARDED_WORLD, root, "pipe_eval")
    cfgs = {}
    for name, overlap in PIPE_RUNS:
        cfg = config_util.parse_pipeline_config(text)
        config_util.edit_config(cfg, {
            "model_dir": os.path.join(root, f"pipe_{name}"),
            "train_input_path": train, "eval_input_path": evals,
            "data_config.batch_size": ZOO_BATCH // SHARDED_WORLD,
            "train_config.num_steps": PIPE_STEPS,
            "train_config.use_tensorboard": False,
            "eval_config.num_steps": 2})
        cfg.train_config.sparse_dist_overlap = overlap
        cfgs[name] = os.path.join(root, f"pipe_{name}.config")
        config_util.save_message(cfg, cfgs[name])
    return cfgs


# (a)'s rank results where the ranks of ``train_zch_ranks`` ran it after
# their own work: a spawned rank's first ``train_and_evaluate`` pays
# ~15 s of start-up that warm ranks do not
PIPE_DONE = {}


def pipelined_ranks(backend) -> dict:
    """(a): the ranks' runs (``PIPE_DONE``'s, else a spawn of their own)
    and the checks. Returns the report with its ``failures``."""
    if PIPE_DONE:
        cfgs, ranks = PIPE_DONE["cfgs"], PIPE_DONE["ranks"]
        t0 = time.perf_counter() - PIPE_DONE["seconds"]
        spawn = "the ranks of train_zch_ranks, after their own work"
    else:
        cfgs = pipelined_configs()
        t0 = time.perf_counter()
        ranks = run_ranks(pipelined_rank, SHARDED_WORLD, (cfgs,), backend,
                          os.path.dirname(cfgs["first"]))
        spawn = "a spawn of their own"
    root = os.path.dirname(cfgs["first"])
    out = {"world_2_s": time.perf_counter() - t0, "ranks_of": spawn,
           "ranks": ranks}
    on = dict(PIPE_RUNS)
    checks = {}
    for r in ranks:
        key = f"rank_{r['rank']}"
        runs = {n: r[n] for n in on}
        out[f"{key}_step_ms_in_turns"] = runs_in_turns(runs, on)
        checks[f"{key}_results_equal"] = all(
            v["result"] == runs["first"]["result"] for v in runs.values())
        checks[f"{key}_steps"] = runs["first"]["result"]["step"] == PIPE_STEPS
        # every step stages the next batch's route (the run stops inside
        # the epoch: the last step's, for a batch it never steps on, is
        # dropped)
        checks[f"{key}_staged"] = all(
            v["staged"] == (PIPE_STEPS if on[n] else 0)
            for n, v in runs.items())
        launches = {v["launches"] for v in runs.values()}
        checks[f"{key}_row_writes"] = (
            len(launches) == 1 and min(launches) > 0
            and min(launches) % PIPE_STEPS == 0)
    for name in on:
        if name == "pipelined":
            continue
        diff = checkpoint_diff(os.path.join(root, "pipe_pipelined"),
                               os.path.join(root, f"pipe_{name}"))
        out[f"checkpoint_pipelined_vs_{name}"] = diff
        checks[f"checkpoint_vs_{name}_0.0"] = (
            diff["max_abs"] == 0.0 and diff["keys_equal"]
            and diff["position_equal"])
    out["checks"] = checks
    out["failures"] = [k for k, ok in checks.items() if not ok]
    out["row_write_launches_pipelined"] = sum(
        r[n]["launches"] for r in ranks for n, v in on.items() if v)
    return out


def prefetch_runs(tmp) -> dict:
    """(b): the host-offloaded ZCH DeepFM with the prefetcher off and on,
    in turns, from the same weights; kernel #3 counted from 0 just before
    each run and read just after. Returns the report with its
    ``failures``."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.ops.row_write import write_rows

    paths = criteo_synth_data(ZOO_TRAIN_ROWS, ZOO_EVAL_ROWS)
    out, runs = {}, {}
    edits = json.dumps({"train_config.num_steps": PIPE_STEPS,
                        "data_config.batch_size": ZOO_BATCH,
                        "train_config.save_checkpoints_steps": 10 ** 6,
                        "train_config.use_tensorboard": False,
                        "eval_config.num_steps": 2})
    init = None
    for name, env in PREFETCH_RUNS:
        model_dir = os.path.join(tmp, name)
        src = write_text(os.path.join(tmp, f"{name}.config"),
                         zch_text(paths, model_dir))
        init = init or cpu_init(src, os.path.join(tmp, "prefetch_init.pt"))
        os.environ["TZREC_HOST_PREFETCH"] = env
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write_rows.launches = 0
        try:
            with step_clock(port_main) as stamps, host_waits(port_main) as ms, \
                    restore_writes() as restored, deterministic():
                result = port_main.train_and_evaluate(
                    src, fine_tune_checkpoint=init, edit_config_json=edits,
                    device="cuda")
            torch.cuda.synchronize()
        finally:
            os.environ.pop("TZREC_HOST_PREFETCH", None)
        steps = int(result["step"])
        runs[name] = {"result": result, "launches": write_rows.launches,
                      "restore_launches": restored["launches"],
                      "seconds": time.perf_counter() - t0,
                      "prefetch_served": ms["served"],
                      "host_ms_per_step": {
                          k: ms[k] / steps
                          for k in ("rows_for", "host_apply", "repair")},
                      "host_wait_ms_per_step": sum(
                          ms[k] for k in ("rows_for", "host_apply",
                                          "repair")) / steps,
                      **epoch_steps(stamps, PIPE_SKIP)}
    out.update(runs)
    on = {n: env == "1" for n, env in PREFETCH_RUNS}
    out["step_ms_in_turns"] = runs_in_turns(runs, on)
    checks = {
        "results_equal": all(v["result"] == runs["prefetch_off"]["result"]
                             for v in runs.values()),
        "steps": runs["prefetch_off"]["result"]["step"] == PIPE_STEPS,
        # one epoch: every step's rows but the first come from the prefetch
        "prefetch_served": all(
            v["prefetch_served"] == (PIPE_STEPS - 1 if on[n] else 0)
            for n, v in runs.items()),
        "row_writes": len({v["launches"] for v in runs.values()}) == 1
        and runs["prefetch_off"]["launches"] > 0,
    }
    for name in on:
        if name == "prefetch_off":
            continue
        diff = checkpoint_diff(os.path.join(tmp, name),
                               os.path.join(tmp, "prefetch_off"))
        out[f"checkpoint_{name}_vs_prefetch_off"] = diff
        checks[f"checkpoint_{name}_0.0"] = (
            diff["max_abs"] == 0.0 and diff["keys_equal"]
            and diff["position_equal"])
    out["checks"] = checks
    out["failures"] = [k for k, ok in checks.items() if not ok]
    out["row_write_launches_prefetching"] = sum(
        runs[n]["launches"] for n, v in on.items() if v)
    return out


def phase_train_pipelined(smi):
    """The training loop's two overlaps (docstring, phase
    ``train_pipelined``). Returns kernel #3's launches on the overlaps'
    main paths: the pipelined runs' on both ranks and the prefetching
    runs'. Every check's result is printed before a failure raises."""
    mode, backend = sharded_backend()
    out = {"phase": "train_pipelined", "ranks_on": mode, "card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out["sparse_dist_overlap"] = pipelined_ranks(backend)
        out["sparse_dist_overlap_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["host_prefetch"] = prefetch_runs(tmp)
        out["host_prefetch_s"] = time.perf_counter() - t0
    failures = (out["sparse_dist_overlap"].pop("failures")
                + out["host_prefetch"].pop("failures"))
    launches = (out["sparse_dist_overlap"]["row_write_launches_pipelined"]
                + out["host_prefetch"]["row_write_launches_prefetching"])
    out["launches_main_path"] = {"row_write": launches}
    out["failures"] = failures
    emit(out)
    if failures:
        raise AssertionError(f"train_pipelined: {failures}")
    return launches


# --- phase train_global_reductions: the reductions over the global batch ---
# Each configuration at world size 2 (the ranks of ``train_zch_ranks``
# after their other work, ``GRS_DONE``, else a spawn of its own) against
# one rank on the card over the same global batches, the one-rank run's
# products over the ranks' row blocks (``row_blocks``), both under
# ``deterministic``. Through ``train_and_evaluate`` (each rank a train file
# of its own; the one-rank run a file of the ranks' batches side by side):
# criteo_synth dbmtl_jrc.config (BF16, packed, every cat table
# ``row_wise``), TIGER's RQ-VAE of ``train_sid`` with Sinkhorn and with the
# contrastive loss, RQ-KMeans at ``train_sid``'s widths (its sample cap
# inside the last step) and criteo_synth deepfm.config ``row_wise`` with a
# delta dump every 2 steps. Through the train step (two ranks' samplers
# draw other negatives than one's, so the loop's batches cannot match):
# MIND at tests/test_torch_port_match.py's mind_concat widths and
# HSTU-Match at the JAX integration config, each rank's batch [its
# positives | its GRS_NEG negatives].
GRS_STEPS = 3
GRS_TOL = LAYOUT_TOL  # of each tensor's max: fp32 and BF16 compute
GRS_HSTU_TOL = SHARDED_TRAP_TOL  # HSTU-Match
GRS_NEG = 32  # a rank's sampled negatives (HSTU-Match's num_sample)
GRS_MIND_BATCH = 256  # the global batch: 128 rows a rank
GRS_HSTU_BATCH = 32  # HSTU-Match's config: 16 rows a rank
GRS_KMEANS_CAP = 2 * SID_BATCH + SID_BATCH // 2  # inside step 3's rows
GRS_MIND = (
    'mind { user_tower { input: "user" history_input: "hist" '
    "user_mlp { hidden_units: [12] } user_seq_combine: CONCAT "
    f"capsule_config {{ max_k: 3 max_seq_len: {MATCH_ON_CARD_SEQ} "
    "high_dim: 8 } concat_mlp { hidden_units: [16] } } "
    'item_tower { input: "item" mlp { hidden_units: [16] } } '
    "output_dim: 8 simi_pow: 10 temperature: 0.2 }")
GRS_ROW_WISE = ('embedding_dim: 16 embedding_constraints { sharding_types: '
                '"row_wise" } }')
GRS_DONE = {}


def grs_split(path, root, name, batch, steps, world=SHARDED_WORLD) -> tuple:
    """(the ranks' train files, comma-joined; the one-rank file): the first
    ``steps`` global batches of ``batch`` rows of a parquet file, rank r
    taking row block r of each, the one-rank file each batch whole."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pq.read_table(path).slice(0, steps * batch)
    per = batch // world
    ranks = []
    for r in range(world):
        p = os.path.join(root, f"{name}_rank_{r}.parquet")
        pq.write_table(pa.concat_tables(
            [t.slice(s * batch + r * per, per) for s in range(steps)]), p)
        ranks.append(p)
    one = os.path.join(root, f"{name}_world_1.parquet")
    pq.write_table(t, one)
    return ",".join(ranks), one


def grs_loop_config(text, root, name, files, batch) -> dict:
    """{"world_2", "world_1": config path} of one config: GRS_STEPS
    steps, no eval, a model dir each."""
    from torcheasyrec_tpu_torch.utils import config_util

    out = {}
    for run, train in zip(("world_2", "world_1"), files):
        cfg = config_util.parse_pipeline_config(text)
        config_util.edit_config(cfg, {
            "model_dir": os.path.join(root, f"{name}_{run}"),
            "train_input_path": train, "eval_input_path": "",
            "data_config.batch_size": batch // (SHARDED_WORLD
                                                if run == "world_2" else 1),
            "train_config.num_steps": GRS_STEPS,
            "train_config.num_epochs": 1,
            "train_config.save_checkpoints_steps": 10 ** 6,
            "train_config.use_tensorboard": False})
        out[run] = os.path.join(root, f"{name}_{run}.config")
        config_util.save_message(cfg, out[run])
    return out


def grs_sid_pairs(path, n, seed) -> str:
    """``sid_items`` with a pair vector near each item and a 0/1 pair
    flag (the contrastive loss's groups)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    sid_items(path, n, seed)
    t = pq.read_table(path)
    x = np.asarray(t.column("item_emb").combine_chunks().flatten(),
                   np.float32).reshape(n, SID_DIM)
    r = np.random.default_rng(seed + 1)
    px = (x + 0.2 * r.normal(size=x.shape)).astype(np.float32)
    t = t.append_column("pair_emb", pa.ListArray.from_arrays(
        pa.array(np.arange(0, n * SID_DIM + 1, SID_DIM, dtype=np.int32)),
        pa.array(px.reshape(-1))))
    t = t.append_column("pair_flag", pa.array(
        (r.random(n) < 0.7).astype(np.float32)))
    pq.write_table(t, path)
    return path


def grs_sid_text(kind) -> str:
    """``sid_text``'s RQ-VAE with Sinkhorn or the contrastive loss, or its
    RQ-KMeans with the sample cap GRS_KMEANS_CAP (paths set later)."""
    paths = {"train": "unused", "eval": ""}
    if kind == "rqkmeans":
        return sid_text(paths, "unused", "rqkmeans").replace(
            f"train_sample_size: {SID_ITEMS}",
            f"train_sample_size: {GRS_KMEANS_CAP}")
    text = sid_text(paths, "unused", "rqvae")
    codebook = f"codebook: {list(SID_CODEBOOK)}"
    if kind == "sinkhorn":
        return text.replace(codebook,
                            codebook + " sinkhorn_config { iters: 3 }")
    text = text.replace(codebook, codebook + (
        ' contrastive_config { pair_feature_group: "pair"'
        ' pair_flag_feature_group: "flag" }'))
    # adam's eps 1e-4, as tests/test_torch_port_sid.py's configs: the
    # in-batch product's rounding differs at another row count (a rank's
    # [B / 2, B] against one rank's [B, B]) and adam at eps 1e-8 turns a
    # gradient at rounding level into a step of the learning rate's size
    # (ROADMAP section 3)
    text = text.replace("adam_optimizer { lr: 0.001 }",
                        "adam_optimizer { lr: 0.001 eps: 1e-4 }")
    text = text.replace(
        "model_config {\n",
        f'feature_configs {{ raw_feature {{ feature_name: "pair_emb" '
        f"value_dim: {SID_DIM} }} }}\n"
        'feature_configs { raw_feature { feature_name: "pair_flag" } }\n'
        "model_config {\n"
        '  feature_groups { group_name: "pair" feature_names: "pair_emb" '
        "group_type: DEEP }\n"
        '  feature_groups { group_name: "flag" feature_names: "pair_flag" '
        "group_type: DEEP }\n")
    return text


def grs_negatives(cols, n_items, seed, cluster=None) -> dict:
    """A global batch's columns with every rank's GRS_NEG negatives after
    its positives (the item-side columns): [B positives | rank 0's | rank
    1's ...]. ``cluster``: (column, divisor) of the item's cluster id."""
    import pyarrow as pa

    neg = np.random.default_rng(seed).integers(0, n_items,
                                               SHARDED_WORLD * GRS_NEG)
    out = dict(cols)
    if cluster is None:  # HSTU-Match: one-item candidate sequences
        out["cand_seq__video_id"] = pa.concat_arrays([
            cols["cand_seq__video_id"], pa.array([str(i) for i in neg])])
        return out
    out["item_id"] = pa.concat_arrays([cols["item_id"], pa.array(neg)])
    out[cluster[0]] = pa.concat_arrays([cols[cluster[0]],
                                        pa.array(neg // cluster[1])])
    return out


def grs_rank_cols(cols, rank, n_global, neg_cols) -> dict:
    """This rank's columns of a global batch: row block ``rank`` of the
    user side; of the item side its positives, then its negatives."""
    import pyarrow as pa

    per = n_global // SHARDED_WORLD
    return {k: (pa.concat_arrays([v.slice(rank * per, per),
                                  v.slice(n_global + rank * GRS_NEG,
                                          GRS_NEG)])
                if k in neg_cols else v.slice(rank * per, per))
            for k, v in cols.items()}


def grs_configs() -> dict:
    """The phase's configs and batches in a directory that lasts the run:
    {"loop": {name: {"world_2", "world_1"}}, "steps": {name: {"text",
    "plan", "labels", "batches" (global), "n_global", "neg"}}}."""
    import pyarrow.parquet as pq

    paths = criteo_synth_data(ZOO_TRAIN_ROWS, ZOO_EVAL_ROWS)
    root = os.path.join(_DATA_ROOT[0].name, "global_reductions")
    os.makedirs(root, exist_ok=True)
    loop = {}
    for name, src in (("dbmtl_jrc", "dbmtl_jrc.config"),
                      ("deepfm_dump", "deepfm.config")):
        with open(os.path.join(zoo_config_dir(), "criteo_synth", src)) as f:
            text = f.read()
        text = text.replace("embedding_dim: 16 }", GRS_ROW_WISE)
        if name == "deepfm_dump":
            text = text.replace("train_config {", "train_config {\n"
                                "  delta_embedding_dump_config "
                                "{ dump_interval_steps: 2 }", 1)
        if text.count('sharding_types: "row_wise"') != 26:
            raise AssertionError(f"criteo_synth {src}'s cat features moved")
        files = grs_split(paths["train"], root, name, ZOO_BATCH, GRS_STEPS)
        loop[name] = grs_loop_config(text, root, name, files, ZOO_BATCH)
    items = {
        "sinkhorn": sid_items(os.path.join(root, "sid_items.parquet"),
                              GRS_STEPS * SID_BATCH, 11),
        "contrastive": grs_sid_pairs(os.path.join(root, "sid_pairs.parquet"),
                                     GRS_STEPS * SID_BATCH, 12)}
    items["rqkmeans"] = items["sinkhorn"]
    for kind, path in items.items():
        files = grs_split(path, root, f"sid_{kind}", SID_BATCH, GRS_STEPS)
        loop[f"sid_{kind}"] = grs_loop_config(
            grs_sid_text(kind), root, f"sid_{kind}", files, SID_BATCH)

    steps = {}
    mpaths = match_on_card_files(root)
    mcfg = match_on_card_config(_MATCH_SAMPLER_FOR_GRS, GRS_MIND, mpaths)
    # mind_concat's optimizers (tests/test_torch_port_match.py): eps 1e-4,
    # where adagrad and adam do not turn a gradient at rounding level
    # into a step of the learning rate's size (ROADMAP section 3)
    mcfg.train_config.sparse_optimizer.adagrad_optimizer.eps = 1e-4
    mcfg.train_config.dense_optimizer.adam_optimizer.eps = 1e-4
    mind_rows = pq.read_table(mpaths["data"])
    steps["mind"] = {
        "text": str(mcfg), "labels": ["pos_label"],
        "plan": {t: "row_wise" for t in ("user_taste_emb", "item_id_emb",
                                         "item_cluster_emb")},
        "n_global": GRS_MIND_BATCH, "neg": ("item_id", "item_cluster"),
        "batches": [grs_negatives(
            {c: mind_rows.column(c).slice(s * GRS_MIND_BATCH, GRS_MIND_BATCH)
             .combine_chunks() for c in mind_rows.column_names},
            MATCH_ON_CARD_ITEMS, SEED + s, ("item_cluster", 40))
            for s in range(GRS_STEPS)]}
    hpaths = gr_match_files(root)
    htext = gr_match_text(hpaths, os.path.join(root, "hstu_match"), 0.0)
    hrows = pq.read_table(hpaths["train"])
    steps["hstu_match"] = {
        "text": htext, "labels": ["cand_seq__action_weight"],
        "plan": {t: "row_wise" for t in ("user_id_emb", "user_degree_emb",
                                         "video_emb")},
        "n_global": GRS_HSTU_BATCH, "neg": ("cand_seq__video_id",),
        "batches": [grs_negatives(
            {c: hrows.column(c).slice(s * GRS_HSTU_BATCH, GRS_HSTU_BATCH)
             .combine_chunks() for c in hrows.column_names},
            GR_MATCH_ITEMS, SEED + 10 + s) for s in range(GRS_STEPS)]}
    return {"loop": loop, "steps": steps, "root": root}


# the sampler block of MIND's config: parsed for the item-side features'
# data group; the phase feeds the negatives itself
_MATCH_SAMPLER_FOR_GRS = MATCH_ON_CARD["mind"][0]


@contextlib.contextmanager
def first_writes(n: int):
    """Captures (table before, targets, rows, table after) of the first
    ``n`` ``write_rows`` calls inside the block (they count as
    launches); yields the list."""
    from torcheasyrec_tpu_torch.ops import row_write

    calls, real = [], row_write.write_rows

    def capture(table, ids, rows):
        if len(calls) >= n:
            return real(table, ids, rows)
        before = table.clone()
        real(table, ids, rows)  # counts on the module's name, ``capture``
        calls.append((before, ids.clone(), rows.clone(), table.clone()))
        return table

    capture.launches = real.launches
    row_write.write_rows = capture
    try:
        yield calls
    finally:
        row_write.write_rows = real
        real.launches = capture.launches


def grs_state(model) -> dict:
    """The model's state_dict on the host (tables canonical: collective
    over the ranks)."""
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items()}


def grs_rank(shard, cfgs):
    """Rank side: every loop config's ``train_and_evaluate`` at world size
    2, then every step config's GRS_STEPS steps on this rank's rows; the
    counts of kernels #1, #2 and #3 set to 0 just before and read just
    after; the first two row writes (dbmtl_jrc's packed ``row_wise``
    blocks) held against the plain version on this rank afterwards."""
    from torcheasyrec_tpu_torch import main as port_main
    from torcheasyrec_tpu_torch.ops import hstu
    from torcheasyrec_tpu_torch.ops.row_write import write_rows

    out = {"rank": shard.rank, "results": {}, "states": {}, "losses": {},
           "seconds": {}}
    sync()
    t_all = time.perf_counter()
    write_rows.launches = 0
    hstu.hstu_attention_fwd.launches = 0
    hstu.hstu_attention_bwd.launches = 0
    with first_writes(2) as calls, deterministic():
        for name, c in cfgs["loop"].items():
            t0 = time.perf_counter()
            out["results"][name] = port_main.train_and_evaluate(
                c["world_2"], device=SHARDED_DEVICE, shard=shard)
            sync()
            out["seconds"][name] = time.perf_counter() - t0
        for name, c in cfgs["steps"].items():
            t0 = time.perf_counter()
            model, features, _, state, step = sharded_trainer(
                c["text"], shard, c["plan"])
            losses = []
            for cols in c["batches"]:
                state, m = step(state, parse_batch(
                    features, grs_rank_cols(cols, shard.rank, c["n_global"],
                                            c["neg"]), c["labels"]))
                losses.append(float(m["total_loss"]))
            out["states"][name] = grs_state(model)
            out["losses"][name] = losses
            del model, state, step
            sync()
            out["seconds"][name] = time.perf_counter() - t0
    sync()
    out["launches"] = {"row_write": write_rows.launches,
                       "hstu_attention_fwd": hstu.hstu_attention_fwd.launches,
                       "hstu_attention_bwd": hstu.hstu_attention_bwd.launches}
    out["seconds"]["all"] = time.perf_counter() - t_all
    out["row_write_checked"] = [tuple(c[1].shape) for c in calls]
    check_step_writes(f"train_global_reductions rank {shard.rank}", calls)
    return out


def grs_ckpt_report(a_dir, b_dir) -> dict:
    """The latest checkpoints of two model dirs: the largest |a - b| of
    each weight relative to its max in ``b``, the worst tensor, and
    whether the keys agree."""
    from torcheasyrec_tpu_torch.utils import checkpoint_util

    a, b = (torch.load(checkpoint_util.latest_checkpoint(d),
                       map_location="cpu", weights_only=True)["model"]
            for d in (a_dir, b_dir))
    if a.keys() != b.keys():
        return {"max_err": float("inf"), "keys_equal": False}
    return rel_report({k: v.float() for k, v in a.items()},
                      {k: v.float() for k, v in b.items()})


def grs_dump_report(a_dir, b_dir) -> dict:
    """Two delta dump dirs: the same files with the same ids, and the
    rows' largest distance relative to each file's max."""
    import pyarrow.parquet as pq

    def read(d):
        out = {}
        for name in sorted(os.listdir(d)):
            t = pq.read_table(os.path.join(d, name))
            out[name] = (t.column("id").to_numpy(), torch.tensor(
                np.asarray(t.column("embedding").to_pylist(), np.float32)))
        return out

    a, b = read(a_dir), read(b_dir)
    same_ids = a.keys() == b.keys() and all(
        np.array_equal(a[k][0], b[k][0]) for k in b)
    rows = (rel_report({k: v[1] for k, v in a.items()},
                       {k: v[1] for k, v in b.items()})
            if a.keys() == b.keys() else {"max_err": float("inf")})
    return {"files": len(b), "names_and_ids_equal": same_ids,
            "ids": int(sum(len(v[0]) for v in b.values())), "rows": rows}


@contextlib.contextmanager
def first_attention_call():
    """The arguments of the first call of kernel #1 inside the block."""
    from torcheasyrec_tpu_torch.ops import hstu

    seen, real = [], hstu.hstu_attention_fwd

    def capture(*args):
        if not seen:
            seen.append(tuple(a.detach().clone() if torch.is_tensor(a)
                              else a for a in args))
        return real(*args)

    capture.launches = real.launches
    hstu.hstu_attention_fwd = capture
    try:
        yield seen
    finally:
        hstu.hstu_attention_fwd = real
        real.launches = capture.launches


def grs_attention_check(args) -> dict:
    """Kernels #1 and #2 against their plain versions at HSTU-Match's
    captured call, cut to one rank's rows; these launches do not count."""
    from torcheasyrec_tpu_torch.ops import hstu

    per = args[0].shape[0] // SHARDED_WORLD
    q, k, v, lengths = (a[:per] for a in args[:4])
    targets = None if args[4] is None else args[4][:per]
    rest = args[5:]
    do = slice_upstream_grad(v)
    kept = (hstu.hstu_attention_fwd.launches,
            hstu.hstu_attention_bwd.launches)
    got = hstu.hstu_attention_fwd(q, k, v, lengths, targets, *rest)
    ref = hstu._torch_hstu_mha(q, k, v, lengths, rest[0], rest[1], targets,
                               *rest[2:])
    fwd_err = check("train_global_reductions attention fwd", got, ref,
                    FP32_TOL)
    grads = hstu.hstu_attention_bwd(q, k, v, do, lengths, targets, *rest)
    refs = hstu._torch_hstu_mha_bwd(q, k, v, do, lengths, rest[0], rest[1],
                                    targets, *rest[2:])
    bwd_err = max(check(f"train_global_reductions attention bwd {n}", g, r,
                        FP32_TOL) for n, g, r in zip("qkv", grads, refs))
    hstu.hstu_attention_fwd.launches, hstu.hstu_attention_bwd.launches = kept
    return {"shape": list(q.shape) + [v.shape[-1]], "dtype": str(q.dtype),
            "fwd_max_abs_err": fwd_err, "bwd_max_abs_err": bwd_err}


def zr_then_pipelined(shard, zr_args, cfgs, grs_cfgs):
    """``zr_rank``, then (a)'s runs (``pipelined_rank``) and
    ``train_global_reductions``' (``grs_rank``) on the same, warm,
    ranks."""
    return (zr_rank(shard, *zr_args), pipelined_rank(shard, cfgs),
            grs_rank(shard, grs_cfgs))


def phase_train_global_reductions(smi):
    """The reductions over the global batch at world size 2 (docstring,
    phase ``train_global_reductions``). Returns the launches of kernels
    #1, #2 and #3 on the ranks' main paths, summed over the ranks. Every
    check's result is printed before a failure raises."""
    from torcheasyrec_tpu_torch import main as port_main

    mode, backend = sharded_backend()
    out = {"phase": "train_global_reductions", "ranks_on": mode,
           "card": smi}
    seconds, failures = {}, []
    if GRS_DONE:
        cfgs, ranks = GRS_DONE["cfgs"], GRS_DONE["ranks"]
        out["ranks_of"] = "the ranks of train_zch_ranks, after their own work"
    else:
        t0 = time.perf_counter()
        cfgs = grs_configs()
        seconds["data"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = run_ranks(grs_rank, SHARDED_WORLD, (cfgs,), backend,
                          cfgs["root"])
        seconds["world_2_spawned"] = time.perf_counter() - t0
        out["ranks_of"] = "a spawn of their own"
    seconds["world_2_by_config"] = ranks[0]["seconds"]
    models = {}
    for name, c in cfgs["loop"].items():
        t0 = time.perf_counter()
        with deterministic(), row_blocks(SHARDED_WORLD):
            one = port_main.train_and_evaluate(c["world_1"],
                                               device=SHARDED_DEVICE)
        sync()
        seconds[f"world_1_{name}"] = time.perf_counter() - t0
        dirs = [os.path.join(cfgs["root"], f"{name}_world_{w}")
                for w in (2, 1)]
        rep = grs_ckpt_report(*dirs)
        rep["steps"] = ([int(r["results"][name]["step"]) for r in ranks]
                        + [int(one["step"])])
        models[name] = rep
        if not rep["max_err"] <= GRS_TOL:
            failures.append(f"{name} at world 2 vs 1: {rep['max_err']} "
                            f"({rep.get('table')})")
        if set(rep["steps"]) != {GRS_STEPS}:
            failures.append(f"{name}: steps {rep['steps']}")
        if name == "deepfm_dump":
            dump = grs_dump_report(*(os.path.join(d, "delta_embedding_dump")
                                     for d in dirs))
            rep["dump"] = dump
            if not (dump["files"] and dump["names_and_ids_equal"]
                    and dump["rows"]["max_err"] <= GRS_TOL):
                failures.append(f"delta dump at world 2 vs 1: {dump}")
    attention = None
    for name, c in cfgs["steps"].items():
        t0 = time.perf_counter()
        model, features, _, state, step = sharded_trainer(c["text"])
        losses = []
        with deterministic(), row_blocks(SHARDED_WORLD), \
                first_attention_call() as seen:
            for cols in c["batches"]:
                state, m = step(state, parse_batch(features, cols,
                                                   c["labels"]))
                losses.append(float(m["total_loss"]))
        ref = grs_state(model)
        del model, state, step
        if seen:
            attention = grs_attention_check(seen[0])
        sync()
        seconds[f"world_1_{name}"] = time.perf_counter() - t0
        tol = GRS_HSTU_TOL if name == "hstu_match" else GRS_TOL
        rep = rel_report(ranks[0]["states"][name], ref)
        rep["losses"] = {"world_2": ranks[0]["losses"][name],
                         "world_1": losses}
        models[name] = rep
        if not rep["max_err"] <= tol:
            failures.append(f"{name} at world 2 vs 1: {rep['max_err']} "
                            f"({rep.get('table')}), bound {tol}")
        if not np.allclose(rep["losses"]["world_2"], losses, rtol=tol * 10):
            failures.append(f"{name} losses: {rep['losses']}")
    out["models"] = models
    for name in list(cfgs["loop"]) + list(cfgs["steps"]):
        digests = {digest(r["states"][name].values()) for r in ranks
                   if name in r["states"]}
        if len(digests) > 1:
            failures.append(f"{name}: the ranks' states differ")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    out["launches_main_path"] = launches
    out["row_write_checked_on_ranks"] = [r["row_write_checked"]
                                         for r in ranks]
    out["attention_check"] = attention
    if attention is None or not (launches["hstu_attention_fwd"] > 0
                                 and launches["hstu_attention_bwd"] > 0):
        failures.append(f"kernels #1/#2 on the ranks: {launches}")
    if not (launches["row_write"] > 0
            and all(r["row_write_checked"] for r in ranks)):
        failures.append(f"kernel #3 on the ranks: {launches}")
    out["seconds"] = seconds
    out["failures"] = failures
    emit(out)
    if failures:
        raise AssertionError(f"train_global_reductions: {failures}")
    return launches


def device_record() -> dict:
    return {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import torcheasyrec_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    start, seconds = time.perf_counter(), {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = timed("env", phase_env)
    fwd_err = timed("kernel", phase_kernel)
    bwd_err = timed("kernel_bwd", phase_kernel_bwd)
    write_err, write_timing, write_library_ms, write_slice_ms = timed(
        "kernel_row_write", phase_kernel_row_write, smi)
    serve_launches, _ = timed("slice", phase_slice)
    train_fwd_launches, bwd_launches, step_ms, trainer = timed(
        "train", phase_train)
    fwd_timing = timed("timing", phase_timing)
    bwd_timing = timed("timing_train", phase_timing_train, trainer, step_ms)
    del trainer
    torch.cuda.empty_cache()
    deepfm_launches, _ = timed("train_deepfm", phase_train_deepfm)
    loader_launches, _ = timed("train_loader", phase_train_loader)
    zoo_launches, lane_off_launches = timed("train_zoo", phase_train_zoo)
    (fp16_fwd_launches, fp16_bwd_launches), (fwd16, bwd16), options_writes = (
        timed("train_options", phase_train_options))
    gr_launches, gr_timing = timed("train_gr", phase_train_gr)
    zoo_rest_launches = timed("train_zoo_rest", phase_train_zoo_rest)
    export_fwd, export_writes = timed("export", phase_export, smi)
    tdm_launches = timed("train_tdm", phase_train_tdm, smi)
    torch.cuda.empty_cache()
    sharded = timed("train_sharded", phase_train_sharded, smi)
    torch.cuda.empty_cache()
    zch_launches = timed("train_zch", phase_train_zch, smi,
                         SHARDED_AUC.get("world_2"))
    torch.cuda.empty_cache()
    sid_launches = timed("train_sid", phase_train_sid, smi)
    torch.cuda.empty_cache()
    fg_launches = timed("train_fg", phase_train_fg, smi)
    torch.cuda.empty_cache()
    zch_ranks_launches = timed("train_zch_ranks", phase_train_zch_ranks, smi)
    torch.cuda.empty_cache()
    stream_launches = timed("train_stream", phase_train_stream, smi)
    torch.cuda.empty_cache()
    pipelined_launches = timed("train_pipelined", phase_train_pipelined, smi)
    torch.cuda.empty_cache()
    grs_launches = timed("train_global_reductions",
                         phase_train_global_reductions, smi)
    emit({"phase": "timeline", "seconds": seconds,
          "total_s": time.perf_counter() - start})

    def kernel_row(name, replaces, launches, err, timing, library_ms=None,
                   **extra):
        kernel_ms, plain_ms, bound_ms, bound_by = timing
        return {
            "name": name, "route": "cuda",
            "source": f"torcheasyrec_tpu_torch/ops/csrc/{name}.cu",
            "replaces": f"torcheasyrec_tpu/ops/pallas/{replaces}",
            "launches": launches, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra,
        }

    def fp16_row(times: dict) -> dict:
        return {k: times[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                      "bound_by")}

    def gr_row(name: str) -> dict:
        """The kernel at hstu_synth's shape, fp32 as that model runs."""
        return {k: gr_timing[name][k] for k in (
            "kernel_ms", "plain_ms", "bound_ms", "bound_by", "shape")}

    gr_fwd = gr_launches["hstu_attention_fwd"]
    gr_bwd = gr_launches["hstu_attention_bwd"]

    emit({"kernels": [
        # no single PyTorch call computes SiLU (softmax-free) attention or
        # its backward: library_ms is null for both. ms, plain_ms and
        # bound_ms are bf16's; fp16 has its own beside them
        kernel_row("hstu_attention_fwd", "hstu_attention.py:114",
                   serve_launches + train_fwd_launches + fp16_fwd_launches
                   + gr_fwd + export_fwd + sharded["hstu_attention_fwd"]
                   + grs_launches["hstu_attention_fwd"],
                   fwd_err, fwd_timing,
                   launches_by_path={"serving": serve_launches,
                                     "training": train_fwd_launches,
                                     "train_options": fp16_fwd_launches,
                                     "train_gr": gr_fwd,
                                     "export": export_fwd,
                                     "train_sharded":
                                         sharded["hstu_attention_fwd"],
                                     "train_global_reductions":
                                         grs_launches["hstu_attention_fwd"]},
                   launches_by_dtype={
                       "bf16": serve_launches + train_fwd_launches,
                       "fp16": fp16_fwd_launches,
                       "fp32": gr_fwd + sharded["hstu_attention_fwd"]
                       + grs_launches["hstu_attention_fwd"],
                       "export (bf16, and fp32 HSTU-Match)": export_fwd},
                   fp16=fp16_row(fwd16),
                   hstu_synth_fp32=gr_row("hstu_attention_fwd")),
        kernel_row("hstu_attention_bwd", "hstu_attention.py:207",
                   bwd_launches + fp16_bwd_launches + gr_bwd
                   + sharded["hstu_attention_bwd"]
                   + grs_launches["hstu_attention_bwd"], bwd_err, bwd_timing,
                   launches_by_path={"training": bwd_launches,
                                     "train_options": fp16_bwd_launches,
                                     "train_gr": gr_bwd,
                                     "train_sharded":
                                         sharded["hstu_attention_bwd"],
                                     "train_global_reductions":
                                         grs_launches["hstu_attention_bwd"]},
                   launches_by_dtype={
                       "bf16": bwd_launches, "fp16": fp16_bwd_launches,
                       "fp32": gr_bwd + sharded["hstu_attention_bwd"]
                       + grs_launches["hstu_attention_bwd"]},
                   fp16=fp16_row(bwd16),
                   hstu_synth_fp32=gr_row("hstu_attention_bwd")),
        # at the real step's dim-16 targets, through the table less its
        # scratch row as the engine calls it; library_ms: index_copy_ of
        # the same writes (the scratch entries taken out beforehand);
        # slice_ms: the slice's shape over the whole table, as the kernel
        # was first timed
        kernel_row("row_write", "row_write.py:35",
                   deepfm_launches + loader_launches + zoo_launches
                   + lane_off_launches + options_writes
                   + gr_launches["row_write"] + zoo_rest_launches
                   + export_writes + tdm_launches + sharded["row_write"]
                   + zch_launches + sid_launches + fg_launches
                   + zch_ranks_launches + stream_launches
                   + pipelined_launches + grs_launches["row_write"],
                   write_err, write_timing, write_library_ms,
                   slice_ms=write_slice_ms,
                   launches_by_path={
                       "train_deepfm": deepfm_launches,
                       "train_loader": loader_launches,
                       "train_zoo": zoo_launches,
                       "train_zoo_dssm_dense_lane_off": lane_off_launches,
                       "train_options": options_writes,
                       "train_gr": gr_launches["row_write"],
                       "train_zoo_rest": zoo_rest_launches,
                       "export": export_writes,
                       "train_tdm": tdm_launches,
                       "train_sharded": sharded["row_write"],
                       "train_zch": zch_launches,
                       "train_sid": sid_launches,
                       "train_fg": fg_launches,
                       "train_zch_ranks": zch_ranks_launches,
                       "train_stream": stream_launches,
                       "train_pipelined": pipelined_launches,
                       "train_global_reductions": grs_launches["row_write"]}),
    ]})
    print(smi, flush=True)
    emit(device_record())
    return 0


if __name__ == "__main__":
    sys.exit(main())
