#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100): builds the
twelve CUDA kernels of the serve and train paths and of the nearest
selection from `stratanet2_tpu_torch/ops/csrc/`, holds each against its
plain PyTorch version at the shapes its path gives it, drives the serve
step, the train step, the training loop, parcel predict, the four CLIs,
the parallel paths (two ranks sharing the card) and the opt-in routes at
full width (B=20 clouds x N=10000 points, random weights from a seed), the
steps on dense plots (N=65536 at diam_pix 100) through the kernels' paths
for long shapes, the reference training schedule (300-epoch folds in
processes of their own, one killed and resumed), the SSL cycle
(pseudo-labels, pretraining, a warm-started cross-validation, folds in one
process) and the learnability sweep, serves a reference checkpoint, runs
the measurement and profiling tools small and serves `bench.py`'s geometry
(128 clouds of 4,096 points), and checks their outputs.

    python3 chip_smoke.py            # one card; exits non-zero on any failure

Phases, in order, each failing loudly:
  1. the card's name and power limit (nvidia-smi), then its SM clock and
     maximum SM clock (`"phase": "card"`);
  2. build: one nvcc per kernel source, started together;
  The steps run as CUDA graphs on the card (`learning/programs.py`): a
  step's first call for a batch shape and set of tensors runs its body and
  captures it, later calls replay it, and the launch counters add the
  launches a graph holds at each replay; the phases that record kernel
  inputs run the steps' eager bodies (`step.body`), since a capture
  computes nothing, and phase 15i holds the replays to those bodies.
  Serve step (fps, sa_fused_eval, knn_interpolate, pixel_max):
  3. capture: one serve step's eager body records every kernel call's
     inputs;
  4. per kernel and call site: kernel vs plain on the captured inputs
     (indices exactly, values within the stated atol; for the SA kernel the
     picks of its built-in ball query are read back through probe launches),
     CUDA-event times of kernel, plain and, where one PyTorch call computes
     the same function, that call (pixel_max also its device time a launch, its
     kernel the only device operation of a call); then FPS's reference sites
     (FPS_REFERENCE: tie-heavy integer-grid clouds at the two step shapes,
     the serve batch unpartitioned at N=10000, a grid cloud at fps_kernel's
     largest N, the pruning's hard clouds (duplicates, fewer distinct points
     than picks; plots at Lambert-93 scale; 90% of the points in 5% of the
     plot, on the cluster path), and the long rows: a grid cloud at the
     dense SA1 parts, an odd row of 40,001 points, rows of 60,000 and
     100,000 (clusters of 8 blocks of 512 and of 1024 threads) and a row of
     200,000 past the cluster's shared memory), each with 0 differing
     indices and a `"fps_pruning"` line with the share of its warp updates
     that the pruning skipped (`cuda_kernels.fps_pruning`, one more launch,
     the same picks), and the SA
     kernel's selection reference sites (SEL_REFERENCE: tie-heavy grid
     clouds at the SA1 and SA2 shapes, a ragged site with an empty last
     group, a site at the longest group staged whole, then the cell grid's
     sites: a grid cloud at the dense SA1 shape, groups longer than two
     slices with a ragged last one, and at the dense SA1 shape plots 1 km
     from the origin, 90% of the points in 5% of the plot and points sorted
     by x), each with 0 differing picks and outputs within SA_ATOL, each
     cell-grid site with its pairs scored against all pairs
     (`"grid_work"`), and kNN's reference sites
     (KNN_REFERENCE: tie-heavy integer-grid clouds at the FP1 and FP2 shapes
     with duplicated sources and targets on sources, a ragged site, three
     sources, more sources than the kernel stages at once, run on knn_kernel;
     then the cell grid's KNN_GRID_REFERENCE at the dense FP1 shape, B=2: an
     integer grid with duplicated sources and targets on sources, plots 1 km
     from the origin, clustered, with sources sorted by x, and targets off
     every source, then B=1 and B=67, the grid pass's clusters of 8 and of
     its floor of 4 blocks; each with its `"grid_work"` line and weights and outputs bit
     for bit), each with 0 differing indices and outputs and weights within
     KNN_ATOL, and
     pixel_max's (PIXEL_MAX_REFERENCE: quantised values whose tied maxima
     fall in different blocks of a cloud's cluster, ids outside the pixels,
     empty pixels, P = 37, N a multiple of no share; a cloud so small that
     the last blocks of its cluster get no point; the tables past a block
     pixel ranges at P = 100 and P = 300), equal
     exactly; every site on the cell grid (here, in phases 11 and 15h)
     reads back the grid its launch built (`recorded_cells`) and holds it
     to the CPU mirror, parameters bit for bit, starts, points and
     centroids cell by cell (`"grid_check"`, 0 differing); then
     `"grid_cluster_sizes"`: kNN's grid path at every cluster size
     `cuda_kernels.cell_grid_cluster` returns (1 to 8 blocks a cloud, one
     cloud of the fewest entries that take each), held alike;
  4b. `"phase": "fps_chain"`: FPS's latency floor, the time of a pick with
     one point a thread (N=1024), against the per-pick time and the share
     of warp updates skipped at the step sites; beside them the cluster's
     time a pick at the dense SA1 parts (40 x 32,768, FPS_CHAIN_LONG) and,
     at the 80,000-point step's 40 x 40,000, its instance (block size, cs),
     its waves of clusters and its time a pick;
  5. the counted serve step (its first call: the body, then the capture):
     launch counters zeroed just before, read just
     after (2 per serve kernel, 0 for the train kernels), outputs finite,
     coverages in [0, 1];
  6. step time (median of 30 synchronised steps, replays) and points/s;
  7. profile: `torch.profiler` traces 10 steps; each device kernel's time
     per step, the port's kernels summed per wrapper, all twelve listed (a
     wrapper shows kernels exactly when it launches), the rest of
     the device time (plain PyTorch ops), and the idle share of the step,
     1 - device busy time / the median step time of phase 6;
  8. the same step at B=2 against the port run on the CPU, and at B=1
     against its row of the B=2 step;
  Train step (forward, plot projection, 3-term loss, backward, Adam; a KDE
  prior fitted on the batch's z; BN running statistics at init; SA1 and SA2
  on the fused route through the four SA train kernels):
  9. capture: one train step's eager body, on a copy of the model, records
     every call of
     the seven train kernels and of pixel_max, whose train-step site is held
     exactly to its plain version and timed like a serve site;
  10. fused vs unfused: SA1 and SA2 at the PROD shapes on the fused route
     and on the unfused path from the same weights and inputs, with random
     BN running means so that the statistics' shifts are nonzero (out, BN
     state and every gradient, tolerances below); the fused stages' SA train
     passes and the unfused SA2's gather backward (a knn_scatter site) are
     captured as reference sites;
  11. per train kernel and call site, the train step's, then phase 10's,
     then the SA train passes' tie-heavy ragged sites (SA_TRAIN_REFERENCE:
     integer-valued q and cterm, K = 31 and 61, masked slots inside
     batches, centroids with no valid slot), then ball_query's
     SEL_REFERENCE sites (the clouds of phase 4's, drawn anew; the largest
     group is the query's own), then the synthetic pixel-max backward sites
     (out-of-range ids, empty pixels; P = 20 and the dense P = 100), then
     knn_scatter's synthetic sites
     (KNN_SCATTER_REFERENCE: a hot destination taking 20% of the pairs, and
     a ragged site with empty rows and ids outside [0, S)):
     kernel vs plain (ball_query and pixel_max_bwd exactly; knn_scatter
     launched twice and equal bit for bit, equal bit for bit to
     `knn_scatter_ordered_plain` (its fixed order of sums), rows with no
     contribution exactly 0, within the float32 error bound of a sum in any
     order, with its device time a launch (its kernel the only device operation)
     and its largest destination degree; the SA train passes' winners and winning values
     exactly, their per-channel sums over edges within the float32 bound at
     the kernels' own summation depth, which must reject a result with one
     block's partial row taken out or zeroed, and dq's scatter within the
     bound of a sum in any order; that bound, and sa_train_bwd2's dcterm
     bound, must reject a result of zeros; sa_train_bwd2 also called twice
     and equal bit for bit, its edge buffer equal to the plain version's
     de0 and its dq equal bit for bit to `sa_train_dq_ordered_plain` of that
     buffer, with the device time of its edge and dq passes and the edge
     buffer's traffic), times as in phase 4, library calls `index_add_`
     (for sa_train_bwd2, of its dq part) and `scatter_add_`;
  11b. `"phase": "launch_path"`: host microseconds a call of the two stream
     getters, of the device check and context, of the parts of a
     pixel_max_bwd call and of a whole pixel_max call;
  12. the counted train step: fps 2, ball_query 2, knn_interpolate 2,
     knn_scatter 2, pixel_max 1, pixel_max_bwd 1, sa_fused_eval 0,
     sa_train_stats 1, sa_train_main 2, sa_train_bwd1 1, sa_train_bwd2 2 (a
     launch: its edge and dq passes); loss parts and gradients finite,
     every parameter changed;
  12b. `"phase": "train_step_reproducible"`: two train steps from one
     saved state (model, Adam, schedule, batch), params, BN state and loss
     parts equal bit for bit;
  13. train step time (median of 30 synchronised steps) and points/s;
  14. profile of the train step, as phase 7;
  15. a B=2 train step on the card against the port on the CPU: loss parts,
     every gradient, BN state and params after the step (tolerances below);
  15b. `"phase": "serve_after_train"`: the serve step at B=2 on the model
     fresh from the train steps (in train mode) equals the serve step on an
     eval copy, moves no BN buffer and leaves the model in train mode;
  15c. `"phase": "loader_steps"`: 24 synthetic plots of 12000 points written
     with the port's LAS writer, read and prepared (`load_las_file`,
     `clean`, `pre_transform`), batched by `PlotLoader` (2 worker threads,
     PROD subsample) for 3 train steps and 1 serve step on the card (launch
     counters zeroed just before and read just after): every loss part
     finite, every shape right; prints the min-z path (native or numpy),
     the host ms a batch and the step ms. Each of those train batches opens
     an epoch (24 plots make one batch of 20), so it is the cold latency of
     a new pool. Then the steady state: one epoch of 12 batches from one
     pool over the prepared plots repeated under new ids, the loader alone
     and then with a train step after each batch (the wait for a batch
     while the card trains);
  15d. `"phase": "train_full"`: the training loop (`learning/train.train_full`)
     over 100 plots (15c's prepared plots repeated under new ids), fold 1 of
     the port's KFold split (80 train, 20 val), the PROD model, the DEV
     profile with early stopping, on the device-resident path that the
     default (`device_resident="auto"`) takes there: 2 epochs (checkpoints written, loss parts
     finite, JAX's dict keys), a resume to 3 epochs from a copy of that
     folder and one from an unbroken 3-epoch run's own epoch-2 checkpoints,
     each against that unbroken run (bit for bit: RESUME_BOUND), the
     same two resumes with Adam's state dropped outside it, and
     the best checkpoint reloaded into a fresh model and evaluated (equal to
     the run's final eval); launch counters zeroed before and checked after each
     run (train batches x the train step's, eval batches x EVAL_LAUNCHES),
     and one 2-epoch run on the host loader's path (`device_resident="false"`),
     counted alike; then the seconds an epoch, points/s and ms a batch of
     each path, eval and checkpoint seconds, and the figures skipped for a
     missing module, each on a line of its own; then `"phase":
     "train_full_paths"`, the two paths' epochs alone from one model (seconds
     an epoch, ms a batch, the device busy share of an epoch, the card-resident
     MB of the tables) and `"phase": "device_epoch_host_syncs"`, the host
     calls that wait for the card in a device-resident epoch's loop;
  15h. `"phase": "dense"` (`dense_phase`, run right after 15d): the serve
     and train steps on
     dense plots (DENSE: B=20 x N=65536, diam_pix 100, the default plan),
     which cross every limit of the PROD kernels: SA1's FPS rows of 32,768
     points (the cluster path), SA1's groups of 2,048 points (the selection
     on the cell grid, in the SA eval kernel serving and the ball query
     training, each site's scored, in-radius and all pairs on its row, one
     call of each under the sync debug mode, `"grid_sync_debug"`), kNN at
     FP1 from 16,384 sources and FP2 from 4,096 (the cell grid, each site's
     sources scored a target on a `"grid_work"` line), the 240,000 B pixel
     table (three pixel ranges); launches counted by wrapper
     (SERVE_LAUNCHES, TRAIN_LAUNCHES) and by path (DENSE_SERVE_PATHS,
     DENSE_TRAIN_PATHS), outputs finite, coverages in [0, 1], loss parts
     finite, every parameter changed; every path's call sites in the two
     steps held to the plain versions (0 differing picks and entries) and
     timed, the global FPS path and sa_train_bwd2's dq windows at their
     reference sites (DQ_REFERENCE: SA1's shape at subsample_size 80,000),
     FPS's time a pick on both and the clusters of each block size the
     card holds at once at each long-row shape (`"phase":
     "fps_cluster_resident"`); a whole
     train step at B=20 x 80,000 (`"phase": "dense_dq_train"`: launches by
     wrapper and by path, the dq windows among them, outputs, its FPS rows
     and SA1 dq windows held to the plain versions and timed, the median of
     3 steps, one profiled step, `"dense_dq_train_profile"`); the median of
     DENSE_STEPS steps of each and one profiled step of
     each, in which each path's kernel shows by name exactly when it
     launched; sa_train_bwd2's edge buffer (the card against the CPU is
     phases 8 and 15's, at PROD: at the dense shapes the CPU's plain
     versions took most of this phase);
  15i. `"phase": "graphs"` (`graphs_phase`, run after 15h): the replayed
     steps against their eager bodies bit for bit: the serve step at PROD
     (B=20), at B=2 and at the dense shape; `make_predict_program` over 3
     batches (each batch's outputs its own); 3 train steps from one state
     with the learning rate dropping before the third (params, BN buffers,
     Adam's moments and count, loss parts); two device-resident epochs and
     an eval (sums, state, the generators' states, predictions and loss
     parts); captures, replays and launches counted through replay; then
     the graph against the eager body in turns: serve and train step ms at
     PROD and at the dense shape, the device-resident epoch's ms a batch
     and busy share;
  15j. the reference training schedule (`schedule_phase`, run after 15i):
     `"phase": "learnability"`, `scripts/torch_learnability_check.py` at
     its defaults in this process (val MAE must beat the mean baseline);
     `"phase": "schedule_fold"`, a line a child process of
     `scripts/torch_prod_schedule_run.py` at PROD (110 plots of 12,000
     points, B=20 x 10,000, 300 epochs, early stopping on): fold 1 killed
     by SIGTERM past epoch SCHEDULE_KILL_AFTER and resumed, fold 2, and an
     unbroken fold 1 in a fresh root, each finished run with its epochs,
     seconds (and their split), points/s, val MAE against its baseline
     (must beat it), launches (the train step's a batch and the eval's an
     eval batch, `schedule_launches`), graphs and peak MB; `"phase":
     "schedule_resume"`, the resumed fold 1 against the unbroken one bit
     for bit (`compare_runs`: both checkpoints' tensors and metadata, the
     loss parts of every epoch and eval from the resume on); `"phase":
     "schedule_host"`, the host's part of an epoch besides its batches;
     `"phase": "schedule"`, the phase's seconds against SCHEDULE_BUDGET_S;
  15k. the SSL cycle (`ssl_cycle_phase`, run after 15j):
     `scripts/torch_ssl_cycle.py` in this process at the JAX side's v5e
     geometry (60 plots of 12,000 points, 4 parcels, B=20 x 10,000, 2 folds
     of 60 epochs, 40 SSL epochs; PROD): `"phase": "ssl_cycle_stage"`, a
     line a stage (cold cross-validation, prepare, pseudo-labelling, SSL
     pretraining, warm cross-validation through the port's CLIs) with its
     launches (every kernel of its path, none off it), graphs and peak MB;
     `"phase": "ssl_cycle_fold"`, a line a fold with its seconds, the card's
     memory at its end (a later fold's within max(16 MB, 5% of the first's
     peak) of the first's) and its captures (each fold captures anew);
     `"phase": "ssl_cycle_fold_alone"`, fold 2 trained again alone in a
     fresh process against the cross-validation's, bit for bit
     (checkpoints, Adam state, every epoch's loss parts); `"phase":
     "ssl_sweep"`, a line a run of `scripts/torch_learnability_sweep.py`
     for seed 0 at both ball-query policies (the nearest one launches
     `ball_query_nearest`); `"phase": "ssl_cycle"`, the cold and warm val
     MAE against their baselines (warm must beat its own, cold the JAX
     side's MAE at this geometry), and the phase's seconds against
     SSL_CYCLE_BUDGET_S;
  15l. the capped-K studies and the parity eval (`cap_studies_phase`, run
     after 15k): `"phase": "neighbor_cap_study"`, the port's eval forward
     at PROD caps for both ball-query policies on the unfused route
     against the reference oracle (cap 2000, on the host) on 2 clouds of
     10,000 points, weight seed 100, each policy's launches its route's
     and its plot coverages equal to the CPU's within CPU_ATOL;
     `"phase": "cap_grad_study"`, the gradient of the train loss at caps
     32 / 64 and 512 / 256 on one batch of 4 learnable plots at init, each
     held to the CPU's (TRAIN_GRAD_RTOL of a leaf's max |g|, the loss
     within TRAIN_LOSS_ATOL), the cosine and norm ratio; `"phase":
     "cap_train_study"`, `train_full` capped against generous (20 plots,
     8 epochs, train_n 2,048) with launches, val MAE and seconds; `"phase":
     "parity_eval"`, `scripts/torch_parity_eval.py` on phase 15f's data
     tree and a seeded reference-layout checkpoint (the eval route's
     launches), and on 4 of its plots on the card against the CPU within
     CPU_ATOL; `"phase": "cap_studies"`, the phase's seconds against
     CAP_STUDIES_BUDGET_S;
  15m. the measurement and profiling tools (`tools_phase`, run after
     15l): `"phase": "tools_b128"`, `bench.py`'s geometry (128 clouds of
     4,096 points) through the eval forward, each of its kernel sites held
     to its plain version (`"tools_site"` lines: SA1's FPS on 256 rows of
     2,048 points, 0 differing picks), its launches as a replayed graph,
     and the same clouds in batches of 16 equal to it within CPU_ATOL;
     `"phase": "tools_fps_parts"`, a PROD train step at fps_parts 4
     (SA1's FPS on 80 rows of 2,500 points), its FPS sites held to the
     plain version and its launches; `"phase": "tools_trace"`,
     `scripts/torch_trace_step.py`'s aggregation of 3 replayed serve
     steps (every serve kernel named, the idle share); `"phase":
     "tools_roofline"`, `scripts/torch_roofline.py`'s line a kernel at the
     PROD sites; `"phase": "tools"`, the phase's seconds against
     TOOLS_BUDGET_S;
  15e. `"phase": "parcel"`: parcel predict at PROD width (`parcel_phase`):
     a synthetic 100 m parcel's LAS (140 m with its buffer, ~627,000
     points) written, tiled and extracted (`"phase": "parcel_prepare"`,
     with the min-z path), `predict_parcel` with chains 8 and 1 for both
     tasks (equal bit for bit, launches counted for every batch the card
     ran), the shapefile update, plots/s end to end with its split (cold,
     and warm with one program for every run), the device busy share of
     the predict loop, and the warm runs by the serve step's graph, by its
     eager body and from pinned memory, in turns; then `"phase":
     "parcel_cpu_reference"`, 4 plots as one batch on the card against the
     CPU (merged tif and PRED_* fields within CPU_ATOL);
  15f. `"phase": "cli"`: the four CLIs in DEV mode at PROD width
     (`cli_phase`) on a data tree written with the port's writers (30 plot
     LAS of 12,000 points and their GT csv; a 60 m parcel's LAS and its
     shapefile): main -> prepare -> predict inference (a subprocess
     `python -m stratanet2_tpu_torch.cli.predict` without `--device`) ->
     predict pseudo_labelling -> main_ssl -> main --PT_model_id, each with
     its artifacts checked and its launches (every kernel of its path, none
     off it), seconds and skipped figures on a line of its own;
  15g. `"phase": "parallel"` (`parallel_phase`): two ranks sharing the card
     over gloo (`parallel/launch.run_ranks`, the group's timeout
     PAR_TIMEOUT; a rank that fails or hangs fails the phase): the
     point-sharded serve step (1x2) at PROD held to its ranks on the CPU at
     B=2 within CPU_ATOL and, at N=PAR_N_ALIGNED, to the single-process
     serve step within SA_ATOL; the data-parallel serve step (2x1); the
     point-sharded train step (1x2) at N=PAR_N_ALIGNED held to the
     single-process step with SA unfused and the data-parallel train step
     (2x1, 10 plots a rank) to the single-process fused step, within phase
     10's TRAIN_* bounds, params and BN state equal bit for bit on the two
     ranks, two point-sharded steps from one state bit for bit; each
     path's launches per rank (the serve steps SERVE_LAUNCHES, the
     point-sharded train step PS_TRAIN_LAUNCHES, the data-parallel one
     TRAIN_LAUNCHES) and step ms (`"parallel_step"`, labelled two ranks
     sharing the card); `train_full` for 2 epochs on each path
     (`"parallel_train_full"`); `dryrun_multichip(2, "gloo", "cuda:0")`
     (`"parallel_dryrun"`); and under torchrun (2 processes, `--device
     cuda:0 --dist_backend gloo`, DEV at PROD width) main --point_sharded,
     main, predict --point_sharded and predict, each with its artifacts and
     every rank's launches (`"parallel_cli"`);
  16. `"phase": "selection_floor"`, for sa_fused_eval and knn_interpolate
     (serve step), ball_query (train step), ball_query_nearest (the
     nearest serve step) and the grouped selection's cell-grid query of
     either library (`ball_query_grid`, `sa_fused_eval_grid`: the dense
     steps' SA1 sites): the SASS instructions a pair
     of the scan loop (cuobjdump of the built library; for kNN also on the
     path of a pair that inserts nothing; the selections' culled queries'
     loops found by their global LDG.E.128 loads, kNN's by the LDS.128 of
     its staged tiles), the step's pairs (for the culled
     queries the pairs they score, their centroids' 3 x 3 cells, beside all
     pairs and the in-radius pairs) and the issue
     floor, pairs x instructions / (132 SMs x 128 lanes x the maximum SM
     clock of phase 1), and each kernel's registers, stack and spills
     (cuobjdump -res-usage), and the SM clocks sampled while the ball query
     runs back to back for a second; then `"phase": "edge_loop"`, one line
     for each instance of the SA train passes, all of which take their
     slots in batches (stats, main at SA1 and SA2, bwd1, bwd2 at SA1 and
     SA2): the SASS
     instructions, SHFLs and FP32 instructions a warp issues an edge in its
     slot loop, its registers, the train step's slots and the issue floor,
     slots x SASS an edge / (132 SMs x 4 schedulers x the maximum SM clock);
     then `"phase": "atomics"`: the global RED/ATOM instructions in the SASS
     of the kernels of ATOMIC_FREE (must be 0: each writes every output
     element once) and their registers,
     stack and spills;
  17. the opt-ins and a reference checkpoint (`optin_phase`, after 15g;
     phase 16 then also reads the nearest kernel's scan loop):
     17a. the nearest selection (`cuda_kernels.ball_query_nearest`) against
     its plain version at the SA1 and SA2 sites of a nearest serve step and
     train step (B=20: C=2500, N=10000, k=32; C=625, N=2500, k=64), then at
     NEAREST_REFERENCE (tie-heavy integer grids at both shapes with
     duplicated points, so zero distances; fewer in-radius points than k;
     every point in radius at NEAREST_MAX_K, one cell; plots 1 km from the
     origin; 90% of the points in 5% of the plot): 0 differing idx and mask
     entries at each, over NEAREST_REPEATS further calls too (with the
     same cell starts), the cell grid that the compared call's kernel built
     (`cuda_kernels.ball_query_nearest_grid`) equal to
     `ballquery.nearest_cells` on the CPU at each (`"phase":
     "nearest_grid"`, with the pairs scored, within the radius and in
     all), one call under
     `torch.cuda.set_sync_debug_mode("error")` (`"nearest_sync_debug"`: no
     host sync), CUDA-event times of the kernel, the plain version and
     the library call (a stable `torch.sort` of the precomputed scores and
     a slice);
     17b/17c. `"phase": "optin_steps"`, one line a route of OPTIN_ROUTES:
     "nearest", "bf16_fused" (compute_dtype bfloat16) and "bf16_unfused"
     (also use_pallas=False): the serve and train steps at PROD through
     `make_predict_step` and `make_train_step`, launches counted and
     checked against the route's (derived beside OPTIN_ROUTES; nearest:
     fps 2, ball_query_nearest 2, knn_interpolate 2, pixel_max 2 serving,
     no SA kernel), outputs finite and coverages in [0, 1], the step ms
     (median of STEPS) and device busy ms, the serve step and the train
     step's loss parts at B=2 against the CPU (serving within CPU_ATOL in
     float32 and BF16_CPU_ATOL in bfloat16, the loss parts within
     TRAIN_LOSS_ATOL), and the same weights and batches on a baseline route
     timed alike with the serve step's gap to it (nearest: the default
     route; bfloat16: its float32 route, the gap above BF16_CPU_ATOL);
     then `"phase":
     "bf16_matmul_probe"`, the two forms of a bfloat16 matmul with float32
     sums at FP1's shape;
     17d. `"phase": "reference_checkpoint"`: a reference-layout state_dict
     from a seed saved as the reference saves it, loaded with
     `load_reference_checkpoint` onto the card (every tensor placed), the
     PROD serve step counted, and B=2 against the CPU load within CPU_ATOL;
     17e. `"phase": "metascripts"`: the three metascripts' `main` on phase
     15f's cross-validation result CSVs copied out of their DEV folder; the
     quantification figure skipped with a warning without matplotlib;
  18. the `{"reference_sites": [...]}` line (phase 10's sites and the
     synthetic FPS, selection, SA train, pixel-max, scatter and nearest
     sites, apart from the per-step rows), the `{"dense_kernels": [...]}`
     line (a row a long-shape path, and the pixel-max backward at the dense
     table: its wrapper, kernels and source, launches in a dense serve and
     train step, device ms in each from phase 15h's profiles, the CUDA-event
     ms, plain ms, bound and max |kernel - plain| of its sites in the dense
     serve step, or the train step for the ball query and the backward, or
     at its reference site for the global FPS path; FPS's us a pick and
     the share of warp updates its pruning skipped at each site,
     `skipped_share`, and the dense serve step's fps_kernel rows (SA2's
     parts), `block_rows`; the cluster FPS and the dq windows also at the
     80,000-point step's sites, `step80k`), the
     `{"kernels": [...]}` line (all twelve; the nearest kernel's row is the
     nearest serve step's, with its grid pass's and query's device ms apart,
     `grid_pass_ms` and `query_ms`, as the dense rows of the grid paths
     give theirs by step, `grid_pass_ms` and `device_ms_by_kernel`; FPS's
     row with `per_pick_us` and `skipped_share` at each serve-step site) and the
     final `{"ok": true, ...}` line.

float32 matmuls run in full float32: TF32 is switched off for cuBLAS and
cuDNN below, so no product (and no distance) passes through TF32.

`bound_ms` is the least time the card could take for the same work: the
larger of the bytes a call must move (inputs read once, outputs written
once) over 3.35 TB/s and its float32 operations over 67 TFLOP/s (H100 SXM
data sheet, non-tensor float32, 700 W). Operations count each add, multiply,
compare, min or max as one; where the work depends on the data (the SA
epilogue runs only for picks within the radius) this run's picks are
counted (and for the SA train passes, this run's valid edges; for the
nearest selection, 10 a pair within the radius, the pairs any exact
method must score, counted by the plain version's scores).
`ms`, `plain_ms`, `bound_ms` and `library_ms` of a kernel are per step: the
sum over its call sites in the serve step (the four serve kernels), in
the train step (the seven train kernels) or in the nearest serve step
(ball_query_nearest); the reference sites are summed on the
`reference_sites` line alone. The operations bound counts a fused
multiply-add as one operation against a rate that counts it as two, so for
the scan kernels (the grouped selection, kNN) it sits below what the card
can issue: phase 16 gives their issue floor beside it. The grouped
selection on the cell grid (the dense rows) counts 10 operations a pair
within the radius, as the nearest selection does, with the bound of 10 a
pair of all pairs beside it (`bound_all_pairs_ms`).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import io
import json
import logging
import subprocess
import sys
import time

SERVE_KERNELS = (  # wrapper, CUDA source, the TPU kernel it replaces
    ("fps", "stratanet2_tpu_torch/ops/csrc/fps.cu",
     "stratanet2_tpu/ops/pallas_kernels.py:134"),
    ("sa_fused_eval", "stratanet2_tpu_torch/ops/csrc/sa_fused_eval.cu",
     "stratanet2_tpu/ops/pallas_kernels.py:959"),
    ("knn_interpolate", "stratanet2_tpu_torch/ops/csrc/knn_interpolate.cu",
     "stratanet2_tpu/ops/pallas_kernels.py:302"),
    ("pixel_max", "stratanet2_tpu_torch/ops/csrc/pixel_max.cu",
     "stratanet2_tpu/ops/pallas_kernels.py:1289"),
)
TRAIN_KERNELS = (
    ("ball_query", "stratanet2_tpu_torch/ops/csrc/ball_query.cu",
     "stratanet2_tpu/ops/pallas_kernels.py:753"),
    ("knn_scatter", "stratanet2_tpu_torch/ops/csrc/knn_scatter.cu",
     "stratanet2_tpu/ops/pallas_kernels.py:483"),
    ("pixel_max_bwd", "stratanet2_tpu_torch/ops/csrc/pixel_max.cu",
     "stratanet2_tpu/ops/pallas_kernels.py:1329"),
    ("sa_train_stats", "stratanet2_tpu_torch/ops/csrc/sa_train.cu",
     "stratanet2_tpu/ops/pallas_kernels.py:1523"),
    ("sa_train_main", "stratanet2_tpu_torch/ops/csrc/sa_train.cu",
     "stratanet2_tpu/ops/pallas_kernels.py:1565"),
    ("sa_train_bwd1", "stratanet2_tpu_torch/ops/csrc/sa_train.cu",
     "stratanet2_tpu/ops/pallas_kernels.py:1645"),
    ("sa_train_bwd2", "stratanet2_tpu_torch/ops/csrc/sa_train.cu",
     "stratanet2_tpu/ops/pallas_kernels.py:1750"),
)
# phase 17's kernel: the nearest selection, which JAX computes in XLA
# (approx_min_k), not in a Pallas kernel
NEAREST_KERNEL = ("ball_query_nearest", "stratanet2_tpu_torch/ops/csrc/ball_query_nearest.cu",
                  "stratanet2_tpu/ops/ballquery.py:104")
SA_TRAIN = ("sa_train_stats", "sa_train_main", "sa_train_bwd1", "sa_train_bwd2")
SERVE_LAUNCHES = {"fps": 2, "sa_fused_eval": 2, "knn_interpolate": 2, "pixel_max": 2,
                  "ball_query": 0, "knn_scatter": 0, "pixel_max_bwd": 0,
                  **dict.fromkeys(SA_TRAIN, 0), "ball_query_nearest": 0}
TRAIN_LAUNCHES = {"fps": 2, "sa_fused_eval": 0, "knn_interpolate": 2, "pixel_max": 1,
                  "ball_query": 2, "knn_scatter": 2, "pixel_max_bwd": 1,
                  "sa_train_stats": 1, "sa_train_main": 2, "sa_train_bwd1": 1,
                  "sa_train_bwd2": 2, "ball_query_nearest": 0}
# phase 17: the steps on the unfused SA route (`models/pointnet2.
# set_abstraction_unfused`). Serve: FPS and the selection at SA1 and SA2, kNN
# at FP2 and FP1, pixel max for the rasters and the plot coverages. Train:
# the same forward with one pixel max (the plot coverages), and in the
# backward the kNN scatter of FP2 and FP1 and the gather backward of SA2's
# pre-projected q (SA1 gathers the input cloud, which takes no gradient), and
# the pixel-max backward; no SA kernel. "nearest" selects with the new
# kernel, use_pallas=False with the grouped query.
NEAREST_SERVE_LAUNCHES = {**dict.fromkeys(TRAIN_LAUNCHES, 0), "fps": 2, "ball_query_nearest": 2,
                          "knn_interpolate": 2, "pixel_max": 2}
NEAREST_TRAIN_LAUNCHES = {**dict.fromkeys(TRAIN_LAUNCHES, 0), "fps": 2, "ball_query_nearest": 2,
                          "knn_interpolate": 2, "knn_scatter": 3, "pixel_max": 1,
                          "pixel_max_bwd": 1}
# the kernels a training run launches, its evals' included: the eleven of
# the default (fused) route, and the nearest route's
FUSED_PATH = set(TRAIN_LAUNCHES) - {"ball_query_nearest"}
NEAREST_PATH = ({k for k, v in NEAREST_SERVE_LAUNCHES.items() if v}
                | {k for k, v in NEAREST_TRAIN_LAUNCHES.items() if v})
UNFUSED_SERVE_LAUNCHES = {**NEAREST_SERVE_LAUNCHES, "ball_query_nearest": 0, "ball_query": 2}
UNFUSED_TRAIN_LAUNCHES = {**NEAREST_TRAIN_LAUNCHES, "ball_query_nearest": 0, "ball_query": 2}
# route: (ModelConfig opt-ins, serve launches, train launches); bfloat16 on
# the fused route leaves the SA kernels as they are
OPTIN_ROUTES = {
    "nearest": (dict(ball_query_method="nearest"), NEAREST_SERVE_LAUNCHES,
                NEAREST_TRAIN_LAUNCHES),
    "bf16_fused": (dict(compute_dtype="bfloat16"), SERVE_LAUNCHES, TRAIN_LAUNCHES),
    "bf16_unfused": (dict(compute_dtype="bfloat16", use_pallas=False), UNFUSED_SERVE_LAUNCHES,
                     UNFUSED_TRAIN_LAUNCHES),
}
# FPS's reference sites (phase 4): (cloud, rows, N, S). "grid": integer
# coordinates in [0, 16), so distances take a few hundred values and most
# picks break ties, at the shapes of SA1's parts and of SA2; "serve": the
# serve batch's clouds unpartitioned, N=10000; a grid cloud at fps_kernel's
# largest N (cuda_kernels.FPS_MAX_N, 16 points a thread); then the pruning's
# hard clouds: "dup", N / 8 distinct points each repeated 8 times (fewer
# distinct points than picks: the last picks are ties among zero minima),
# "lambert", serve-like plots at Lambert-93 scale (FPS_LAMBERT93: an ulp of
# 0.06-0.5 m in x and y) and "clustered", 90% of the points in 5% of the
# plot (NEAREST_CLUSTER), the last on the cluster path; then the long-row
# paths (cuda_kernels.fps_path): a grid cloud at the dense phase's SA1 parts
# (20 rows: clusters of 8 blocks of 512 threads, 8 points a thread), an odd
# row that no partition takes (N=40001: 8 blocks of 512, 5,001 points, 10 a
# thread), rows of 60,000 (8 blocks of 512, 7,500 points, 15 a thread) and
# 100,000 (8 blocks of 1024, 12,500 points, 13 a thread) and, last (the
# dense phase's global site), a row past the
# cluster's shared memory (N=200000: 8 blocks, x, y, z and the running
# minima in device memory), all "uniform": serve-like plots (xy in
# [-10, 10]^2 m, z in [0, 3])
FPS_REFERENCE = (("grid", 40, 5000, 1250), ("grid", 20, 2500, 625),
                 ("serve", 20, 10000, 2500), ("grid", 20, 16384, 1024),
                 ("dup", 20, 2500, 2500), ("lambert", 20, 5000, 1250),
                 ("clustered", 4, 32768, 8192),
                 ("grid", 20, 32768, 8192), ("uniform", 4, 40001, 10000),
                 ("uniform", 4, 60000, 2048), ("uniform", 2, 100000, 2048),
                 ("uniform", 1, 200000, 1024))
FPS_LAMBERT93 = (6.5e5, 6.86e6, 200.0)  # a plot's offset in Lambert-93 metres
# call sites held against their plain versions outside the steps: phase 10's
# (the gather backward of the unfused SA2 stage, the SA train passes of the
# fused SA1 and SA2 stages with nonzero statistics shifts) and synthetic ones
# (FPS_REFERENCE; SA_TRAIN_REFERENCE; the pixel-max backward with
# out-of-range ids and empty pixels)
PHASE10_SITES = {"knn_scatter": 1, "sa_train_stats": 1, "sa_train_main": 2,
                 "sa_train_bwd1": 1, "sa_train_bwd2": 2}
# The SA train passes' tie-heavy, ragged reference sites (phase 11): (B, N,
# C, K, C1), the SA1 instance (16 -> 16, two layers; all four passes) and
# the SA2 instance (32, one layer; main and bwd2). q rows drawn from 8
# integer-valued rows and an integer cterm, so h ties across the slots of a
# centroid and the first winning slot must be taken; K = 31 and 61 are
# multiples of no slot batch tried (2, 4, 8, 16), so the last batch is cut;
# slot j's ids drawn from group j (the ceil(N/K) points from j ceil(N/K)),
# as the grouped selection picks them, ~10 valid picks a point (the SA2 site's
# last group is empty and its slot always masked, as the selection masks
# it); 40% of the slots masked at random, so masked slots fall inside
# batches, and every 5th centroid has no valid slot at all (vmax -3.4e38,
# amax 0); B x C leaves the last block of groups partial
SA_TRAIN_REFERENCE = ((4, 2000, 1203, 31, 16), (4, 1200, 301, 61, 32))
SA_TRAIN_REF_SITES = {"sa_train_stats": 1, "sa_train_main": 2, "sa_train_bwd1": 1,
                      "sa_train_bwd2": 2}
# (kernel, library) of the kernels whose SASS must hold no global atomic
# (phase 16): each writes every output element once, so two runs give the
# same bits
ATOMIC_FREE = (("knn_scatter_kernel", "knn_scatter"), ("pixel_max_kernel", "pixel_max"),
               ("sa_train_bwd2_kernel", "sa_train"), ("sa_train_dq_kernel", "sa_train"),
               ("sa_train_dq_keys_kernel", "sa_train"))
# csrc/sa_train.cu's passes that take their slots in batches, by (kernel, C1)
EDGE_LOOP_INSTANCES = (("sa_train_stats", 16), ("sa_train_main", 16), ("sa_train_main", 32),
                       ("sa_train_bwd1", 16), ("sa_train_bwd2", 16), ("sa_train_bwd2", 32))
# The grouped selection's reference sites (phase 4 for sa_fused_eval, phase
# 11 for ball_query): (cloud, B, N, C, K, radius). "grid": integer
# coordinates in [0, 16) with the centroids drawn from the points, so every
# d2 is an exact integer, most picks break first-index ties among duplicated
# points and many points lie at d2 = 2 or 8, one float32 ulp outside the
# PROD radii sqrt(2) and sqrt(8) (r^2 rounds to 1.9999999 and 7.9999995): the
# SA1 and SA2 shapes; a ragged site (N=1030, K=48: g=22, group 46 holds 18
# points and group 47 none; C=300 leaves a partial tile) at radius 2, where
# r^2 = 4 exactly and the points at d2 = 4 are inside; a site at the
# kernels' longest group staged whole ("max_g", B=2, K=4: cuda_kernels.
# BQ_MAX_G for the query, sa_fused_eval_max_g for the SA kernel's
# instances); the dense phase's SA1 shape (B=2, N=65536, C=16384, K=32:
# groups of 2048, past both slices: the cell grid); and "long" (B=2, K=4, N
# set for each kernel instance): groups of twice the longest staged whole
# + 5 points and a ragged last group 2 points shorter (the cell grid). Then
# the cell grid's own sites at the dense SA1 shape, each centroid of which
# scores only its 3 x 3 cells: "shifted", serve-like plots (xy in
# [-10, 10]^2, z in [0, 3]) moved to (1000, 1000, 0) m, where the expanded
# d2 admits points beyond r (the culling radius's margin); "clustered",
# 90% of those points in a square of 5% of the plot (NEAREST_CLUSTER), so
# the cells around most centroids hold most of the cloud; "sorted", such
# plots' points sorted by x, so each group is a strip of the plot and a
# centroid's cells hold a few groups' points each
SEL_REFERENCE = (("grid", 20, 10000, 2500, 32, 2 ** 0.5), ("grid", 20, 2500, 625, 64, 8 ** 0.5),
                 ("grid", 3, 1030, 300, 48, 2.0), ("max_g", 2, 0, 300, 4, 2.0),
                 ("grid", 2, 65536, 16384, 32, 2 ** 0.5), ("long", 2, 0, 300, 4, 2.0),
                 ("shifted", 2, 65536, 16384, 32, 2 ** 0.5),
                 ("clustered", 2, 65536, 16384, 32, 2 ** 0.5),
                 ("sorted", 2, 65536, 16384, 32, 2 ** 0.5))
# kNN's reference sites (phase 4): (cloud, B, S, T, F). "grid": integer
# coordinates in [0, 16) with an eighth of the sources duplicated and an
# eighth of the targets put on sources, so most picks break ties, many at
# d2 = 0 (the 1e-16 weight clamp), at the FP1 and FP2 shapes of the step;
# "ragged": S and T that are multiples of no tile; "s3": three sources;
# "chunked": more sources than the kernel stages at once
# (csrc/knn_interpolate.cu, kChunk = 4096), so it walks them in chunks; all
# on knn_kernel (`knn_whole`: the wrapper sends "chunked" to the cell grid)
KNN_REFERENCE = (("grid", 20, 2500, 10000, 34), ("grid", 20, 625, 2500, 64),
                 ("ragged", 3, 1001, 1337, 34), ("s3", 2, 3, 333, 64),
                 ("chunked", 2, 10000, 3000, 34))
# kNN's cell-grid reference sites (phase 4; cuda_kernels.knn_path "grid"),
# at the dense plots' FP1 shape, B=2: "grid", integer coordinates in [0,
# 16) with an eighth of the sources duplicated and an eighth of the targets
# put on sources (four sources a lattice point: most picks break ties,
# many at d2 = 0); then serve-like plots (xy in [-10, 10]^2, z in [0, 3])
# whose sources are a random subset of the targets, as SA1's centroids are
# points of the cloud: "shifted", moved to (1000, 1000, 0) m, where the
# stop rule's rounding margin keeps the box growing; "clustered", 90% of
# the points in a square of 5% of the plot (NEAREST_CLUSTER), so the
# crowded cells hold most of the sources; "sorted", the sources sorted by
# x, so the scan's cell order and the index order of ties differ most;
# "far", the targets moved KNN_FAR m along x, off every source, so the box
# grows over most of the grid; then serve-like plots at the two ends of the
# grid pass's cluster rule (cuda_kernels.cell_grid_cluster on 132 SMs): "one",
# a single cloud (8 blocks), and "many", 67 clouds (its floor of 4 blocks a
# cloud, in two waves); the B=2 sites take 8 blocks, the dense steps' B=20 4
KNN_GRID_REFERENCE = (("grid", 2, 16384, 65536, 34), ("shifted", 2, 16384, 65536, 34),
                      ("clustered", 2, 16384, 65536, 34), ("sorted", 2, 16384, 65536, 34),
                      ("far", 2, 16384, 65536, 34), ("one", 1, 16384, 65536, 34),
                      ("many", 67, 16384, 65536, 34))
# the grid pass at every cluster size cell_grid_cluster returns (phase 4):
# kNN's grid path on one cloud of S sources and T = 4 S targets, F = 8, at
# the fewest entries S + T (a multiple of GRID_CLUSTER_STEP) that take each
# size
GRID_CLUSTER_STEP, GRID_CLUSTER_F = 1000, 8
KNN_FAR = 40.0
# pixel_max's reference sites (phase 4): (kind, B, N, P), C = 3. "ties":
# values quantised to 5 levels, so a pixel's maximum is reached by several
# points, often in different blocks of the cloud's cluster; ids drawn over
# [-P^2/8, 9 P^2/8) and a band of P^2/8 pixels left empty; N = 10007, a
# multiple of no cluster size tried (2, 4, 8) nor of a block's threads;
# P = 37. "tiny": five points a cloud, so the last blocks of a cluster of 4
# or 8 get no point. Then tables past a block's shared memory, cut into
# pixel ranges (cuda_kernels.pixel_max_range): "ties" at P = 100, the dense
# phase's (three ranges of 3,334 pixels; ~8 points a pixel, tied maxima in
# different blocks of a range's cluster and equal maxima on both sides of
# the ranges' boundaries), and "wide" at P = 300 (19 ranges of 4,737
# pixels, most of them empty)
PIXEL_MAX_REFERENCE = (("ties", 4, 10007, 37), ("tiny", 3, 5, 37),
                       ("ties", 1, 80021, 100), ("wide", 1, 5003, 300))
# knn_scatter's synthetic reference sites (phase 11): (kind, B, k, T, S, F).
# "hot": phase 10's gather shape, k = 1 and no weights, 20% of the pairs on
# row 0 as masked ball-query slots put them there (~8000 a cloud, many
# chunks), the rest uniform; "ragged": k = 3 with weights, S and T multiples
# of no tile or round tried, a band of rows with no contribution, and 1% of
# the indices outside [0, S) (-1 or S + 2)
KNN_SCATTER_REFERENCE = (("hot", 4, 1, 40000, 2500, 32), ("ragged", 3, 3, 3001, 1001, 34))
# The nearest selection's reference sites (phase 17a): (cloud, B, N, C, K,
# radius). "grid": integer coordinates with an eighth of the points
# duplicated and the centroids drawn from the points, so zero distances and
# ties at the k-th distance abound (the picks break them by index): the SA1
# shape in [0, 16)^3 at radius 2 (r^2 = 4 exactly, about 80 points in a
# ball) and the SA2 shape in [0, 10)^3 at sqrt(8) (r^2 rounds below 8, about
# 230 points in a ball); "few": fewer in-radius points than K (uniform in
# [-10, 10]^3 at radius 1, about 1 a ball), most slots masked; "all": every
# point within the radius, at the kernel's largest K (NEAREST_MAX_K), one
# cell of the kernel's grid; "shifted": serve-like plots (xy in [-10, 10]^2,
# z in [0, 3]) moved to (1000, 1000, 0) m, where one ulp of |p|^2 is 0.125
# m^2 and the expanded d2 admits points beyond r (the culling radius's
# margin); "clustered": 90% of the points in a square of 5% of the plot, so
# those centroids' cells hold most of the cloud (the culled scan near brute
# force); both at the SA1 shape
NEAREST_REFERENCE = (("grid", 20, 10000, 2500, 32, 2.0), ("grid", 20, 2500, 625, 64, 8 ** 0.5),
                     ("few", 4, 3000, 500, 64, 1.0), ("all", 2, 2048, 256, 128, 1e3),
                     ("shifted", 20, 10000, 2500, 32, 2 ** 0.5),
                     ("clustered", 20, 10000, 2500, 32, 2 ** 0.5))
NEAREST_SHIFT = 1000.0
# further kernel calls a nearest site on the card, each held to the plain
# picks and to the first call's cell starts: a race in the grid pass shows
# as one call that differs
NEAREST_REPEATS = 30
NEAREST_CLUSTER = (0.9, 20 * 0.05 ** 0.5)  # share of the points, side of their square (m)
REFERENCE_SITES = {"fps": len(FPS_REFERENCE), "sa_fused_eval": len(SEL_REFERENCE),
                   "knn_interpolate": len(KNN_REFERENCE) + len(KNN_GRID_REFERENCE),
                   "pixel_max": len(PIXEL_MAX_REFERENCE),
                   "ball_query": len(SEL_REFERENCE), "pixel_max_bwd": 2,
                   **{name: n + SA_TRAIN_REF_SITES.get(name, 0)
                      for name, n in PHASE10_SITES.items()}}
REFERENCE_SITES["knn_scatter"] += len(KNN_SCATTER_REFERENCE)
REFERENCE_SITES["ball_query_nearest"] = len(NEAREST_REFERENCE)
# Phase 15h (dense): plots of subsample_size 65,536 rasterised at diam_pix
# 100 (UAV LiDAR: hundreds of points a square metre, tens of thousands in a
# 10 m plot; 0.2 m pixels over its 20 m). At B=20 and the default plan (k1
# 32, k2 64, fps_parts 2) every limit of the PROD kernels is crossed at
# once: SA1's FPS rows of 32,768 points (40 rows of 8,192 picks: the
# cluster), SA1's groups of 2,048 points (the cell grid), kNN at FP1 from
# 16,384 sources and at FP2 from 4,096 (the cell grid), a pixel table of
# 10,000 x 3 x 8 B = 240,000 B (three pixel ranges); SA2's rows of
# 8,192 and groups of 256 stay on the PROD kernels.
DENSE = {"subsample_size": 65536, "diam_pix": 100}
DENSE_STEPS = 10  # timed steps of each; the median is reported
# launches of the long-shape paths (cuda_kernels.PATH_LAUNCHES) in a dense
# step, and of the pixel-max backward, whose table has no limit
DENSE_SERVE_PATHS = {"fps_cluster": 1, "fps_global": 0, "ball_query_grid": 0,
                     "sa_fused_eval_grid": 1, "knn_interpolate_grid": 2, "pixel_max_ranges": 2,
                     "sa_train_dq_chunked": 0}
DENSE_TRAIN_PATHS = {"fps_cluster": 1, "fps_global": 0, "ball_query_grid": 1,
                     "sa_fused_eval_grid": 0, "knn_interpolate_grid": 2, "pixel_max_ranges": 1,
                     "sa_train_dq_chunked": 0, "pixel_max_bwd": 1}
# each path's device kernels, by name prefix: the grid paths' grid pass,
# query and (SA) apply, and the dq windows by their template instance (the
# PROD instances take the other launches); the pixel ranges run in
# pixel_max_kernel itself, whose device ms hold every launch of the step
# (all of them ranged in the dense steps)
DENSE_WRAPPERS = {"fps_cluster": "fps", "fps_global": "fps",
                  "sa_fused_eval_grid": "sa_fused_eval", "ball_query_grid": "ball_query",
                  "knn_interpolate_grid": "knn_interpolate", "pixel_max_ranges": "pixel_max",
                  "sa_train_dq_chunked": "sa_train_bwd2", "pixel_max_bwd": "pixel_max_bwd"}
DENSE_KERNELS = {"fps_cluster": "fps_cluster_kernel", "fps_global": "fps_cluster_kernel<0, 1024>",
                 "sa_fused_eval_grid": ("sa_grid_kernel", "grouped_cull_kernel<true>",
                                        "sa_apply_kernel<16, 16, true>"),
                 "ball_query_grid": ("ball_query_grid_kernel", "grouped_cull_kernel<false>"),
                 "knn_interpolate_grid": ("knn_grid_kernel", "knn_cull_kernel"),
                 "pixel_max_ranges": "pixel_max_kernel",
                 "sa_train_dq_chunked": ("sa_train_dq_kernel<16, true>",
                                         "sa_train_dq_keys_kernel"),
                 "pixel_max_bwd": "pixel_max_bwd_kernel"}
# the paths that run the cell grid's pass (the first of their DENSE_KERNELS)
GRID_PATHS = ("sa_fused_eval_grid", "ball_query_grid", "knn_interpolate_grid")
# sa_train_bwd2's dq windows (cuda_kernels.sa_train_dq_plan) at SA1's
# shape of subsample_size 80,000, (B, N, C, K, C1): 4 (2 C + 9 ceil(N/K) +
# 1) B = 250,004 B of lists and counts a block, past its 232,448 B, so the
# dense steps (N = 65,536: 204,804 B) do not reach them; drawn as the SA
# train reference sites are (`sa_train_site_args`), held and timed in the
# dense phase as the dq path's reference site
DQ_REFERENCE = (1, 80000, 20000, 32, 16)
# ... and a whole train step there (phase 15h's last part): B=20 plots of
# subsample_size 80,000 at diam_pix 100, the default plan, whose SA1 dq pass
# takes windows (SA2's, at 20,000 points, does not); FPS rows of 40,000 (a
# cluster of 5 blocks of 512 threads, one wave), SA1 groups of 2,500 (the
# cell grid), kNN from 20,000
# and 5,000 sources (the cell grid), three pixel ranges
DENSE_DQ_N = 80000
DENSE_DQ_TRAIN_PATHS = {"fps_cluster": 1, "fps_global": 0, "ball_query_grid": 1,
                        "sa_fused_eval_grid": 0, "knn_interpolate_grid": 2,
                        "pixel_max_ranges": 1, "sa_train_dq_chunked": 1}
DENSE_DQ_STEPS = 3  # timed steps; the median is reported
FPS_FLOOR_N = 1024  # one point for each thread of the FPS block
# the cluster's rows at fps_chain: the dense serve step's SA1 parts and the
# 80,000-point train step's, (rows, N, S)
FPS_CHAIN_LONG = ((40, 32768, 8192), (40, 40000, 10000))
SHIFT_STD = 0.1  # phase 10's BN running means (the shifts), as the CPU stage tests draw them
SA_ATOL = 1e-4  # layer-2 dot: FMA contraction and summation order differ
# Fused vs unfused SA stage at PROD (phase 10): both sum the batch statistics
# of ~1.6 M edges in float32 in other orders and BN divides by the batch std
# (outputs within rtol 1e-3, atol 1e-4; BN state within TRAIN_STATE_ATOL).
# Gradients, leaf by leaf relative to the leaf's max: a winner whose margin
# is within rounding can be another slot on each side, moving that output's
# whole cotangent to another point (x's gradient is per point), as a ReLU
# flip does in the step. The inputs are fixed by the seed and both sides are
# deterministic; measured at most 3.9e-3 on an H100 with phase 10's random
# running means (1.1e-3 with zero shifts).
FUSED_OUT_RTOL, FUSED_OUT_ATOL, FUSED_GRAD_RTOL = 1e-3, 1e-4, 1e-2
KNN_ATOL = 1e-5  # kernel and plain round alike (fma chains): expected 0
CPU_ATOL = 1e-5  # CPU vs card: MKL vs cuBLAS float32 rounding; picks identical
U32 = 2.0 ** -24  # unit roundoff of float32
# B=2 train step, card vs CPU. Loss parts and BN running state: float32
# rounding of means over 20000 points. Gradients, leaf by leaf relative to
# the leaf's max |g|: reductions sum in another order on each side, BatchNorm
# divides the difference by the batch std, and a ReLU input within rounding
# of zero can switch on one side only, moving that row's share of every
# gradient upstream (the CPU tests hold the port to JAX at N=2048 with the
# same tolerance, for the same reason). Params after Adam's first step
# (about -lr * sign(g + wd * p)): within 1e-7 plus one ulp where |g + wd * p|
# exceeds the gradient tolerance, else within 2 * lr + 1e-7.
TRAIN_LOSS_ATOL = 1e-5
TRAIN_STATE_ATOL = 1e-5
TRAIN_GRAD_RTOL = 5e-2
STEPS_PER_EPOCH = 5  # ~90 training plots of a fold (5 folds of ~110 plots) at B=20
# phase 15c (loader_steps): LAS plots written, read and prepared on the host,
# then batched by PlotLoader's worker threads for train and serve steps
LOADER_PLOTS, LOADER_POINTS, LOADER_WORKERS = 24, 12000, 2
LOADER_TRAIN_STEPS = 3
LOADER_EPOCH_BATCHES = 12  # the steady-state epoch: batches from one pool
# phase 15d (train_full): the training loop over the prepared plots repeated
# under new ids, fold 1 of the port's KFold split (80 train plots, 4
# batches of 20; 20 val plots, 1 batch), the PROD model
TRAIN_FULL_PLOTS = 100
EVAL_LAUNCHES = {"fps": 2, "sa_fused_eval": 2, "knn_interpolate": 2, "pixel_max": 1,
                 "ball_query": 0, "knn_scatter": 0, "pixel_max_bwd": 0,
                 **dict.fromkeys(SA_TRAIN, 0), "ball_query_nearest": 0}
# the keys of JAX's train_full dicts (train.py:250-256, 613-614; the eval's
# evaluate.LOSS_KEYS and 629-630)
JAX_TRAIN_KEYS = {"total_loss", "MAE_loss", "log_loss", "entropy_loss", "step",
                  "points_per_sec", "epoch", "epoch_seconds"}
JAX_EVAL_KEYS = {"total_loss", "MAE_loss", "log_loss", "MAE_veg_b", "MAE_veg_moy", "MAE_veg_h",
                 "epoch", "step"}
# Resumed vs unbroken runs (phase 15d), each against the unbroken 3-epoch
# run: one resumed at epoch 3 from another 2-epoch run's files (12 steps
# apart) and one from the unbroken run's own epoch-2 files (4 steps apart).
# Both bit for bit, as every sum of the train step has one order (phase
# 12b): loss parts and plot predictions, params (every element and the
# median) and BN running state (relative to max(|value|, 1)) all 0. Each has
# a control, the same resume from a `.resume` file whose Adam state is
# dropped (count and moments zeroed), which must fall outside: on an NVIDIA
# H100 80GB HBM3 at 700 W the controls moved the losses by 7.0e-3, the
# params by 5.8e-3 (median 1.04e-3) and BN state by 0.19.
RESUME_BOUND = {"loss": 0.0, "param_max": 0.0, "param_median": 0.0, "bn_rel": 0.0}
# phase 15e (parcel): a square parcel of PARCEL_SIZE m whose LAS covers it and
# the 20 m buffer of tiling.LAS_PARCEL_BUFFER (140 m x 140 m), at
# PARCEL_DENSITY points a square metre, so that a 10 m-radius plot holds about
# 10,000 points (PROD's subsample), ~627,000 points in all; its lower-left
# corner at PARCEL_ORIGIN, Lambert-93 metres. The card-vs-CPU check takes
# PARCEL_CPU_PLOTS of its plots as one batch.
PARCEL_SIZE, PARCEL_DENSITY = 100.0, 32.0
PARCEL_ORIGIN = (650_000.0, 6_860_000.0)
PARCEL_CPU_PLOTS = 4
# warm runs of the chain-8 inference, the port's (batches from pageable
# memory, the serve step's graph replayed), the serve step's eager body, and
# with a pinned, non-blocking upload, in turns
PARCEL_UPLOADS = ("pageable", "eager", "pinned", "pinned", "eager", "pageable", "pageable",
                  "eager", "pinned")
# phase 15f (cli): DEV's 30 plots (5 folds x 6) of about a PROD plot's
# points, and a parcel of CLI_PARCEL_SIZE m at PARCEL_DENSITY
CLI_PLOTS, CLI_POINTS = 30, 12000
CLI_PARCEL_SIZE = 60.0
# phase 15j (schedule): fold 1 killed once it has finished SCHEDULE_KILL_AFTER
# epochs (two evals at PROD's n_epoch_test of 10), a child's longest run, the
# phase's budget (reported beside its seconds) and the calls a host cost is
# averaged over
SCHEDULE_KILL_AFTER = 25
SCHEDULE_TIMEOUT = 600.0
SCHEDULE_BUDGET_S = 200
SCHEDULE_HOST_REPS = 200
# phase 15k (ssl_cycle): scripts/torch_ssl_cycle.py at the geometry of the
# JAX side's v5e run (RESULTS.md:566-591: 60 plots of 12,000 points, 4
# parcels, B=20 x 10,000, 2 folds of 60 epochs, 40 SSL epochs) at PROD
# width; fold SSL_ALONE_FOLD of its cold cross-validation trained again
# alone in a fresh process; then scripts/torch_learnability_sweep.py at the
# learnability check's defaults (60 plots, 60 epochs) for SSL_SWEEP_SEEDS.
# A fold's card memory at its end may differ from the first fold's by
# SSL_MEMORY_SLACK_MB or SSL_MEMORY_SHARE of the first fold's peak, the
# larger. The warm val MAE must beat its predict-the-mean baseline; the cold
# one, after 60 Adam steps a fold (30 train plots, one batch an epoch),
# must be no worse than the JAX side's at this geometry and data
# (SSL_JAX_COLD_MAE, RESULTS.md:584), which is above that baseline too
SSL_CYCLE_ARGS = ("--mode", "PROD", "--n_plots", "60", "--points", "12000", "--n_parcels", "4",
                  "--subsample_size", "10000", "--batch_size", "20", "--folds", "2",
                  "--epochs", "60", "--ssl_epochs", "40")
SSL_ALONE_FOLD = 2
SSL_SWEEP_SEEDS, SSL_SWEEP_EPOCHS = (0,), 60
SSL_CYCLE_BUDGET_S = 180
SSL_MEMORY_SLACK_MB, SSL_MEMORY_SHARE = 16.0, 0.05
SSL_JAX_COLD_MAE = 0.2427
# phase 15l (cap_studies): scripts/torch_neighbor_cap_study.py on
# CAP_NEIGHBOR clouds (n_clouds, N, weight seeds), the gradient study of
# scripts/torch_cap_train_study.py on one batch at CAP_GRAD_ARGS and its
# training study at CAP_TRAIN_ARGS (their full depth stays in the
# scripts), scripts/torch_parity_eval.py on phase 15f's tree, and its first
# PARITY_CPU_PLOTS plots again on the card and on the CPU
CAP_NEIGHBOR = (2, 10000, 1)
CAP_GRAD_ARGS = ("--n", "10000", "--batch", "4", "--seeds", "1", "--skip_pretrain")
CAP_TRAIN_ARGS = ("--n_plots", "20", "--epochs", "8")
PARITY_CPU_PLOTS = 4
CAP_STUDIES_BUDGET_S = 90
# the unfused route's eval forward (FPS and the selection at SA1 and SA2,
# kNN at FP2 and FP1, a pixel max for the plot coverages) by policy
CAP_EVAL_LAUNCHES = {
    "grouped": {**UNFUSED_SERVE_LAUNCHES, "pixel_max": 1},
    "nearest": {**NEAREST_SERVE_LAUNCHES, "pixel_max": 1},
}
# phase 15m (tools): bench.py's geometry served by the port (TOOLS_SERVE: B
# clouds of N points in one forward, and in batches of the third), a PROD
# train step at TOOLS_FPS_PARTS parts (fps_min_part_samples 1),
# scripts/torch_trace_step.py's aggregation over TOOLS_TRACE_STEPS replayed
# serve steps and scripts/torch_roofline.py at the PROD sites
TOOLS_SERVE = (128, 4096, 16)
TOOLS_FPS_PARTS = 4
TOOLS_TRACE_STEPS = 3
TOOLS_BUDGET_S = 60
TOOLS_FORWARD_LAUNCHES = {"fps": 2, "sa_fused_eval": 2, "knn_interpolate": 2}
SEED = 0
STEPS = 30  # timed steps; the median is reported
# phase 15i: batches of make_predict_program, train steps from one state,
# the device-resident epochs' plots (the last 2 batches' worth for the eval)
# and points a plot, and the synchronised steps of each turn of its timing
GRAPH_BATCHES, GRAPH_TRAIN_STEPS = 3, 3
GRAPH_PLOTS = (160, 12000)
GRAPH_STEPS = 10
PROFILE_STEPS = 10
# traces device_profile takes before it gives up on one that holds no kernel
# (three empty traces in a row at one site were seen once on an H100)
PROFILE_TRIES = 8
LAUNCH_REPS = 2000  # calls a host cost of phase 11b is averaged over
# device kernels of each wrapper, by name prefix (ops/csrc/*.cu)
DEVICE_KERNELS = {"fps": ("fps_kernel", "fps_cluster_kernel"),
                  "sa_fused_eval": ("sa_kernel", "sa_grid_kernel", "grouped_cull_kernel<true>",
                                    "sa_apply_kernel"),
                  "knn_interpolate": ("knn_kernel", "knn_grid_kernel", "knn_cull_kernel"),
                  "pixel_max": ("pixel_max_kernel",),
                  "ball_query": ("ball_query_kernel", "ball_query_grid_kernel",
                                 "grouped_cull_kernel<false>"),
                  "knn_scatter": ("knn_scatter_kernel",),
                  "pixel_max_bwd": ("pixel_max_bwd_kernel",),
                  **{name: (f"{name}_kernel",) for name in SA_TRAIN},
                  "sa_train_bwd2": ("sa_train_bwd2_kernel", "sa_train_dq_kernel",
                                    "sa_train_dq_keys_kernel"),
                  "ball_query_nearest": ("ball_query_nearest_kernel", "nearest_grid_kernel")}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def device_profile(torch, fn, prefixes, reps: int = 10):
    """reps calls of fn traced, after one warm-up (`device_events`): the
    device time (ms) a launch of the kernels whose names start with
    `prefixes` (over the launches the trace holds: it may miss some, or
    all, and is then taken again, PROFILE_TRIES times at most), those
    launches, and every device operation (kernels, memsets, copies) it
    holds."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):  # a trace can come back empty: take another
        if attempt:
            time.sleep(0.1)
        # twice the calls each try: late in a long run a trace lost its
        # first tens of ms, all of 10 calls of a few ms
        events = device_events(fn, reps << attempt)
        mine = [ev for ev in events if ev["name"].removeprefix("void ").startswith(prefixes)]
        if mine:
            break
    return sum(ev["dur"] for ev in mine) / 1e3 / max(len(mine), 1), len(mine), len(events)


def device_events(fn, calls: int = 1, warmup: int = 0):
    """The device operations (kernels, copies, memsets) of `calls` calls of
    fn on the card, as `scripts/torch_trace_step.py` traces and selects them
    (`traced_events`: `utils/profiling.trace`, `load_trace`,
    `is_device_op`), after `warmup` calls left out of the trace. Every
    device time this script reports is taken through it or through the
    trace script's `trace_table`."""
    import tempfile

    with tempfile.TemporaryDirectory() as logdir:
        return trace_step().traced_events(fn, calls, logdir, "cuda", warmup)


def sa_probe_picks(torch, ck, xyz, centroids, radius, k):
    """Read back the picks of the SA kernel's built-in grouped ball query.
    The one-layer 32-channel instance runs with q[j, ch] = j + 1 for the
    points of group (first + ch) and 0 elsewhere, identity affines and zero
    cterm: output channel ch is then (pick + 1) of that group, or <= 0 where
    it has no point within the radius."""
    b, n, _ = xyz.shape
    c = centroids.shape[1]
    g = -(-n // k)
    group = torch.arange(n, device=xyz.device) // g
    ones, zeros = torch.ones(32, device=xyz.device), torch.zeros(32, device=xyz.device)
    cterm = torch.zeros((b, c, 32), device=xyz.device)
    idx = torch.zeros((b, c, k), dtype=torch.long, device=xyz.device)
    mask = torch.zeros((b, c, k), dtype=torch.bool, device=xyz.device)
    for first in range(0, k, 32):
        chans = torch.arange(32, device=xyz.device) + first
        hit = group[:, None] == chans[None, :]  # (n, 32)
        q = torch.where(hit, torch.arange(1, n + 1, device=xyz.device, dtype=torch.float32)[:, None], 0.0)
        q = q[None].expand(b, n, 32).contiguous()
        out = ck.sa_fused_eval(q, xyz, centroids, cterm, ones, zeros,
                               None, None, None, None, radius, k)
        w = min(32, k - first)
        idx[:, :, first:first + w] = (out[..., :w] - 1).clamp_min(0).long()
        mask[:, :, first:first + w] = out[..., :w] >= 1
    return idx, mask


def report_site(torch, name, site, shape, kernel, plain, args, nbytes, ops, err, diff_sel,
                lib_ms, agg, reference=False, plain_reps=2):
    """Time kernel and plain at one call site, print its line, add it to agg.
    The plain version is timed over `plain_reps` calls, after a warm-up
    unless that is one call (a plain version of seconds has nothing left to
    warm)."""
    from stratanet2_tpu_torch.utils.profiling import time_ms

    k_ms = time_ms(lambda: kernel(*args), 20)
    p_ms = time_ms(lambda: plain(*args), plain_reps, warmup=plain_reps > 1)
    b_ms, _ = roofline().bound_ms(nbytes, ops)
    print(json.dumps({
        "kernel": name, "site": site, "reference": reference, "shape": shape, "kernel_ms": k_ms,
        "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms,
        "max_abs_diff": err, "differing_selections": diff_sel,
    }), flush=True)
    if name == "fps":  # FPS's time a pick at each site
        agg.setdefault("per_pick_us", []).append(k_ms / max(args[1] - 1, 1) * 1e3)
    agg["ms"] += k_ms
    agg["plain_ms"] += p_ms
    agg["bytes"] += nbytes
    agg["ops"] += ops
    agg["max_abs_err"] = max(agg["max_abs_err"], err)
    if lib_ms is not None:
        agg["library_ms"] = (agg["library_ms"] or 0.0) + lib_ms


def new_agg():
    return dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None, max_abs_err=0.0,
                bytes=0.0, ops=0.0, pairs=0.0, sites=[])


def finish_agg(agg):
    agg["bound_ms"], agg["bound_by"] = roofline().bound_ms(agg.pop("bytes"), agg.pop("ops"))
    if not agg["pairs"]:  # only the scans (grouped selection, kNN) count their pairs
        del agg["pairs"]
    if not agg["sites"]:  # only the SA train passes' step sites: (C1, B x C, K) each
        del agg["sites"]
    return agg


def fps_reference_calls(torch, xyz, device):
    """The arguments of FPS's reference sites (FPS_REFERENCE), starts drawn
    from a seed; `xyz` is the serve batch's (B, N, 3)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    calls = []
    for cloud, rows, n, s in FPS_REFERENCE:
        if cloud == "serve":
            pts = xyz.float().contiguous()
            check(tuple(pts.shape) == (rows, n, 3), f"serve clouds {tuple(pts.shape)}")
        elif cloud in ("uniform", "lambert", "clustered"):
            u = torch.rand((rows, n, 3), generator=gen, device=device)
            pts = torch.cat([u[..., :2] * 20 - 10, u[..., 2:] * 3], -1)
            if cloud == "lambert":
                pts = pts + torch.tensor(FPS_LAMBERT93, device=device)
            elif cloud == "clustered":
                share, side = NEAREST_CLUSTER
                k = int(share * n)
                pts[:, :k, :2] = pts[:, :k, :2] * (side / 20) + 3.0
                pts = pts[:, torch.randperm(n, generator=gen, device=device)].contiguous()
        elif cloud == "dup":
            base = torch.rand((rows, -(-n // 8), 3), generator=gen, device=device) * 6
            pts = base.repeat_interleave(8, 1)[:, :n].contiguous()
        else:
            pts = torch.randint(0, 16, (rows, n, 3), generator=gen, device=device).float()
        start = torch.randint(0, n, (rows,), generator=gen, device=device, dtype=torch.int32)
        calls.append((pts, s, start))
    return calls


def knn_reference_calls(torch, device):
    """The arguments (x_src, pos_src, pos_tgt) of kNN's reference sites
    (KNN_REFERENCE, then KNN_GRID_REFERENCE), drawn from a seed."""
    gen = torch.Generator(device=device).manual_seed(SEED + 8)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    calls = []
    for kind, b, s, t, f in KNN_REFERENCE + KNN_GRID_REFERENCE:
        if kind == "grid":
            src = torch.randint(0, 16, (b, s, 3), generator=gen, device=device).float()
            tgt = torch.randint(0, 16, (b, t, 3), generator=gen, device=device).float()
            src[:, s // 2 : s // 2 + s // 8] = src[:, : s // 8]
            tgt[:, : t // 8] = src[:, torch.randint(0, s, (t // 8,), generator=gen, device=device)]
        elif kind in ("shifted", "clustered", "sorted", "far", "one", "many"):
            tgt = torch.cat([rand(b, t, 2) * 20 - 10, rand(b, t, 1) * 3], -1)
            if kind == "shifted":
                tgt[..., :2] += NEAREST_SHIFT
            elif kind == "clustered":
                share, side = NEAREST_CLUSTER
                tgt[..., :2] = torch.where((rand(b, t) < share)[..., None],
                                           (rand(b, t, 2) - 0.5) * side, tgt[..., :2])
            src = tgt[:, torch.randperm(t, generator=gen, device=device)[:s]]
            if kind == "sorted":
                src = torch.gather(src, 1, src[..., 0].argsort(dim=1)[..., None].expand(b, s, 3))
            elif kind == "far":
                tgt[..., 0] += KNN_FAR
        else:
            src = rand(b, s, 3) * 20 - 10
            tgt = rand(b, t, 3) * 20 - 10
        x = torch.randn((b, s, f), generator=gen, device=device)
        calls.append((x, src.contiguous(), tgt.contiguous()))
    return calls


@contextlib.contextmanager
def knn_whole(ck):
    """`knn_interpolate` on knn_kernel at any number of sources, for the
    reference site of its staging in chunks (KNN_REFERENCE's "chunked",
    whose sources the wrapper would send to the cell grid)."""
    saved = ck.KNN_GRID_MIN_S
    ck.KNN_GRID_MIN_S = 2 ** 31
    try:
        yield
    finally:
        ck.KNN_GRID_MIN_S = saved


def pixel_max_reference_calls(torch, device):
    """The arguments (pix, vals, n_pix) of pixel_max's reference sites
    (PIXEL_MAX_REFERENCE), drawn from a seed."""
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    calls = []
    for _kind, b, n, p in PIXEL_MAX_REFERENCE:
        p2 = p * p
        pix = torch.randint(-p2 // 8, p2 + p2 // 8, (b, n), generator=gen, device=device,
                            dtype=torch.int32)
        pix[(pix >= p2 // 4) & (pix < p2 // 4 + p2 // 8)] = -1
        vals = torch.randint(-2, 3, (b, n, 3), generator=gen, device=device).float() / 2
        calls.append((pix, vals, p2))
    return calls


def knn_scatter_reference_calls(torch, device):
    """The arguments (idx, w, g, s) of knn_scatter's synthetic reference
    sites (KNN_SCATTER_REFERENCE), drawn from a seed."""
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    calls = []
    for kind, b, k, t, s, f in KNN_SCATTER_REFERENCE:
        idx = torch.randint(0, s, (b, k, t), generator=gen, device=device, dtype=torch.int32)
        g = torch.randn((b, t, f), generator=gen, device=device)
        if kind == "hot":
            idx[torch.rand((b, k, t), generator=gen, device=device) < 0.2] = 0
            calls.append((idx, None, g, s))
            continue
        band = (idx >= s // 3) & (idx < s // 3 + s // 10)
        idx[band] -= s // 3  # rows [s/3, s/3 + s/10) get no contribution
        out = torch.rand((b, k, t), generator=gen, device=device) < 0.01
        low = torch.rand((b, k, t), generator=gen, device=device) < 0.5
        idx[out] = torch.where(low, -1, s + 2)[out].int()
        calls.append((idx, torch.rand((b, k, t), generator=gen, device=device), g, s))
    return calls


def selection_reference_calls(torch, ck, device):
    """The arguments of the grouped selection's reference sites
    (SEL_REFERENCE), drawn from a seed: ball_query's (centroids, points,
    radius, k) and sa_fused_eval's (q, xyz, centroids, cterm, a1, c1, w2, b2,
    a2, c2, radius, k). The SA kernel runs its SA1 instance (16 -> 16, two
    layers) at K=32 and at the max_g site, its SA2 instance (32, one layer)
    elsewhere; its picks are read back through the SA2 instance
    (`sa_probe_picks`). Centroids are points of the cloud."""
    gen = torch.Generator(device=device).manual_seed(SEED + 6)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def cloud(kind, b, n):
        if kind == "grid":
            return torch.randint(0, 16, (b, n, 3), generator=gen, device=device).float()
        pts = torch.cat([rand(b, n, 2) * 20 - 10, rand(b, n, 1) * 3], -1)
        if kind == "shifted":
            pts[..., :2] += NEAREST_SHIFT
        elif kind == "clustered":
            share, side = NEAREST_CLUSTER
            pts[..., :2] = torch.where((rand(b, n) < share)[..., None], (rand(b, n, 2) - 0.5) * side,
                                       pts[..., :2])
        elif kind == "sorted":
            pts = torch.gather(pts, 1, pts[..., 0].argsort(dim=1)[..., None].expand(b, n, 3))
        return pts.contiguous()

    bq, sa = [], []
    for kind, b, n, c, k, radius in SEL_REFERENCE:
        two = k == 32 or kind in ("max_g", "long")
        ch = 16 if two else 32
        chunks = (ck.BQ_MAX_G, ck.sa_fused_eval_max_g(ch, ch, two, k))
        if kind == "max_g":
            n_bq, n_sa = (m * k for m in chunks)
        elif kind == "long":  # groups of 2 slices + 5, the last 2 points short
            n_bq, n_sa = (k * (2 * m + 5) - 2 for m in chunks)
        else:
            n_bq = n_sa = n
        for n_site, calls in ((n_bq, bq), (n_sa, sa)):
            pts = cloud(kind, b, n_site)
            pick = torch.randperm(n_site, generator=gen, device=device)[:c]
            cent = pts[:, pick].contiguous()
            if calls is bq:
                calls.append((cent, pts, radius, k))
                continue
            layer2 = ((torch.randn((ch, ch), generator=gen, device=device) * 0.25,
                       rand(ch) - 0.5, rand(ch) + 0.5, rand(ch) - 0.5) if two else (None,) * 4)
            calls.append((torch.randn((b, n_site, ch), generator=gen, device=device), pts, cent,
                          torch.randn((b, c, ch), generator=gen, device=device), rand(ch) + 0.5,
                          rand(ch) - 0.5, *layer2, radius, k))
    return bq, sa


def sass_functions(sass: str):
    """{function: [(address, instruction text)]} of `cuobjdump -sass`."""
    import re

    funcs, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            funcs[func] = []
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and func:
            funcs[func].append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


GLOBAL_ATOMICS = ("RED", "REDG", "ATOM", "ATOMG")  # ATOMS, on shared memory, is not one


def global_atomics(sass: str, kernel: str):
    """{function: global atomic instructions (RED, ATOM, their G forms)} of
    the functions of `sass` whose name holds `kernel`."""
    return {func: sum(opcode(t) in GLOBAL_ATOMICS for _, t in ins)
            for func, ins in sass_functions(sass).items() if kernel in func}


def check_no_atomics(counts, kernel: str) -> None:
    """Phase 16 fails unless `kernel` is in the listing with no global atomic."""
    check(len(counts) > 0, f"{kernel}: not found in the SASS")
    check(not any(counts.values()), f"{kernel}: global atomic instructions in the SASS: {counts}")


def loops_of(ins):
    """The loops of one function: (head, tail) address ranges closed by a
    backward branch."""
    import re

    back = []
    for addr, text in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            back.append((int(m.group(1), 16), addr))
    return back


def innermost_loops(ins):
    """The innermost loops of one function: ranges closed by a backward
    branch that hold no other backward branch. An out-of-line block that
    jumps back into a loop spans the loop's own back edge, so it is not
    one."""
    back = loops_of(ins)
    return [[(a, t) for a, t in ins if head <= a <= tail] for head, tail in back
            if not any(head <= h2 and t2 <= tail and (h2, t2) != (head, tail) for h2, t2 in back)]


def opcode(text: str) -> str:
    import re

    return re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0]


def sass_per_pair(sass: str, r: int, load: str = r"LDS\.128", nested: bool = False):
    """SASS instructions a pair in the scan loop of each kernel in `sass`
    (cuobjdump -sass of a library): of the innermost loops that hold both a
    128-bit load of one point (`load`, a regular expression: a shared-memory
    LDS.128 of a staged point by default; the selections' culled queries
    read their sorted points from global memory, LDG.E.128) and a float
    compare, the
    one with the most such loads (an unrolled main loop, not its
    remainder). Each point feeds `r` targets, so its length over (points x
    r) is per pair. `common_per_pair` leaves out what a forward branch
    inside the loop can skip (kNN's top-3 insert): the path of a pair whose
    compare fails. With `nested`, a loop may hold loops without such loads
    (the grouped cell-grid query's compare-and-swap retries): the scan loop
    is then the innermost of the loops with such loads, those nested loops
    are left out of its counts and their instructions reported as
    `nested`."""
    import re
    from collections import Counter

    found = {}
    for func, ins in sass_functions(sass).items():
        back = loops_of(ins) if nested else []
        bodies = ([[(a, t) for a, t in ins if head <= a <= tail] for head, tail in back]
                  if nested else innermost_loops(ins))
        scans = [(body, sum(re.search(load, t) is not None for _, t in body)) for body in bodies]
        scans = [(body, points) for body, points in scans
                 if points and any("FSETP" in t for _, t in body)]
        # innermost among the loops that load points
        scans = [(body, points) for body, points in scans
                 if not any(o[0][0] >= body[0][0] and o[-1][0] <= body[-1][0] and len(o) < len(body)
                            for o, _ in scans)]
        if not scans:
            continue
        body, points = max(scans, key=lambda bp: (bp[1], -len(bp[0])))
        inner = {a for h2, t2 in back if body[0][0] <= h2 and t2 <= body[-1][0]
                 and (h2, t2) != (body[0][0], body[-1][0]) for a, _ in body if h2 <= a <= t2}
        body = [(a, t) for a, t in body if a not in inner]
        skipped = set()
        for addr, text in body:
            m = re.search(r"BRA (0x[0-9a-f]+)", text)
            if m and text.startswith("@") and addr < int(m.group(1), 16) <= body[-1][0]:
                skipped.update(a for a, _ in body if addr < a < int(m.group(1), 16))
        ops = Counter(opcode(t) for _, t in body)
        found[func] = {"instructions": len(body), "points": points,
                       "per_pair": len(body) / (points * r),
                       "common_per_pair": (len(body) - len(skipped)) / (points * r),
                       "opcodes": dict(ops.most_common())}
        if nested:
            found[func]["nested"] = len(inner)
    return found


def sass_edge_loops(sass: str, stats_lanes):
    """The slot loop of each instance of the SA train passes (csrc/sa_train.cu,
    all four take their slots in batches): the innermost loop that holds the
    q rows' global loads (LDG), the longest if several, with its SASS
    instructions, SHFLs and FP32 instructions, each over the edges one pass
    of the loop covers, KB slots of each of a warp's 32 / L groups of L
    lanes (C1 and KB are the template arguments in the kernel's name:
    <C1, TWO?, KB> for main, bwd1 and bwd2, whose lanes are C1 channels;
    <C1, KB> for stats, whose lanes `stats_lanes(C1)` gives, the library's
    `sa_train_stats_lanes`): what a warp issues an edge. None for an
    instance with no such loop."""
    import re
    from collections import Counter

    found = {}
    for func, ins in sass_functions(sass).items():
        m = re.search(r"(sa_train_(?:main|bwd1|bwd2))_kernelILi(\d+)E(?:Lb[01]E)?Li(\d+)E", func)
        s = re.search(r"(sa_train_stats)_kernelILi(\d+)ELi(\d+)E", func)
        if m:
            name, ch, kb = m.group(1), int(m.group(2)), int(m.group(3))
            lanes = ch
        elif s:
            name, ch, kb = s.group(1), int(s.group(2)), int(s.group(3))
            lanes = stats_lanes(ch)
        else:
            continue
        loops = [b for b in innermost_loops(ins) if any(opcode(t) == "LDG" for _, t in b)]
        if not loops:
            found[func] = None
            continue
        body = max(loops, key=len)
        edges = kb * 32 // lanes
        ops = Counter(opcode(t) for _, t in body)
        fp32 = sum(ops[o] for o in ("FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL"))
        found[func] = {"kernel": name, "C1": ch, "lanes": lanes, "KB": kb,
                       "instructions": len(body),
                       "edges_a_pass": edges, "per_edge": len(body) / edges,
                       "shfl_per_edge": ops["SHFL"] / edges, "fp32_per_edge": fp32 / edges,
                       "opcodes": dict(ops.most_common())}
    return found


def check_edge_loops(loops):
    """Phase 16 fails unless the slot loop of every SA train instance was
    found: stats, main at SA1 and SA2, bwd1, bwd2 at SA1 and SA2."""
    got = sorted((v["kernel"], v["C1"]) for v in loops.values() if v is not None)
    check(got == sorted(EDGE_LOOP_INSTANCES) and None not in loops.values(),
          f"sa_train: slot loops found for {got} (missing: "
          f"{[f for f, v in loops.items() if v is None]}), expected {sorted(EDGE_LOOP_INSTANCES)}")


def sm_clock_under_load(torch, ck, device):
    """SM clocks (MHz) nvidia-smi samples every 100 ms while the ball query
    runs back to back for a second at the SA1 shape of the step."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    pts = torch.rand((20, 10000, 3), generator=gen, device=device) * 20 - 10
    cent = pts[:, :2500].contiguous()
    for _ in range(20):
        ck.ball_query(cent, pts, 2 ** 0.5, 32)
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--id=0", "--query-gpu=clocks.sm",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for _ in range(50):
            ck.ball_query(cent, pts, 2 ** 0.5, 32)
        torch.cuda.synchronize()
    smi.terminate()
    out = smi.communicate(timeout=30)[0]
    return [float(v) for v in out.split()]


def scan_floor(torch, ck, libs, clock_mhz, rows):
    """Phase 16. The issue floor of the kernels that scan pairs: the pairs
    of a step (serve for sa_fused_eval and knn_interpolate, train for
    ball_query; the pairs it scores for the culled queries: the nearest
    selection's serve step, the grouped cell-grid query's dense SA1
    sites, `ball_query_grid` and `sa_fused_eval_grid`, and kNN's cell-grid
    query at the dense FP1 and FP2 sites, `knn_interpolate_grid`, whose
    `rows` are the dense rows) times the SASS instructions a pair of the
    scan loop, over 132 SMs x 128 lanes x the card's maximum SM clock (one
    instruction a lane a cycle); for the kNN scans on the path of a pair
    that inserts nothing (`common_per_pair`), beside the whole loop's. Then the slot loop of
    every SA train instance (`sass_edge_loops`): SASS instructions,
    SHFLs and FP32 instructions an edge, and its issue floor over the train
    step's slots. Then the global atomics of the kernels of ATOMIC_FREE,
    which must have none. Each kernel's registers, stack and spills
    (cuobjdump -res-usage)."""
    from pathlib import Path

    from stratanet2_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"

    def dump(name, what):
        return subprocess.run([str(cuobjdump), what, str(libs[name])], capture_output=True,
                              text=True, check=True, timeout=120).stdout

    def resources(name):
        res, func = {}, None
        for line in dump(name, "-res-usage").splitlines():  # "Function <name>:", "REG:.."
            if line.strip().startswith("Function "):
                func = line.strip()[len("Function "):].rstrip(":")
            elif "REG:" in line and func:
                res[func] = line.strip()
        return res

    load_mhz = sm_clock_under_load(torch, ck, torch.device("cuda", 0))
    ldg = r"LDG\.E\S*\.128"
    # (row, library, kernel, targets a loaded point, its load, nested loops):
    # the cell-grid query scores each point for ck.CULL_CENTS centroids and
    # retries its slot folds in a nested compare-and-swap loop
    for name, library, func, r, load, nested in (
            ("sa_fused_eval", "sa_fused_eval", "sa_kernel", ck.SEL_TILE // 32, r"LDS\.128", False),
            ("ball_query", "ball_query", "ball_query_kernel", ck.SEL_TILE // 32, r"LDS\.128", False),
            ("knn_interpolate", "knn_interpolate", "knn_kernel", 1, r"LDS\.128", False),
            ("ball_query_nearest", "ball_query_nearest", "ball_query_nearest_kernel", 1, ldg, False),
            ("ball_query_grid", "ball_query", "grouped_cull_kernel", ck.CULL_CENTS, ldg, True),
            ("sa_fused_eval_grid", "sa_fused_eval", "grouped_cull_kernel", ck.CULL_CENTS, ldg,
             True),
            ("knn_interpolate_grid", "knn_interpolate", "knn_cull_kernel", 1, r"LDS\.128",
             False)):
        loops = {f: v for f, v in sass_per_pair(dump(library, "-sass"), r, load, nested).items()
                 if func in f}
        check(len(loops) > 0, f"{name}: no scan loop found in the SASS")
        per_pair = max(v["per_pair"] for v in loops.values())
        common = max(v["common_per_pair"] for v in loops.values())
        # the pairs the kernel scores: all of them for the brute-force scans,
        # the centroids' 3 x 3 cells for the nearest selection and the
        # grouped selection's grid path, the warps' boxes for kNN's (their
        # dense step's sites)
        pairs = rows[name].get("scored_pairs", rows[name]["pairs"])
        culled = {key: rows[name][key] for key in ("pairs", "in_radius_pairs")
                  if "scored_pairs" in rows[name] and key in rows[name]}
        print(json.dumps({"phase": "selection_floor", "kernel": name, "sass_loops": loops,
                          "resource_usage": resources(library), **culled,
                          "pairs_per_step": pairs, "sm_clock_max_mhz": clock_mhz,
                          "sm_clock_under_load_mhz": load_mhz,
                          "issue_floor_ms": pairs * common / (132 * 128 * clock_mhz * 1e6) * 1e3,
                          "issue_floor_whole_loop_ms":
                              pairs * per_pair / (132 * 128 * clock_mhz * 1e6) * 1e3,
                          "ms": rows[name]["ms"], "bound_ms": rows[name]["bound_ms"]}), flush=True)
    loops = sass_edge_loops(dump("sa_train", "-sass"), ck.sa_train_stats_lanes)
    check_edge_loops(loops)
    res = resources("sa_train")
    for func, loop in loops.items():
        row = rows[loop["kernel"]]
        slots = sum(bc * -(-k // loop["KB"]) * loop["KB"]  # every slot of a batch is computed
                    for ch, bc, k in row["sites"] if ch == loop["C1"])
        print(json.dumps({"phase": "edge_loop", "function": func, **loop,
                          "resource_usage": res.get(func), "slots_per_step": slots,
                          "sm_clock_max_mhz": clock_mhz,
                          "issue_floor_ms": slots * loop["per_edge"] / (132 * 4 * clock_mhz * 1e6) * 1e3,
                          "kernel_ms": row["ms"], "kernel_bound_ms": row["bound_ms"]}), flush=True)
    for kernel, library in ATOMIC_FREE:
        counts = global_atomics(dump(library, "-sass"), kernel)
        res = resources(library)
        print(json.dumps({"phase": "atomics", "kernel": kernel, "global_atomics": counts,
                          "resource_usage": {f: res.get(f) for f in counts}}), flush=True)
        check_no_atomics(counts, kernel)


def fps_chain(torch, ck, step_calls, device):
    """Phase 4b: FPS's latency floor. One point a thread (N=FPS_FLOOR_N, S=N)
    leaves the pick's chain (winner load, skip test, reductions, the
    barrier) and a one-point update; its time per pick, times the step's
    picks, is the floor a kernel with this chain cannot go under. Beside
    it the step sites' time a pick and the share of their warp updates
    that the pruning skipped (`cuda_kernels.fps_pruning`), and the
    cluster's rows of FPS_CHAIN_LONG: each one's instance, its waves of
    clusters on this card and its time a pick."""
    from stratanet2_tpu_torch.utils.profiling import time_ms

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    rows = step_calls[0][0].shape[0]
    pts = torch.randint(0, 16, (rows, FPS_FLOOR_N, 3), generator=gen, device=device).float()
    start = torch.zeros(rows, dtype=torch.int32, device=device)
    args = (pts, FPS_FLOOR_N, start)
    check(torch.equal(ck.fps(*args), ck.fps_plain(*args)), "fps_chain: kernel differs from plain")
    per_pick_ms = time_ms(lambda: ck.fps(*args), 20) / (FPS_FLOOR_N - 1)
    picks = [a[1] - 1 for a in step_calls]
    step_per_pick = [time_ms(lambda a=a: ck.fps(*a), 20) / (a[1] - 1) for a in step_calls]
    shares = []
    for a in [args] + list(step_calls):
        _, skipped, possible = ck.fps_pruning(*a)
        shares.append(skipped / possible if possible else None)
    long_rows = []
    for r, n, s in FPS_CHAIN_LONG:  # the cluster's rows: its instance, waves and time a pick
        u = torch.rand((r, n, 3), generator=gen, device=device)
        a = (torch.cat([u[..., :2] * 20 - 10, u[..., 2:] * 3], -1), s,
             torch.zeros(r, dtype=torch.int32, device=device))
        resident = ck.fps_cluster_resident(n, device)
        path, cs, threads = ck.fps_path(n, r, resident)
        check(torch.equal(ck.fps(*a), ck.fps_plain(*a)), f"fps_chain {r}x{n}: kernel differs")
        long_rows.append({"rows": r, "N": n, "S": s, "path": path, "cs": cs, "threads": threads,
                          "waves": -(-r // resident[threads][cs]),
                          "per_pick_us": time_ms(lambda a=a: ck.fps(*a), 5) / (s - 1) * 1e3})
        del u, a
    print(json.dumps({"phase": "fps_chain", "rows": rows, "N": FPS_FLOOR_N, "S": FPS_FLOOR_N,
                      "per_pick_us": per_pick_ms * 1e3, "skipped_share": shares[0],
                      "step_picks": picks, "step_floor_ms": per_pick_ms * sum(picks),
                      "step_sites_per_pick_us": [t * 1e3 for t in step_per_pick],
                      "step_sites_skipped_share": shares[1:], "cluster_rows": long_rows}),
          flush=True)


def pixel_max_site(torch, ck, site, args):
    """One pixel_max call site: vmax and amax equal to the plain version
    exactly, the device time and device operations of a call (one kernel,
    no memset), and `scatter_reduce` (amax, values only) as the library
    call. Returns (shape, bytes, operations, max |diff|, differing argmax,
    library ms)."""
    from stratanet2_tpu_torch.utils.profiling import time_ms

    pix, vals, n_pix = args
    (gv, ga), (wv, wa) = ck.pixel_max(*args), ck.pixel_max_plain(*args)
    diff_sel = int((ga != wa).sum())
    err = float((gv - wv).abs().max())
    check(err == 0.0, f"pixel_max site {site}: vmax differs by {err}")
    b, n, c = vals.shape
    inside = (pix >= 0) & (pix < n_pix)
    index = torch.where(inside, pix, n_pix).long()[..., None].expand(b, n, c)
    init = torch.full((b, n_pix + 1, c), ck.NEG, device=vals.device)  # a row for the outside
    lib_ms = time_ms(lambda: init.scatter_reduce(1, index, vals, "amax"), 20)
    lib = init.scatter_reduce(1, index, vals, "amax")[:, :n_pix]
    check(torch.equal(lib, gv), "scatter_reduce(amax) disagrees with pixel_max")
    dev_ms, launches, dev_ops = device_profile(torch, lambda: ck.pixel_max(*args),
                                               DEVICE_KERNELS["pixel_max"])
    print(json.dumps({"kernel": "pixel_max", "site": site, "device_ms": dev_ms,
                      "profiled_launches": launches, "profiled_device_ops": dev_ops,
                      "cluster": ck.PIXEL_MAX_CLUSTER}), flush=True)
    check(launches > 0 and dev_ops == launches,
          f"pixel_max site {site}: {dev_ops} device operations for {launches} kernels")
    shape = (f"B={b} N={n} P2={n_pix} C={c} ids_out_of_range={int((~inside).sum())} "
             f"empty_pixels={int((wa[..., 0] < 0).sum())}")
    return (shape, *roofline().pixel_max_counts(b, n, c, n_pix), err, diff_sel, lib_ms)


def knn_scatter_site(torch, ck, site, args):
    """One knn_scatter call site. The kernel is launched twice and the two
    results must be equal bit for bit, and equal bit for bit to
    `knn_scatter_ordered_plain`, the kernel's order of sums. Against the
    plain version (float64 sums; ids outside [0, S) given weight 0 at row 0,
    since it takes none) it must lie within the float32 error bound of a sum
    in any order, and rows with no contribution must be exactly 0. Prints
    the device time and device operations of a call (one kernel, no memset),
    the largest destination degree and `index_add_`'s error. Returns (shape,
    bytes, operations, max |diff|, library ms, the plain call)."""
    from stratanet2_tpu_torch.utils.profiling import time_ms

    idx, w, g, s = args
    b, k, t = idx.shape
    f = g.shape[2]
    valid = (idx >= 0) & (idx < s)
    check(w is not None or bool(valid.all()), f"knn_scatter site {site}: ids outside [0, S)")
    pidx = torch.where(valid, idx, 0)
    pw = None if w is None else torch.where(valid, w, 0.0)
    got, again = ck.knn_scatter(*args), ck.knn_scatter(*args)
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
          f"knn_scatter site {site}: two launches differ")
    ordered = ck.knn_scatter_ordered_plain(*args)
    differ = int((got.view(torch.int32) != ordered.view(torch.int32)).sum())
    check(differ == 0, f"knn_scatter site {site}: {differ} elements differ from the ordered plain")
    want = ck.knn_scatter_plain(pidx, pw, g, s)
    flat = (pidx.long() + (torch.arange(b, device=g.device) * s)[:, None, None]).reshape(-1)
    contrib = g[:, None].expand(b, k, t, f)
    if pw is not None:
        contrib = pw[..., None] * contrib
    contrib = contrib.reshape(-1, f)
    # float32 error bound of a sum in any order, per element
    absum = torch.zeros((b * s, f), dtype=torch.float64, device=g.device)
    absum.index_add_(0, flat, contrib.abs().double())
    cnt = torch.zeros(b * s, dtype=torch.float64, device=g.device)
    cnt.index_add_(0, flat, valid.reshape(-1).double())
    bound = (cnt[:, None] * U32 * absum + 2 * U32 * want.reshape(-1, f).abs().double())
    diff = (got - want).abs().reshape(-1, f).double()
    err = float(diff.max())
    ratio = float((diff / bound.clamp_min(1e-45)).max())
    check(bool((diff <= bound).all()),
          f"knn_scatter site {site}: |kernel - plain| exceeds the float32 bound (worst ratio {ratio})")
    empty = cnt == 0
    check(bool((got.reshape(-1, f)[empty] == 0).all()),
          f"knn_scatter site {site}: a row with no contribution is not 0")
    lib_out = torch.zeros((b * s, f), device=g.device)
    lib_ms = time_ms(lambda: lib_out.zero_().index_add_(0, flat, contrib), 20)
    lib_err = float((lib_out.reshape(b, s, f) - want).abs().max())
    dev_ms, launches, dev_ops = device_profile(torch, lambda: ck.knn_scatter(*args),
                                               DEVICE_KERNELS["knn_scatter"])
    print(json.dumps({"kernel": "knn_scatter", "site": site, "library": "index_add_",
                      "library_max_abs_diff": lib_err, "kernel_bound_ratio": ratio,
                      "device_ms": dev_ms, "profiled_launches": launches,
                      "profiled_device_ops": dev_ops,
                      "max_degree": int(cnt.max()), "empty_rows": int(empty.sum()),
                      "ids_out_of_range": int((~valid).sum()),
                      "rows_a_block": ck.knn_scatter_rows(b, s, f),
                      "pairs_a_round": ck.KNN_SCATTER_PAIRS, "chunk": ck.KNN_SCATTER_CHUNK}),
          flush=True)
    check(launches > 0 and dev_ops == launches,
          f"knn_scatter site {site}: {dev_ops} device operations for {launches} kernels")
    nbytes, ops = roofline().knn_scatter_counts(b, k, t, s, f, w is not None)
    shape = f"B={b} k={k} T={t} S={s} F={f} weights={w is not None}"
    return shape, nbytes, ops, err, lib_ms, lambda *_: ck.knn_scatter_plain(pidx, pw, g, s)


def grid_work(cent, pts, radius):
    """The cell-grid selection's work at one site: the pairs its query
    scores (each centroid's 3 x 3 cells, `ballquery.nearest_cells`) and the
    pairs within the radius (what any exact method must score), the latter
    counted by the plain version's distances (`torch_roofline.in_radius_pairs`)."""
    from stratanet2_tpu_torch.ops.ballquery import nearest_cells

    scored = float(nearest_cells(cent, pts, radius).scored.sum())
    return scored, roofline().in_radius_pairs(cent, pts, radius)


def check_site(torch, ck, name, site, args, work=None):
    """Kernel vs plain at one call site of fps, sa_fused_eval,
    knn_interpolate, pixel_max, ball_query, pixel_max_bwd or sa_train_bwd2:
    selections exactly (the SA kernel's picks read back through probe
    launches), values within the kernel's atol (pixel_max and its backward
    exactly; sa_train_bwd2 as phase 11 holds it, `bwd2_dq_checks` and
    `compare_sa_train_site`). A grouped selection on the cell grid prints
    its `"grid_work"` line (`grid_work`: pairs scored against all pairs),
    its selection counts the pairs within the radius (as the nearest
    selection's, `nearest_site`) and `work`, where given, takes its scored
    and in-radius pairs. The bytes and operations are `torch_roofline`'s
    counts of the site. Returns (shape, bytes, operations, max |diff|,
    differing selections, library ms, all pairs)."""
    from stratanet2_tpu_torch.ops.ballquery import ball_query_grouped
    from stratanet2_tpu_torch.utils.profiling import time_ms

    kernel, plain = getattr(ck, name), getattr(ck, f"{name}_plain")
    rl, diff_sel, lib_ms, pairs = roofline(), 0, None, 0.0
    if name == "fps":
        xyz, s, start = args
        got, want = kernel(*args), plain(*args)
        diff_sel = int((got != want).sum())
        err = float((got - want).abs().max())
        r, n, _ = xyz.shape
        nbytes, ops = rl.fps_counts(r, n, s)
        path, cs, threads = ck.fps_path(n, r, ck.fps_cluster_resident(n, xyz.device)
                                        if xyz.is_cuda and n > ck.FPS_MAX_N else None)
        shape = f"rows={r} N={n} S={s} path={path} cs={cs} threads={threads}"
        # the pruning's work: one more launch, with its counter
        again, skipped, possible = ck.fps_pruning(*args)
        check(torch.equal(again, got), f"fps site {site}: the counted launch picks differently")
        share = skipped / possible if possible else None
        print(json.dumps({"phase": "fps_pruning", "fps_site": site, "fps_shape": shape,
                          "skipped_warp_updates": skipped, "possible_warp_updates": possible,
                          "skipped_share": share}), flush=True)
        if work is not None:
            work.setdefault("skipped_share", []).append(share)
    elif name == "sa_fused_eval":
        q, xyz, cent, cterm, a1, c1, w2, b2, a2, c2, radius, k = args
        with recorded_cells(ck) as cells:
            got = kernel(*args)
        want = plain(*args)
        err = float((got - want).abs().max())
        check(err <= SA_ATOL, f"sa_fused_eval site {site}: max |diff| {err} > {SA_ATOL}")
        pidx, pmask = sa_probe_picks(torch, ck, xyz, cent, radius, k)
        ridx, rmask = ball_query_grouped(cent, xyz, radius, k)
        diff_sel = int(((pmask != rmask) | (rmask & (pidx != ridx))).sum())
        b, n, ch1 = q.shape
        c, ch2 = cent.shape[1], got.shape[2]
        valid = float(rmask.sum())
        g = -(-n // k)
        path = ck.sel_path(g, ck.sa_fused_eval_max_g(ch1, ch2, w2 is not None, k))
        pairs = float(b * c * n)
        sel = grid_site(name, site, cent, xyz, radius, pairs, path == "grid", work)
        if path == "grid":
            checked_grids(torch, ck, name, site, cells, xyz, cent, radius)
        nbytes, ops = rl.sa_fused_eval_counts(b, n, c, k, ch1, ch2, w2 is not None, valid, sel)
        shape = (f"B={b} N={n} C={c} K={k} C1={ch1} C2={ch2} valid_picks={int(valid)} "
                 f"g={g} path={path}")
    elif name == "knn_interpolate":
        x, ps, pt = args
        (go, gi, gw), (wo, wi, ww) = kernel(*args), plain(*args)
        diff_sel = int((gi != wi).sum())
        err = max(float((go - wo).abs().max()), float((gw - ww).abs().max()))
        check(err <= KNN_ATOL, f"knn site {site}: max |diff| {err} > {KNN_ATOL}")
        b, s, f = x.shape
        t = pt.shape[1]
        pairs = float(b * t * s)
        path = ck.knn_path(s, t)
        if path == "grid":  # the culled scan: its weights and outputs bit for bit, its pairs
            check(torch.equal(gw, ww) and torch.equal(go, wo),
                  f"knn site {site}: the grid's weights or outputs differ in bits")
            scored = knn_grid_work(torch, ck, site, args, gi, pairs, work)
            shape = f"B={b} S={s} T={t} F={f} path=grid"
        else:
            scored = pairs
            shape = f"B={b} S={s} T={t} F={f} path=whole slices={ck.knn_slices(b, t)}"
        nbytes, ops = rl.knn_interpolate_counts(b, s, t, f, scored)
    elif name == "pixel_max":
        shape, nbytes, ops, err, diff_sel, lib_ms = pixel_max_site(torch, ck, site, args)
    elif name == "ball_query":
        cent, pts, radius, k = args
        with recorded_cells(ck) as cells:
            gi, gm = kernel(*args)
        wi, wm = plain(*args)
        diff_sel = int(((gm != wm) | (wm & (gi != wi))).sum())
        check(torch.equal(gi, wi) and torch.equal(gm, wm),
              f"ball_query site {site}: idx/mask differ from the plain version")
        err = 0.0
        b, c, _ = cent.shape
        n = pts.shape[1]
        g = -(-n // k)
        pairs = float(b * c * n)
        path = ck.sel_path(g, ck.BQ_MAX_G)
        sel = grid_site(name, site, cent, pts, radius, pairs, path == "grid", work)
        if path == "grid":
            checked_grids(torch, ck, name, site, cells, pts, cent, radius)
        nbytes, ops = rl.ball_query_counts(b, c, n, k, sel)
        shape = f"B={b} C={c} N={n} K={k} valid={int(wm.sum())} g={g} path={path}"
    elif name == "sa_train_bwd2":
        got, want = kernel(*args), plain(*args)
        lib_ms, _ = bwd2_dq_checks(torch, ck, site, args, got)
        shape, nbytes, ops, err = compare_sa_train_site(torch, ck, name, site, args, got, want)
        q, _, idx = args[:3]
        shape += f" dq_windows={ck.sa_train_dq_plan(q.shape[0], q.shape[1], *idx.shape[1:])}"
    else:  # pixel_max_bwd
        pix, amax, g = args
        got, want = kernel(*args), plain(*args)
        check(torch.equal(got, want), f"pixel_max_bwd site {site}: differs from plain")
        err = float((got - want).abs().max())
        b, p2, c = g.shape
        n = pix.shape[1]
        outside = (pix < 0) | (pix >= p2)
        check(not bool(got[outside].any()),
              f"pixel_max_bwd site {site}: a point outside the pixels has a gradient")
        index = amax.clamp_min(0).long()
        src = torch.where(amax >= 0, g, torch.zeros_like(g))
        lib_ms = time_ms(lambda: torch.zeros((b, n, c), device=g.device)
                         .scatter_add_(1, index, src), 20)
        lib = torch.zeros((b, n, c), device=g.device).scatter_add_(1, index, src)
        check(torch.equal(lib, got), "scatter_add_ disagrees with pixel_max_bwd")
        nbytes, ops = rl.pixel_max_bwd_counts(b, n, c, p2)
        shape = (f"B={b} P2={p2} C={c} N={n} winners={int((amax >= 0).sum())} "
                 f"ids_out_of_range={int(outside.sum())} "
                 f"empty_pixels={int((amax[..., 0] < 0).sum())}")
    check(diff_sel == 0, f"{name} site {site}: {diff_sel} selections differ")
    return shape, nbytes, ops, err, diff_sel, lib_ms, pairs


def knn_grid_work(torch, ck, site, args, idx, pairs, work):
    """kNN's cell grid at one site (`check_site`): the sources each
    target's warp scanned (`cuda_kernels.knn_interpolate_grid`, another
    launch, whose picks must equal the site's, and whose cell grid is held
    to `ballquery.knn_cells`), printed on a `"grid_work"` line against all
    pairs and added to `work` (a dict, or None). Returns the pairs
    scored."""
    with recorded_cells(ck) as cells:
        _, gi, _, scored = ck.knn_interpolate_grid(*args)
    check(torch.equal(gi, idx), f"knn site {site}: two grid launches pick differently")
    checked_grids(torch, ck, "knn_interpolate", site, cells, args[1], args[2])
    total = float(scored.double().sum())
    print(json.dumps({"phase": "grid_work", "kernel": "knn_interpolate", "site": site,
                      "scored_pairs": total, "all_pairs": pairs, "scored_share": total / pairs,
                      "sources_a_target": total / scored.numel(),
                      "most_sources_a_target": int(scored.max())}), flush=True)
    if work is not None:
        work["scored_pairs"] = work.get("scored_pairs", 0.0) + total
    return total


def grid_site(name, site, cent, pts, radius, pairs, grid, work):
    """The pairs the grouped selection must score at a site (`check_site`):
    all `pairs` whole, or on the cell grid (`grid`: groups past the
    wrapper's slice, `cuda_kernels.sel_path`) those within the radius, with
    the site's `"grid_work"` line printed and `work` (a dict, or None)
    given its scored and in-radius pairs."""
    if not grid:
        return pairs
    scored, in_radius = grid_work(cent, pts, radius)
    print(json.dumps({"phase": "grid_work", "kernel": name, "site": site,
                      "scored_pairs": scored, "all_pairs": pairs, "scored_share": scored / pairs,
                      "in_radius_pairs": in_radius}), flush=True)
    if work is not None:
        for key, v in (("scored_pairs", scored), ("in_radius_pairs", in_radius)):
            work[key] = work.get(key, 0.0) + v
    return in_radius


def grid_cluster_sizes(torch, ck, device):
    """Phase 4: the grid pass at every cluster size `cuda_kernels.
    cell_grid_cluster` returns on this card, through kNN's grid path
    (`knn_interpolate_grid`) on one serve-like cloud of the fewest entries
    (S sources, T = 4 S targets; GRID_CLUSTER_STEP apart) that take each
    size: idx equal to the plain version's, weights and outputs bit for
    bit, and the cell grid equal to `ballquery.knn_cells`, a
    `"grid_cluster_sizes"` line each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    first, n = {}, GRID_CLUSTER_STEP
    while len(first) < ck.CELL_GRID_CLUSTER_MAX and n <= 64 * GRID_CLUSTER_STEP:
        first.setdefault(ck.cell_grid_cluster(1, n, sms), n)
        n += GRID_CLUSTER_STEP
    check(sorted(first) == list(range(1, ck.CELL_GRID_CLUSTER_MAX + 1)),
          f"cell_grid_cluster takes sizes {sorted(first)} for one cloud on {sms} SMs")
    f = GRID_CLUSTER_F
    for cs, n in sorted(first.items()):
        s, t = n // 5, n - n // 5
        u = torch.rand((1, t, 3), generator=gen, device=device)
        tgt = torch.cat([u[..., :2] * 20 - 10, u[..., 2:] * 3], -1)
        src = tgt[:, torch.randperm(t, generator=gen, device=device)[:s]].contiguous()
        x = torch.randn((1, s, f), generator=gen, device=device)
        with recorded_cells(ck) as cells:
            go, gi, gw, scored = ck.knn_interpolate_grid(x, src, tgt)
        wo, wi, ww = ck.knn_interpolate_plain(x, src, tgt)
        diff = int((gi != wi).sum())
        print(json.dumps({"phase": "grid_cluster_sizes", "cs": cs, "B": 1, "S": s, "T": t,
                          "wrapper_cs": ck._grid_cs(1, s + t, device), "differing_indices": diff,
                          "weights_equal": torch.equal(gw, ww), "outputs_equal": torch.equal(go, wo),
                          "sources_a_target": float(scored.double().mean())}), flush=True)
        check(ck._grid_cs(1, s + t, device) == cs,
              f"S={s}, T={t}: the wrapper takes cs {ck._grid_cs(1, s + t, device)}")
        check(diff == 0 and torch.equal(gw, ww) and torch.equal(go, wo),
              f"grid cluster size {cs} (S={s}, T={t}): {diff} indices differ, "
              "or weights or outputs")
        checked_grids(torch, ck, "knn_interpolate", f"cluster size {cs}", cells, src, tgt)


def compare_kernels(torch, ck, captured):
    """Phase 4: every serve kernel against its plain version at each call
    site of the serve step, then at its reference sites. Returns the
    per-step rows and the rows of the reference sites."""
    references = {"fps": FPS_REFERENCE, "sa_fused_eval": SEL_REFERENCE,
                  "knn_interpolate": KNN_REFERENCE + KNN_GRID_REFERENCE,
                  "pixel_max": PIXEL_MAX_REFERENCE}
    rows, ref_rows = {}, {}
    for name, _src, _rep in SERVE_KERNELS:
        kernel, plain = getattr(ck, name), getattr(ck, f"{name}_plain")
        calls = captured[name]
        want_sites = 2 + REFERENCE_SITES.get(name, 0)
        check(len(calls) == want_sites, f"{name}: expected {want_sites} call sites, saw {len(calls)}")
        agg, ref_agg = new_agg(), new_agg()
        for site, args in enumerate(calls):
            reference = site >= 2
            kind = references[name][site - 2][0] if reference else None
            with knn_whole(ck) if kind == "chunked" else contextlib.nullcontext():
                shape, nbytes, ops, err, diff_sel, lib_ms, pairs = check_site(
                    torch, ck, name, site, args,
                    (ref_agg if reference else agg) if name == "fps" else None)
                if reference:
                    shape += f" cloud={kind}"
                (ref_agg if reference else agg)["pairs"] += pairs
                # kNN's grid reference sites: a plain call of seconds (15 s at
                # B=67) is timed once, as the dense phase times its sites
                slow = name == "knn_interpolate" and site - 2 >= len(KNN_REFERENCE)
                report_site(torch, name, site, shape, kernel, plain, args, nbytes, ops, err,
                            diff_sel, lib_ms, ref_agg if reference else agg, reference,
                            plain_reps=1 if slow else 2)
        rows[name] = finish_agg(agg)
        if name in REFERENCE_SITES:
            ref_rows[name] = finish_agg(ref_agg)
    return rows, ref_rows


def sum_bound(want, abs_sum, depth):
    """The float32 error bound of a sum whose every term passes through at
    most `depth` roundings, in any order: gamma_depth * sum|terms| + 2 *
    2^-24 * |plain|, gamma_d = d u / (1 - d u) (the plain versions sum in
    float64 and round once)."""
    gamma = depth * U32 / (1 - depth * U32)
    return gamma * abs_sum.double() + 2 * U32 * want.double().abs()


def check_sum(torch, what, got, want, abs_sum, depth):
    """|kernel - plain| within `sum_bound`. Returns (max |diff|, worst
    diff/bound)."""
    bound = sum_bound(want, abs_sum, depth)
    diff = (got - want).abs().double()
    ratio = float((diff / bound.clamp_min(1e-45)).max())
    check(bool((diff <= bound).all()), f"{what}: |kernel - plain| exceeds the float32 bound "
                                       f"of its sum (worst ratio {ratio})")
    return float(diff.max()), ratio


def sa_lanes(ck, name, ch1):
    """Lanes a centroid of SA train pass `name` at C1 = ch1: the stats
    pass's from its library, C1 (a lane a channel) for main, bwd1 and bwd2."""
    return ck.sa_train_stats_lanes(ch1) if name == "sa_train_stats" else ch1


def sa_sum_depth(torch, ck, mask, lanes):
    """The summation depth of an SA train pass's per-channel sums over edges
    on the card (csrc/sa_train.cu), whose groups of `lanes` lanes
    (`sa_lanes`) each take one centroid at a time: the longest
    chain of valid edges one lane adds up (its group walks centroids with
    the grid's stride), then the block's groups in order, then the grid's
    partial rows (torch, any order). Also the (B, C) selection of the
    centroids that block 0 walks."""
    b, c, _ = mask.shape
    groups = ck.SA_THREADS // lanes
    grid = ck.sa_grid(b, c, lanes)
    walker = torch.arange(b * c, device=mask.device) % (grid * groups)
    chain = torch.zeros(grid * groups, dtype=torch.long, device=mask.device)
    chain.index_add_(0, walker, mask.sum(2).reshape(-1))
    return int(chain.max()) + groups + grid, (walker // groups == 0).reshape(b, c)


def compare_sa_train_site(torch, ck, name, site, args, got, want):
    """One call site of an SA train pass: every per-edge value rounds alike
    in kernel and plain version (`cuda_kernels.sa_train_edges`), so winners
    and their values must be equal. The per-channel sums over edges
    (statistics, S1/S2, db2, dW2) are held to the float32 bound of a sum at
    the kernel's own summation depth (`sa_sum_depth`, ~1.2e3 at PROD, not
    the ~1.4e6 edges), and the bound must reject the kernel's result with
    block 0's partial row taken out and a result of zeros: a kernel that
    drops a block or returns a zeroed S1 fails. dcterm (K slots a centroid)
    and the dq scatter (the picks of a point) are held to the bound at
    their own depth (sa_train_bwd2 sums no deeper: a chain over the picks
    for dq, at most K terms for dcterm), which must reject a result of
    zeros. Returns (shape, bytes, operations, max |diff|), the bytes and
    operations `torch_roofline`'s counts of the site."""
    q, cterm, idx, mask, aff = args[:5]
    w2 = args[5] if len(args) > 5 else None  # the stats pass takes no W2
    b, n, ch1 = q.shape
    c, k = idx.shape[1], idx.shape[2]
    ch2 = w2.shape[1] if w2 is not None else ch1
    e = ck.sa_train_edges(q, cterm, idx, mask, aff, w2, *args[6:])
    m = e["m"]
    valid = float(mask.sum())
    depth, blk0 = sa_sum_depth(torch, ck, mask, sa_lanes(ck, name, ch1))
    where = f"{name} site {site}"
    errs, ratios = [], []

    def held(what, g, w, abs_sum, part0=None, at=depth):
        err, ratio = check_sum(torch, f"{where} {what}", g, w, abs_sum, at)
        errs.append(err)
        ratios.append(ratio)
        wrongs = [(torch.zeros_like(w), "zeros")]
        if part0 is not None:
            wrongs.append((g.double() - part0, "block 0's partial row taken out"))
        for wrong, label in wrongs:
            passes = bool(((wrong - w).abs() <= sum_bound(w, abs_sum, at)).all())
            check(not passes, f"{where} {what}: the bound passes a result with {label}")

    def terms(t):  # (B, C, K, ...) per-edge terms -> (sum |t|, block 0's sum)
        t = t.double()
        return t.abs().sum((0, 1, 2)), t[blk0].sum((0, 1))

    rl, two, width = roofline(), w2 is not None, aff.shape[1]
    if name == "sa_train_stats":
        hc = torch.where(m, e["h1"] - aff[ck.SA_AFF["shift1"], :ch1], 0.0)
        held("sum", got[0], want[0], *terms(hc))
        held("sum of squares", got[1], want[1], *terms(hc.double() * hc))
        nbytes, ops = rl.sa_train_stats_counts(b, n, c, k, ch1, valid, width)
    elif name == "sa_train_main":
        for what, g, w in zip(("vmax", "vmin", "amax", "amin"), got[2:], want[2:]):
            check(torch.equal(g, w), f"{where}: {what} differs from the plain version "
                                     f"({int((g != w).sum())} entries)")
        hc = torch.where(m, e["h"] - aff[ck.SA_AFF["shift_l"], :ch2], 0.0)
        held("sum", got[0], want[0], *terms(hc))
        held("sum of squares", got[1], want[1], *terms(hc.double() * hc))
        nbytes, ops = rl.sa_train_main_counts(b, n, c, k, ch1, ch2, two, valid, width)
    elif name == "sa_train_bwd1":
        dy1, du, y1 = e["dy1"].double(), e["du"].double(), e["y1"].double()
        held("S1", got[0], want[0], *terms(dy1))
        held("S2", got[1], want[1], *terms(dy1 * e["xhat1"]))
        held("db2", got[2], want[2], *terms(du))
        held("dW2", got[3], want[3], torch.einsum("bcki,bcko->io", y1.abs(), du.abs()),
             torch.einsum("nki,nko->io", y1[blk0], du[blk0]))
        nbytes, ops = rl.sa_train_bwd1_counts(b, n, c, k, ch1, ch2, valid, width)
    else:  # sa_train_bwd2
        de0 = e["de0"]
        flat = (idx.long() + (torch.arange(b, device=q.device) * n)[:, None, None]).reshape(-1)
        absum = torch.zeros((b * n, ch1), dtype=torch.float64, device=q.device)
        absum.index_add_(0, flat, de0.reshape(-1, ch1).abs().double())
        cnt = torch.zeros(b * n, dtype=torch.float64, device=q.device)
        cnt.index_add_(0, flat, m.reshape(-1).double())
        held("dq", got[0].reshape(-1, ch1), want[0].reshape(-1, ch1), absum, at=cnt[:, None])
        held("dcterm", got[1], want[1], de0.double().abs().sum(2), at=k)
        # its edge buffer is a cost of the design, not of the function, and
        # is reported beside the bound (bwd2_dq_checks)
        nbytes, ops = rl.sa_train_bwd2_counts(b, n, c, k, ch1, ch2, two, valid, width)
    print(json.dumps({"kernel": name, "site": site, "sum_depth": depth,
                      "sums_worst_bound_ratio": max(ratios)}), flush=True)
    shape = f"B={b} N={n} C={c} K={k} C1={ch1} C2={ch2} valid_edges={int(valid)}"
    return shape, nbytes, float(ops), max(errs)


def bwd2_dq_checks(torch, ck, site, args, got):
    """sa_train_bwd2's dq at one call site: a second call, which also
    returns the edge buffer of de0, must give dq and dcterm bit for bit;
    the buffer must equal the plain version's per-edge de0 (0 on a masked
    slot), and dq must equal bit for bit `sa_train_dq_ordered_plain` of that
    buffer, the dq pass's order of sums. Prints the device time a launch of
    the edge pass and of the dq pass and the edge buffer's bytes (written
    once, its valid rows read once) with their time at the HBM rate: a cost
    of the design that the bound of the function leaves out. Returns the
    time of the library call for the dq part, `index_add_` of the buffer
    into dq, and those figures."""
    from stratanet2_tpu_torch.utils.profiling import time_ms

    where = f"sa_train_bwd2 site {site}"
    again = ck.sa_train_bwd2(*args, edges=True)
    for what, g, a in zip(("dq", "dcterm"), got, again):
        check(torch.equal(g.view(torch.int32), a.view(torch.int32)),
              f"{where}: two calls differ in {what}")
    de = again[2]
    q, cterm, eidx, mask, aff, w2, awin, gt = args
    b, c, k = eidx.shape
    n, ch1 = q.shape[1], q.shape[2]
    want_de = ck.sa_train_edges(q, cterm, eidx, mask, aff, w2, awin, gt)["de0"]
    check(torch.equal(de, want_de.reshape(de.shape)), f"{where}: the edge buffer differs from "
          f"the plain de0 ({int((de != want_de.reshape(de.shape)).sum())} elements)")
    ordered = ck.sa_train_dq_ordered_plain(de, eidx, mask, n)
    differ = int((got[0].view(torch.int32) != ordered.view(torch.int32)).sum())
    check(differ == 0, f"{where}: dq differs from the ordered plain in {differ} elements")
    flat = (eidx.long() + (torch.arange(b, device=q.device) * n)[:, None, None]).reshape(-1)
    lib_out = torch.zeros((b * n, ch1), device=q.device)
    lib_ms = time_ms(lambda: lib_out.zero_().index_add_(0, flat, de.reshape(-1, ch1)),
                     20)  # masked slots add their exact 0 to point 0
    parts = dict(edge_pass_device_ms=0.0, dq_pass_device_ms=0.0)
    # the dq pass: its keys kernel too where it takes windows
    windowed = ck.sa_train_dq_plan(b, n, c, k) is not None
    for part, kernel in (("edge_pass", "sa_train_bwd2_kernel"), ("dq_pass", "sa_train_dq_kernel"),
                         ("dq_pass", "sa_train_dq_keys_kernel")):
        if kernel == "sa_train_dq_keys_kernel" and not windowed:
            continue
        ms, launches, dev_ops = device_profile(torch, lambda: ck.sa_train_bwd2(*args), (kernel,))
        check(launches > 0, f"{where}: the profiler saw no {kernel}")
        parts[f"{part}_device_ms"] += ms
    buffer_bytes = 4.0 * b * c * k * ch1 + 4.0 * float(mask.sum()) * ch1
    parts.update(edge_buffer_bytes=buffer_bytes,
                 edge_buffer_hbm_ms=roofline().bound_ms(buffer_bytes, 0.0)[0])
    print(json.dumps({"kernel": "sa_train_bwd2", "site": site, "library": "index_add_ (dq)",
                      "profiled_device_ops": dev_ops, **parts}), flush=True)
    return lib_ms, parts


def compare_train_kernels(torch, ck, captured):
    """Phase 11: the train kernels against their plain versions at each
    call site of the train step, then at phase 10's reference sites.
    Returns the per-step rows (train-step sites only) and the rows of the
    reference sites. Prints sa_train_bwd2's edge and dq passes and edge
    buffer summed over the train step's sites."""
    rows, ref_rows = {}, {}
    bwd2_parts = {}
    for name, _src, _rep in TRAIN_KERNELS:
        kernel, plain = getattr(ck, name), getattr(ck, f"{name}_plain")
        calls = captured[name]
        n_step = TRAIN_LAUNCHES[name]
        want_sites = n_step + REFERENCE_SITES.get(name, 0)
        check(len(calls) == want_sites,
              f"{name}: expected {want_sites} call sites, saw {len(calls)}")
        agg, ref_agg = new_agg(), new_agg()
        for site, args in enumerate(calls):
            diff_sel, lib_ms = 0, None
            if name in ("ball_query", "pixel_max_bwd"):
                shape, nbytes, ops, err, diff_sel, lib_ms, pairs = check_site(
                    torch, ck, name, site, args,
                    (ref_agg if reference else agg) if name == "fps" else None)
                if name == "ball_query" and site >= n_step:
                    shape += f" cloud={SEL_REFERENCE[site - n_step][0]}"
                (ref_agg if site >= n_step else agg)["pairs"] += pairs
            elif name == "knn_scatter":
                shape, nbytes, ops, err, lib_ms, plain = knn_scatter_site(torch, ck, site, args)
                ref = site - n_step - PHASE10_SITES[name]
                if ref >= 0:
                    shape += f" cloud={KNN_SCATTER_REFERENCE[ref][0]}"
            elif name in SA_TRAIN:
                got, want = kernel(*args), plain(*args)
                if name == "sa_train_bwd2":
                    lib_ms, parts = bwd2_dq_checks(torch, ck, site, args, got)
                    if site < n_step:
                        for key, v in parts.items():
                            bwd2_parts[key] = bwd2_parts.get(key, 0.0) + v
                shape, nbytes, ops, err = compare_sa_train_site(torch, ck, name, site, args,
                                                                got, want)
                b, c, k = args[2].shape
                if site < n_step:
                    agg["sites"].append((args[0].shape[2], b * c, k))
            reference = site >= n_step
            report_site(torch, name, site, shape, kernel, plain, args, nbytes, ops, err,
                        diff_sel, lib_ms, ref_agg if reference else agg, reference)
        rows[name] = finish_agg(agg)
        if name in REFERENCE_SITES:
            ref_rows[name] = finish_agg(ref_agg)
    print(json.dumps({"kernel": "sa_train_bwd2", "train_step_parts": bwd2_parts}), flush=True)
    return rows, ref_rows


def pixel_max_bwd_reference_call(torch, ck, device, b, n, n_pix):
    """The synthetic pixel-max backward site: ids drawn over [-n_pix/8,
    9 n_pix/8) (20% outside the pixels), the points of a band of n_pix/8
    pixels moved outside too (30% in all, the band left empty), quantised
    values (ties, lowest index wins), amax from the plain forward and
    random cotangents."""
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    pix = torch.randint(-n_pix // 8, n_pix + n_pix // 8, (b, n), generator=gen, device=device,
                        dtype=torch.int32)
    pix[(pix >= n_pix // 4) & (pix < n_pix // 4 + n_pix // 8)] = -1
    vals = torch.randint(0, 8, (b, n, 3), generator=gen, device=device).float() / 8
    _, amax = ck.pixel_max_plain(pix, vals, n_pix)
    g = torch.randn((b, n_pix, 3), generator=gen, device=device)
    return pix, amax, g


def sa_train_reference_calls(torch, ck, device):
    """The arguments of the SA train passes at the SA_TRAIN_REFERENCE sites,
    drawn from a seed, as {pass: [args]}: the stats and bwd1 passes at the
    two-layer site only."""
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    calls = {name: [] for name in SA_TRAIN}
    for site in SA_TRAIN_REFERENCE:
        bwd = sa_train_site_args(torch, ck, gen, device, *site)
        calls["sa_train_main"].append(bwd[:6])
        calls["sa_train_bwd2"].append(bwd)
        if bwd[5] is not None:  # two layers
            calls["sa_train_stats"].append(bwd[:5])
            calls["sa_train_bwd1"].append(bwd)
    return calls


def sa_train_site_args(torch, ck, gen, device, b, n, c, k, ch):
    """One SA train reference site's arguments of sa_train_bwd2 (q, cterm,
    idx, mask, aff, w2, awin, gt), drawn from `gen` as the comment of
    SA_TRAIN_REFERENCE says (the main pass takes the first six, the stats
    pass the first five). The per-channel BN terms (`sa_aff`; the scales
    a1, gos and inv_s around 1) and W2 are drawn too; the backward passes
    take the plain main pass's winners (awin) and random cotangents."""
    def draw(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale + shift

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device).float()

    two = ch == 16
    q = ints(-2, 3, 8, ch)[torch.randint(0, 8, (b, n), generator=gen, device=device)]
    cterm = ints(-1, 2, b, c, ch)
    g = -(-n // k)
    lo = torch.arange(k, device=device) * g
    size = (n - lo).clamp(0, g)  # the groups' points
    pick = (torch.rand((b, c, k), generator=gen, device=device) * size).long()
    idx = torch.where(size > 0, lo + pick, 0).int()
    mask = (torch.rand((b, c, k), generator=gen, device=device) < 0.6) & (size > 0)
    mask.view(b * c, k)[::5] = False
    positive = ("a1", "gos2", "inv_s2", "inv_s1", "gos1")
    aff = ck.sa_aff(ch, **{row: (draw(ch, scale=0.25, shift=1.0) if row in positive
                                 else draw(ch, scale=0.1))
                           for row in ck.SA_AFF_ROWS}).contiguous()
    w2 = draw(ch, ch, scale=0.25) if two else None
    awin = ck.sa_train_main_plain(q, cterm, idx, mask, aff, w2)[4]
    return q, cterm, idx, mask, aff, w2, awin, draw(b, c, ch)


def launch_path(torch, ck, args, pm_args):
    """Phase 11b: host microseconds a call (mean of LAUNCH_REPS, no
    synchronisation inside) of the two ways to get the current stream, of
    the device check and the device context a launch no longer enters, of
    the parts of a pixel_max_bwd call: its device check, the output's
    allocation, the C entry alone (ctypes and the kernel launch) and the
    whole wrapper, and of a whole pixel_max call (`pm_args`, the train
    step's)."""
    dev = torch.device("cuda", 0)
    pix, amax, g = args
    ck.pixel_max_bwd(*args)
    entry = ck._fns["pixel_max_bwd"]
    dv = torch.empty((g.shape[0], pix.shape[1], g.shape[2]), device=dev)
    cargs = (pix.data_ptr(), amax.data_ptr(), g.data_ptr(), dv.data_ptr(),
             g.shape[0], pix.shape[1], g.shape[1], g.shape[2],
             torch._C._cuda_getCurrentRawStream(0))

    def swap(d):  # what a launch paid before: a device context around every call
        with torch.cuda.device(d):
            pass

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAUNCH_REPS):
            fn()
        us = (time.perf_counter() - t0) / LAUNCH_REPS * 1e6
        torch.cuda.synchronize()
        return us

    print(json.dumps({
        "phase": "launch_path", "reps": LAUNCH_REPS,
        "current_stream_cuda_stream_us": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_stream_us": host_us(lambda: torch._C._cuda_getCurrentRawStream(0)),
        "current_device_us": host_us(torch.cuda.current_device),
        "device_context_us": host_us(lambda: swap(dev)),
        "pixel_max_bwd_on_card_us": host_us(lambda: ck._on_card("pixel_max_bwd", *args)),
        "torch_empty_dv_us": host_us(lambda: torch.empty(dv.shape, dtype=torch.float32,
                                                          device=dev)),
        "new_empty_dv_us": host_us(lambda: g.new_empty(dv.shape)),
        "pixel_max_bwd_c_entry_us": host_us(lambda: entry(*cargs)),
        "pixel_max_bwd_call_us": host_us(lambda: ck.pixel_max_bwd(*args)),
        "pixel_max_call_us": host_us(lambda: ck.pixel_max(*pm_args)),
    }), flush=True)


def profile_mismatches(kernels, launches):
    """The wrappers whose device kernels show in `kernels` ((ms, calls,
    name) a step) other than exactly when `launches` expects them to
    launch, each as a message."""
    out = []
    for name, count in launches.items():
        calls = sum(c for _, c, key in kernels
                    if key.removeprefix("void ").startswith(DEVICE_KERNELS[name]))
        if (calls > 0) != (count > 0):
            out.append(f"the profiler saw {calls} device kernels of {name} per step, "
                       f"expected {count} launches")
    return out


def profile_step(torch, step, args, step_ms, label, launches, steps=None, strict=True,
                 warmup=0):
    """Phases 7 and 14: device time per step, by kernel and by every
    wrapper, from `torch_trace_step.trace_table` (the trace script's own
    trace, device operations and grouping); with `strict`, a wrapper's
    device kernels must show up exactly when `launches` expects it to launch
    in the step. With `warmup`, that many steps run first under the
    profiler's warm-up (left out of the trace): late in a long run on an
    H100 the first tens of ms of a trace lost their kernels' records.
    Returns the device kernels as (ms a step, calls a step, name)."""
    import tempfile

    steps = PROFILE_STEPS if steps is None else steps
    with tempfile.TemporaryDirectory() as logdir:
        table = trace_step().trace_table(lambda: step(*args), steps, logdir, "cuda", step_ms,
                                         warmup)
    kernels, busy_ms = table.rows, table.busy_ms
    port = {name: [0.0, 0.0] for name in launches}
    for ms, calls, key in kernels:
        for name in launches:
            prefixes = DEVICE_KERNELS[name]
            if key.removeprefix("void ").startswith(prefixes):
                port[name][0] += ms
                port[name][1] += calls
    for msg in profile_mismatches(kernels, launches) if strict else ():
        check(False, msg)
    port_ms = sum(ms for ms, _ in port.values())
    print(json.dumps({
        "phase": label, "steps": steps, "step_ms": step_ms,
        "device_busy_ms": busy_ms, "idle_share": table.idle_share,
        # blocking copies from pageable host memory drain the stream
        "htod_copies": sum(c for _, c, key in kernels if key.startswith("Memcpy HtoD")),
        "port_kernels": {name: {"ms": ms, "launches": calls} for name, (ms, calls) in port.items()},
        "rest_ms": busy_ms - port_ms,
        "rest_launches": sum(c for _, c, _ in kernels) - sum(c for _, c in port.values()),
        "device_kernels": [{"kernel": key[:90], "ms": ms, "calls": calls}
                           for ms, calls, key in kernels],
    }), flush=True)
    return kernels


def timed_steps(torch, fn, steps=None):
    """Median and all host-clock times (ms) of `steps` (STEPS) synchronised
    calls."""
    times = []
    for _ in range(STEPS if steps is None else steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], times


def check_launches(launches, want, path):
    print(json.dumps({"phase": f"{path}_launches", **launches}), flush=True)
    for name, count in want.items():
        check(launches[name] == count,
              f"{name} launched {launches[name]} times in the {path}, expected {count}")


def serve_phases(torch, ck, cfg, device, card):
    """Phases 3-8. Returns the serve kernels' rows, the rows of their
    reference sites and the counted launches."""
    from stratanet2_tpu_torch.inference.predict import make_predict_step
    from stratanet2_tpu_torch.utils.profiling import record_calls
    from stratanet2_tpu_torch.utils.synthetic import random_model, serve_batch

    b, n = cfg.train.batch_size, cfg.model.subsample_size
    gen = torch.Generator(device=device).manual_seed(SEED)
    cloud, xyz = serve_batch(b, n, gen, device)
    model = random_model(cfg.model, SEED, device)
    step = make_predict_step(cfg, device=device)

    # phase 3: one serve step, its eager body (a graph's capture computes
    # nothing), records each kernel call's inputs
    captured = record_calls(ck, [name for name, _, _ in SERVE_KERNELS],
                            lambda: step.body(model, cloud, xyz))
    torch.cuda.synchronize()
    step_fps = list(captured["fps"])
    captured["fps"] += fps_reference_calls(torch, xyz, device)
    captured["sa_fused_eval"] += selection_reference_calls(torch, ck, device)[1]
    captured["knn_interpolate"] += knn_reference_calls(torch, device)
    captured["pixel_max"] += pixel_max_reference_calls(torch, device)
    with torch.inference_mode():
        rows, ref_rows = compare_kernels(torch, ck, captured)
        grid_cluster_sizes(torch, ck, device)
        fps_chain(torch, ck, step_fps, device)
    del captured, step_fps

    # phase 5: the counted serve step
    ck.reset_launches()
    rasters, pred_pl = step(model, cloud, xyz)
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    check_launches(launches, SERVE_LAUNCHES, "serve_step")
    check(tuple(rasters.shape) == (b, 3, cfg.model.diam_pix, cfg.model.diam_pix),
          f"rasters shape {tuple(rasters.shape)}")
    check(tuple(pred_pl.shape) == (b, 4), f"pred_pl shape {tuple(pred_pl.shape)}")
    filled = rasters[~torch.isnan(rasters)]
    check(filled.numel() > 0, "every raster pixel is empty")
    check(bool(torch.isfinite(pred_pl).all()), "pred_pl is not finite")
    for what, t in (("rasters", filled), ("pred_pl", pred_pl)):
        check(bool(((t >= 0) & (t <= 1)).all()), f"{what} outside [0, 1]")

    # phase 6: step time, host clock around synchronised steps
    step_ms, times = timed_steps(torch, lambda: step(model, cloud, xyz))
    print(json.dumps({"phase": "serve_step", "B": b, "N": n, "step_ms_median": step_ms,
                      "step_ms_all": times, "points_per_s": b * n / (step_ms / 1e3),
                      "card": card}), flush=True)

    profile_step(torch, step, (model, cloud, xyz), step_ms, "profile", SERVE_LAUNCHES)

    # phase 8: B=2 on the card against the port on the CPU
    r_gpu, p_gpu = step(model, cloud[:2], xyz[:2])
    r_cpu, p_cpu = make_predict_step(cfg, device="cpu")(
        copy.deepcopy(model).cpu(), cloud[:2].cpu(), xyz[:2].cpu()
    )
    r_gpu, p_gpu = r_gpu.cpu(), p_gpu.cpu()
    check(torch.equal(torch.isnan(r_gpu), torch.isnan(r_cpu)), "raster NaN pattern differs from CPU")
    r_err = float(torch.nan_to_num(r_gpu - r_cpu).abs().max())
    p_err = float((p_gpu - p_cpu).abs().max())
    print(json.dumps({"phase": "cpu_reference_B2", "rasters_max_abs_diff": r_err,
                      "pred_pl_max_abs_diff": p_err, "atol": CPU_ATOL}), flush=True)
    check(max(r_err, p_err) <= CPU_ATOL, f"card vs CPU differ by {max(r_err, p_err)}")
    r_one, p_one = step(model, cloud[:1], xyz[:1])  # a partial batch of one plot
    one_err = max(float(torch.nan_to_num(r_one.cpu()[0] - r_gpu[0]).abs().max()),
                  float((p_one.cpu()[0] - p_gpu[0]).abs().max()))
    check(torch.equal(torch.isnan(r_one.cpu()[0]), torch.isnan(r_gpu[0])) and one_err <= CPU_ATOL,
          f"B=1 step differs from its row of the B=2 step by {one_err}")
    return rows, ref_rows, launches


def compare_train_with_cpu(torch, cfg, model, kde, cloud, xyz, gt,
                           label="train_cpu_reference_B2"):
    """Phase 15: one train step at B=2 (at most) on the card and on the CPU
    from the same weights and batch."""
    from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step

    sides = {}
    for side, dev in (("card", "cuda"), ("cpu", "cpu")):
        m = copy.deepcopy(model).to(dev)
        start = {k: v.detach().cpu().clone() for k, v in m.named_parameters()}
        opt, sched = make_optimizer(cfg, m, STEPS_PER_EPOCH)
        comps = make_train_step(cfg, kde, device=dev)(
            m, opt, sched, cloud[:2].to(dev), xyz[:2].to(dev), gt[:2].to(dev))
        sides[side] = dict(
            comps={k: float(v) for k, v in comps.items()},
            grads={k: v.grad.detach().cpu() for k, v in m.named_parameters()},
            params={k: v.detach().cpu() for k, v in m.named_parameters()},
            state={k: v.detach().cpu() for k, v in m.named_buffers()},
            start=start,
        )
    gpu, cpu = sides["card"], sides["cpu"]
    loss_err = max(abs(gpu["comps"][k] - cpu["comps"][k]) for k in cpu["comps"])
    state_err = max(float((gpu["state"][k] - v).abs().max()) for k, v in cpu["state"].items())
    grad_rel, param_sure, param_all = 0.0, 0.0, 0.0
    lr, wd = cfg.train.lr, cfg.train.wd
    for k, g in cpu["grads"].items():
        scale = float(g.abs().max())
        check(scale > 0 and bool(torch.isfinite(gpu["grads"][k]).all()), f"gradient of {k}")
        grad_rel = max(grad_rel, float((gpu["grads"][k] - g).abs().max()) / scale)
        eff = (g + wd * cpu["start"][k]).abs()
        sure = eff > TRAIN_GRAD_RTOL * scale
        diff = (gpu["params"][k] - cpu["params"][k]).abs()
        slack = diff - 1.2e-7 * cpu["params"][k].abs()
        param_sure = max(param_sure, float(slack[sure].max()) if bool(sure.any()) else 0.0)
        param_all = max(param_all, float(diff.max()))
    print(json.dumps({"phase": label, "loss_max_abs_diff": loss_err,
                      "grad_max_rel_diff": grad_rel, "bn_state_max_abs_diff": state_err,
                      "param_max_abs_diff_where_sure": param_sure,
                      "param_max_abs_diff": param_all, "loss_atol": TRAIN_LOSS_ATOL,
                      "grad_rtol": TRAIN_GRAD_RTOL, "state_atol": TRAIN_STATE_ATOL,
                      "comps_card": gpu["comps"], "comps_cpu": cpu["comps"]}), flush=True)
    check(loss_err <= TRAIN_LOSS_ATOL, f"train loss parts: card vs CPU differ by {loss_err}")
    check(grad_rel <= TRAIN_GRAD_RTOL, f"gradients: card vs CPU differ by {grad_rel} of max")
    check(state_err <= TRAIN_STATE_ATOL, f"BN state: card vs CPU differ by {state_err}")
    check(param_sure <= 1e-7, f"params after the step differ by {param_sure} where sure")
    check(param_all <= 2 * lr + 1e-7, f"params after the step differ by {param_all}")


def serve_after_train(torch, cfg, model, cloud, xyz):
    """Phase 15b: the serve step at B=2 on `model`, fresh from train steps
    and in train mode, must give exactly what it gives on an eval copy,
    change no BN running statistic and leave the model in train mode (the
    serve step runs the model in eval mode, as JAX's train=False does)."""
    from stratanet2_tpu_torch.inference.predict import make_predict_step

    check(model.training, "the trained model is not in train mode")
    step = make_predict_step(cfg, device=cloud.device)
    state = {k: v.clone() for k, v in model.named_buffers()}
    eval_copy = copy.deepcopy(model).eval()
    r_got, p_got = step(model, cloud[:2], xyz[:2])
    r_want, p_want = step(eval_copy, cloud[:2], xyz[:2])
    torch.cuda.synchronize()
    moved = [k for k, v in model.named_buffers() if not torch.equal(v, state[k])]
    same_nan = torch.equal(torch.isnan(r_got), torch.isnan(r_want))
    r_err = float(torch.nan_to_num(r_got - r_want).abs().max())
    p_err = float((p_got - p_want).abs().max())
    print(json.dumps({"phase": "serve_after_train", "B": 2, "rasters_max_abs_diff": r_err,
                      "pred_pl_max_abs_diff": p_err, "bn_buffers_moved": moved,
                      "training_after": model.training}), flush=True)
    check(same_nan and r_err == 0.0 and p_err == 0.0,
          f"serve step on the trained model differs from an eval copy by {max(r_err, p_err)}")
    check(not moved, f"the serve step moved BN state: {moved}")
    check(model.training, "the serve step left the model out of train mode")


def compare_fused_with_unfused(torch, cfg, model, cloud, xyz):
    """Phase 10: SA1 and SA2 at the PROD shapes on the fused route and on
    the unfused path (`set_abstraction_unfused`, SA2 in its pre-projected
    form, whose gather backward is a knn_scatter call), from the same
    weights, inputs and random cotangent, and with random BN running means
    (N(0, SHIFT_STD^2), another draw per layer): the statistics' shifts are
    nonzero and differ between SA1's two layers, so a kernel that read the
    wrong shift row, or none, fails here and at these reference sites in
    phase 11. SA2's input is SA1's fused output. Centroids must be equal;
    out, BN state and every gradient (and SA2's gradient in x) are held to
    the tolerances above."""
    from stratanet2_tpu_torch.models.pointnet2 import (
        set_abstraction_unfused,
        set_abstraction_train_fused,
    )

    mc = cfg.model
    gen = torch.Generator(device=cloud.device).manual_seed(SEED + 2)
    fps_kw = dict(fps_parts=mc.fps_parts, fps_min_part_samples=mc.fps_min_part_samples)
    x, pos = cloud[..., 2:].contiguous(), xyz
    stages = (("sa1", model.sa1, mc.n_centroids1, mc.r1, mc.k1, False),
              ("sa2", model.sa2, mc.n_centroids2, mc.r2, mc.k2, True))
    for stage, mlp, n_c, radius, k, preproject in stages:
        sides, gy = {}, None
        shifts = [SHIFT_STD * torch.randn(layer.bn.mean.shape, generator=gen, device=cloud.device)
                  for layer in mlp.layers]
        for route in ("fused", "unfused"):
            net = copy.deepcopy(mlp).train()
            for layer, shift in zip(net.layers, shifts):
                layer.bn.mean = shift.clone()
            xt = x.detach().clone().requires_grad_(preproject)
            if route == "fused":
                out, cent = set_abstraction_train_fused(net, xt, pos, n_c, radius, k, **fps_kw)
                gy = torch.randn(out.shape, generator=gen, device=out.device)
            else:
                out, cent = set_abstraction_unfused(net, xt, pos, n_c, radius, k, **fps_kw,
                                                  preproject=preproject)
            (out * gy).sum().backward()
            grads = {name: p.grad for name, p in net.named_parameters()}
            if preproject:
                grads["x"] = xt.grad
            sides[route] = dict(out=out.detach(), cent=cent, grads=grads,
                                state=dict(net.named_buffers()))
        f, u = sides["fused"], sides["unfused"]
        check(torch.equal(f["cent"], u["cent"]), f"{stage}: fused and unfused centroids differ")
        out_diff = (f["out"] - u["out"]).abs()
        out_err = float(out_diff.max())
        out_ratio = float((out_diff / (FUSED_OUT_ATOL + FUSED_OUT_RTOL * u["out"].abs())).max())
        state_err = max(float((f["state"][kk] - v).abs().max()) for kk, v in u["state"].items())
        grad_rel = {kk: float((f["grads"][kk] - g).abs().max() / g.abs().max())
                    for kk, g in u["grads"].items()}
        print(json.dumps({"phase": "sa_fused_vs_unfused", "stage": stage,
                          "shape": list(f["out"].shape), "out_max_abs_diff": out_err,
                          "out_worst_tolerance_ratio": out_ratio,
                          "bn_state_max_abs_diff": state_err, "grad_max_rel_diff": grad_rel,
                          "out_rtol": FUSED_OUT_RTOL, "out_atol": FUSED_OUT_ATOL,
                          "state_atol": TRAIN_STATE_ATOL, "grad_rtol": FUSED_GRAD_RTOL}),
              flush=True)
        check(out_ratio <= 1.0, f"{stage}: fused and unfused outputs differ by {out_err}")
        check(state_err <= TRAIN_STATE_ATOL, f"{stage}: BN state differs by {state_err}")
        check(max(grad_rel.values()) <= FUSED_GRAD_RTOL,
              f"{stage}: gradients differ by {max(grad_rel.values())} of the leaf's max")
        x, pos = f["out"], f["cent"]


def loader_steps(torch, ck, cfg, device, card):
    """Phase 15c: the steps on batches made the way users make them.
    LOADER_PLOTS synthetic plots of LOADER_POINTS points are written with the
    port's LAS writer into a temporary directory, read and prepared
    (`load_las_file` -> `clean` -> `pre_transform`; gt coverages drawn from
    the seed, no CSV), then `PlotLoader` (LOADER_WORKERS threads, the PROD
    subsample) gives LOADER_TRAIN_STEPS train batches (shuffled, one an
    epoch) and one eval batch; each goes to the card with
    `torch.from_numpy(...).to(device)` for a train step on a fresh model,
    then a serve step. Launch counters are zeroed just before the steps and
    read just after. Prints the min-z path taken, the host ms of each batch
    (the loader's `next`) and the step ms beside them (a step's ms includes
    its batch's copy to the card). Each of those batches is an epoch's first
    (a new pool, nothing prefetched). The steady state: one epoch of
    LOADER_EPOCH_BATCHES batches from one pool, over the prepared plots
    repeated under new ids (each item draws its own subsample and
    augmentation), the loader alone (`epoch_host_ms_a_batch`), then with a
    train step after each batch (`fed_wait_ms`: the host's wait for the
    next batch while the card trains; `fed_step_ms`)."""
    import tempfile

    import numpy as np

    from stratanet2_tpu_torch.data import dataset, las, transforms
    from stratanet2_tpu_torch.data.loader import PlotLoader
    from stratanet2_tpu_torch.inference.predict import make_predict_step
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
    from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step
    from stratanet2_tpu_torch.utils.synthetic import (
        cloud_to_las_fields,
        make_plot_cloud,
        random_model,
    )

    rng = np.random.default_rng(SEED + 12)
    ds = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        names = []
        for i in range(LOADER_PLOTS):
            c = make_plot_cloud(rng, n=LOADER_POINTS, center=(1000 + 40 * i, 2000))
            names.append(f"{tmp}/Plot_{i:03d}.las")
            las.write_las(names[-1], cloud_to_las_fields(c))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, name in enumerate(names):
            cloud = dataset.clean(dataset.load_las_file(name), name)
            cloud = transforms.pre_transform(cloud, cfg.data.znorm_radius_in_meters)
            low, med, high = rng.uniform(0, 1, 3)
            pid = f"Plot_{i:03d}"
            ds[pid] = {"cloud": cloud, "coverages": np.array([low, 1 - low, med, high]),
                       "plot_center": dataset.get_plot_center(cloud), "plot_id": pid,
                       "N_points_in_cloud": cloud.shape[1], "index": i}
        prepare_s = time.perf_counter() - t0

    def batches(loader, count):
        """`count` batches and the host ms of each, epoch after epoch."""
        out = []
        while len(out) < count:
            it = iter(loader)
            while len(out) < count:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
                out.append((batch, (time.perf_counter() - t0) * 1e3))
        return out

    b, p = cfg.train.batch_size, cfg.model.diam_pix
    train = batches(PlotLoader(ds, cfg, train=True, batch_size=b, seed=SEED,
                               workers=LOADER_WORKERS), LOADER_TRAIN_STEPS)
    (serve, serve_host_ms), = batches(PlotLoader(ds, cfg, batch_size=b, workers=LOADER_WORKERS), 1)

    def to_card(batch, *keys):
        return [torch.from_numpy(batch[k]).to(device) for k in keys]

    kde = fit_kde_mixture(train[0][0]["cloud"][..., 2].astype(np.float64) * cfg.model.z_max)
    model = random_model(cfg.model, SEED, device, running_stats=False)
    opt, sched = make_optimizer(cfg, model, STEPS_PER_EPOCH)
    step, predict = make_train_step(cfg, kde, device=device), make_predict_step(cfg, device=device)
    ck.reset_launches()
    train_ms, losses = [], []
    for batch, _ in train:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = step(model, opt, sched, *to_card(batch, "cloud", "xyz", "coverages"))
        torch.cuda.synchronize()
        train_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in comps.items()})
    t0 = time.perf_counter()
    rasters, pred_pl = predict(model, *to_card(serve, "cloud", "xyz"))
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = ck.launch_counts()
    want = {name: LOADER_TRAIN_STEPS * TRAIN_LAUNCHES[name] + SERVE_LAUNCHES[name]
            for name in TRAIN_LAUNCHES}
    check_launches(launches, want, "loader_steps")

    reps = -(-LOADER_EPOCH_BATCHES * b // len(ds))
    epoch_ds = {f"{pid}_{r}": dict(item, plot_id=f"{pid}_{r}", index=r * len(ds) + item["index"])
                for r in range(reps) for pid, item in ds.items()}

    def epoch(work):
        """The host ms of each `next` over one train epoch from one pool,
        with `work(batch)` after each."""
        waits, it = [], iter(PlotLoader(epoch_ds, cfg, train=True, batch_size=b, seed=SEED,
                                        workers=LOADER_WORKERS))
        while len(waits) < LOADER_EPOCH_BATCHES:
            t0 = time.perf_counter()
            batch = next(it)
            waits.append((time.perf_counter() - t0) * 1e3)
            work(batch)
        return waits

    def fed(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = step(model, opt, sched, *to_card(batch, "cloud", "xyz", "coverages"))
        torch.cuda.synchronize()
        fed_step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in comps.items()})

    alone_ms = epoch(lambda batch: None)
    fed_step_ms = []
    fed_wait_ms = epoch(fed)
    host_ms = [ms for _, ms in train] + [serve_host_ms]
    print(json.dumps({"phase": "loader_steps", "plots": LOADER_PLOTS, "points": LOADER_POINTS,
                      "workers": LOADER_WORKERS, "B": b, "N": cfg.model.subsample_size,
                      "min_z_path": transforms.min_z_path(), "write_las_s": write_s,
                      "prepare_s": prepare_s, "host_ms_a_batch": host_ms,
                      "host_ms_a_batch_median": sorted(host_ms)[len(host_ms) // 2],
                      "train_step_ms": train_ms, "serve_step_ms": serve_ms,
                      "epoch_plots": len(epoch_ds), "epoch_host_ms_a_batch": alone_ms,
                      "epoch_steady_ms_a_batch": sum(alone_ms[1:]) / (len(alone_ms) - 1),
                      "fed_wait_ms": fed_wait_ms, "fed_step_ms": fed_step_ms,
                      "loss_parts": losses, "card": card}), flush=True)
    for i, parts in enumerate(losses):
        for name, value in parts.items():
            check(np.isfinite(value), f"loader_steps: train step {i}: loss part {name} is {value}")
    for i, (batch, _) in enumerate(train + [(serve, 0.0)]):
        check(batch["cloud"].shape == (b, cfg.model.subsample_size, 10)
              and batch["xyz"].shape == (b, cfg.model.subsample_size, 3)
              and batch["coverages"].shape == (b, 4),
              f"loader_steps: batch {i} shapes {batch['cloud'].shape} {batch['xyz'].shape}")
    check(tuple(rasters.shape) == (b, 3, p, p), f"loader_steps: rasters {tuple(rasters.shape)}")
    check(tuple(pred_pl.shape) == (b, 4) and bool(torch.isfinite(pred_pl).all()),
          f"loader_steps: pred_pl {tuple(pred_pl.shape)} not finite")
    check(bool(((pred_pl >= 0) & (pred_pl <= 1)).all()), "loader_steps: pred_pl outside [0, 1]")
    return ds, (sum(fed_wait_ms) + sum(fed_step_ms)) / LOADER_EPOCH_BATCHES


class _Warnings(logging.Handler):
    """Keeps the messages of the warnings it gets."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def train_full_phase(torch, ck, cfg, device, card, prepared, fed_ms):
    """Phase 15d: the training loop users run, `train_full`, on the card.
    TRAIN_FULL_PLOTS plots: phase 15c's prepared plots repeated under new
    ids, with coverages drawn from the seed; fold 1 of the port's KFold
    split; the PROD model from `init_pointnet2` (seed), the KDE prior fitted
    on the plots; the DEV train profile (eval every epoch) with early
    stopping on and a patience of 3 epochs, so that no run stops before
    epoch 3; `MetricSink` in a temporary experiment folder. Four runs,
    launch counters zeroed before and checked after each (train batches x
    TRAIN_LAUNCHES + evals x EVAL_LAUNCHES, + 1 pixel_max a val plot of the
    last eval where matplotlib draws its figures):
    1. 2 epochs: the best and the `.resume` checkpoints written, every loss
       part finite, the train and eval dicts with JAX's keys;
    2. `resume=True` with n_epoch=3 from a copy of run 1's folder: starts at
       epoch 3;
    3. an unbroken 3-epoch run, whose checkpoints after epoch 2 are copied
       aside;
    4. `resume=True` with n_epoch=3 from run 3's copied checkpoints;
    5. and 6., the controls: runs 4 and 2 again, each from a `.resume`
       file whose Adam state is dropped (`drop_adam_state`);
    run 2 and run 4 against run 3 within RESUME_BOUND, bit for bit
    (epoch 3's train and eval losses, the final eval, its plot predictions,
    params and BN state), and each control outside it, so that the check
    tells a resume that loses the optimizer from one that keeps it; then
    the reload: `load_checkpoint` of run 1's best file into a fresh model
    and `evaluate`, equal to run 1's final eval bit for bit. Prints the
    seconds an epoch, points/s, ms a batch (beside phase 15c's fed ms a
    batch), the seconds of an eval and of a checkpoint
    write (timed by `utils.profiling.Phase`), and the figures skipped for a
    missing module."""
    import importlib.util
    import os
    import shutil
    import tempfile
    from dataclasses import replace

    import numpy as np

    from stratanet2_tpu_torch.data.dataset import get_index_sorted_plot_ids
    from stratanet2_tpu_torch.learning.crossval import kfold_split
    from stratanet2_tpu_torch.learning.evaluate import LOSS_KEYS, evaluate
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture_from_dataset
    from stratanet2_tpu_torch.learning.train import (
        TRAIN_LOSS_KEYS,
        make_eval_step,
        save_train_state,
        train_full,
        use_device_resident,
    )
    from stratanet2_tpu_torch.utils import checkpoint as ckpt
    from stratanet2_tpu_torch.utils.convert import from_jax_params
    from stratanet2_tpu_torch.utils.experiment import MetricSink, setup_experiment_folder
    from stratanet2_tpu_torch.utils.profiling import Phase

    rng = np.random.default_rng(SEED + 15)
    items = list(prepared.values())
    ds = {}
    for i in range(TRAIN_FULL_PLOTS):
        pid = f"Plot_tf_{i:03d}"
        low, med, high = rng.uniform(0, 1, 3)
        ds[pid] = dict(items[i % len(items)], plot_id=pid, index=i,
                       coverages=np.array([low, 1 - low, med, high]))
    ids = get_index_sorted_plot_ids(ds)
    train_idx, val_idx = kfold_split(len(ids), cfg.train.folds)[0]
    train_ids, val_ids = ids[train_idx], ids[val_idx]
    dev_cfg = cfg.as_dev()
    run_cfg = replace(dev_cfg, train=replace(dev_cfg.train, use_early_stopping=True,
                                             patience_in_epochs=3))
    b = run_cfg.train.batch_size
    batches = len(train_ids) // b
    kde = fit_kde_mixture_from_dataset(ds, seed=SEED)
    check(use_device_resident(ds, train_ids, val_ids, run_cfg),
          "train_full: the default (auto) does not take the device-resident path at PROD")
    draws = importlib.util.find_spec("matplotlib") is not None
    warned = _Warnings()
    logging.getLogger("stratanet2_tpu_torch").addHandler(warned)

    def counted(what, fn, train_batches, evals):
        ck.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        want = {name: train_batches * TRAIN_LAUNCHES[name] + evals * EVAL_LAUNCHES[name]
                for name in TRAIN_LAUNCHES}
        want["pixel_max"] += len(val_ids) if draws else 0  # the last eval's figures
        check_launches(ck.launch_counts(), want, f"train_full_{what}")
        return out

    def run(folder, n_epoch, resume=False, device_resident="auto"):
        sink = MetricSink(folder)
        try:
            cfg_n = replace(run_cfg, train=replace(run_cfg.train, n_epoch=n_epoch),
                            data=replace(run_cfg.data, device_resident=device_resident))
            return train_full(ds, train_ids, val_ids, cfg_n, kde, folder, sink, fold_id=1,
                              seed=SEED, resume=resume, device=device)
        finally:
            sink.close()

    def run_keeping_epoch_2(folder, asides):
        """`run(folder, 3)`, its checkpoints after epoch 2 copied to each
        folder of `asides`."""
        save = ckpt.save_checkpoint

        def saving(path, *args, metadata=None, **kw):
            save(path, *args, metadata=metadata, **kw)
            if path.endswith(".resume") and metadata["epoch"] == 2:
                for aside in asides:
                    os.makedirs(aside)
                    for name in os.listdir(folder):
                        if ".pt" in name:
                            shutil.copy(os.path.join(folder, name), aside)

        ckpt.save_checkpoint = saving
        try:
            return run(folder, 3)
        finally:
            ckpt.save_checkpoint = save

    def drop_adam_state(folder):
        """The control's `.resume` file: Adam's count and moments zeroed
        (a fresh Adam), the schedule's count kept."""
        path = os.path.join(folder, ckpt.checkpoint_name(1) + ".resume")
        payload = ckpt.load_checkpoint(path)
        empty, (count, mu, nu), sched = payload["opt_state"]

        def zeros(tree):
            if isinstance(tree, dict):
                return {k: zeros(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(zeros(v) for v in tree)
            return np.zeros_like(tree)

        payload["opt_state"] = (empty, (np.zeros_like(count), zeros(mu), zeros(nu)), sched)
        ckpt.save_checkpoint(path, **payload)

    def loss_diff(got, want, keys):
        return max(abs(g[k] - w[k]) for g, w in zip(got, want) for k in keys)

    def pred_diff(got, want):
        check([g["pl_id"] for g in got] == [w["pl_id"] for w in want], "plot rows differ")
        return max(abs(g[k] - w[k]) for g, w in zip(got, want) for k in w
                   if k.startswith("pred_"))

    def compare(got, want):
        """Epoch 3 and the final eval of two 3-epoch runs (results of `run`)."""
        (ts_g, tr_g, te_g, rows_g), (ts_w, tr_w, te_w, rows_w) = got, want
        params_w = dict(ts_w.model.named_parameters())
        dp = torch.cat([(p - params_w[k]).detach().abs().flatten().double()
                        for k, p in ts_g.model.named_parameters()])
        buffers_w = dict(ts_w.model.named_buffers())
        bn = max(float(((v - buffers_w[k]).abs() / buffers_w[k].abs().clamp_min(1)).max())
                 for k, v in ts_g.model.named_buffers())
        return {"loss": max(loss_diff(tr_g[-1:], tr_w[-1:], TRAIN_LOSS_KEYS),
                            loss_diff(te_g[-2:], te_w[-2:], LOSS_KEYS),
                            pred_diff(rows_g, rows_w)),
                "param_max": float(dp.max()), "param_median": float(dp.median()),
                "bn_rel": bn}

    with tempfile.TemporaryDirectory() as tmp:
        root = setup_experiment_folder(tmp, "learning", "DEV")
        run1, run2, run3, run4, run5, run6, run7 = (os.path.join(root, f"run_{i}")
                                                    for i in range(1, 8))
        os.makedirs(run1)
        out1 = counted("run_1", lambda: run(run1, 2), 2 * batches, 3)
        best = os.path.join(run1, ckpt.checkpoint_name(1))
        check(os.path.exists(best) and os.path.exists(best + ".resume"),
              f"train_full: checkpoints missing in {sorted(os.listdir(run1))}")
        shutil.copytree(run1, run2)
        shutil.copytree(run1, run6)
        out2 = counted("run_2_resumed", lambda: run(run2, 3, resume=True), batches, 2)
        os.makedirs(run3)
        out3 = counted("run_3_unbroken", lambda: run_keeping_epoch_2(run3, (run4, run5)),
                       3 * batches, 4)
        out4 = counted("run_4_resumed_own", lambda: run(run4, 3, resume=True), batches, 2)
        drop_adam_state(run5)
        drop_adam_state(run6)
        out5 = counted("run_5_control_own", lambda: run(run5, 3, resume=True), batches, 2)
        out6 = counted("run_6_control_from_run_1", lambda: run(run6, 3, resume=True),
                       batches, 2)
        os.makedirs(run7)
        out7 = counted("run_7_host_path", lambda: run(run7, 2, device_resident="false"),
                       2 * batches, 3)

        payload = ckpt.load_checkpoint(best)
        fresh = from_jax_params(payload["params"], payload["model_state"], run_cfg.model,
                                device=device)
        eval_step = make_eval_step(run_cfg, kde, device=device)
        sink = MetricSink(run1)
        prof = Phase("train_full")
        try:
            with prof.phase("eval"):
                te_re, rows_re = counted("reload", lambda: evaluate(
                    fresh, ds, val_ids, run_cfg, kde, eval_step, run1, sink, fold_id=1,
                    epoch=2, last_epoch=True, device=device), 0, 1)
        finally:
            sink.close()
        with prof.phase("checkpoint_write"):
            save_train_state(os.path.join(tmp, "write.pt"), out1[0], {"epoch": 2})
        eval_s, write_s = prof.totals["eval"], prof.totals["checkpoint_write"]
    logging.getLogger("stratanet2_tpu_torch").removeHandler(warned)

    runs = {"run_1": out1, "run_2_resumed": out2, "run_3_unbroken": out3,
            "run_4_resumed_own": out4, "run_5_control_own": out5,
            "run_6_control_from_run_1": out6, "run_7_host_path": out7}
    resume = {"from_run_1": compare(out2, out3), "own": compare(out4, out3),
              "control_from_run_1": compare(out6, out3), "control_own": compare(out5, out3),
              "recomputed_epochs_1_2_loss": max(
                  loss_diff(out1[1], out3[1][:2], TRAIN_LOSS_KEYS),
                  loss_diff(out1[2][:2], out3[2][:2], LOSS_KEYS))}
    reload = {"loss": loss_diff([te_re], out1[2][-1:], LOSS_KEYS),
              "pred": pred_diff(rows_re, out1[3])}
    train_rows = [d for name, out in runs.items() for d in out[1] if name != "run_7_host_path"]
    host_rows = out7[1]
    epoch_s = [d["epoch_seconds"] for d in train_rows]
    print(json.dumps({"phase": "train_full", "plots": len(ds), "train_plots": len(train_ids),
                      "val_plots": len(val_ids), "B": b, "N": run_cfg.model.subsample_size,
                      "epochs": {k: [d["epoch"] for d in out[1]] for k, out in runs.items()},
                      "train_losses": {k: out[1] for k, out in runs.items()},
                      "eval_losses": {k: out[2] for k, out in runs.items()},
                      "resume_max_abs_diff": resume, "reload_max_abs_diff": reload,
                      "card": card}), flush=True)
    print(json.dumps({"phase": "train_full_epoch", "path": "device_resident",
                      "epoch_seconds": epoch_s,
                      "points_per_sec": [d["points_per_sec"] for d in train_rows],
                      "ms_a_batch": [t * 1e3 / batches for t in epoch_s],
                      "loader_steps_fed_ms_a_batch": fed_ms, "card": card}), flush=True)
    host_s = [d["epoch_seconds"] for d in host_rows]
    print(json.dumps({"phase": "train_full_epoch", "path": "host_loader", "epoch_seconds": host_s,
                      "points_per_sec": [d["points_per_sec"] for d in host_rows],
                      "ms_a_batch": [t * 1e3 / batches for t in host_s], "card": card}),
          flush=True)
    print(json.dumps({"phase": "train_full_eval", "eval_seconds": eval_s, "val_plots": len(val_ids),
                      "card": card}), flush=True)
    print(json.dumps({"phase": "train_full_checkpoint", "write_seconds": write_s,
                      "card": card}), flush=True)
    print(json.dumps({"phase": "train_full_figures_skipped", "matplotlib": draws,
                      "warnings": sorted(set(warned.messages))}), flush=True)

    want_epochs = {"run_1": [1, 2], "run_2_resumed": [3], "run_3_unbroken": [1, 2, 3],
                   "run_4_resumed_own": [3], "run_5_control_own": [3],
                   "run_6_control_from_run_1": [3], "run_7_host_path": [1, 2]}
    for name, out in runs.items():
        ts, tr, te, _ = out
        check([d["epoch"] for d in tr] == want_epochs[name], f"train_full {name}: epochs")
        check(ts.step == batches * want_epochs[name][-1], f"train_full {name}: step {ts.step}")
        for d in tr:
            check(set(d) == JAX_TRAIN_KEYS, f"train_full {name}: train keys {sorted(d)}")
            for k in TRAIN_LOSS_KEYS:
                check(bool(np.isfinite(d[k])), f"train_full {name}: train {k} = {d[k]}")
        for d in te:
            check(set(d) == JAX_EVAL_KEYS, f"train_full {name}: eval keys {sorted(d)}")
            for k in LOSS_KEYS:
                check(bool(np.isfinite(d[k])), f"train_full {name}: eval {k} = {d[k]}")
    check(set(te_re) == set(LOSS_KEYS), f"train_full: reloaded eval keys {sorted(te_re)}")
    for what, bounds in (("from_run_1", RESUME_BOUND), ("own", RESUME_BOUND)):
        check(all(resume[what][k] <= bound for k, bound in bounds.items()),
              f"train_full: resumed run ({what}) off the unbroken one {resume[what]}")
        control = resume[f"control_{what}"]
        check(any(control[k] > bound for k, bound in bounds.items()),
              f"train_full: a resume without Adam's state ({what}) within the bounds "
              f"{bounds}: {control}")
    check(reload["loss"] == 0 and reload["pred"] == 0,
          f"train_full: reloaded eval off run 1's final eval {reload}")
    epoch_paths(torch, run_cfg, ds, train_ids, val_ids, kde, device, card)


# host calls that wait for the card (or copy from it), and kernel launches,
# as torch.profiler names them
SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
               "cudaMemcpy", "cudaMemcpyAsync", "aten::item", "aten::_local_scalar_dense",
               "aten::nonzero")
EPOCH_REPS = 3  # timed epochs of each path


def epoch_paths(torch, cfg, ds, train_ids, val_ids, kde, device, card):
    """Phase 15d's epochs measured alone, the device-resident path against
    the host loader's, from one model: EPOCH_REPS epochs of each timed on
    the host clock (each ends with its loss parts read), then one of each
    under torch.profiler for the device's busy time (`device_busy_ms`), the
    busy share of the median epoch, and, for the device-resident epoch's
    loop (`make_device_epoch`'s function, without the read that ends it),
    the count of each host call that may wait for the card (SYNC_EVENTS,
    less those of a profile of nothing, which ends with the same
    synchronize) and of the card's copies by direction. Prints the
    card-resident MB of the train and val tables."""
    import numpy as np

    from stratanet2_tpu_torch.data import device_dataset as D
    from stratanet2_tpu_torch.data.loader import PlotLoader
    from stratanet2_tpu_torch.learning import train as T

    b = cfg.train.batch_size
    nb = len(train_ids) // b
    step = T.make_train_step(cfg, kde, device=device)
    ts = T.init_train_state(cfg, nb, seed=SEED, device=device)
    dd = D.build_device_dataset(ds, list(train_ids), cfg.model, device)
    dd_val = D.build_device_dataset(ds, list(val_ids), cfg.model, device)
    table_mb = sum(t.numel() * t.element_size() for table in (dd, dd_val)
                   for t in (table.feats, table.xyz, table.n, table.coverages)) / 1e6
    epoch_fn = D.make_device_epoch(cfg, step)
    paths = {
        "device_resident": lambda e: T.train_one_epoch_device_resident(
            epoch_fn, ts, dd, cfg, SEED, e),
        "host_loader": lambda e: T.train_one_epoch(
            step, ts, PlotLoader(ds, cfg, plot_ids=train_ids, train=True, seed=SEED),
            T.epoch_generator(SEED, e, device)),
    }
    out = {}
    for name, epoch in paths.items():
        seconds = []
        for e in range(1, EPOCH_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch(e)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        _, busy = device_busy_ms(torch, lambda: epoch(EPOCH_REPS + 1))
        median_ms = sorted(seconds)[len(seconds) // 2] * 1e3
        out[name] = {"epoch_seconds": seconds, "ms_a_batch": median_ms / nb,
                     "device_busy_ms": busy, "busy_share": busy / median_ms}
        check(busy > 0, f"epoch_paths: no device time in the profiled {name} epoch")
    idx = torch.from_numpy(D.epoch_index_table(len(train_ids), b, SEED, 9)).to(device)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def listing(fn):
        """{event name: count} of fn() and the synchronize that ends it."""
        with torch.profiler.profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key: e.count for e in prof.key_averages()}

    base = listing(lambda: None)  # what the profile itself adds
    counts = listing(lambda: epoch_fn(ts.model, ts.optimizer, ts.scheduler, dd, idx,
                                      T.epoch_generator(SEED, 9, device)))
    syncs = {k: counts.get(k, 0) - base.get(k, 0) for k in SYNC_EVENTS}
    # the copies the card ran, by direction (kineto's "Memcpy HtoD (...)" names)
    syncs.update({k: v for k, v in counts.items() if k.startswith("Memcpy")})
    launches = sum(v for k, v in counts.items() if k in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                                        "cuLaunchKernel", "cuLaunchKernelEx"))
    print(json.dumps({"phase": "train_full_paths", "plots": len(train_ids), "B": b, "batches": nb,
                      "N": cfg.model.subsample_size, "rows_a_plot": int(dd.feats.shape[1]),
                      "card_resident_mb": table_mb, **out, "card": card}), flush=True)
    print(json.dumps({"phase": "device_epoch_host_syncs", "batches": nb, **syncs,
                      "kernel_launches": launches,
                      "graph_launches": counts.get("cudaGraphLaunch", 0),
                      "note": "less an empty profile's events; aten::item on the host's "
                              "tensors waits for nothing"}), flush=True)
    check(np.isfinite(out["device_resident"]["busy_share"]), "epoch_paths: busy share")


def device_busy_ms(torch, fn):
    """fn() once traced (`device_events`): its result and the device time
    (ms) of every device operation it ran (kernels, copies, memsets)."""
    out = []
    events = device_events(lambda: out.append(fn()))
    return out[0], sum(ev["dur"] for ev in events) / 1e3


def parcel_phase(torch, ck, cfg, device, card):
    """Phase 15e: parcel predict, what the system is for, at PROD width.
    Prepare: a synthetic parcel's LAS (PARCEL_SIZE, PARCEL_DENSITY) written,
    then read, tiled and its plots extracted (`inference/tiling.py`), timed.
    Predict: `predict_parcel` with the random serve model, the inference
    task with the default chain (8, its last chain shorter) and with chain
    1, and the pseudo_labelling task with both: the merged tifs and the
    pseudo-label sets of the two chains must be equal bit for bit; launch
    counters zeroed before and checked after each run (batches x the serve
    step's launches); the tif has the 6 bands, values in [0, 1], NaN outside the
    parcel; then `update_shapefile_with_predictions` (PRED_* in [0, 1]).
    Prints plots/s end to end and its split into prepare, predict (loader
    and steps: `predict_parcel` less its merge) and merge + shapefile, for
    the process's first parcel ("cold": the first merge imports scipy) and
    for the median of the later chain-8 inference runs of the port
    ("warm": one program for every run, as the predict CLI makes one for
    its parcels, its first run untimed); the device busy share of the
    predict loop (busy time from a profiled chain-8 run over the warm loop
    time); and the warm runs with the batches uploaded as the port does
    (pageable memory), run by the serve step's eager body instead of its
    graph, and from pinned memory without blocking, in the turns of
    PARCEL_UPLOADS, each variant's program made once. Card against
    CPU: PARCEL_CPU_PLOTS plots as one batch (chain 1), merged tif and
    PRED_* fields within CPU_ATOL, NaN in the same places."""
    import os
    import pickle
    import tempfile
    from dataclasses import replace

    import numpy as np

    from stratanet2_tpu_torch.data import las, transforms
    from stratanet2_tpu_torch.data.dataset import get_index_sorted_plot_ids
    from stratanet2_tpu_torch.inference import (
        geotiff,
        polygons,
        predict,
        rasters,
        shapefile_io,
        tiling,
    )
    from stratanet2_tpu_torch.utils.synthetic import (
        cloud_to_las_fields,
        make_parcel_cloud,
        random_model,
    )

    rng = np.random.default_rng(SEED + 16)
    x0, y0 = PARCEL_ORIGIN
    size, buf = PARCEL_SIZE, tiling.LAS_PARCEL_BUFFER
    ring = np.array([[x0, y0], [x0 + size, y0], [x0 + size, y0 + size], [x0, y0 + size]])
    shape = polygons.Polygon([ring])
    model = random_model(cfg.model, SEED, device)
    b = cfg.train.batch_size
    parcel_id = "PARCEL_000"

    def bits(a):
        return np.ascontiguousarray(a).view(np.uint32)

    def write_input_shapefile(path):
        shapefile_io.write_shapefile(path, shapefile_io.Shapefile(
            fields=[shapefile_io.FieldSpec("ID", "C", 16)],
            shape_records=[shapefile_io.ShapeRecord(shape, {"ID": parcel_id})]))

    with tempfile.TemporaryDirectory() as tmp:
        las_path = os.path.join(tmp, f"{parcel_id}.las")
        t0 = time.perf_counter()
        cloud = make_parcel_cloud(rng, (x0 - buf, y0 - buf), size + 2 * buf, PARCEL_DENSITY)
        las.write_las(las_path, cloud_to_las_fields(cloud))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        centers, parcel_cloud = tiling.divide_parcel_las_and_get_disk_centers(cfg, las_path, shape)
        plots = tiling.extract_plots_from_parcel(cfg, parcel_cloud, centers)
        prepare_s = time.perf_counter() - t0
        check(len(plots) > 0, "parcel: no plot extracted")
        points = [p["N_points_in_cloud"] for p in plots.values()]
        print(json.dumps({"phase": "parcel_prepare", "las_points": int(cloud.shape[1]),
                          "las_write_seconds": write_s, "prepare_seconds": prepare_s,
                          "centers": len(centers), "plots": len(plots),
                          "points_a_plot": [min(points), float(np.median(points)), max(points)],
                          "min_z_path": transforms.min_z_path(), "card": card}), flush=True)

        shp_in = os.path.join(tmp, "input", "parcels.shp")
        write_input_shapefile(shp_in)
        runs = {}

        def run(name, chain, task, data=plots, run_cfg=cfg, on=device, net=model, program=None):
            """One predict_parcel (by `program`, default a new one): (output
            path, seconds, merge seconds), launches checked."""
            out_dir = os.path.join(tmp, name)
            c = replace(run_cfg, data=replace(run_cfg.data, predict_chain=chain))
            data = {k: dict(v) for k, v in data.items()}
            n = len(predict.filter_dataset(data, task == "pseudo_labelling",
                                           c.data.min_points_for_pseudo_labelling))
            batches = -(-n // c.train.batch_size)
            merge_s = []
            real_merge = predict.merge_geotiff_rasters

            def timed_merge(*args, **kw):
                t = time.perf_counter()
                try:
                    return real_merge(*args, **kw)
                finally:
                    merge_s.append(time.perf_counter() - t)

            predict.merge_geotiff_rasters = timed_merge
            ck.reset_launches()
            try:
                if on.type == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()
                path = predict.predict_parcel(net, data, c, parcel_id, out_dir, task=task,
                                              parcel_shape=shape, device=on, program=program)
                if on.type == "cuda":
                    torch.cuda.synchronize()
                seconds = time.perf_counter() - t
            finally:
                predict.merge_geotiff_rasters = real_merge
            want = {k: (batches * v if on.type == "cuda" else 0)
                    for k, v in SERVE_LAUNCHES.items()}
            check_launches(ck.launch_counts(), want, f"parcel_{name}")
            check(path is not None and os.path.exists(path), f"parcel {name}: no output")
            runs[name] = {"chain": chain, "task": task, "plots": n, "batches": batches,
                          "seconds": seconds, "merge_seconds": sum(merge_s)}
            return path, seconds, sum(merge_s)

        tif8, s8, merge8 = run("inference_chain_8", 8, "inference")
        tif1 = run("inference_chain_1", 1, "inference")[0]
        pkl8 = run("pseudo_chain_8", 8, "pseudo_labelling")[0]
        pkl1 = run("pseudo_chain_1", 1, "pseudo_labelling")[0]
        t = time.perf_counter()
        out_shp = predict.update_shapefile_with_predictions(shp_in, os.path.dirname(tif8))
        shapefile_s = time.perf_counter() - t

        got8, got1 = geotiff.read_geotiff(tif8), geotiff.read_geotiff(tif1)
        check(got8.band_names == rasters.FINAL_RASTER_BANDNAMES, "parcel: tif bands")
        check(np.array_equal(bits(got8.bands), bits(got1.bands)),
              "parcel: the merged tifs of chain 8 and chain 1 differ")
        filled = got8.bands[:5][~np.isnan(got8.bands[:5])]
        check(filled.size > 0 and bool(((filled >= 0) & (filled <= 1)).all()),
              "parcel: band values outside [0, 1]")
        g = got8.geotransform
        h, w = got8.bands.shape[1:]
        outside = ~shape.contains_grid(g[0] + (np.arange(w) + 0.5) * g[1],
                                       g[3] + (np.arange(h) + 0.5) * g[5])
        check(bool(outside.any()) and bool(np.isnan(got8.bands[:, outside]).all()),
              "parcel: pixels outside the parcel are not NaN")
        with open(pkl8, "rb") as f8, open(pkl1, "rb") as f1:
            lab8, lab1 = pickle.load(f8), pickle.load(f1)
        check(list(lab8) == list(lab1) and len(lab8) == runs["pseudo_chain_8"]["plots"],
              "parcel: pseudo-labelled plots differ")
        check(all(np.array_equal(bits(lab8[k]["coverages"]), bits(lab1[k]["coverages"]))
                  for k in lab8), "parcel: pseudo-labels of chain 8 and chain 1 differ")
        check(not [f for d in (os.path.dirname(pkl8), os.path.dirname(pkl1))
                   for f in os.listdir(d) if f.endswith(".tmp")], "parcel: a .tmp file left")
        record = shapefile_io.read_shapefile(out_shp).shape_records[0].record
        fields = {k: record[k] for k in ("PRED_BASSE", "PRED_INTER", "PRED_HAUTE", "PRED_ADM")}
        check(all(0 <= v <= 1 for v in fields.values()), f"parcel: PRED fields {fields}")

        # each warm variant's program, made once and run once untimed: the
        # port's, the serve step's eager body, and the port's given its
        # batches from pinned memory, copied without blocking the host
        def pinned_step(step):
            def pinned(net, *arrays):
                return step(net, *(torch.as_tensor(a).pin_memory().to(device, non_blocking=True)
                                   for a in arrays))

            return pinned

        variants = {
            "pageable": predict.make_predict_program(cfg, device),
            "eager": predict.make_predict_program(
                cfg, device, step=eager_serve(predict.make_predict_step(cfg, device))),
            "pinned": predict.make_predict_program(
                cfg, device, step=pinned_step(predict.make_predict_step(cfg, device))),
        }
        for kind, program in variants.items():
            run(f"first_{kind}", 8, "inference", program=program)
        # the device's busy time in a profiled chain-8 run, and the warm runs
        # of each variant, in turns
        (_, busy_ms) = device_busy_ms(torch, lambda: run("inference_profiled", 8, "inference",
                                                         program=variants["pageable"]))
        upload = {kind: [] for kind in variants}
        for i, kind in enumerate(PARCEL_UPLOADS):
            upload[kind].append(run(f"upload_{kind}_{i}", 8, "inference",
                                    program=variants[kind])[1:3])

        # card against CPU: PARCEL_CPU_PLOTS plots as one batch
        ids = get_index_sorted_plot_ids(plots)[:PARCEL_CPU_PLOTS]
        corner = {k: plots[k] for k in ids}
        one_batch = replace(cfg, train=replace(cfg.train, batch_size=len(corner)))
        cpu_model = copy.deepcopy(model).cpu()
        sides = {}
        for side, on, net in (("card", device, model), ("cpu", torch.device("cpu"), cpu_model)):
            path = run(f"corner_{side}", 1, "inference", corner, one_batch, on, net)[0]
            shp_side = os.path.join(os.path.dirname(path), "input", "parcels.shp")
            write_input_shapefile(shp_side)
            rec = shapefile_io.read_shapefile(predict.update_shapefile_with_predictions(
                shp_side, os.path.dirname(path))).shape_records[0].record
            sides[side] = (geotiff.read_geotiff(path).bands,
                           np.array([rec[k] for k in fields], np.float64))
        (card_tif, card_pred), (cpu_tif, cpu_pred) = sides["card"], sides["cpu"]
        check(card_tif.shape == cpu_tif.shape and np.array_equal(np.isnan(card_tif),
                                                                   np.isnan(cpu_tif)),
              "parcel corner: card and CPU tifs differ in shape or NaN pattern")
        tif_err = float(np.nan_to_num(np.abs(card_tif - cpu_tif)).max())
        pred_err = float(np.abs(card_pred - cpu_pred).max())

    n = len(plots)

    def warm(kind):
        return {"prepare": prepare_s,
                "predict": float(np.median([t - m for t, m in upload[kind]])),
                "merge_and_shapefile": float(np.median([m for _, m in upload[kind]])) + shapefile_s}

    split = {"cold": {"prepare": prepare_s, "predict": s8 - merge8,
                      "merge_and_shapefile": merge8 + shapefile_s},
             "warm": warm("pageable"), "warm_eager_body": warm("eager")}
    warm_loop = split["warm"]["predict"]
    print(json.dumps({"phase": "parcel", "plots": n, "B": b, "N": cfg.model.subsample_size,
                      "runs": runs, "split_seconds": split,
                      "plots_per_s": {k: n / sum(v.values()) for k, v in split.items()},
                      "predict_plots_per_s": {k: n / v["predict"] for k, v in split.items()},
                      "device_busy_ms": busy_ms, "device_busy_share": busy_ms / 1e3 / warm_loop,
                      "upload_seconds": {k: [t for t, _ in v] for k, v in upload.items()},
                      "pred_fields": fields, "min_z_path": transforms.min_z_path(),
                      "card": card}), flush=True)
    print(json.dumps({"phase": "parcel_cpu_reference", "plots": len(corner),
                      "tif_max_abs_diff": tif_err, "pred_fields_max_abs_diff": pred_err,
                      "atol": CPU_ATOL}), flush=True)
    check(max(tif_err, pred_err) <= CPU_ATOL,
          f"parcel corner: card and CPU differ by {max(tif_err, pred_err)}")


def check_path_launches(name, launches, path):
    """Every kernel of `path` launched in a run's `launches` (by wrapper),
    and none off it."""
    for kernel, count in launches.items():
        if kernel in path:
            check(count > 0, f"{name}: {kernel} never launched")
        else:
            check(count == 0, f"{name}: {kernel} launched off its path")


def cli_launches(stats_dir):
    """The kernel launches a CLI logged at its end (`cli.log_kernel_launches`)
    in its run folder's stats.txt."""
    import os

    with open(os.path.join(stats_dir, "stats.txt")) as f:
        lines = [line for line in f if "Kernel launches: " in line]
    check(len(lines) == 1, f"cli: {len(lines)} kernel-launch lines in {stats_dir}/stats.txt")
    return json.loads(lines[0].split("Kernel launches: ", 1)[1])


def write_cli_tree(tmp, flags=("--subsample_size", "10000")):
    """The CLIs' data tree under `tmp`, written with the port's writers:
    CLI_PLOTS plot LAS of CLI_POINTS points and their GT csv, and a parcel
    (CLI_PARCEL_SIZE m, its LAS with the tiling buffer at PARCEL_DENSITY)
    with its shapefile. Returns the DEV command line over it (`args`, with
    `flags`) and its parts."""
    import os

    import numpy as np

    from stratanet2_tpu_torch.data import las
    from stratanet2_tpu_torch.inference import polygons, shapefile_io, tiling
    from stratanet2_tpu_torch.utils.synthetic import (
        cloud_to_las_fields,
        make_parcel_cloud,
        make_plot_cloud,
    )

    rng = np.random.default_rng(SEED + 17)
    classes = (0, 10, 25, 33, 50, 75, 90, 100)
    las_dir = os.path.join(tmp, "placettes_dataset", "las_classes")
    parcels = os.path.join(tmp, "parcelles_dataset_20m")
    os.makedirs(las_dir)
    os.makedirs(os.path.join(parcels, "input"))
    gt_csv = os.path.join(tmp, "placettes_dataset", "placettes_metadata.csv")
    t0 = time.perf_counter()
    lines = ["nom,COUV_BASSE,COUV_INTER,COUV_HAUTE"]
    for i in range(CLI_PLOTS):
        name = f"Plot_{i:02d}"
        c = make_plot_cloud(rng, n=CLI_POINTS, center=(1000 + 40 * i, 2000))
        las.write_las(os.path.join(las_dir, f"{name}.las"), cloud_to_las_fields(c))
        lines.append(",".join([name] + [str(int(v)) for v in rng.choice(classes, 3)]))
    with open(gt_csv, "w") as f:
        f.write("\n".join(lines) + "\n")
    x0, y0 = PARCEL_ORIGIN
    size, buf = CLI_PARCEL_SIZE, tiling.LAS_PARCEL_BUFFER
    parcel_id = "PARCEL_CLI"
    cloud = make_parcel_cloud(rng, (x0 - buf, y0 - buf), size + 2 * buf, PARCEL_DENSITY)
    las.write_las(os.path.join(parcels, "input", f"{parcel_id}.las"),
                  cloud_to_las_fields(cloud))
    ring = np.array([[x0, y0], [x0 + size, y0], [x0 + size, y0 + size], [x0, y0 + size]])
    shp_in = os.path.join(parcels, "input", "parcels.shp")
    shapefile_io.write_shapefile(shp_in, shapefile_io.Shapefile(
        fields=[shapefile_io.FieldSpec("ID", "C", 16)],
        shape_records=[shapefile_io.ShapeRecord(polygons.Polygon([ring]),
                                                {"ID": parcel_id})]))
    experiments = os.path.join(tmp, "experiments")
    args = ["--mode", "DEV", *flags, "--data_path", tmp, "--las_plots_folder_path", las_dir,
            "--gt_file_path", gt_csv, "--corrected_gt_file_path", gt_csv,
            "--plots_pickled_dataset_path",
            os.path.join(tmp, "placettes_dataset", "prepared", "plots.pkl"),
            "--las_parcels_folder_path", parcels, "--parcel_shapefile_path", shp_in,
            "--experiments_path", experiments]
    return dict(args=args, parcels=parcels, parcel_id=parcel_id, cloud=cloud,
                write_s=time.perf_counter() - t0, experiments=experiments)


def cli_phase(torch, ck, card, flags=("--subsample_size", "10000"), device="cuda"):
    """Phase 15f: the four CLIs (`stratanet2_tpu_torch/cli/`) in DEV mode at
    PROD width (`--subsample_size 10000`) on a data tree written with the
    port's writers: CLI_PLOTS plot LAS of CLI_POINTS points and their GT
    csv, and a parcel (CLI_PARCEL_SIZE m, its LAS with the tiling buffer at
    PARCEL_DENSITY) with its shapefile. In order: main -> prepare -> predict
    inference -> predict pseudo_labelling -> main_ssl -> main --PT_model_id,
    each in this process with `--device cuda` (launch counters zeroed just
    before and read just after) except predict inference, which runs as
    `python -m stratanet2_tpu_torch.cli.predict` in a subprocess without
    `--device` (the default is the card; its counts are the line the CLI
    logs in its stats.txt, which the in-process runs must log equal to the
    counters). Each run's artifacts are checked, and its counts: every
    kernel of its path launched (training: all eleven, the eval's
    sa_fused_eval among them; predict: the four serve kernels), none off
    it (prepare: none). Prints each CLI's seconds, its launches and the
    warnings its stats.txt holds (the figures it skipped). `flags` and
    `device` let a test run the phase small on the CPU (then the subprocess
    is given the device too). Returns the first training run's
    cross-validation result CSVs, {file name: text}."""
    import os
    import pickle
    import tempfile

    import numpy as np

    from stratanet2_tpu_torch.cli import main as cli_main
    from stratanet2_tpu_torch.cli import main_ssl as cli_ssl
    from stratanet2_tpu_torch.cli import predict as cli_predict
    from stratanet2_tpu_torch.cli import prepare as cli_prepare
    from stratanet2_tpu_torch.inference import geotiff, shapefile_io

    serve = {"fps", "sa_fused_eval", "knn_interpolate", "pixel_max"}
    logger = logging.getLogger("stratanet2_tpu_torch")
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_cli_tree(tmp, flags)
        args, parcels, parcel_id = tree["args"], tree["parcels"], tree["parcel_id"]
        cloud, write_s, experiments = tree["cloud"], tree["write_s"], tree["experiments"]
        on_card = args + ["--device", device]

        def newest(task):
            folder = os.path.join(experiments, task, "DEV")
            return os.path.join(folder, sorted(os.listdir(folder))[-1])

        def warnings_of(stats_dir):
            with open(os.path.join(stats_dir, "stats.txt")) as f:
                return [line.split(":WARNING: ", 1)[1].strip() for line in f
                        if ":WARNING: " in line]

        def cli(name, fn, task, path):
            """fn() in this process, counted; returns (its result, its run folder)."""
            ck.reset_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = ck.launch_counts()
            for handler in list(logger.handlers):  # the CLI's stdout and stats.txt
                logger.removeHandler(handler)
                handler.close()
            stats_dir = out if isinstance(out, str) else newest(task)
            if path:
                check(cli_launches(stats_dir) == launches,
                      f"cli {name}: logged launches differ from the counters {launches}")
            report(name, seconds, launches, stats_dir, path)
            return out, stats_dir

        def report(name, seconds, launches, stats_dir, path):
            print(json.dumps({"phase": "cli", "cli": name, "seconds": seconds,
                              "launches": launches, "warnings": warnings_of(stats_dir),
                              "card": card}), flush=True)
            check_path_launches(f"cli {name}", launches, path)

        def check_training(name, stats_dir, fold_ckpt, summaries=("relabeled_summary", "summary")):
            csvs = tuple(f"PCC_inference_all_placettes_{s}.csv" for s in summaries)
            for f in (fold_ckpt, "metrics.jsonl") + csvs:
                check(os.path.exists(os.path.join(stats_dir, f)), f"cli {name}: no {f}")
            with open(os.path.join(stats_dir, "stats.txt")) as f:
                check("Device-resident dataset" in f.read(),
                      f"cli {name}: training did not take the device-resident path")

        trained, train_dir = cli("main", lambda: cli_main.main(on_card), "learning", FUSED_PATH)
        check_training("main", train_dir, "PCC_model_fold_n=1.pt")
        model_id = os.path.basename(trained)
        results = {}  # the cross-validation result CSVs, for phase 17e
        for name in sorted(os.listdir(train_dir)):
            if "placettes" in name and name.endswith(".csv"):
                with open(os.path.join(train_dir, name)) as f:
                    results[name] = f.read()

        cli("prepare", lambda: cli_prepare.main(on_card), "prepare", set())
        prepared = os.path.join(parcels, "prepared", f"{parcel_id}.pkl")
        with open(prepared, "rb") as f:
            n_plots = len(pickle.load(f))
        check(n_plots > 0, "cli prepare: no plot in the prepared parcel")

        # predict inference: a user's command line, without --device
        ck.reset_launches()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "stratanet2_tpu_torch.cli.predict", *args,
             "--task", "inference", "--inference_model_id", model_id,
             *(() if device == "cuda" else ("--device", device))],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"cli predict (subprocess): exit {proc.returncode}: {proc.stderr[-3000:]}")
        check(ck.launch_counts() == dict.fromkeys(ck.LAUNCHES, 0), "cli: counters moved here")
        stats_dir = newest("inference")
        report("predict_inference_subprocess", seconds, cli_launches(stats_dir), stats_dir,
               serve)
        out_dir = os.path.join(parcels, "inference", model_id)
        tif = geotiff.read_geotiff(os.path.join(out_dir, f"{parcel_id}.tif"))
        check(tif.bands.shape[0] == 6, f"cli predict: tif bands {tif.bands.shape}")
        filled = tif.bands[:5][np.isfinite(tif.bands[:5])]  # the 6th band: the weights
        check(filled.size > 0 and bool(((filled >= 0) & (filled <= 1)).all()),
              "cli predict: coverage bands outside [0, 1] or empty")
        record = shapefile_io.read_shapefile(
            os.path.join(out_dir, "parcels.shp")).shape_records[0].record
        preds = {k: float(v) for k, v in record.items() if k.startswith("PRED_")}
        check(len(preds) == 4 and all(0 <= v <= 1 for v in preds.values()),
              f"cli predict: PRED_* fields {preds}")

        cli("predict_pseudo_labelling", lambda: cli_predict.main(
            on_card + ["--task", "pseudo_labelling", "--inference_model_id", model_id]),
            "pseudo_labelling", serve)
        with open(os.path.join(parcels, "pseudo_labelling", model_id, f"{parcel_id}.pkl"),
                  "rb") as f:
            labelled = pickle.load(f)
        check(len(labelled) >= CLI_PLOTS, f"cli predict: {len(labelled)} plots pseudo-labelled")
        for item in labelled.values():
            cov = np.asarray(item["coverages"])
            check(cov.shape == (4,) and bool(((cov >= 0) & (cov <= 1)).all()),
                  f"cli predict: pseudo-label {cov}")

        ssl_dir, _ = cli("main_ssl", lambda: cli_ssl.main(
            on_card + ["--inference_model_id", model_id]), "pretraining", FUSED_PATH)
        check_training("main_ssl", ssl_dir, "PCC_model_full.pt", ("pretraining_summary",))
        _, warm_dir = cli("main_warm_start", lambda: cli_main.main(
            on_card + ["--PT_model_id", os.path.basename(ssl_dir)]), "learning", FUSED_PATH)
        check_training("main_warm_start", warm_dir, "PCC_model_fold_n=1.pt")
        with open(os.path.join(warm_dir, "stats.txt")) as f:
            check("Warm-starting from pretrained model" in f.read(),
                  "cli main --PT_model_id: no warm start")
    print(json.dumps({"phase": "cli_data", "plots": CLI_PLOTS, "points": CLI_POINTS,
                      "parcel_las_points": int(cloud.shape[1]), "parcel_plots": n_plots,
                      "write_seconds": write_s, "card": card}), flush=True)
    return results


# phase 15g (parallel): two ranks over gloo on the one card (NCCL refuses
# two ranks on one card). The point-sharded paths at PROD (N=10000: k1=32
# groups of 313 points, which a 5000-point shard does not align with, so
# they are JAX's own sharded functions, held to the same step on the CPU)
# and at PAR_N_ALIGNED (N % k1 == 0, C1 = 2496: the sharded groups and the
# local FPS are the unsharded step's with fps_parts 2, held to it on the
# card); the data-parallel steps at PROD, 10 plots a rank, held to the
# single-process step on the 20 plots.
PAR_WORLD = 2
PAR_N_ALIGNED = 9984
PAR_STEPS = 10  # timed steps of each path; the median is reported
PAR_TIMEOUT = 600.0  # the ranks' whole phase and the group's timeout, seconds
PAR_PLOTS, PAR_POINTS = 50, 12000  # train_full: 40 train plots (2 batches), 10 val
PS_TRAIN_LAUNCHES = {**dict.fromkeys(TRAIN_LAUNCHES, 0), "fps": 2, "ball_query": 2,
                     "knn_interpolate": 2, "knn_scatter": 3, "pixel_max": 1,
                     "pixel_max_bwd": 1}
# each rank's CLI launches: the kernels that must launch on every rank, and
# those that must not launch on any (rank 0 alone evaluates: the eval's
# sa_fused_eval in training runs on rank 0)
_SERVE_PATH = {k for k, v in SERVE_LAUNCHES.items() if v}
PAR_CLI_PATHS = {
    "main_point_sharded": ({k for k, v in PS_TRAIN_LAUNCHES.items() if v}, set(SA_TRAIN)),
    "main_data_parallel": ({k for k, v in TRAIN_LAUNCHES.items() if v}, set()),
    "predict_point_sharded": (_SERVE_PATH, set(SERVE_LAUNCHES) - _SERVE_PATH),
    "predict_data_parallel": (_SERVE_PATH, set(SERVE_LAUNCHES) - _SERVE_PATH),
}


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _step_state(model):
    return [p for p in model.parameters()] + [b for b in model.buffers()]


# The stages JAX's point-sharded step computes replicated on the point ranks
# (point_sharded.py:617-641): their BatchNorm sums every row once a rank, which
# leaves the mean and the biased variance as they are but stores the unbiased
# running variance with n_d / (n_d - 1), n_d = D n, for n / (n - 1) (nn.py:96-106;
# the port does as JAX does, tests/test_torch_port_parallel_train.py). The
# reference's running variances of these stages are re-derived with that count.
REPLICATED_STAGES = ("sa2.", "sa3.", "fp3.", "fp2.")


def counted_bn_rows(run):
    """run() with every train-mode BatchNorm's row count recorded:
    (its result, {module: n})."""
    from stratanet2_tpu_torch.models.nn import BatchNorm

    counts = {}
    real = BatchNorm.update_running_stats

    def recording(self, mean, var, n):
        counts[self] = float(n)
        return real(self, mean, var, n)

    BatchNorm.update_running_stats = recording
    try:
        return run(), counts
    finally:
        BatchNorm.update_running_stats = real


def replicated_count_state(model, counts, var0, world):
    """`model`'s BN buffers, the running variances of REPLICATED_STAGES as
    they would be with each of their rows counted `world` times (var0 the
    running variance before the step, momentum 0.1)."""
    state = {k: b.detach().cpu().clone() for k, b in model.named_buffers()}
    for name, mod in model.named_modules():
        if mod in counts and name.startswith(REPLICATED_STAGES):
            n = counts[mod]
            biased = (state[name + ".var"] - 0.9 * var0) / 0.1 * (n - 1) / n
            state[name + ".var"] = 0.9 * var0 + 0.1 * biased * (world * n) / (world * n - 1)
    return state


def step_diffs(torch, cfg, got, want):
    """Loss parts, BN state, gradients and params after one Adam step of
    two train steps from one state (`compare_train_with_cpu`'s measures)."""
    lr, wd = cfg.train.lr, cfg.train.wd
    out = dict(loss=max(abs(float(got["comps"][k]) - float(want["comps"][k]))
                        for k in want["comps"]),
               state=max(float((got["state"][k] - v).abs().max())
                         for k, v in want["state"].items()),
               grad_rel=0.0, param_sure=0.0, param_all=0.0)
    for k, g in want["grads"].items():
        scale = float(g.abs().max())
        check(scale > 0 and bool(torch.isfinite(got["grads"][k]).all()), f"gradient of {k}")
        out["grad_rel"] = max(out["grad_rel"], float((got["grads"][k] - g).abs().max()) / scale)
        sure = (g + wd * want["start"][k]).abs() > TRAIN_GRAD_RTOL * scale
        diff = (got["params"][k] - want["params"][k]).abs()
        slack = diff - 1.2e-7 * want["params"][k].abs()
        if bool(sure.any()):
            out["param_sure"] = max(out["param_sure"], float(slack[sure].max()))
        out["param_all"] = max(out["param_all"], float(diff.max()))
    return out


def check_step_diffs(what, d, lr):
    check(d["loss"] <= TRAIN_LOSS_ATOL, f"{what}: loss parts differ by {d['loss']}")
    check(d["grad_rel"] <= TRAIN_GRAD_RTOL, f"{what}: gradients differ by {d['grad_rel']}")
    check(d["state"] <= TRAIN_STATE_ATOL, f"{what}: BN state differs by {d['state']}")
    check(d["param_sure"] <= 1e-7, f"{what}: params differ by {d['param_sure']} where sure")
    check(d["param_all"] <= 2 * lr + 1e-7, f"{what}: params differ by {d['param_all']}")


def _snapshot(model, comps, start):
    return dict(comps={k: float(v) for k, v in comps.items()},
                grads={k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()},
                params={k: p.detach().cpu().clone() for k, p in model.named_parameters()},
                state={k: b.detach().cpu().clone() for k, b in model.named_buffers()},
                start=start)


def _par_timed(torch, device, fn):
    """Median and all host-clock ms of PAR_STEPS synchronised calls (both
    ranks step together: each call holds collectives)."""
    times = []
    for _ in range(PAR_STEPS):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2], times


def _plots(n_plots, n_points, seed):
    """A {plot_id: plot} dataset of synthetic plots in the pickled layout."""
    import numpy as np

    from stratanet2_tpu_torch.utils.synthetic import make_plot_cloud

    rng = np.random.default_rng(seed)
    ds = {}
    for i in range(n_plots):
        cloud = make_plot_cloud(rng, n=n_points, center=(1000.0 + 40 * i, 2000.0))
        gt = rng.uniform(0, 1, 4)
        gt[1] = 1.0 - gt[0]
        pid = f"PAR_{i:03d}"
        ds[pid] = {"cloud": cloud, "coverages": gt.astype(np.float32),
                   "plot_center": np.array([(cloud[0].max() + cloud[0].min()) / 2,
                                            (cloud[1].max() + cloud[1].min()) / 2], np.float32),
                   "plot_id": pid, "N_points_in_cloud": cloud.shape[1], "index": i}
    return ds


def parallel_rank(payload, device):
    """A rank of phase 15g (started by `parallel_phase` through
    `parallel/launch.run_ranks`): the point-sharded and data-parallel
    serve and train steps with their launches, references and times, and
    `train_full` on both paths. Returns what the parent prints and checks."""
    import copy
    import os
    from dataclasses import replace

    import numpy as np
    import torch

    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.inference.predict import (
        make_point_sharded_predict_step,
        make_predict_step,
    )
    from stratanet2_tpu_torch.learning.kde import (
        fit_kde_mixture,
        fit_kde_mixture_from_dataset,
    )
    from stratanet2_tpu_torch.learning.train import (
        make_optimizer,
        make_train_step,
        rank_generator,
        train_full,
    )
    from stratanet2_tpu_torch.ops import cuda_kernels as ck
    from stratanet2_tpu_torch.parallel import multihost
    from stratanet2_tpu_torch.parallel.mesh import (
        make_mesh,
        make_mesh_2d,
        shard_batch,
        shard_points,
    )
    from stratanet2_tpu_torch.parallel.point_sharded import make_point_sharded_train_step
    from stratanet2_tpu_torch.utils.experiment import MetricSink, NullSink
    from stratanet2_tpu_torch.utils.synthetic import random_model, serve_batch, train_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = default_config()
    b, n = payload.get("B", cfg.train.batch_size), payload.get("N", cfg.model.subsample_size)
    n_al = payload.get("N_aligned", PAR_N_ALIGNED)
    cfg = replace(cfg, model=replace(cfg.model, subsample_size=n),
                  train=replace(cfg.train, batch_size=b))
    c1 = int(n_al * cfg.model.ratio1)
    cfg_al = replace(cfg, model=replace(
        cfg.model, subsample_size=n_al,
        fps_min_part_samples=min(cfg.model.fps_min_part_samples, c1 // PAR_WORLD)))
    cpu = torch.device("cpu")
    out = {"rank": multihost.rank(), "device": str(device)}
    mesh_ps, mesh_dp = make_mesh_2d(1, PAR_WORLD), make_mesh()

    def counted(fn):
        ck.reset_launches()
        res = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return res, ck.launch_counts()

    # --- serve: point-sharded at PROD, at the aligned N, data-parallel ---
    cloud, xyz = serve_batch(b, n, torch.Generator().manual_seed(SEED + 40), cpu)
    cloud, xyz = cloud.to(device), xyz.to(device)
    model = random_model(cfg.model, SEED, device)
    ps_serve = make_point_sharded_predict_step(cfg, PAR_WORLD, device)
    ps_serve(model, cloud, xyz)  # warm
    (rasters, pred_pl), out["ps_serve_launches"] = counted(lambda: ps_serve(model, cloud, xyz))
    out["ps_serve_finite"] = bool(torch.isfinite(pred_pl).all()) and tuple(pred_pl.shape) == (b, 4)
    out["ps_serve_ms"] = _par_timed(torch, device, lambda: ps_serve(model, cloud, xyz))
    r_dev, p_dev = ps_serve(model, cloud[:2], xyz[:2])
    r_cpu, p_cpu = make_point_sharded_predict_step(cfg, PAR_WORLD, cpu)(
        copy.deepcopy(model).to(cpu), cloud[:2].to(cpu), xyz[:2].to(cpu))
    out["ps_serve_cpu_nan_equal"] = bool(torch.equal(torch.isnan(r_dev.cpu()),
                                                     torch.isnan(r_cpu)))
    out["ps_serve_cpu_diff"] = max(float(torch.nan_to_num(r_dev.cpu() - r_cpu).abs().max()),
                                   float((p_dev.cpu() - p_cpu).abs().max()))
    cl_al, xyz_al = cloud[:, :n_al].contiguous(), xyz[:, :n_al].contiguous()
    model_al = random_model(cfg_al.model, SEED, device)  # the same weights, C1 of N_aligned
    r_ps, p_ps = make_point_sharded_predict_step(cfg_al, PAR_WORLD, device)(
        model_al, cl_al, xyz_al)
    r_1, p_1 = make_predict_step(cfg_al, device)(model_al, cl_al, xyz_al)
    out["ps_serve_aligned_nan_equal"] = bool(torch.equal(torch.isnan(r_ps), torch.isnan(r_1)))
    out["ps_serve_aligned_diff"] = max(float(torch.nan_to_num(r_ps - r_1).abs().max()),
                                       float((p_ps - p_1).abs().max()))
    dp_serve = make_predict_step(cfg, device, mesh_dp)
    (r_dp, p_dp), out["dp_serve_launches"] = counted(lambda: dp_serve(model, cloud, xyz))
    r_one, p_one = make_predict_step(cfg, device)(model, cloud, xyz)
    out["dp_serve_diff"] = max(float(torch.nan_to_num(r_dp - r_one).abs().max()),
                               float((p_dp - p_one).abs().max()))
    out["dp_serve_ms"] = _par_timed(torch, device, lambda: dp_serve(model, cloud, xyz))
    del rasters, r_dev, r_ps, r_1, r_dp, r_one

    # --- train: point-sharded at the aligned N, data-parallel at PROD ---
    cloud, xyz, gt = train_batch(b, n, torch.Generator().manual_seed(SEED + 41), cpu)
    cloud, xyz, gt = cloud.to(device), xyz.to(device), gt.to(device)
    kde = fit_kde_mixture((cloud[..., 2] * cfg.model.z_max).cpu().numpy())
    # the point-sharded step's reference: the single-process step of the
    # unfused route (use_pallas=False), which the sharded step runs
    cfg_unf = replace(cfg_al, model=replace(cfg_al.model, use_pallas=False))
    bases = {id(c): random_model(c.model, SEED, device, running_stats=False)
             for c in (cfg, cfg_al, cfg_unf)}
    start = {k: p.detach().cpu().clone() for k, p in bases[id(cfg)].named_parameters()}

    def run(step, mcfg_cfg, args, gen=None):
        m = copy.deepcopy(bases[id(mcfg_cfg)])
        opt, sched = make_optimizer(mcfg_cfg, m, STEPS_PER_EPOCH)
        comps, launches = counted(lambda: step(m, opt, sched, *args, *(() if gen is None
                                                                      else (gen,))))
        return m, opt, sched, comps, launches

    cl_al, xyz_al = cloud[:, :n_al].contiguous(), xyz[:, :n_al].contiguous()
    ps_step = make_point_sharded_train_step(cfg_al, kde, mesh_ps, device)
    local = (shard_points(mesh_ps, cl_al), shard_points(mesh_ps, xyz_al), gt)
    m, opt, sched, comps, out["ps_train_launches"] = run(
        ps_step, cfg_al, local, rank_generator(SEED, 1, mesh_ps, device))
    ps = _snapshot(m, comps, start)
    m2, _, _, _, _ = run(ps_step, cfg_al, local, rank_generator(SEED, 1, mesh_ps, device))
    out["ps_train_reproducible"] = _digest(_step_state(m)) == _digest(_step_state(m2))
    out["ps_train_digest"] = _digest(_step_state(m))
    # the eager body: the counting reads each n, which a graph's capture
    # has not computed
    (ref_m, _, _, ref_comps, _), rows = counted_bn_rows(lambda: run(
        eager_train(make_train_step(cfg_unf, kde, device)), cfg_unf, (cl_al, xyz_al, gt)))
    ref = _snapshot(ref_m, ref_comps, start)
    ref["state"] = replicated_count_state(ref_m, rows, 1.0, PAR_WORLD)
    out["ps_train_vs_unfused"] = step_diffs(torch, cfg_al, ps, ref)
    out["ps_train_comps"] = ps["comps"]
    out["ps_train_ms"] = _par_timed(torch, device, lambda: ps_step(m, opt, sched, *local))
    del m, m2, ref_m, ps

    dp_step = make_train_step(cfg, kde, device, mesh_dp)
    rows = tuple(shard_batch(mesh_dp, t) for t in (cloud, xyz, gt))
    m, opt, sched, comps, out["dp_train_launches"] = run(dp_step, cfg, rows)
    dp = _snapshot(m, comps, start)
    out["dp_train_digest"] = _digest(_step_state(m))
    ref_m, _, _, ref_comps, _ = run(make_train_step(cfg, kde, device), cfg, (cloud, xyz, gt))
    out["dp_train_vs_single"] = step_diffs(torch, cfg, dp, _snapshot(ref_m, ref_comps, start))
    out["dp_train_comps"] = dp["comps"]
    out["dp_train_ms"] = _par_timed(torch, device, lambda: dp_step(m, opt, sched, *rows))
    del m, ref_m, dp

    # --- train_full: 2 epochs, data-parallel device-resident and point-sharded ---
    ds = _plots(payload.get("plots", PAR_PLOTS), payload.get("points", PAR_POINTS), SEED + 42)
    ids = sorted(ds)
    n_val = len(ids) // 5
    dev_cfg = cfg.as_dev()
    dev_cfg = replace(dev_cfg, data=replace(dev_cfg.data, device_resident="true"),
                      train=replace(dev_cfg.train, use_early_stopping=True, n_epoch=2))
    kde_ds = fit_kde_mixture_from_dataset(ds)
    out["train_full"] = {}
    for name, mesh, point_sharded in (("data_parallel", mesh_dp, False),
                                      ("point_sharded", None, True)):
        stats = os.path.join(payload["stats_root"], name)
        sink = MetricSink(stats) if multihost.is_writer() else NullSink()
        t0 = time.perf_counter()
        ck.reset_launches()
        _, tr, te, _ = train_full(ds, ids[n_val:], ids[:n_val], dev_cfg, kde_ds, stats, sink,
                                  fold_id=1, device=device, mesh=mesh,
                                  point_sharded=point_sharded)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sink.close()
        timing = ("points_per_sec", "epoch_seconds")
        out["train_full"][name] = dict(
            seconds=time.perf_counter() - t0, launches=ck.launch_counts(),
            train=[{k: v for k, v in d.items() if k not in timing} for d in tr],
            test=te, epoch_seconds=[d["epoch_seconds"] for d in tr])
    return out


def parallel_phase(torch, ck, card, device="cuda:0", small=None):
    """Phase 15g: the parallel paths on two ranks sharing the card over
    gloo (NCCL refuses two ranks on one card), the group's timeout
    PAR_TIMEOUT. `parallel_rank` on both ranks: the point-sharded serve step
    (1x2) at PROD, launches per rank, held to the same step with its ranks
    on the CPU at B=2 within CPU_ATOL, and at PAR_N_ALIGNED to the
    single-process serve step within SA_ATOL; the data-parallel serve step
    (2x1) to the single-process one; the point-sharded train step (1x2) at
    PAR_N_ALIGNED to the single-process step with SA unfused, the
    data-parallel train step (2x1, 10 plots a rank) at PROD to the
    single-process fused step on the 20 plots, each within phase 10's
    bounds (TRAIN_*: sums in another order), params and BN state equal bit
    for bit on both ranks, two point-sharded steps from one state equal bit
    for bit; each path's step time; `train_full` for 2 epochs on each
    path (finite losses, the same decisions on both ranks, one set of
    files). Then `dryrun_multichip(2, "gloo", device)`, and the CLIs under
    torchrun (2 processes, `--device cuda:0 --dist_backend gloo`, DEV at
    PROD width, the two mains at once, then the two predicts at once): main
    --point_sharded, main, predict --point_sharded, predict, each with its
    artifacts and every rank's launches (`Kernel launches by rank`).
    `small` (sizes and CLI flags) lets a test run it on the CPU."""
    import math
    import os
    import shutil
    import tempfile

    import numpy as np

    from stratanet2_tpu_torch.cli import prepare as cli_prepare
    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.inference import geotiff
    from stratanet2_tpu_torch.parallel.dryrun import dryrun_multichip
    from stratanet2_tpu_torch.parallel.launch import run_ranks

    small = small or {}
    lr = default_config().train.lr
    label = f"two ranks sharing one {card}"
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        stats_root = os.path.join(tmp, "train_full")
        for name in ("data_parallel", "point_sharded"):
            os.makedirs(os.path.join(stats_root, name))
        t0 = time.perf_counter()
        outs = run_ranks(PAR_WORLD, "chip_smoke:parallel_rank",
                         dict(small.get("rank", {}), stats_root=stats_root), backend="gloo",
                         device=device, timeout=PAR_TIMEOUT, workdir=os.path.join(tmp, "ranks"))
        ranks_s = time.perf_counter() - t0
        for r, out in enumerate(outs):
            check(out["rank"] == r, f"parallel: rank {r} reported {out['rank']}")
            for path, want in (("ps_serve", SERVE_LAUNCHES), ("dp_serve", SERVE_LAUNCHES),
                               ("ps_train", PS_TRAIN_LAUNCHES), ("dp_train", TRAIN_LAUNCHES)):
                check_launches(out[f"{path}_launches"], want, f"parallel_{path}_rank{r}")
            check(out["ps_serve_finite"], "parallel: point-sharded serve outputs")
            check(out["ps_serve_cpu_nan_equal"] and out["ps_serve_cpu_diff"] <= CPU_ATOL,
                  f"parallel: point-sharded serve, card vs CPU ranks {out['ps_serve_cpu_diff']}")
            check(out["ps_serve_aligned_nan_equal"] and out["ps_serve_aligned_diff"] <= SA_ATOL,
                  f"parallel: point-sharded vs single serve {out['ps_serve_aligned_diff']}")
            check(out["dp_serve_diff"] <= SA_ATOL,
                  f"parallel: data-parallel vs single serve {out['dp_serve_diff']}")
            check_step_diffs("parallel point-sharded train vs unfused",
                             out["ps_train_vs_unfused"], lr)
            check_step_diffs("parallel data-parallel train vs single",
                             out["dp_train_vs_single"], lr)
            check(out["ps_train_reproducible"], "parallel: two point-sharded steps differ")
            for name in ("serve", "train"):
                for path in ("ps", "dp"):
                    med, times = out[f"{path}_{name}_ms"]
                    print(json.dumps({"phase": "parallel_step", "rank": r, "path": path,
                                      "step": name, "step_ms_median": med, "step_ms_all": times,
                                      "label": label}), flush=True)
        print(json.dumps({"phase": "parallel", "ranks_seconds": ranks_s, **{
            k: outs[0][k] for k in ("ps_serve_cpu_diff", "ps_serve_aligned_diff",
                                    "dp_serve_diff", "ps_train_vs_unfused",
                                    "dp_train_vs_single", "ps_train_comps", "dp_train_comps")},
            "cpu_atol": CPU_ATOL, "sa_atol": SA_ATOL, "card": card}), flush=True)
        for key in ("ps_train_digest", "dp_train_digest"):
            check(outs[0][key] == outs[1][key], f"parallel: {key} differs across ranks")
        for name in ("data_parallel", "point_sharded"):
            runs = [o["train_full"][name] for o in outs]
            check(runs[0]["train"] == runs[1]["train"] and runs[0]["test"] == runs[1]["test"],
                  f"parallel train_full {name}: the ranks' losses or decisions differ")
            for d in runs[0]["train"] + runs[0]["test"]:
                check(all(math.isfinite(d[k]) for k in ("total_loss", "MAE_loss", "log_loss")),
                      f"parallel train_full {name}: a loss is not finite")
            files = sorted(os.listdir(os.path.join(stats_root, name)))
            for f in ("PCC_model_fold_n=1.pt", "PCC_model_fold_n=1.pt.resume", "metrics.jsonl"):
                check(f in files, f"parallel train_full {name}: no {f}")
            print(json.dumps({"phase": "parallel_train_full", "path": name,
                              "seconds": [x["seconds"] for x in runs],
                              "epoch_seconds": runs[0]["epoch_seconds"],
                              "epochs": len(runs[0]["train"]), "evals": len(runs[0]["test"]),
                              "launches": [x["launches"] for x in runs], "files": files,
                              "label": label}), flush=True)

        t0 = time.perf_counter()
        dry = dryrun_multichip(PAR_WORLD, "gloo", device)
        print(json.dumps({"phase": "parallel_dryrun", "seconds": time.perf_counter() - t0,
                          **dry}), flush=True)

        tree = write_cli_tree(os.path.join(tmp, "cli"), small.get(
            "flags", ("--subsample_size", "10000")))
        args, parcels = tree["args"], tree["parcels"]

        def torchrun(name, module, extra, experiments):
            argv = [a if a != tree["experiments"] else experiments for a in args]
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(PAR_WORLD), "-m", f"stratanet2_tpu_torch.cli.{module}",
                   *argv, *extra, "--device", device, "--dist_backend", "gloo"]
            env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""),
                       OMP_NUM_THREADS="1")
            return name, time.perf_counter(), subprocess.Popen(
                cmd, cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)

        def finish(started):
            done = {}
            for name, t0, proc in started:
                try:
                    log, _ = proc.communicate(timeout=PAR_TIMEOUT)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    log, _ = proc.communicate()
                    fail(f"parallel cli {name}: timed out\n{log[-3000:]}")
                check(proc.returncode == 0,
                      f"parallel cli {name}: exit {proc.returncode}\n{log[-3000:]}")
                done[name] = time.perf_counter() - t0
            return done

        def run_dir(experiments, task):
            folder = os.path.join(experiments, task, "DEV")
            (only,) = os.listdir(folder)
            return os.path.join(folder, only)

        def by_rank(name, stats_dir, seconds):
            with open(os.path.join(stats_dir, "stats.txt")) as f:
                log = f.read()
            line = [x for x in log.splitlines() if "Kernel launches by rank: " in x]
            check(len(line) == 1 and log.count("Kernel launches: ") == 1,
                  f"parallel cli {name}: launch lines in stats.txt")
            every = json.loads(line[0].split("Kernel launches by rank: ", 1)[1])
            must, never = PAR_CLI_PATHS[name]
            check(len(every) == PAR_WORLD, f"parallel cli {name}: {len(every)} ranks logged")
            for r, launches in enumerate(every):
                for k in must:
                    check(launches[k] > 0 or device == "cpu",
                          f"parallel cli {name}: {k} never launched on rank {r}")
                for k in never:
                    check(launches[k] == 0, f"parallel cli {name}: {k} launched on rank {r}")
            print(json.dumps({"phase": "parallel_cli", "cli": name, "seconds": seconds,
                              "launches_by_rank": every, "label": label}), flush=True)
            return log

        exp = {k: os.path.join(tmp, "cli", f"experiments_{k}") for k in ("ps", "dp")}
        secs = finish([torchrun("main_point_sharded", "main", ["--point_sharded"], exp["ps"]),
                       torchrun("main_data_parallel", "main", [], exp["dp"])])
        ids = {}
        for k, name, marker in (("ps", "main_point_sharded", "Point-sharded training over 2"),
                                ("dp", "main_data_parallel", "Using 2-device data-parallel")):
            stats_dir = run_dir(exp[k], "learning")
            log = by_rank(name, stats_dir, secs[name])
            check(marker in log, f"parallel cli {name}: its path is not in stats.txt")
            for f in ("PCC_model_fold_n=1.pt", "metrics.jsonl",
                      "PCC_inference_all_placettes_relabeled_summary.csv"):
                check(os.path.exists(os.path.join(stats_dir, f)), f"parallel cli {name}: no {f}")
            ids[k] = os.path.basename(stats_dir)
        cli_prepare.main(args + ["--device", device])
        for handler in list(logging.getLogger("stratanet2_tpu_torch").handlers):
            logging.getLogger("stratanet2_tpu_torch").removeHandler(handler)
            handler.close()
        shutil.copytree(parcels, parcels + "_dp")
        dp_args = ["--las_parcels_folder_path", parcels + "_dp", "--parcel_shapefile_path",
                   os.path.join(parcels + "_dp", "input", "parcels.shp")]
        secs = finish([
            torchrun("predict_point_sharded", "predict", ["--point_sharded", "--task",
                     "inference", "--inference_model_id", ids["ps"]], exp["ps"]),
            torchrun("predict_data_parallel", "predict", ["--task", "inference",
                     "--inference_model_id", ids["dp"], *dp_args], exp["dp"])])
        for k, name, folder, marker in (
                ("ps", "predict_point_sharded", parcels, "POINT-sharded inference mesh"),
                ("dp", "predict_data_parallel", parcels + "_dp", "data-parallel inference")):
            log = by_rank(name, run_dir(exp[k], "inference"), secs[name])
            check(marker in log, f"parallel cli {name}: its path is not in stats.txt")
            tif = geotiff.read_geotiff(os.path.join(folder, "inference", ids[k],
                                                    f"{tree['parcel_id']}.tif"))
            filled = tif.bands[:5][np.isfinite(tif.bands[:5])]
            check(tif.bands.shape[0] == 6 and filled.size > 0
                  and bool(((filled >= 0) & (filled <= 1)).all()),
                  f"parallel cli {name}: the parcel tif")
            check(os.path.exists(os.path.join(folder, "inference", ids[k], "parcels.shp")),
                  f"parallel cli {name}: no parcels.shp")


def reproducible_steps(torch, cfg, step, model, opt, sched, batch):
    """Phase 12b: two train steps from one saved state (the model's params
    and BN state, Adam's moments and count, the schedule) on one batch must
    give the same params, BN state and loss parts bit for bit: no operation
    of the step sums in an order that changes from run to run."""
    from stratanet2_tpu_torch.learning.train import make_optimizer

    saved = [copy.deepcopy(x.state_dict()) for x in (model, opt, sched)]
    runs = []
    for _ in range(2):
        m = copy.deepcopy(model)
        o, s = make_optimizer(cfg, m, STEPS_PER_EPOCH)
        for x, state in zip((m, o, s), saved):
            x.load_state_dict(copy.deepcopy(state))
        comps = step(m, o, s, *batch)
        runs.append({**{f"loss:{k}": v.detach() for k, v in comps.items()},
                     **{f"param:{k}": v.detach() for k, v in m.named_parameters()},
                     **{f"state:{k}": v for k, v in m.named_buffers()}})
    torch.cuda.synchronize()
    differ = sorted(k for k, v in runs[0].items()
                    if not torch.equal(v.view(torch.int32), runs[1][k].view(torch.int32)))
    print(json.dumps({"phase": "train_step_reproducible", "tensors": len(runs[0]),
                      "differ": differ}), flush=True)
    check(not differ, f"two train steps from one state differ in {differ}")


def train_phases(torch, ck, cfg, device, card):
    """Phases 9-15d. Returns the train kernels' rows and the counted launches."""
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
    from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step
    from stratanet2_tpu_torch.utils.profiling import record_calls
    from stratanet2_tpu_torch.utils.synthetic import random_model, train_batch

    b, n = cfg.train.batch_size, cfg.model.subsample_size
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    cloud, xyz, gt = train_batch(b, n, gen, device)
    kde = fit_kde_mixture((cloud[..., 2] * cfg.model.z_max).cpu().numpy())
    model = random_model(cfg.model, SEED, device, running_stats=False)
    step = make_train_step(cfg, kde, device=device)

    def fresh():
        m = copy.deepcopy(model)
        opt, sched = make_optimizer(cfg, m, STEPS_PER_EPOCH)
        return m, opt, sched

    # phase 9: one train step's eager body on a copy records each train
    # kernel's calls
    m, opt, sched = fresh()
    captured = record_calls(ck, [name for name, _, _ in TRAIN_KERNELS] + ["pixel_max"],
                            lambda: step.body(m, opt, cloud, xyz, gt))
    torch.cuda.synchronize()
    del m, opt, sched
    # phase 10: fused vs unfused SA stages with nonzero shifts; its SA train
    # passes and the unfused SA2's gather backward (the knn_scatter site
    # that left the train step) are the reference sites
    ref = record_calls(ck, list(PHASE10_SITES),
                       lambda: compare_fused_with_unfused(torch, cfg, model, cloud, xyz))
    for name, calls in ref.items():
        captured[name] += calls
    for name, calls in sa_train_reference_calls(torch, ck, device).items():
        captured[name] += calls
    captured["ball_query"] += selection_reference_calls(torch, ck, device)[0]
    captured["knn_scatter"] += knn_scatter_reference_calls(torch, device)
    step_bwd = captured["pixel_max_bwd"][0]
    for n_pix in (cfg.model.diam_pix ** 2, DENSE["diam_pix"] ** 2):  # PROD's table, the dense one
        captured["pixel_max_bwd"].append(
            pixel_max_bwd_reference_call(torch, ck, device, b, n, n_pix))
    step_pm = captured.pop("pixel_max")
    check(len(step_pm) == TRAIN_LAUNCHES["pixel_max"],
          f"pixel_max: expected {TRAIN_LAUNCHES['pixel_max']} train-step sites, saw {len(step_pm)}")
    with torch.no_grad():
        rows, ref_rows = compare_train_kernels(torch, ck, captured)
        for site, args in enumerate(step_pm):  # held and timed, outside the serve row
            shape, nbytes, ops, err, diff_sel, lib_ms = pixel_max_site(torch, ck, site, args)
            check(diff_sel == 0, f"pixel_max train-step site {site}: {diff_sel} argmax differ")
            report_site(torch, "pixel_max", f"train_step {site}", shape, ck.pixel_max,
                        ck.pixel_max_plain, args, nbytes, ops, err, diff_sel, lib_ms, new_agg())
        launch_path(torch, ck, step_bwd, step_pm[0])
    del captured, ref, step_bwd, step_pm

    # phase 12: the counted train step
    m, opt, sched = fresh()
    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    ck.reset_launches()
    comps = step(m, opt, sched, cloud, xyz, gt)
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    check_launches(launches, TRAIN_LAUNCHES, "train_step")
    print(json.dumps({"phase": "train_step_losses", **{k: float(v) for k, v in comps.items()}}),
          flush=True)
    for name, value in comps.items():
        check(bool(torch.isfinite(value)), f"train loss part {name} is not finite")
    for name, prm in m.named_parameters():
        check(prm.grad is not None and bool(torch.isfinite(prm.grad).all()),
              f"gradient of {name} missing or not finite")
        check(not torch.equal(prm.detach(), before[name]), f"{name} did not change")
    reproducible_steps(torch, cfg, step, m, opt, sched, (cloud, xyz, gt))

    # phase 13: train step time
    step_ms, times = timed_steps(torch, lambda: step(m, opt, sched, cloud, xyz, gt))
    print(json.dumps({"phase": "train_step", "B": b, "N": n, "step_ms_median": step_ms,
                      "step_ms_all": times, "points_per_s": b * n / (step_ms / 1e3),
                      "card": card}), flush=True)

    profile_step(torch, step, (m, opt, sched, cloud, xyz, gt), step_ms, "train_profile",
                 TRAIN_LAUNCHES)

    compare_train_with_cpu(torch, cfg, model, kde, cloud, xyz, gt)
    serve_after_train(torch, cfg, m, cloud, xyz)
    del m, opt, sched
    prepared, fed_ms = loader_steps(torch, ck, cfg, device, card)
    train_full_phase(torch, ck, cfg, device, card, prepared, fed_ms)
    return rows, ref_rows, launches


# ---------------------------------------------------------------------------
# phase 15i: the steps' CUDA graphs against their eager bodies
# ---------------------------------------------------------------------------


def _on_model(model, *arrays):
    """The arrays as float32 tensors on the model's device, as a step takes
    its inputs."""
    import torch

    dev = next(model.parameters()).device
    return tuple(torch.as_tensor(a, device=dev).float() for a in arrays)


def eager_serve(step):
    """The serve step `step` run by its eager body (`step.body`): what it
    runs without its CUDA graph."""
    def run(model, cloud, xyz):
        return step.body(model, *_on_model(model, cloud, xyz))

    run.body = step.body
    return run


def eager_train(step):
    """The train step `step` run by its eager body, then the schedule."""
    def run(model, optimizer, scheduler, cloud, xyz, gt, generator=None):
        comps = step.body(model, optimizer, *_on_model(model, cloud, xyz, gt), generator)
        scheduler.step()
        return comps

    run.body = step.body
    return run


def same_bits(torch, a, b) -> bool:
    """Tensors equal bit for bit (NaN payloads included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(ints), b.contiguous().view(ints)
    return torch.equal(a, b)


def _train_state(model, optimizer):
    """Every tensor a train step writes: params, BN buffers, Adam's state."""
    out = {f"param:{k}": p.detach().clone() for k, p in model.named_parameters()}
    out.update({f"buffer:{k}": b.clone() for k, b in model.named_buffers()})
    for k, p in model.named_parameters():
        for key, value in optimizer.state[p].items():
            out[f"adam:{k}:{key}"] = value.clone()
    return out


def _turns(torch, fns, reps):
    """{name: [median host ms of `reps` synchronised calls, one a turn]} of
    each fn in turns: a, b, b, a."""
    names = list(fns)
    out = {name: [] for name in names}
    for name in names + names[::-1]:
        out[name].append(timed_steps(torch, fns[name], reps)[0])
    return out


def graphs_phase(torch, ck, cfg, device, card, small=None):
    """Phase 15i: the steps' CUDA graphs (`learning/programs.py`) against
    their eager bodies, bit for bit, and their times in turns. The serve
    step replayed at PROD (B=20), at B=2 and at the dense shape (DENSE)
    against `step.body` on the same inputs; `make_predict_program` over
    GRAPH_BATCHES different batches against as many eager steps (each
    batch's outputs its own); GRAPH_TRAIN_STEPS train steps from one state
    through the step (the first eager, then its capture and replays)
    against as many eager bodies, with the schedule's period 2 so that the
    learning rate drops before the third (params, BN buffers, Adam's
    moments and count, loss parts, lr); two device-resident epochs and an
    eval over GRAPH_PLOTS plots against their eager runs with the same
    generators (the sums, the model and Adam after them, the generators'
    states, the eval's predictions and loss parts). Captures and replays
    counted, and the launch counters through replay (SERVE_LAUNCHES,
    TRAIN_LAUNCHES, EVAL_LAUNCHES a step). Then, graph against eager body
    in turns (a, b, b, a; GRAPH_STEPS synchronised steps a turn, the
    median): serve and train step ms at PROD and at the dense shape, and
    the device-resident epoch's ms a batch and device busy share. `small`
    (the CPU test's) takes other sizes."""
    from dataclasses import replace

    from stratanet2_tpu_torch.data import device_dataset as D
    from stratanet2_tpu_torch.inference.predict import make_predict_program
    from stratanet2_tpu_torch.learning import train as T
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture_from_dataset
    from stratanet2_tpu_torch.utils.synthetic import serve_batch

    t0 = time.perf_counter()
    small = small or {}
    dcfg = replace(cfg, model=replace(cfg.model, **small.get("dense", DENSE)))
    st, dst = optin_setup(torch, cfg, device, {}), optin_setup(torch, dcfg, device, {})
    b = cfg.train.batch_size
    row = {"phase": "graphs", "card": card}

    def counted(fn):
        ck.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, ck.launch_counts(), ck.graph_counts()

    def times(n, want):
        return {k: n * v for k, v in want.items()}

    # the serve step, replayed against its body
    serve, model, cloud, xyz = st["serve"], st["model"], st["cloud"], st["xyz"]
    sites = {"prod_B20": (serve, model, cloud, xyz), "prod_B2": (serve, model, cloud[:2], xyz[:2]),
             "dense": (dst["serve"], dst["model"], dst["cloud"], dst["xyz"])}
    row["serve"] = {}
    for label, (step, m, c, x) in sites.items():
        (_, first, made) = counted(lambda: step(m, c, x))  # the body, then its capture
        (got, launches, graphs) = counted(lambda: step(m, c, x))
        want = step.body(m, c, x)
        differ = [name for name, g, w in zip(("rasters", "pred_pl"), got, want)
                  if not same_bits(torch, g, w)]
        row["serve"][label] = {"differ": differ, "first_call": made, "replay": graphs}
        check(not differ, f"graphs: the replayed serve step at {label} differs in {differ}")
        check(made == {"captures": 1, "replays": 0} and graphs == {"captures": 0, "replays": 1},
              f"graphs: serve at {label}: captures and replays {made}, {graphs}")
        check_launches(first, SERVE_LAUNCHES, f"graphs_serve_{label}_first")
        check_launches(launches, SERVE_LAUNCHES, f"graphs_serve_{label}_replay")

    # make_predict_program over different batches: each batch's outputs its own
    gen = torch.Generator(device=device).manual_seed(SEED + 60)
    batches = [serve_batch(b, cfg.model.subsample_size, gen, device) for _ in range(GRAPH_BATCHES)]
    (rasters, preds), launches, graphs = counted(lambda: make_predict_program(
        cfg, device, step=serve)(model, [c for c, _ in batches], [x for _, x in batches]))
    differ = [i for i, (c, x) in enumerate(batches)
              if not all(same_bits(torch, g, w) for g, w in zip((rasters[i], preds[i]),
                                                                serve.body(model, c, x)))]
    alike = [(i, j) for i in range(GRAPH_BATCHES) for j in range(i)
             if same_bits(torch, preds[i], preds[j])]
    row["predict_program"] = {"batches": GRAPH_BATCHES, "differ": differ, "alike": alike,
                              "graphs": graphs}
    check(not differ and not alike,
          f"graphs: make_predict_program's batches differ from their steps {differ} "
          f"or alike {alike}")
    check(graphs == {"captures": 0, "replays": GRAPH_BATCHES},
          f"graphs: the program's replays {graphs}")
    check_launches(launches, times(GRAPH_BATCHES, SERVE_LAUNCHES), "graphs_predict_program")

    # train steps from one state, replayed against eager bodies, the lr
    # dropping before the third (a period of 2 updates)
    gcfg = replace(cfg, train=replace(cfg.train, step_size=2))
    sides = {}
    for side in ("graph", "eager"):
        m = copy.deepcopy(st["train_model"])
        opt, sched = T.make_optimizer(gcfg, m, 1)
        run = st["train"] if side == "graph" else eager_train(st["train"])
        comps, launches, graphs = counted(
            lambda: [run(m, opt, sched, *st["batch"]) for _ in range(GRAPH_TRAIN_STEPS)])
        state = _train_state(m, opt)
        state.update({f"loss:{i}:{k}": v for i, c in enumerate(comps) for k, v in c.items()})
        state["lr"] = torch.as_tensor(opt.param_groups[0]["lr"]).clone()
        sides[side] = (state, launches, graphs)
        check_launches(launches, times(GRAPH_TRAIN_STEPS, TRAIN_LAUNCHES), f"graphs_train_{side}")
    (got, _, graphs), (want, _, _) = sides["graph"], sides["eager"]
    differ = sorted(k for k in want if not same_bits(torch, got[k], want[k]))
    lr = float(want["lr"])
    row["train"] = {"steps": GRAPH_TRAIN_STEPS, "tensors": len(want), "differ": differ,
                    "graphs": graphs, "lr": lr, "lr0": cfg.train.lr}
    check(not differ, f"graphs: replayed train steps differ from eager ones in {differ[:8]}")
    check(graphs == {"captures": 1, "replays": GRAPH_TRAIN_STEPS - 1},
          f"graphs: the train step's captures and replays {graphs}")
    check(lr < cfg.train.lr, f"graphs: the lr {lr} did not drop within the train steps")

    # two device-resident epochs and an eval, against their eager runs
    n_plots, n_points = small.get("plots", GRAPH_PLOTS)
    ds = _plots(n_plots, n_points, SEED + 61)
    ids = sorted(ds)
    train_ids, val_ids = ids[:-2 * b], ids[-2 * b:]
    nb = len(train_ids) // b
    kde = fit_kde_mixture_from_dataset(ds)
    dd = D.build_device_dataset(ds, train_ids, cfg.model, device)
    dd_val = D.build_device_dataset(ds, val_ids, cfg.model, device)
    vidx = torch.from_numpy(D.eval_index_table(len(val_ids), b)[0]).to(device)
    sides, epochs = {}, {}
    for side in ("graph", "eager"):
        m = copy.deepcopy(st["train_model"])
        opt, sched = T.make_optimizer(cfg, m, nb)
        step = T.make_train_step(cfg, kde, device=device)
        epoch = D.make_device_epoch(cfg, step if side == "graph" else eager_train(step))
        ev = D.make_device_eval(cfg, T.make_eval_core(cfg, kde, device))

        def draws(g, side=side):
            return {} if side == "graph" else {"draws": D.generator_draws(g)}

        def run_epochs(epoch=epoch, ev=ev, m=m, opt=opt, sched=sched, draws=draws):
            out = {}
            for e in (1, 2):
                g = T.epoch_generator(SEED, e, device)
                idx = torch.from_numpy(D.epoch_index_table(len(train_ids), b, SEED, e)).to(device)
                out.update({f"sums:{e}:{k}": v for k, v in
                            epoch(m, opt, sched, dd, idx, g, **draws(g)).items()})
                out[f"generator:{e}"] = g.get_state()
            g = torch.Generator(device=device).manual_seed(1)
            pred, parts = ev(m, dd_val, vidx, g, **draws(g))
            out.update({"eval:pred_pl": pred, **{f"eval:{k}": v for k, v in parts.items()}})
            return out

        out, launches, graphs = counted(run_epochs)
        out.update(_train_state(m, opt))
        sides[side] = (out, graphs)
        check_launches(launches, {k: 2 * nb * TRAIN_LAUNCHES[k] + vidx.shape[0] * v
                                  for k, v in EVAL_LAUNCHES.items()}, f"graphs_epochs_{side}")
        epochs[side] = (m, opt, sched, epoch)
    (got, graphs), (want, _) = sides["graph"], sides["eager"]
    differ = sorted(k for k in want if not same_bits(torch, got[k], want[k]))
    row["device_epochs"] = {"plots": len(train_ids), "batches": nb, "val_batches": vidx.shape[0],
                            "tensors": len(want), "differ": differ, "graphs": graphs}
    check(not differ, f"graphs: replayed device epochs and eval differ in {differ[:8]}")
    check(graphs == {"captures": 2, "replays": 2 * nb - 1 + vidx.shape[0] - 1},
          f"graphs: the device epochs' captures and replays {graphs}")
    seconds = {"checks": time.perf_counter() - t0}

    # graph against eager body, in turns
    reps = small.get("steps", GRAPH_STEPS)
    ms = {}
    for label, s in (("prod", st), ("dense", dst)):
        serve_args = (s["model"], s["cloud"], s["xyz"])
        ms[f"serve_{label}"] = _turns(torch, {
            "graph": lambda s=s, a=serve_args: s["serve"](*a),
            "eager": lambda s=s, a=serve_args: s["serve"].body(*a)}, reps)
        tm = copy.deepcopy(s["train_model"])
        train_args = (tm, *T.make_optimizer(s["cfg"], tm, STEPS_PER_EPOCH), *s["batch"])
        s["train"](*train_args)  # the first call and the capture
        ms[f"train_{label}"] = _turns(torch, {
            "graph": lambda s=s, a=train_args: s["train"](*a),
            "eager": lambda s=s, a=train_args: eager_train(s["train"])(*a)}, reps)
    row["step_ms"] = ms
    epoch_ms, busy = {"graph": [], "eager": []}, {"graph": [], "eager": []}
    for side in ("graph", "eager", "eager", "graph"):
        m, opt, sched, epoch = epochs[side]
        g = T.epoch_generator(SEED, 3, device)
        idx = torch.from_numpy(D.epoch_index_table(len(train_ids), b, SEED, 3)).to(device)
        extra = {} if side == "graph" else {"draws": D.generator_draws(g)}
        torch.cuda.synchronize()
        t = time.perf_counter()
        epoch(m, opt, sched, dd, idx, g, **extra)
        torch.cuda.synchronize()
        epoch_ms[side].append((time.perf_counter() - t) * 1e3 / nb)
        g = T.epoch_generator(SEED, 3, device)
        extra = {} if side == "graph" else {"draws": D.generator_draws(g)}
        _, busy_ms = device_busy_ms(torch, lambda: epoch(m, opt, sched, dd, idx, g, **extra))
        busy[side].append(busy_ms / nb)
    row["device_epoch"] = {"batches": nb, "ms_a_batch": epoch_ms, "busy_ms_a_batch": busy,
                           "busy_share": {k: [bz / t for bz, t in zip(busy[k], epoch_ms[k])]
                                          for k in busy}}
    seconds["timing"] = time.perf_counter() - t0 - seconds["checks"]
    row["seconds"] = seconds
    print(json.dumps(row), flush=True)


# ---------------------------------------------------------------------------
# phase 15j: the reference training schedule
# ---------------------------------------------------------------------------


def _script(name):
    """`scripts/<name>.py` of this checkout, loaded as a module."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def trace_step():
    """`scripts/torch_trace_step.py`: the one way this script traces the
    card and picks and groups its device operations."""
    return _script("torch_trace_step")


@functools.lru_cache(maxsize=None)
def roofline():
    """`scripts/torch_roofline.py`: the one source of the kernels' byte and
    operation counts (a function a kernel), the card's peaks and the bound
    that the kernels' lines and sites report."""
    return _script("torch_roofline")


def schedule_launches(run, train=None, evals=None):
    """The launches a training run's summary must show: the train step's
    (`train`, TRAIN_LAUNCHES by default) for every batch it ran, the eval's
    (`evals`, EVAL_LAUNCHES by default) for every eval batch, and a pixel
    max a val plot where its last eval drew the figures."""
    train, evals = train or TRAIN_LAUNCHES, evals or EVAL_LAUNCHES
    want = {name: run["train_batches"] * train[name] + run["eval_batches"] * evals[name]
            for name in train}
    want["pixel_max"] += run["val_plots"] if run["figures"] else 0
    return want


def epoch_host_costs(torch, device, card, epoch_s, reps=SCHEDULE_HOST_REPS):
    """Host microseconds a call of what a schedule's epoch does besides its
    batches: the sink's train record (JSONL and its TensorBoard mirror),
    `print_epoch_losses` (no handler, as in the schedule's children), the
    shuffled index table's upload and the read of the epoch's sums; their
    sum as a share of `epoch_s`, the median epoch."""
    import tempfile

    import numpy as np

    from stratanet2_tpu_torch.data.device_dataset import epoch_index_table
    from stratanet2_tpu_torch.learning.train import TRAIN_LOSS_KEYS, print_epoch_losses
    from stratanet2_tpu_torch.utils.experiment import MetricSink

    losses = {**dict.fromkeys(TRAIN_LOSS_KEYS, 0.25), "step": 4, "points_per_sec": 3.4e7,
              "epoch": 1, "epoch_seconds": 0.025}
    sums = {k: torch.full((), 0.5, device=device) for k in TRAIN_LOSS_KEYS}

    def per_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    with tempfile.TemporaryDirectory() as tmp:
        sink = MetricSink(tmp)
        try:
            us = {"sink_record": per_call(lambda i: sink.log_metrics(losses, epoch=i, step=i))}
        finally:
            sink.close()
    us["print_epoch_losses"] = per_call(lambda i: print_epoch_losses(i, losses, train=True))
    us["table_upload"] = per_call(lambda i: torch.from_numpy(
        epoch_index_table(88, 20, SEED, i)).to(device))
    us["sums_read"] = per_call(lambda i: torch.stack([sums[k] for k in sums]).tolist())
    total = sum(us.values())
    print(json.dumps({"phase": "schedule_host", "us_a_call": us, "us_an_epoch": total,
                      "median_epoch_seconds": epoch_s,
                      "share_of_epoch": total * 1e-6 / epoch_s if epoch_s else None,
                      "card": card}), flush=True)


def schedule_phase(torch, ck, card, device="cuda", small=None):
    """Phase 15j: the reference training schedule as users run it, through
    the port's counterparts of the JAX side's tools, each child a process
    of its own on the card.
    1. `"learnability"`: `scripts/torch_learnability_check.py`'s run at its
       defaults (60 plots built from their geometry, 60 epochs, subsample
       4,096, batch 8), in this process: val MAE must beat the
       predict-the-mean baseline;
    2. `"schedule_fold"`, a line a child run: `scripts/
       torch_prod_schedule_run.py`'s orchestration at PROD (110 plots of
       12,000 points, B=20 x 10,000, 300 epochs, early stopping on): fold 1
       killed by SIGTERM past epoch SCHEDULE_KILL_AFTER (two evals: a
       `.resume` exists) and resumed in a new process, then fold 2; then an
       unbroken fold 1 in a fresh root. Each finished run: 300 epochs or an
       early stop past `epoch_to_start_early_stop`, val MAE below its
       baseline, launches equal to `schedule_launches`, graphs captured on
       the card; the killed run's kill landed mid-schedule;
    3. `"schedule_resume"`: the resumed fold 1 against the unbroken one, bit
       for bit (`compare_runs`: the best checkpoint's params and BN
       buffers, the `.resume` checkpoint's, Adam's moments and counts among
       them, both files' metadata, the loss parts of every epoch and eval
       from the resume on);
    4. `"schedule_host"`: what an epoch costs the host besides its batches
       (`epoch_host_costs`), and `"schedule"`, the phase's seconds.
    `small` cuts the sizes for a run on the CPU: {"learnability": kwargs of
    `learnability`, "schedule": flags of the schedule script, "kill_after":
    epochs}."""
    import os
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    small = small or {}
    learn = _script("torch_learnability_check")
    sched = _script("torch_prod_schedule_run")
    summary = learn.learnability(device=str(device), **small.get("learnability", {}))
    print(json.dumps({"phase": "learnability", **{k: summary[k] for k in (
        "val_MAE", "baseline_MAE", "train_MAE_first", "train_MAE_last", "epochs", "n_plots",
        "seconds")}, "card": card}), flush=True)
    check(summary["val_MAE"] < summary["baseline_MAE"],
          f"learnability: val MAE {summary['val_MAE']} does not beat the mean baseline "
          f"{summary['baseline_MAE']}")

    kill_after = small.get("kill_after", SCHEDULE_KILL_AFTER)
    with tempfile.TemporaryDirectory() as tmp:
        root, ref = os.path.join(tmp, "schedule"), os.path.join(tmp, "unbroken")
        ns = sched.parse_args(["--root", root, "--kill_after", str(kill_after),
                               "--device", str(device), *small.get("schedule", ())])
        runs = sched.orchestrate(ns, timeout=SCHEDULE_TIMEOUT)
        os.makedirs(ref)
        shutil.copy(os.path.join(root, "plots.pkl"), ref)
        runs.append(dict(sched.run_child(ns, ref, 1, timeout=SCHEDULE_TIMEOUT), run="unbroken"))
        cmp = sched.compare_runs(root, ref, 1)
    early_stop = sched.fold_config(ns).train.epoch_to_start_early_stop
    wants = [None if run["run"] == "killed" else schedule_launches(run) for run in runs]
    for run, want in zip(runs, wants):
        extra = {} if want is None else {"want_launches": want}
        print(json.dumps({"phase": "schedule_fold", **run, **extra, "card": card}), flush=True)
    resumed = runs[1]
    print(json.dumps({"phase": "schedule_resume", **cmp,
                      "killed_after_epoch": resumed["killed_after_epoch"], "card": card}),
          flush=True)
    for run, want in zip(runs, wants):
        name = f"schedule_fold_{run['fold']}_{run['run']}"
        if want is None:
            check(kill_after <= run["killed_after_epoch"] < ns.n_epoch,
                  f"{name}: the kill landed after epoch {run['killed_after_epoch']}")
            continue
        # 300 epochs, or an early stop (allowed from epoch_to_start_early_stop on)
        check(run["last_epoch"] == ns.n_epoch or early_stop <= run["last_epoch"] < ns.n_epoch,
              f"{name}: ended at epoch {run['last_epoch']} of {ns.n_epoch}")
        check(run["final_val_MAE"] < run["mean_baseline_MAE"],
              f"{name}: val MAE {run['final_val_MAE']} does not beat the mean baseline "
              f"{run['mean_baseline_MAE']}")
        check_launches(run["launches"], want, name)
        if str(device).startswith("cuda"):
            check(run["graphs"]["captures"] > 0 and run["graphs"]["replays"] > 0,
                  f"{name}: its steps ran outside graphs {run['graphs']}")
    check(sched.same_run(cmp),
          f"schedule: the resumed fold 1 differs from the unbroken one {cmp}")
    epoch_host_costs(torch, device, card, runs[2]["median_epoch_seconds"])
    print(json.dumps({"phase": "schedule", "seconds": time.perf_counter() - t_phase,
                      "budget_seconds": SCHEDULE_BUDGET_S, "card": card}), flush=True)

# ---------------------------------------------------------------------------
# phase 15k: the SSL cycle and the learnability sweep
# ---------------------------------------------------------------------------


def fold_memory_drift(folds):
    """The card memory allocated at each later fold's end against the first
    fold's of one cross-validation: [(fold, drift MB, bound MB)], the bound
    max(SSL_MEMORY_SLACK_MB, SSL_MEMORY_SHARE x the first fold's peak)."""
    first = folds[0]
    bound = max(SSL_MEMORY_SLACK_MB, SSL_MEMORY_SHARE * first["peak_allocated_mb"])
    return [(f["fold"], f["allocated_mb"] - first["allocated_mb"], bound) for f in folds[1:]]


def ssl_cycle_phase(torch, ck, card, device="cuda", small=None):
    """Phase 15k: the SSL cycle and the learnability sweep as users run
    them, through the port's counterparts of the JAX side's tools.
    1. `"ssl_cycle_stage"`, a line a stage of `scripts/torch_ssl_cycle.py`
       in this process at SSL_CYCLE_ARGS (cold cross-validation, prepare,
       pseudo-labelling, SSL pretraining, warm cross-validation through the
       port's CLIs) with its seconds, launches, graphs and peak MB; each
       stage launches every kernel of its path and none off it (training:
       the eleven of the fused route; pseudo-labelling: the four serve
       kernels; prepare: none), pseudo-labelling labels at least one plot;
    2. `"ssl_cycle_fold"`, a line a fold of either cross-validation: its
       seconds, the card's allocated and reserved MB at its end, its peak
       and its captures (each fold captures anew on the card); a later
       fold's allocated MB within `fold_memory_drift`'s bound of the first
       fold's;
    3. `"ssl_cycle_fold_alone"`: fold SSL_ALONE_FOLD of the cold
       cross-validation trained again alone in a fresh process
       (`torch_ssl_cycle.run_fold_alone`) against the cross-validation's,
       bit for bit (`compare_fold`: both checkpoints' params, BN buffers,
       Adam state and metadata, every epoch's and eval's loss parts);
    4. `"ssl_cycle"`: the cold and warm val MAE and their predict-the-mean
       baselines (the warm one must beat its baseline, the cold one
       SSL_JAX_COLD_MAE), the SSL run's val MAE on pseudo-labels and warm
       minus cold (printed), the phase's seconds against
       SSL_CYCLE_BUDGET_S; before it, `"ssl_sweep"`, a line a run of
       `scripts/torch_learnability_sweep.py` for SSL_SWEEP_SEEDS at both
       policies and SSL_SWEEP_EPOCHS (the grouped policy launches the
       fused route's eleven, the nearest policy its own, with
       `ball_query_nearest`), and `"ssl_sweep_summary"` a policy.
    `small` cuts the sizes for a run on the CPU: {"cycle": the cycle's
    flags, "sweep": keyword arguments of `sweep`}."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    small = small or {}
    cycle = _script("torch_ssl_cycle")
    sched = _script("torch_prod_schedule_run")
    sweep = _script("torch_learnability_sweep")
    on_card = str(device).startswith("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "cycle")
        argv = ["--root", root, "--device", str(device), *small.get("cycle", SSL_CYCLE_ARGS)]
        result = cycle.main(argv)
        alone_s = cycle.run_fold_alone(argv, SSL_ALONE_FOLD, timeout=SCHEDULE_TIMEOUT)
        cmp = cycle.compare_fold(result, root, SSL_ALONE_FOLD)
    stages, summary = result["stages"], result["summary"]
    paths = {"cold_crossval": FUSED_PATH, "prepare": set(), "pseudo_label": _SERVE_PATH,
             "ssl_pretrain": FUSED_PATH, "warm_crossval": FUSED_PATH}
    for name in paths:
        print(json.dumps({"phase": "ssl_cycle_stage", **stages[name], "card": card}), flush=True)
    folds = {cv: [{k: v for k, v in f.items() if k not in ("train", "test")}
                  for f in result["folds"] if f["of"] == cv]
             for cv in ("cold_crossval", "warm_crossval")}
    for rows in folds.values():
        for row in rows:
            print(json.dumps({"phase": "ssl_cycle_fold", **row, "card": card}), flush=True)
    print(json.dumps({"phase": "ssl_cycle_fold_alone", **cmp, "process_seconds": alone_s,
                      "card": card}), flush=True)

    for name, path in paths.items():
        check_path_launches(f"ssl_cycle {name}", stages[name]["launches"], path)
    check(stages["pseudo_label"]["pseudo_labels"] > 0, "ssl_cycle: no plot pseudo-labelled")
    n_folds = cycle.parse_args(argv).folds or 5  # the config's default
    for cv, rows in folds.items():
        check([row["fold"] for row in rows] == list(range(1, n_folds + 1)),
              f"ssl_cycle {cv}: folds {[row['fold'] for row in rows]} of {n_folds}")
        if on_card:
            for row in rows:
                check(row["captures"] > 0 and row["replays"] > 0,
                      f"ssl_cycle {cv} fold {row['fold']}: no capture anew {row}")
            for fold, drift, bound in fold_memory_drift(rows):
                check(abs(drift) <= bound, f"ssl_cycle {cv}: card memory after fold {fold} "
                      f"{drift:+.1f} MB from fold 1's, past {bound:.1f} MB")
    check(sched.same_run(cmp), f"ssl_cycle: fold {SSL_ALONE_FOLD} of the cross-validation "
          f"differs from the fold trained alone {cmp}")
    cold, warm = summary["cold_val_MAE"], summary["warm_val_MAE"]
    check(cold <= SSL_JAX_COLD_MAE, f"ssl_cycle: cold val MAE {cold} does not beat the JAX "
          f"side's {SSL_JAX_COLD_MAE} at this geometry")
    check(warm < summary["warm_baseline_MAE"], f"ssl_cycle: warm val MAE {warm} does not beat "
          f"the mean baseline {summary['warm_baseline_MAE']}")

    kwargs = {"epochs": SSL_SWEEP_EPOCHS, **small.get("sweep", {})}
    records, summaries = sweep.sweep(SSL_SWEEP_SEEDS, device=str(device), **kwargs)
    for rec in records:
        print(json.dumps({"phase": "ssl_sweep", **rec, "card": card}), flush=True)
    for row in summaries:
        print(json.dumps({"phase": "ssl_sweep_summary", **row, "card": card}), flush=True)
    check(sorted((r["seed"], r["policy"]) for r in records)
          == sorted((seed, pol) for seed in SSL_SWEEP_SEEDS for pol in ("grouped", "nearest")),
          f"ssl_sweep: runs {[(r['seed'], r['policy']) for r in records]}")
    for rec in records:
        path = FUSED_PATH if rec["policy"] == "grouped" else NEAREST_PATH
        check_path_launches(f"ssl_sweep seed {rec['seed']} {rec['policy']}", rec["launches"], path)
    print(json.dumps({"phase": "ssl_cycle", **{k: summary[k] for k in (
        "cold_val_MAE", "cold_baseline_MAE", "warm_val_MAE", "warm_baseline_MAE",
        "warm_minus_cold", "ssl_val_MAE", "pseudo_labels")},
        "seconds": time.perf_counter() - t_phase, "budget_seconds": SSL_CYCLE_BUDGET_S,
        "card": card}), flush=True)


# ---------------------------------------------------------------------------
# phase 15l: the capped-K studies and the reference-checkpoint parity eval
# ---------------------------------------------------------------------------


def grad_diffs(card, cpu):
    """The card's gradients against the CPU's ({name: array} each): the
    largest |difference| over a leaf's max |g| of the CPU's."""
    import numpy as np

    return max(float(np.abs(card[k] - cpu[k]).max()) / max(float(np.abs(cpu[k]).max()), 1e-30)
               for k in cpu)


def parity_subtree(tree_args, root, plots):
    """The first `plots` plot LAS of a parity tree (`write_cli_tree`'s
    args) and their GT rows copied under `root`: the args over the copy,
    in batches of `plots` (a plot's eval outputs do not depend on its
    batch; the CPU then computes no padding plots)."""
    import os
    import shutil

    args = list(tree_args)
    las_dir = args[args.index("--las_plots_folder_path") + 1]
    gt_csv = args[args.index("--gt_file_path") + 1]
    names = sorted(f for f in os.listdir(las_dir) if f.endswith(".las"))[:plots]
    sub_las = os.path.join(root, "las")
    os.makedirs(sub_las)
    for name in names:
        shutil.copy(os.path.join(las_dir, name), sub_las)
    keep = {os.path.splitext(n)[0] for n in names}
    with open(gt_csv) as f:
        rows = f.read().splitlines()
    sub_gt = os.path.join(root, "gt.csv")
    with open(sub_gt, "w") as f:
        f.write("\n".join([rows[0]] + [r for r in rows[1:] if r.split(",")[0] in keep]) + "\n")
    for flag, value in (("--las_plots_folder_path", sub_las), ("--gt_file_path", sub_gt),
                        ("--corrected_gt_file_path", sub_gt),
                        ("--plots_pickled_dataset_path", os.path.join(root, "plots.pkl"))):
        args[args.index(flag) + 1] = value
    return [*args, "--batch_size", str(plots)]


def cap_studies_phase(torch, ck, card, device="cuda", small=None):
    """Phase 15l: the capped-K studies and the parity eval through the
    port's counterparts of the JAX side's scripts, at small depths (their
    full depth stays in the scripts).
    1. `"neighbor_cap_study"`: `torch_neighbor_cap_study.study` at
       CAP_NEIGHBOR (2 clouds of 10,000 points, weight seed 100): each
       policy's mean and max |plot coverage - oracle's| (the oracle, cap
       2000, on the host), its launches (CAP_EVAL_LAUNCHES) and its plot
       coverages against the port's on the CPU (within CPU_ATOL);
    2. `"cap_grad_study"`: the gradient study at CAP_GRAD_ARGS (one batch
       of 4 learnable plots of 10,000 points, the port's seed-0 init): the
       cosine and norm ratio, each cap's gradient against the CPU's (every
       leaf within TRAIN_GRAD_RTOL of its max |g|, the loss within
       TRAIN_LOSS_ATOL) and the launches (the unfused train step's, twice);
    3. `"cap_train_study"`: the training study at CAP_TRAIN_ARGS, both
       configurations with their launches (`schedule_launches` of the
       unfused route), val MAE and seconds;
    4. `"parity_eval"`: `torch_parity_eval.main` on `write_cli_tree`'s data
       (DEV, subsample 10,000) with the checkpoint of
       `reference_state_dict(SEED + 26)` saved as the reference saves it:
       the MAEs, the indicators, the eval route's launches; then its first
       PARITY_CPU_PLOTS plots on the card and on the CPU, the MAEs within
       CPU_ATOL;
    5. `"cap_studies"`: the phase's seconds against CAP_STUDIES_BUDGET_S.
    `small` cuts the sizes for a run on the CPU: {"neighbor": (n_clouds, N,
    seeds), "grad": flags, "train": flags, "parity": write_cli_tree's
    flags}."""
    import os
    import tempfile
    from dataclasses import replace

    import numpy as np

    from stratanet2_tpu_torch.config import parse_config
    from stratanet2_tpu_torch.utils.reference_oracle import make_reference_state_dict

    t_phase = time.perf_counter()
    small = small or {}
    ncs = _script("torch_neighbor_cap_study")
    cts = _script("torch_cap_train_study")
    pe = _script("torch_parity_eval")
    quiet = lambda line: None  # noqa: E731  (the phase prints its own lines)

    # 1. the neighbour-cap study, card against the CPU
    t0 = time.perf_counter()
    n_clouds, n, seeds = small.get("neighbor", CAP_NEIGHBOR)
    lines, summaries = ncs.study(n_clouds, n, seeds, str(device), on_line=quiet)
    mcfg = ncs.study_config(n)
    feats, xyz = ncs.synth(np.random.default_rng(0), -(-n_clouds // seeds), n, mcfg.z_max)
    sd = make_reference_state_dict(seed=100)
    policies = {}
    for line in lines[:len(ncs.POLICIES)]:
        policy = line["policy"]
        pl_cpu = ncs.port_coverages(sd, replace(mcfg, ball_query_method=policy), feats, xyz,
                                    "cpu")
        policies[policy] = {
            "mean_abs_dev": line["mean_abs_dev"], "max_abs_dev": line["max_abs_dev"],
            "cpu_mean_abs_dev": float(np.abs(pl_cpu - line["pl_ref"]).mean()),
            "card_vs_cpu_max_abs_diff": float(np.abs(line["pl"] - pl_cpu).max()),
            "launches": line["launches"]}
    print(json.dumps({"phase": "neighbor_cap_study", "n": n, "clouds": n_clouds,
                      "weight_seeds": seeds, "policies": policies,
                      "summaries": summaries, "atol": CPU_ATOL,
                      "seconds": time.perf_counter() - t0, "card": card}), flush=True)
    for policy, row in policies.items():
        check_launches(row["launches"], CAP_EVAL_LAUNCHES[policy],
                       f"neighbor_cap_study_{policy}")
        check(row["card_vs_cpu_max_abs_diff"] <= CPU_ATOL,
              f"neighbor_cap_study {policy}: card vs CPU plot coverages differ by "
              f"{row['card_vs_cpu_max_abs_diff']}")

    # 2. the gradient study, card against the CPU, at the port's init
    t0 = time.perf_counter()
    ns = cts.parse_args([*small.get("grad", CAP_GRAD_ARGS), "--device", str(device)])
    card_lines = cts.grad_study(ns, str(device), on_line=quiet)
    card_s = time.perf_counter() - t0
    cpu_lines = cts.grad_study(ns, "cpu", on_line=quiet)
    got, want = card_lines[0], cpu_lines[0]
    grad_rel = {k: grad_diffs(got["grads"][k], want["grads"][k]) for k in want["grads"]}
    loss_diff = max(abs(a - b) for a, b in zip(got["loss"], want["loss"]))
    print(json.dumps({"phase": "cap_grad_study", **cts.printable(got),
                      "cpu_cosine": want["cosine"], "cpu_grad_norm_ratio": want["grad_norm_ratio"],
                      "card_vs_cpu_grad_rel": grad_rel, "card_vs_cpu_loss_diff": loss_diff,
                      "grad_rtol": TRAIN_GRAD_RTOL, "loss_atol": TRAIN_LOSS_ATOL,
                      "launches": card_lines[-1]["launches"], "card_seconds": card_s,
                      "seconds": time.perf_counter() - t0, "card": card}), flush=True)
    check_launches(card_lines[-1]["launches"],
                   {k: 2 * v for k, v in UNFUSED_TRAIN_LAUNCHES.items()}, "cap_grad_study")
    for name, rel in grad_rel.items():
        check(rel <= TRAIN_GRAD_RTOL, f"cap_grad_study {name}: card vs CPU gradients differ "
              f"by {rel} of a leaf's max |g|")
    check(loss_diff <= TRAIN_LOSS_ATOL, f"cap_grad_study: card vs CPU losses differ by "
          f"{loss_diff}")

    # 3. the training study on the card
    t0 = time.perf_counter()
    ns = cts.parse_args([*small.get("train", CAP_TRAIN_ARGS), "--device", str(device)])
    train_lines = cts.train_study(ns, str(device), on_line=quiet)
    print(json.dumps({"phase": "cap_train_study", "runs": train_lines[:2],
                      **train_lines[2], "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)
    for line in train_lines[:2]:
        check(np.isfinite(line["val_MAE"]), f"cap_train_study {line['config']}: val MAE "
              f"{line['val_MAE']}")
        want = schedule_launches(line, UNFUSED_TRAIN_LAUNCHES, CAP_EVAL_LAUNCHES["grouped"])
        check_launches(line["launches"], want, f"cap_train_study_{line['config']}")

    # 4. the parity eval on phase 15f's tree, and a few of its plots on the CPU
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tree = write_cli_tree(tmp, small.get("parity", ("--subsample_size", "10000")))
        ckpt = os.path.join(tmp, "PCC_model_fold_n=1.pt")
        torch.save({"state_dict": reference_state_dict(SEED + 26), "best_metric_epoch": 3,
                    "best_metric_value": 0.1}, ckpt)
        argv = ["--checkpoint", ckpt, *tree["args"]]
        with contextlib.redirect_stdout(io.StringIO()):
            full = pe.main([*argv, "--device", str(device)])
            sub = parity_subtree(tree["args"], os.path.join(tmp, "sub"), PARITY_CPU_PLOTS)
            sub_argv = ["--checkpoint", ckpt, *sub]
            sub_card = pe.main([*sub_argv, "--device", str(device)])
            sub_cpu = pe.main([*sub_argv, "--device", "cpu"])
        cfg, _ = parse_config(tree["args"])
    diff = max(abs(sub_card["means"][k] - sub_cpu["means"][k]) for k in pe.MEAN_KEYS)
    figures = cts.figures_drawn()
    batches = -(-full["plots"] // cfg.train.batch_size)
    want = {k: batches * v for k, v in EVAL_LAUNCHES.items()}
    want["pixel_max"] += full["plots"] if figures else 0
    print(json.dumps({"phase": "parity_eval", "plots": full["plots"], "means": full["means"],
                      "indicators": full["indicators"], "skipped": full["skipped"],
                      "launches": full["launches"], "want_launches": want,
                      "cpu_plots": sub_cpu["plots"], "card_vs_cpu_max_abs_diff": diff,
                      "atol": CPU_ATOL, "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)
    check(full["plots"] == CLI_PLOTS and sub_cpu["plots"] == PARITY_CPU_PLOTS,
          f"parity_eval: {full['plots']} and {sub_cpu['plots']} plots evaluated")
    check(all(np.isfinite(v) for v in full["means"].values()), f"parity_eval: {full['means']}")
    check_launches(full["launches"], want, "parity_eval")
    check(diff <= CPU_ATOL, f"parity_eval: card vs CPU MAEs differ by {diff}")
    print(json.dumps({"phase": "cap_studies", "seconds": time.perf_counter() - t_phase,
                      "budget_seconds": CAP_STUDIES_BUDGET_S, "card": card}), flush=True)


# ---------------------------------------------------------------------------
# phase 15m: the measurement and profiling tools, bench.py's geometry
# ---------------------------------------------------------------------------


def tools_phase(torch, ck, card, device="cuda", small=None):
    """Phase 15m: the port's counterparts of the JAX side's measurement
    and profiling scripts, small, and the geometry of `bench.py`.
    1. `"tools_b128"`: one eval forward (`torch_serve_bench`'s function:
       the model without the projection) at TOOLS_SERVE's B=128 x N=4,096,
       its eager body recorded; each kernel call site (fps, sa_fused_eval,
       knn_interpolate, 2 each) held to its plain version by `check_site`
       (0 differing picks, SA_ATOL, KNN_ATOL) and timed (a `"tools_site"`
       line each, with its bound); the launches of the forward as a graph
       (its first call and a replay: twice TOOLS_FORWARD_LAUNCHES); the
       same clouds in batches of 16 equal to the B=128 forward cloud for
       cloud within CPU_ATOL;
    2. `"tools_fps_parts"`: the PROD train step at fps_parts
       TOOLS_FPS_PARTS (`torch_fps_parts_steptime.parts_config`), its FPS
       sites the rule's rows (`fps_rows`) and held to the plain version,
       and its launches TRAIN_LAUNCHES;
    3. `"tools_trace"`: `torch_trace_step.trace_table` over
       TOOLS_TRACE_STEPS replayed PROD serve steps: every serve kernel
       named among the device operations, the idle share in [0, 1);
    4. `"tools_roofline"`: `torch_roofline.roofline` at the PROD sites, a
       line a kernel (ms, bound ms and share; launches > 0);
    5. `"tools"`: the phase's seconds against TOOLS_BUDGET_S.
    `small` cuts the sizes for a run on the CPU: {"serve": (B, N, split),
    "train": (B, N), "prod": (B, N)} (the trace's and the roofline's)."""
    import tempfile
    from dataclasses import replace

    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.inference.predict import make_predict_step
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
    from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step
    from stratanet2_tpu_torch.utils.profiling import record_calls, time_ms
    from stratanet2_tpu_torch.utils.synthetic import random_model, serve_batch, train_batch

    t_phase = time.perf_counter()
    small = small or {}
    device = torch.device(device)
    on_card = device.type == "cuda"
    sb = _script("torch_serve_bench")
    fp = _script("torch_fps_parts_steptime")
    ts = trace_step()
    rl = roofline()
    cfg = default_config()

    def sized(c, b, n):
        return replace(c, model=replace(c.model, subsample_size=n),
                       train=replace(c.train, batch_size=b))

    # 1. bench.py's geometry: B=128 x 4,096 in one forward
    t0 = time.perf_counter()
    b, n, split = small.get("serve", TOOLS_SERVE)
    mcfg = sized(cfg, b, n).model
    model = random_model(mcfg, SEED, device)
    cloud, xyz = serve_batch(b, n, torch.Generator(device=device).manual_seed(SEED + 27), device)
    feats = cloud[..., 2:].contiguous()
    with torch.inference_mode():
        captured = record_calls(ck, list(TOOLS_FORWARD_LAUNCHES),
                                lambda: model(feats, xyz))
        cov, proba = model(feats, xyz)
        for name, calls in captured.items():
            check(len(calls) == TOOLS_FORWARD_LAUNCHES[name],
                  f"tools_b128: {len(calls)} {name} sites, expected {TOOLS_FORWARD_LAUNCHES[name]}")
            for site, args in enumerate(calls):
                shape, nbytes, ops, err, diff_sel, _, _ = check_site(torch, ck, name, site, args)
                k_ms = time_ms(lambda: getattr(ck, name)(*args), 10) if on_card else None
                print(json.dumps({"phase": "tools_site", "kernel": name, "site": site,
                                  "shape": shape, "kernel_ms": k_ms,
                                  "bound_ms": rl.bound_ms(nbytes, ops)[0], "max_abs_diff": err,
                                  "differing_selections": diff_sel}), flush=True)
        parts = [model(feats[i:i + split], xyz[i:i + split]) for i in range(0, b, split)]
    batched = max(float((torch.cat([p[j] for p in parts]) - want).abs().max())
                  for j, want in enumerate((cov, proba)))
    forward = sb.forward_program(model)
    ck.reset_launches()
    forward(feats, xyz)  # the first call: its eager body, then the capture
    forward(feats, xyz)  # a replay
    if on_card:
        torch.cuda.synchronize(device)
    launches = ck.launch_counts()
    check_launches(launches, {k: 2 * v for k, v in TOOLS_FORWARD_LAUNCHES.items()},
                   "tools_b128_forward")
    print(json.dumps({"phase": "tools_b128", "B": b, "N": n, "split": split,
                      "batches_vs_whole_max_abs_diff": batched, "atol": CPU_ATOL,
                      "finite": bool(torch.isfinite(cov).all()),
                      "seconds": time.perf_counter() - t0, "card": card}), flush=True)
    check(tuple(cov.shape) == (b, n, 4) and bool(torch.isfinite(cov).all()),
          f"tools_b128: coverages {tuple(cov.shape)}, finite {bool(torch.isfinite(cov).all())}")
    check(batched <= CPU_ATOL, f"tools_b128: batches of {split} differ from the whole batch "
          f"by {batched}")
    del captured, cov, proba, parts

    # 2. the PROD train step at fps_parts TOOLS_FPS_PARTS, fps_min_part_samples 1
    t0 = time.perf_counter()
    b, n = small.get("train", (cfg.train.batch_size, cfg.model.subsample_size))
    pcfg = fp.parts_config(TOOLS_FPS_PARTS, b, n)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    tcloud, txyz, gt = train_batch(b, n, gen, device)
    kde = fit_kde_mixture((tcloud[..., 2] * pcfg.model.z_max).cpu().numpy())
    tmodel = random_model(pcfg.model, SEED, device, running_stats=False)
    opt, sched = make_optimizer(pcfg, tmodel, STEPS_PER_EPOCH)
    step = make_train_step(pcfg, kde, device=device)
    m = copy.deepcopy(tmodel)  # the recorded body steps a copy
    o, _ = make_optimizer(pcfg, m, STEPS_PER_EPOCH)
    fps_calls = record_calls(ck, ["fps"], lambda: step.body(m, o, tcloud, txyz, gt))["fps"]
    del m, o
    want = [(rows, npts, picks) for _, rows, npts, picks in fp.fps_rows(pcfg)]
    got = [(a[0].shape[0], a[0].shape[1], a[1]) for a in fps_calls]
    check(got == want, f"tools_fps_parts: the step's FPS rows {got}, the rule's {want}")
    for site, args in enumerate(fps_calls):  # 0 differing picks, or it fails
        check_site(torch, ck, "fps", site, args)
    ck.reset_launches()
    step(tmodel, opt, sched, tcloud, txyz, gt)
    if on_card:
        torch.cuda.synchronize(device)
    launches = ck.launch_counts()
    check_launches(launches, TRAIN_LAUNCHES, "tools_fps_parts_train_step")
    print(json.dumps({"phase": "tools_fps_parts", "fps_parts": TOOLS_FPS_PARTS, "B": b, "N": n,
                      "fps_rows": [dict(zip(("parts", "rows", "points_a_row", "picks_a_row"), r))
                                   for r in fp.fps_rows(pcfg)],
                      "differing_picks": 0, "seconds": time.perf_counter() - t0, "card": card}),
          flush=True)

    # 3. the trace of replayed PROD serve steps, aggregated as torch_trace_step does
    t0 = time.perf_counter()
    b, n = small.get("prod", (cfg.train.batch_size, cfg.model.subsample_size))
    scfg = sized(cfg, b, n)
    smodel = random_model(scfg.model, SEED, device)
    scloud, sxyz = serve_batch(b, n, torch.Generator(device=device).manual_seed(SEED), device)
    serve = make_predict_step(scfg, device=device)
    serve(smodel, scloud, sxyz)  # the warm-up and the capture
    wall = ts.step_wall_ms(lambda: serve(smodel, scloud, sxyz), device)
    with tempfile.TemporaryDirectory() as logdir:
        table = ts.trace_table(lambda: serve(smodel, scloud, sxyz), TOOLS_TRACE_STEPS, logdir,
                               device, wall)
    named = {name: any(key.removeprefix("void ").startswith(DEVICE_KERNELS[name])
                       for _, _, key in table.rows)
             for name, _, _ in SERVE_KERNELS}
    print(json.dumps({"phase": "tools_trace", "B": b, "N": n, "steps": TOOLS_TRACE_STEPS,
                      "step_ms": wall, "device_busy_ms": table.busy_ms,
                      "idle_share": table.idle_share, "kernels_named": named,
                      "top": [{"op": key[:90], "ms": ms} for ms, _, key in table.rows[:10]],
                      "seconds": time.perf_counter() - t0, "card": card}), flush=True)
    if on_card:
        check(all(named.values()), f"tools_trace: serve kernels missing from the trace {named}")
        check(0 <= table.idle_share < 1, f"tools_trace: idle share {table.idle_share}")

    # 4. the roofline at the PROD sites
    t0 = time.perf_counter()
    for row in rl.roofline(scfg, device):
        print(json.dumps({"phase": "tools_roofline", "row": row["row"], "kernel": row["kernel"],
                          "step": row["step"], "launches": row["launches"], "ms": row["ms"],
                          "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                          "share": row["share"], "card": card}), flush=True)
        check(row["launches"] > 0, f"tools_roofline: no {row['kernel']} site")
        check(not on_card or row["ms"] > 0, f"tools_roofline: {row['kernel']} took {row['ms']}")
    print(json.dumps({"phase": "tools_roofline_seconds", "seconds": time.perf_counter() - t0}),
          flush=True)
    print(json.dumps({"phase": "tools", "seconds": time.perf_counter() - t_phase,
                      "budget_seconds": TOOLS_BUDGET_S, "card": card}), flush=True)


# ---------------------------------------------------------------------------
# phase 15h: dense plots
# ---------------------------------------------------------------------------


def dense_path_sites(ck, serve_calls, train_calls):
    """The call sites of the long-shape paths in the dense steps, as
    {path: [(step, wrapper, args)]}: the SA1 FPS rows (the cluster), SA1's
    selection in the SA eval kernel (serve) and the ball query (train),
    both on the cell grid, kNN from many sources (FP1 and FP2: the cell
    grid), and every pixel max (three pixel ranges); then
    the pixel-max backward at the dense table, which has no table to
    outgrow. The global FPS path and the dq windows, which the dense steps
    do not reach, get their reference sites in `dense_phase`."""
    def sa_max_g(a):  # (q, xyz, centroids, cterm, a1, c1, w2, b2, a2, c2, radius, k)
        ch1, w2 = a[0].shape[2], a[6]
        return ck.sa_fused_eval_max_g(ch1, ch1 if w2 is None else w2.shape[1], w2 is not None,
                                      a[11])

    sites = {path: [] for path in ck.PATHS if path not in ("fps_global", "sa_train_dq_chunked")}
    for step, calls in (("serve", serve_calls), ("train", train_calls)):
        for args in calls["fps"]:
            if ck.fps_path(args[0].shape[1], args[0].shape[0])[0] == "cluster":
                sites["fps_cluster"].append((step, "fps", args))
        for name, path, max_g in (("sa_fused_eval", "sa_fused_eval_grid", sa_max_g),
                                  ("ball_query", "ball_query_grid", lambda a: ck.BQ_MAX_G)):
            for args in calls[name]:  # xyz or points second, k last
                g = -(-args[1].shape[1] // args[-1])
                if ck.sel_path(g, max_g(args)) == "grid":
                    sites[path].append((step, name, args))
        for args in calls["knn_interpolate"]:  # (x_src, pos_src, pos_tgt)
            if ck.knn_path(args[1].shape[1], args[2].shape[1]) == "grid":
                sites["knn_interpolate_grid"].append((step, "knn_interpolate", args))
        for args in calls["pixel_max"]:
            if ck.pixel_max_range(args[2], args[1].shape[2]) < args[2]:
                sites["pixel_max_ranges"].append((step, "pixel_max", args))
    sites["pixel_max_bwd"] = [("train", "pixel_max_bwd", a) for a in train_calls["pixel_max_bwd"]]
    return sites


def fps_resident(torch, ck, device, shapes):
    """At each long-row FPS shape (rows, N): the clusters of each size and
    block size the card holds at once (`cuda_kernels.fps_cluster_resident`),
    the table the CPU tests take (FPS_RESIDENT) and the wrapper's instance;
    fails if an instance would hold every row at once but the wrapper's
    does not."""
    for rows, n in shapes:
        resident = ck.fps_cluster_resident(n, device)
        path, cs, threads = ck.fps_path(n, rows, resident)
        print(json.dumps({"phase": "fps_cluster_resident", "rows": rows, "N": n, "path": path,
                          "cs": cs, "threads": threads,
                          "resident": {str(t): v for t, v in resident.items()},
                          "table": {str(t): v for t, v in ck.FPS_RESIDENT.items()},
                          "one_wave": rows <= resident[threads][cs]}), flush=True)
        if path == "cluster" and any(rows <= k for v in resident.values() for k in v.values()):
            check(rows <= resident[threads][cs],
                  f"fps rows={rows} N={n}: {threads} threads x {cs} leaves rows waiting")


def dense_phase(torch, ck, cfg, device, card, small=None):
    """Phase 15h: the serve and train steps on dense plots (DENSE: B=20 x
    N=65536 at diam_pix 100, the default plan), which cross every limit of
    the PROD kernels at once: counted launches a step by wrapper
    (SERVE_LAUNCHES, TRAIN_LAUNCHES) and by long-shape path
    (DENSE_SERVE_PATHS, DENSE_TRAIN_PATHS), outputs finite, coverages in
    [0, 1], loss parts finite and every parameter changed; each path's call
    sites kernel vs plain (`check_site`, 0 differing picks and entries)
    with their times; the global FPS path at FPS_REFERENCE's last site and
    sa_train_bwd2's dq windows at DQ_REFERENCE; the median of DENSE_STEPS
    steps and one profiled step of each, in which each path's kernel shows
    by name exactly when it launched; sa_train_bwd2's edge buffer; then a
    train step past the dq pass's one window (`dense_dq_step`). `small` ({"B": ..., "model": {ModelConfig
    overrides}, "dq_N": ...}, the CPU test's) runs it at another size.
    Returns the dense_kernels rows."""
    from dataclasses import replace

    from stratanet2_tpu_torch.learning.train import make_optimizer
    from stratanet2_tpu_torch.utils.profiling import record_calls, time_ms

    t0 = time.perf_counter()
    seconds = {}
    torch.cuda.empty_cache()  # the earlier phases' cached blocks go back to the card
    dcfg = replace(cfg, model=replace(cfg.model, **(DENSE if small is None else small["model"])))
    if small is not None:
        dcfg = replace(dcfg, train=replace(dcfg.train, batch_size=small["B"]))
    st = optin_setup(torch, dcfg, device, {})
    b, n = dcfg.train.batch_size, dcfg.model.subsample_size
    model, cloud, xyz, batch = st["model"], st["cloud"], st["xyz"], st["batch"]

    def train_state():
        m = copy.deepcopy(st["train_model"])
        opt, sched = make_optimizer(dcfg, m, STEPS_PER_EPOCH)
        return m, opt, sched

    names = ["fps", "sa_fused_eval", "knn_interpolate", "pixel_max", "ball_query",
             "pixel_max_bwd", "sa_train_bwd2"]
    serve_calls = record_calls(ck, names, lambda: st["serve"].body(model, cloud, xyz))
    m, opt, sched = train_state()
    train_calls = record_calls(ck, names, lambda: st["train"].body(m, opt, *batch))
    torch.cuda.synchronize()

    ck.reset_launches()
    rasters, pred_pl = st["serve"](model, cloud, xyz)
    torch.cuda.synchronize()
    check_launches(ck.launch_counts(), SERVE_LAUNCHES, "dense_serve_step")
    paths = {"serve": ck.path_launch_counts()}
    check_launches(paths["serve"], DENSE_SERVE_PATHS, "dense_serve_step_paths")
    check_serve_outputs("dense serve step", dcfg, rasters, pred_pl, b)
    m, opt, sched = train_state()
    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    ck.reset_launches()
    comps = st["train"](m, opt, sched, *batch)
    torch.cuda.synchronize()
    check_launches(ck.launch_counts(), TRAIN_LAUNCHES, "dense_train_step")
    paths["train"] = {**ck.path_launch_counts(),
                      "pixel_max_bwd": ck.launch_counts()["pixel_max_bwd"]}
    check_launches(paths["train"], DENSE_TRAIN_PATHS, "dense_train_step_paths")
    for part, value in comps.items():
        check(bool(torch.isfinite(value)), f"dense train loss part {part} is not finite")
    for name, prm in m.named_parameters():
        check(prm.grad is not None and bool(torch.isfinite(prm.grad).all()),
              f"dense train step: gradient of {name} missing or not finite")
        check(not torch.equal(prm.detach(), before[name]),
              f"dense train step: {name} did not change")

    seconds["steps"] = time.perf_counter() - t0
    # each long-shape path against its plain version at the steps' sites,
    # the global FPS path at its reference site
    sites = dense_path_sites(ck, serve_calls, train_calls)
    _, rows_g, n_g, s_g = FPS_REFERENCE[-1]
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    u = torch.rand((rows_g, n_g, 3), generator=gen, device=device)
    sites["fps_global"] = [("reference", "fps", (torch.cat([u[..., :2] * 20 - 10, u[..., 2:] * 3],
                                                          -1), s_g,
                                                torch.zeros(rows_g, dtype=torch.int32,
                                                            device=device)))]
    sites["sa_train_dq_chunked"] = [("reference", "sa_train_bwd2",
                                     sa_train_site_args(torch, ck, gen, device, *DQ_REFERENCE))]
    rows = {}
    with torch.no_grad():
        if device.type == "cuda":  # the grid paths size their workspace from shapes alone
            for path in ("ball_query_grid", "sa_fused_eval_grid"):
                _, name, args = sites[path][0]
                nearest_sync_free(torch, ck, args, name, "grid_sync_debug")
        for path, path_sites in sites.items():
            check(len(path_sites) > 0, f"dense phase: no call site of {path}")
            agg = new_agg()
            # a row is a step's: the serve step's sites, or the train step's
            # for the paths that only it runs (both run FPS and pixel_max:
            # their train sites are held to the plain versions too)
            counted = "train" if path in ("ball_query_grid", "pixel_max_bwd") else "serve"
            work = {}
            for i, (step, name, args) in enumerate(path_sites):
                shape, nbytes, ops, err, diff_sel, lib_ms, pairs = check_site(
                    torch, ck, name, f"dense {path} {i}", args,
                    work if step in (counted, "reference") else None)
                print(json.dumps({"kernel": name, "site": f"dense {step} {path} {i}",
                                  "shape": shape, "max_abs_diff": err,
                                  "differing_selections": diff_sel}), flush=True)
                if step not in (counted, "reference"):
                    continue  # held to the plain version; its time is the other step's
                agg["pairs"] += pairs
                report_site(torch, name, f"dense {step} {path} {i}", shape, getattr(ck, name),
                            getattr(ck, f"{name}_plain"), args, nbytes, ops, err, diff_sel,
                            lib_ms, agg, reference=step == "reference", plain_reps=1)
            rows[path] = finish_agg(agg)
            if "skipped_share" in work:  # the FPS paths: the pruning's share at each site
                rows[path]["skipped_share"] = work.pop("skipped_share")
            if work:  # the grid paths: their work, and the operations of all pairs
                a_pair = 11.0 if path == "knn_interpolate_grid" else 10.0
                rows[path].update(work, bound_all_pairs_ms=roofline().bound_ms(
                    0.0, a_pair * rows[path]["pairs"])[0])
    fps_sites = [a for _, _, a in sites["fps_cluster"][:1] + sites["fps_global"]]
    rows["fps_cluster"]["per_pick_us"], rows["fps_global"]["per_pick_us"] = (
        time_ms(lambda a=a: ck.fps(*a), 5) / (a[1] - 1) * 1e3 for a in fps_sites)
    # the dense serve step's FPS rows on fps_kernel (SA2's parts): a pick and the share skipped
    block = [a for a in serve_calls["fps"] if a[0].shape[1] <= ck.FPS_MAX_N]
    rows["fps_cluster"]["block_rows"] = [
        {"rows": a[0].shape[0], "N": a[0].shape[1], "S": a[1],
         "per_pick_us": time_ms(lambda a=a: ck.fps(*a), 5) / (a[1] - 1) * 1e3,
         "skipped_share": (lambda t: t[1] / t[2] if t[2] else None)(ck.fps_pruning(*a))}
        for a in block]
    dq_n = DENSE_DQ_N if small is None else small["dq_N"]
    fps_resident(torch, ck, device, [(a[0].shape[0], a[0].shape[1]) for a in fps_sites] +
                 [(2 * b, -(-dq_n // 2))])
    del serve_calls, sites

    edges = [(4.0 * a[2].numel() * a[0].shape[2], 4.0 * float(a[3].sum()) * a[0].shape[2])
             for a in train_calls["sa_train_bwd2"]]
    del train_calls
    seconds["sites"] = time.perf_counter() - t0 - sum(seconds.values())
    serve_ms, serve_all = timed_steps(torch, lambda: st["serve"](model, cloud, xyz), DENSE_STEPS)
    m, opt, sched = train_state()
    train_ms, train_all = timed_steps(torch, lambda: st["train"](m, opt, sched, *batch),
                                      DENSE_STEPS)
    profiles, attempts = {}, {}
    for step, fn, args, ms, launches in (
            ("serve", st["serve"], (model, cloud, xyz), serve_ms, SERVE_LAUNCHES),
            ("train", st["train"], (m, opt, sched, *batch), train_ms, TRAIN_LAUNCHES)):
        # one step traced after one warm-up step; taken again, PROFILE_TRIES
        # times at most, while a launched wrapper or path shows no kernel
        for attempts[step] in range(1, PROFILE_TRIES + 1):
            kernels = profile_step(torch, fn, args, ms, f"dense_{step}_profile", launches,
                                   steps=1, strict=False, warmup=1)
            missing = profile_mismatches(kernels, launches) + [
                path for path, want in paths[step].items()
                if want and not any(key.removeprefix("void ").startswith(DENSE_KERNELS[path])
                                    for _, _, key in kernels)]
            if not missing:
                break
        for msg in profile_mismatches(kernels, launches):
            check(False, f"dense {step} step: {msg}")
        profiles[step] = kernels
    for path, row in rows.items():
        row["launches"] = {step: paths[step].get(path, 0) for step in paths}
        row["device_ms"] = {}
        for step, kernels in profiles.items():  # a kernel shows by name exactly when launched
            hit = [ms for ms, _, key in kernels
                   if key.removeprefix("void ").startswith(DENSE_KERNELS[path])]
            check(bool(hit) == (row["launches"][step] > 0),
                  f"dense {step} profile: {len(hit)} kernels named {DENSE_KERNELS[path]}, "
                  f"{row['launches'][step]} launches of {path}")
            row["device_ms"][step] = sum(hit)
            if path in GRID_PATHS:  # the grid pass apart from the query (and the SA apply)
                row.setdefault("device_ms_by_kernel", {})[step] = {
                    k: sum(ms for ms, _, key in kernels if key.removeprefix("void ").startswith(k))
                    for k in DENSE_KERNELS[path]}
                row.setdefault("grid_pass_ms", {})[step] = \
                    row["device_ms_by_kernel"][step][DENSE_KERNELS[path][0]]
    seconds["timing"] = time.perf_counter() - t0 - sum(seconds.values())
    print(json.dumps({"phase": "dense", "B": b, "N": n, "diam_pix": dcfg.model.diam_pix,
                      "serve_step_ms_median": serve_ms, "serve_step_ms_all": serve_all,
                      "train_step_ms_median": train_ms, "train_step_ms_all": train_all,
                      "points_per_s_serve": b * n / (serve_ms / 1e3),
                      "points_per_s_train": b * n / (train_ms / 1e3),
                      "device_busy_ms": {k: sum(ms for ms, _, _ in v)
                                         for k, v in profiles.items()},
                      "profile_attempts": attempts,
                      "sa_train_bwd2_edge_buffer_bytes": sum(w + r for w, r in edges),
                      "sa_train_bwd2_edge_buffer_allocated_bytes": sum(w for w, _ in edges),
                      "loss_parts": {k: float(v) for k, v in comps.items()},
                      "seconds_so_far": seconds, "card": card}), flush=True)
    del st, model, cloud, xyz, batch, m, opt, sched
    torch.cuda.empty_cache()  # the dense steps' blocks go back before the next phases
    for path, row in dense_dq_step(torch, ck, dcfg, device, card, dq_n).items():
        rows[path]["step80k"] = row
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "dense_seconds", "seconds": time.perf_counter() - t0}), flush=True)
    return rows


def dense_dq_step(torch, ck, dcfg, device, card, n):
    """Phase 15h's last part: the train step of dcfg at subsample_size n
    (DENSE_DQ_N: past what sa_train_bwd2's dq pass holds in one window):
    counted launches by wrapper (TRAIN_LAUNCHES) and by path
    (DENSE_DQ_TRAIN_PATHS), loss parts and gradients finite, every
    parameter changed; its cluster FPS rows and windowed dq sites held to
    the plain versions (0 differing picks; dq bit for bit its ordered
    plain, two calls equal) and timed; the median of DENSE_DQ_STEPS steps
    and one profiled step (`"dense_dq_train_profile"`: device ms by
    kernel). Returns the two paths' rows at this step's sites."""
    from dataclasses import replace

    from stratanet2_tpu_torch.learning.train import make_optimizer
    from stratanet2_tpu_torch.utils.profiling import record_calls, time_ms

    qcfg = replace(dcfg, model=replace(dcfg.model, subsample_size=n))
    st = optin_setup(torch, qcfg, device, {})

    def fresh():
        m = copy.deepcopy(st["train_model"])
        return (m, *make_optimizer(qcfg, m, STEPS_PER_EPOCH))

    calls = record_calls(ck, ["fps", "sa_train_bwd2"],
                         lambda: st["train"].body(*fresh()[:2], *st["batch"]))
    m, opt, sched = fresh()
    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    ck.reset_launches()
    comps = st["train"](m, opt, sched, *st["batch"])
    torch.cuda.synchronize()
    check_launches(ck.launch_counts(), TRAIN_LAUNCHES, "dense_dq_train_step")
    check_launches(ck.path_launch_counts(), DENSE_DQ_TRAIN_PATHS, "dense_dq_train_step_paths")
    for part, value in comps.items():
        check(bool(torch.isfinite(value)), f"dense dq train loss part {part} is not finite")
    for name, prm in m.named_parameters():
        check(prm.grad is not None and bool(torch.isfinite(prm.grad).all()),
              f"dense dq train step: gradient of {name} missing or not finite")
        check(not torch.equal(prm.detach(), before[name]),
              f"dense dq train step: {name} did not change")
    sites = {"fps_cluster": ("fps", [a for a in calls["fps"]
                                     if ck.fps_path(a[0].shape[1], a[0].shape[0])[0] == "cluster"]),
             "sa_train_dq_chunked": ("sa_train_bwd2", [
                 a for a in calls["sa_train_bwd2"]
                 if ck.sa_train_dq_plan(a[0].shape[0], a[0].shape[1], *a[2].shape[1:])])}
    del calls
    rows = {}
    with torch.no_grad():
        for path, (name, path_sites) in sites.items():
            check(len(path_sites) > 0, f"dense dq train step: no call site of {path}")
            agg = new_agg()
            for i, args in enumerate(path_sites):
                shape, nbytes, ops, err, diff_sel, lib_ms, _ = check_site(
                    torch, ck, name, f"dense_dq {path} {i}", args, agg if name == "fps" else None)
                report_site(torch, name, f"dense_dq train {path} {i}", shape, getattr(ck, name),
                            getattr(ck, f"{name}_plain"), args, nbytes, ops, err, diff_sel,
                            lib_ms, agg, plain_reps=1)
            rows[path] = finish_agg(agg)
    fps_args = sites["fps_cluster"][1][0]
    rows["fps_cluster"]["per_pick_us"] = (time_ms(lambda: ck.fps(*fps_args), 5)
                                          / (fps_args[1] - 1) * 1e3)
    del sites, fps_args
    ms, every = timed_steps(torch, lambda: st["train"](m, opt, sched, *st["batch"]),
                            DENSE_DQ_STEPS)
    kernels = profile_step(torch, st["train"], (m, opt, sched, *st["batch"]), ms,
                           "dense_dq_train_profile", TRAIN_LAUNCHES, steps=1, strict=False,
                           warmup=1)
    b = qcfg.train.batch_size
    print(json.dumps({"phase": "dense_dq_train", "B": b, "N": n,
                      "diam_pix": qcfg.model.diam_pix, "train_step_ms_median": ms,
                      "train_step_ms_all": every, "points_per_s_train": b * n / (ms / 1e3),
                      "device_busy_ms": sum(k for k, _, _ in kernels),
                      "loss_parts": {k: float(v) for k, v in comps.items()}, "card": card}),
          flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 17: the opt-ins and a reference checkpoint
# ---------------------------------------------------------------------------

# The serve step's card vs CPU at B=2 in bfloat16 (phase 17c): both round
# the same float32 operands to bfloat16, but an operand that cuBLAS and MKL
# sum into float32 values a rounding apart can round to bfloat16 values 2^-8
# apart. Measured on an NVIDIA H100 80GB HBM3 at 700 W: 2.46e-5 on the fused
# route, 4.04e-5 on the unfused one, against 1.44e-4 between bfloat16 and
# float32 on either; the bound is twice the larger, and the run also checks
# that it stays below its own bfloat16-vs-float32 gap, so that a step that
# ignored the opt-in would fail. The train step's loss parts stay within
# TRAIN_LOSS_ATOL (measured 1.2e-7 and 7.2e-7).
BF16_CPU_ATOL = 8e-5
BF16_PROBE_ROWS = 20 * 10000  # FP1's rows at PROD: the largest bfloat16 matmul of a step


def nearest_reference_calls(torch, device):
    """The arguments (centroids, points, radius, k) of the nearest
    selection's reference sites (NEAREST_REFERENCE), drawn from a seed."""
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    calls = []
    for kind, b, n, c, k, radius in NEAREST_REFERENCE:
        if kind == "grid":
            side = 16 if c == 2500 else 10
            pts = torch.randint(0, side, (b, n, 3), generator=gen, device=device).float()
            pts[:, n // 2 : n // 2 + n // 8] = pts[:, : n // 8]
        elif kind in ("shifted", "clustered"):
            pts = torch.rand((b, n, 3), generator=gen, device=device) * torch.tensor(
                [20.0, 20.0, 3.0], device=device) - torch.tensor([10.0, 10.0, 0.0], device=device)
            if kind == "shifted":
                pts[..., :2] += NEAREST_SHIFT
            else:
                share, side = NEAREST_CLUSTER
                crowd = torch.rand((b, n), generator=gen, device=device) < share
                square = (torch.rand((b, n, 2), generator=gen, device=device) - 0.5) * side
                pts[..., :2] = torch.where(crowd[..., None], square, pts[..., :2])
        else:
            pts = torch.rand((b, n, 3), generator=gen, device=device) * 20 - 10
        pick = torch.randperm(n, generator=gen, device=device)[:c]
        calls.append((pts[:, pick].contiguous(), pts.contiguous(), radius, k))
    return calls


def nearest_site(torch, ck, args):
    """The nearest selection's kernel against its plain version at one site:
    (shape, bytes, operations, differing idx and mask entries, the library
    call's ms, all pairs, in-radius pairs, the cell grid that the kernel's
    launch built for the compared picks). On the card the differing entries
    also count NEAREST_REPEATS further calls' picks and cell starts. The library call is a stable
    `torch.sort` of the precomputed chunked scores and a slice of its first
    k, the plain version's selection alone. The operations are 10 a pair
    within the radius (the pairs any exact method must score: distance,
    compare, key), counted by `torch_roofline.in_radius_pairs`, whose counts
    give the bytes and operations."""
    from stratanet2_tpu_torch.ops.ballquery import _BIG, _CHUNK, radius_sq
    from stratanet2_tpu_torch.ops.distance import expanded_d2, sq_norm3
    from stratanet2_tpu_torch.utils.profiling import time_ms

    cent, pts, radius, k = args
    (gi, gm, grid), (wi, wm) = ck.ball_query_nearest_grid(*args), ck.ball_query_nearest_plain(*args)
    diff = int((gi != wi).sum()) + int((gm != wm).sum())
    for _ in range(NEAREST_REPEATS if gi.is_cuda else 0):
        ri, rm, again = ck.ball_query_nearest_grid(*args)
        diff += int((ri != wi).sum()) + int((rm != wm).sum())
        diff += int((again["starts"] != grid["starts"]).sum())
    b, c, _ = cent.shape
    n = pts.shape[1]
    r2, pts_sq = radius_sq(radius), sq_norm3(pts)
    scores = []
    for c0 in range(0, c, _CHUNK):
        cc = cent[:, c0 : c0 + _CHUNK]
        d2 = expanded_d2(cc, sq_norm3(cc), pts, pts_sq)
        scores.append(torch.where(d2 <= r2, d2, torch.full_like(d2, _BIG)))
    del d2
    lib_ms = time_ms(lambda: [torch.sort(sc, dim=-1, stable=True)[1][..., :k]
                                     for sc in scores], 2)
    del scores
    rl = roofline()
    in_radius = rl.in_radius_pairs(cent, pts, radius)
    nbytes, ops = rl.ball_query_nearest_counts(b, c, n, k, in_radius)
    shape = f"B={b} N={n} C={c} K={k} valid_picks={int(wm.sum())} in_radius={int(in_radius)}"
    return shape, nbytes, ops, diff, lib_ms, float(b * c * n), in_radius, grid


@contextlib.contextmanager
def recorded_cells(ck):
    """The cell-grid workspaces that the wrappers allocate while inside
    (`cuda_kernels._cell_workspace`), as a list of (ws, B, N, C): each
    launch's grid, read back with `cuda_kernels.cell_grid_view`."""
    calls, original = [], ck._cell_workspace

    def record(b, n, c, device):
        ws, g = original(b, n, c, device)
        calls.append((ws, b, n, c))
        return ws, g

    ck._cell_workspace = record
    try:
        yield calls
    finally:
        ck._cell_workspace = original


def cell_grid_check(torch, grid, pts, cent, radius=None):
    """The cell grid `grid` (`cuda_kernels.cell_grid_view`) that one launch's
    grid pass built against the CPU mirror, `ballquery.nearest_cells` (the
    radius form: the nearest and grouped selections) or, for radius None,
    `ballquery.knn_cells` (kNN: pts the sources, cent the targets): the
    parameters bit for bit, the cell starts, the points cell by cell (within
    a cell as a set: the pass's order there follows its atomics) with their
    float4 [x, y, z, |p|^2], the centroids cell by cell. Returns (differing
    entries, the mirror, the differing entries by part)."""
    from stratanet2_tpu_torch.ops.ballquery import knn_cells, nearest_cells
    from stratanet2_tpu_torch.ops.distance import sq_norm3

    pts, cent = pts.cpu(), cent.cpu()
    got = {key: v.cpu() for key, v in grid.items()}
    if radius is None:
        m = knn_cells(pts, cent)
        want = dict(xmin=m.xmin, ymin=m.ymin, inv_h=m.inv_h, rc2=m.m, gx=m.gx, gy=m.gy)
        pcell, ccell = m.src_cy * m.gx[:, None] + m.src_cx, m.tgt_cy * m.gx[:, None] + m.tgt_cx
    else:
        m = nearest_cells(cent, pts, radius)
        want = dict(xmin=m.xmin, ymin=m.ymin, inv_h=m.inv_h, rc2=m.rc2, gx=m.gx, gy=m.gy)
        pcell, ccell = m.point_cy * m.gx[:, None] + m.point_cx, m.cent_cy * m.gx[:, None] + m.cent_cx
    b, n, _ = pts.shape
    bits = {key: v.view(torch.int32) if v.dtype == torch.float32 else v for key, v in want.items()}
    parts = {key: int((got[key].view(torch.int32) if got[key].dtype == torch.float32
                       else got[key]).ne(bits[key]).sum()) for key in want}
    parts["starts"] = int((got["starts"] != m.starts).sum())

    def by_cell(order, cell, want_order):
        """Entries where `order` is not `want_order` cell by cell."""
        cg = cell.gather(1, order.clamp(0, cell.shape[1] - 1))
        cw = cell.gather(1, want_order)
        keys = (cg * cell.shape[1] + order).sort(dim=1).values
        return int((cg != cw).sum()) + int((keys != cw * cell.shape[1] + want_order).sum())

    parts["points"] = by_cell(got["sorted_idx"], pcell, m.order)
    parts["centroids"] = by_cell(got["cent_order"], ccell, m.cent_order)
    p4 = torch.cat([pts, sq_norm3(pts)[..., None]], -1)
    at = got["sorted_idx"].clamp(0, n - 1)[..., None].expand(b, n, 4)
    parts["positions"] = int((got["sorted_pts"].view(torch.int32)
                              != p4.gather(1, at).view(torch.int32)).any(-1).sum())
    return sum(parts.values()), m, parts


def checked_grids(torch, ck, name, site, cells, pts, cent, radius=None):
    """Each grid recorded by `recorded_cells` at one call site of `name`
    held to its mirror (`cell_grid_check`), with a `"grid_check"` line:
    the site's clouds, the cluster size of its grid pass and the differing
    entries (which must be 0). On the CPU the wrappers build no grid."""
    if not pts.is_cuda:
        return
    check(len(cells) > 0, f"{name} site {site}: no cell grid was built")
    for ws, b, n, c in cells:
        diff, _, parts = cell_grid_check(torch, ck.cell_grid_view(ws, b, n, c), pts, cent, radius)
        print(json.dumps({"phase": "grid_check", "kernel": name, "site": site, "B": b, "N": n,
                          "C": c, "cs": ck._grid_cs(b, n + c, pts.device), "grid_differing": diff,
                          "parts": parts}), flush=True)
        check(diff == 0, f"{name} site {site}: the card's cell grid differs from the CPU "
              f"mirror's in {diff} entries: {parts}")


def nearest_grid_check(torch, args, grid):
    """The cell grid `grid` that one nearest call built (`ck.
    ball_query_nearest_grid`) against `ballquery.nearest_cells` on the CPU
    (`cell_grid_check`). Returns (differing entries, pairs the kernel
    scores: each centroid's 3 x 3 cells, the differing entries by part)."""
    cent, pts, radius, _ = args
    diff, m, parts = cell_grid_check(torch, grid, pts, cent, radius)
    return diff, float(m.scored.sum()), parts


def optin_setup(torch, cfg, device, overrides):
    """The serve and train steps of the config with `overrides` (ModelConfig
    opt-ins) at cfg's width, their models (random weights from SEED, BN
    running statistics random for serve, at init for train) and batches
    (phase 3's and phase 9's seeds)."""
    from dataclasses import replace

    from stratanet2_tpu_torch.inference.predict import make_predict_step
    from stratanet2_tpu_torch.learning.kde import fit_kde_mixture
    from stratanet2_tpu_torch.learning.train import make_train_step
    from stratanet2_tpu_torch.utils.synthetic import random_model, serve_batch, train_batch

    ocfg = replace(cfg, model=replace(cfg.model, **overrides))
    b, n = cfg.train.batch_size, cfg.model.subsample_size
    cloud, xyz = serve_batch(b, n, torch.Generator(device=device).manual_seed(SEED), device)
    tcloud, txyz, gt = train_batch(b, n, torch.Generator(device=device).manual_seed(SEED + 1),
                                   device)
    kde = fit_kde_mixture((tcloud[..., 2] * cfg.model.z_max).cpu().numpy())
    return dict(cfg=ocfg, serve=make_predict_step(ocfg, device=device),
                model=random_model(ocfg.model, SEED, device), cloud=cloud, xyz=xyz,
                train=make_train_step(ocfg, kde, device=device), kde=kde,
                train_model=random_model(ocfg.model, SEED, device, running_stats=False),
                batch=(tcloud, txyz, gt))


def serve_vs_cpu(torch, cfg, model, cloud, xyz):
    """The serve step at B=2 on the card and on the CPU from one model:
    the larger max |diff| of the rasters and the plot coverages."""
    from stratanet2_tpu_torch.inference.predict import make_predict_step

    r_gpu, p_gpu = make_predict_step(cfg, device=cloud.device)(model, cloud[:2], xyz[:2])
    r_cpu, p_cpu = make_predict_step(cfg, device="cpu")(
        copy.deepcopy(model).cpu(), cloud[:2].cpu(), xyz[:2].cpu())
    r_gpu, p_gpu = r_gpu.cpu(), p_gpu.cpu()
    check(torch.equal(torch.isnan(r_gpu), torch.isnan(r_cpu)), "raster NaN pattern differs from CPU")
    return max(float(torch.nan_to_num(r_gpu - r_cpu).abs().max()),
               float((p_gpu - p_cpu).abs().max()))


def train_loss_vs_cpu(torch, cfg, kde, model, batch):
    """One train step at B=2 on the card and on the CPU from one model: the
    max |diff| of the loss parts."""
    from stratanet2_tpu_torch.learning.train import make_optimizer, make_train_step

    parts = []
    for dev in (batch[0].device, "cpu"):
        m = copy.deepcopy(model).to(dev)
        opt, sched = make_optimizer(cfg, m, STEPS_PER_EPOCH)
        comps = make_train_step(cfg, kde, device=dev)(m, opt, sched,
                                                      *(t[:2].to(dev) for t in batch))
        parts.append({k: float(v) for k, v in comps.items()})
    return max(abs(parts[0][k] - parts[1][k]) for k in parts[0])


def check_serve_outputs(what, cfg, rasters, pred_pl, b):
    check(tuple(rasters.shape) == (b, 3, cfg.model.diam_pix, cfg.model.diam_pix),
          f"{what}: rasters shape {tuple(rasters.shape)}")
    check(tuple(pred_pl.shape) == (b, 4), f"{what}: pred_pl shape {tuple(pred_pl.shape)}")
    filled = rasters[~rasters.isnan()]
    check(filled.numel() > 0 and bool(pred_pl.isfinite().all()), f"{what}: outputs not finite")
    for name, t in (("rasters", filled), ("pred_pl", pred_pl)):
        check(bool(((t >= 0) & (t <= 1)).all()), f"{what}: {name} outside [0, 1]")


def optin_route(torch, ck, cfg, device, card, name, baseline=None):
    """Phases 17b and 17c for one route of OPTIN_ROUTES: the counted serve
    and train steps at cfg's width (launches checked against the route's,
    outputs finite, coverages in [0, 1]), their step ms (median of STEPS)
    and device busy ms (one step under the profiler), and each step at B=2
    against the CPU. With `baseline` (the opt-ins of another route), the
    same weights and batches on that route, timed alike, and the serve
    step's gap to it; a bfloat16 route's gap to its float32 route must
    exceed BF16_CPU_ATOL. Returns the counted serve launches."""
    from stratanet2_tpu_torch.learning.train import make_optimizer

    def timed(st):
        """The serve and train steps' median ms and busy ms, on a copy of
        the train model."""
        m = copy.deepcopy(st["train_model"])
        opt, sched = make_optimizer(st["cfg"], m, STEPS_PER_EPOCH)

        def train():
            return st["train"](m, opt, sched, *st["batch"])

        def serve():
            return st["serve"](st["model"], st["cloud"], st["xyz"])

        out = {}
        for what, fn in (("serve", serve), ("train", train)):
            out[f"{what}_step_ms_median"], out[f"{what}_step_ms_all"] = timed_steps(torch, fn)
            out[f"{what}_device_busy_ms"] = device_busy_ms(torch, fn)[1]
        return out

    overrides, serve_want, train_want = OPTIN_ROUTES[name]
    st = optin_setup(torch, cfg, device, overrides)
    ocfg, model, cloud, xyz = st["cfg"], st["model"], st["cloud"], st["xyz"]
    b = cloud.shape[0]
    ck.reset_launches()
    rasters, pred_pl = st["serve"](model, cloud, xyz)
    torch.cuda.synchronize()
    serve_launches = ck.launch_counts()
    check_launches(serve_launches, serve_want, f"{name}_serve_step")
    check_serve_outputs(f"{name} serve step", ocfg, rasters, pred_pl, b)
    m = copy.deepcopy(st["train_model"])
    opt, sched = make_optimizer(ocfg, m, STEPS_PER_EPOCH)
    ck.reset_launches()
    comps = st["train"](m, opt, sched, *st["batch"])
    torch.cuda.synchronize()
    check_launches(ck.launch_counts(), train_want, f"{name}_train_step")
    for part, value in comps.items():
        check(bool(torch.isfinite(value)), f"{name} train loss part {part} is not finite")
    row = {"phase": "optin_steps", "route": name, "opt_ins": overrides, "B": b,
           "N": cfg.model.subsample_size, **timed(st),
           "serve_cpu_B2_max_abs_diff": serve_vs_cpu(torch, ocfg, model, cloud, xyz),
           "train_cpu_B2_loss_max_abs_diff": train_loss_vs_cpu(torch, ocfg, st["kde"],
                                                               st["train_model"], st["batch"]),
           "loss_parts": {k: float(v) for k, v in comps.items()}, "card": card}
    if baseline is not None:
        base = optin_setup(torch, cfg, device, baseline)
        r0, p0 = base["serve"](base["model"], cloud, xyz)
        row["baseline"] = {"opt_ins": baseline, **timed(base)}
        row["vs_baseline_serve_max_abs_diff"] = max(
            float(torch.nan_to_num(rasters - r0).abs().max()), float((pred_pl - p0).abs().max()))
    print(json.dumps(row), flush=True)
    bf16 = ocfg.model.compute_dtype == "bfloat16"
    atol = BF16_CPU_ATOL if bf16 else CPU_ATOL
    check(row["serve_cpu_B2_max_abs_diff"] <= atol,
          f"{name}: serve step card vs CPU differ by {row['serve_cpu_B2_max_abs_diff']} > {atol}")
    check(row["train_cpu_B2_loss_max_abs_diff"] <= TRAIN_LOSS_ATOL,
          f"{name}: train loss parts card vs CPU differ by "
          f"{row['train_cpu_B2_loss_max_abs_diff']} > {TRAIN_LOSS_ATOL}")
    if bf16:
        gap = row["vs_baseline_serve_max_abs_diff"]
        check(gap > BF16_CPU_ATOL, f"{name}: bfloat16 moved the serve step by {gap} only, "
              f"within the card-vs-CPU bound {BF16_CPU_ATOL}")
    return serve_launches


def nearest_phase(torch, ck, cfg, device):
    """Phase 17a: the nearest selection's kernel against its plain version
    at the sites one nearest serve step and one train step give it (SA1 and
    SA2 each), then at NEAREST_REFERENCE; 0 differing idx and mask entries
    at each. Returns the per-step row (the serve step's sites) and the
    reference sites' row."""
    from stratanet2_tpu_torch.learning.train import make_optimizer
    from stratanet2_tpu_torch.utils.profiling import record_calls

    st = optin_setup(torch, cfg, device, OPTIN_ROUTES["nearest"][0])
    serve = record_calls(ck, ["ball_query_nearest"],
                         lambda: st["serve"].body(st["model"], st["cloud"], st["xyz"]))
    m = copy.deepcopy(st["train_model"])
    opt, sched = make_optimizer(st["cfg"], m, STEPS_PER_EPOCH)
    train = record_calls(ck, ["ball_query_nearest"],
                         lambda: st["train"].body(m, opt, *st["batch"]))
    torch.cuda.synchronize()
    del st, m, opt, sched
    sites = [(f"serve_step {i}", a) for i, a in enumerate(serve["ball_query_nearest"])]
    sites += [(f"train_step {i}", a) for i, a in enumerate(train["ball_query_nearest"])]
    check(len(sites) == 4, f"ball_query_nearest: expected 4 step sites, saw {len(sites)}")
    sites += [(f"{i} {NEAREST_REFERENCE[i][0]}", a)
              for i, a in enumerate(nearest_reference_calls(torch, device))]
    row, ref_row = new_agg(), new_agg()
    with torch.no_grad():
        if device.type == "cuda":
            nearest_sync_free(torch, ck, sites[0][1])
        for label, args in sites:
            shape, nbytes, ops, diff, lib_ms, pairs, in_radius, grid = nearest_site(torch, ck, args)
            check(diff == 0, f"ball_query_nearest site {label}: {diff} idx and mask entries differ")
            grid_diff, scored, grid_parts = nearest_grid_check(torch, args, grid)
            del grid
            check(grid_diff == 0, f"ball_query_nearest site {label}: the card's cell grid differs "
                  f"from nearest_cells in {grid_diff} entries: {grid_parts}")
            reference = not label.startswith(("serve", "train"))
            agg = ref_row if reference else row if label.startswith("serve") else new_agg()
            agg["pairs"] += pairs
            agg["scored_pairs"] = agg.get("scored_pairs", 0.0) + scored
            agg["in_radius_pairs"] = agg.get("in_radius_pairs", 0.0) + in_radius
            print(json.dumps({"phase": "nearest_grid", "site": label, "grid_differing": grid_diff,
                              "scored_pairs": scored, "in_radius_pairs": in_radius,
                              "all_pairs": pairs}), flush=True)
            report_site(torch, "ball_query_nearest", label, shape, ck.ball_query_nearest,
                        ck.ball_query_nearest_plain, args, nbytes, ops, 0.0, diff, lib_ms, agg,
                        reference)
            if label.startswith("serve") and device.type == "cuda":  # the two kernels apart
                for key, prefix in (("grid_pass_ms", "nearest_grid_kernel"),
                                    ("query_ms", "ball_query_nearest_kernel")):
                    row[key] = row.get(key, 0.0) + device_profile(
                        torch, lambda a=args: ck.ball_query_nearest(*a), (prefix,))[0]
    return finish_agg(row), finish_agg(ref_row)


def nearest_sync_free(torch, ck, args, name="ball_query_nearest", phase="nearest_sync_debug"):
    """One call of wrapper `name` (the nearest selection, or a grouped
    selection on the cell grid) under `torch.cuda.set_sync_debug_mode(
    "error")`: the wrapper sizes its grid's workspace from shapes alone and
    reads nothing back, so no host sync may happen (one raises)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        getattr(ck, name)(*args)
    except RuntimeError as err:
        fail(f"{name} synchronised with the host: {err}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(json.dumps({"phase": phase, "wrapper": name, "mode": "error", "raised": False}),
          flush=True)


def bf16_matmul_probe(torch, device, card):
    """Phase 17c's probe of the two forms of a bfloat16 matmul with float32
    sums at FP1's shape (B x N rows, 42 -> 34): the float32 matmul of the
    widened operands (the port's `models/nn.Linear`) and cuBLAS's bfloat16
    GEMM with a float32 output (`torch.mm(..., out_dtype=torch.float32)`,
    where this PyTorch has it): their times and max |diff|."""
    from stratanet2_tpu_torch.utils.profiling import time_ms

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    x = torch.randn((BF16_PROBE_ROWS, 42), generator=gen, device=device).bfloat16()
    w = torch.randn((42, 34), generator=gen, device=device).bfloat16()
    widened = x.float() @ w.float()
    row = {"phase": "bf16_matmul_probe", "rows": BF16_PROBE_ROWS, "kept": "widened float32",
           "widened_ms": time_ms(lambda: x.float() @ w.float(), 20), "card": card}
    try:
        gemm = torch.mm(x, w, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as err:  # a PyTorch without the dtype overload
        row["bf16_gemm"] = f"unavailable: {err}"
    else:
        row["bf16_gemm_ms"] = time_ms(lambda: torch.mm(x, w, out_dtype=torch.float32), 20)
        row["bf16_gemm_max_abs_diff"] = float((gemm - widened).abs().max())
    print(json.dumps(row), flush=True)


def reference_state_dict(seed: int):
    """A reference checkpoint's state_dict from a seed, as the reference
    saves it: `utils/reference_oracle.make_reference_state_dict`'s weights
    (the modules of model/point_net2.py:81-99 under torch_geometric 1.7.2's
    keys, torch Linear weights (out, in), BatchNorm weight, bias and
    running statistics, the head bias of the reference's init) as tensors,
    with each BatchNorm's num_batches_tracked."""
    import torch

    from stratanet2_tpu_torch.utils.reference_oracle import make_reference_state_dict

    sd = {k: torch.from_numpy(v) for k, v in make_reference_state_dict(seed).items()}
    for key in [k for k in sd if k.endswith(".running_var")]:
        sd[key[: -len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    return sd


def reference_checkpoint_phase(torch, ck, cfg, device, card):
    """Phase 17d: a reference checkpoint ({"state_dict": ...,
    "best_metric_epoch": ...}, torch.save as the reference writes it) loaded
    with `load_reference_checkpoint(path, cfg, device)` (the card): every
    tensor of the state_dict placed on it (Linear weights transposed), the serve
    step at cfg's width (launches counted), and at B=2 the card against the
    CPU load within CPU_ATOL."""
    import os
    import tempfile

    from stratanet2_tpu_torch.inference.predict import make_predict_step
    from stratanet2_tpu_torch.utils.synthetic import serve_batch
    from stratanet2_tpu_torch.utils.torch_import import load_reference_checkpoint

    sd = reference_state_dict(SEED + 12)
    stage = {"sa1_module.conv.local_nn": "sa1", "sa2_module.conv.local_nn": "sa2",
             "sa3_module.nn": "sa3", "fp3_module.nn": "fp3", "fp2_module.nn": "fp2",
             "fp1_module.nn": "fp1"}
    block = {"0.weight": "linear.w", "0.bias": "linear.b", "2.weight": "bn.scale",
             "2.bias": "bn.bias", "2.running_mean": "bn.mean", "2.running_var": "bn.var"}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "PCC_model_fold_n=1.pt")
        torch.save({"state_dict": sd, "best_metric_epoch": 3, "best_metric_value": 0.1}, path)
        model = load_reference_checkpoint(path, cfg.model, device)
        cpu_model = load_reference_checkpoint(path, cfg.model, "cpu")
    got = model.state_dict()
    placed = set()
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith("lin"):
            lin, leaf = key.split(".")
            name, want = (f"{lin}.w", value.t()) if leaf == "weight" else (f"{lin}.b", value)
        else:
            prefix, i, layer, leaf = key.rsplit(".", 3)
            suffix = f"{layer}.{leaf}"
            name = f"{stage[prefix]}.layers.{i}.{block[suffix]}"
            want = value.t() if suffix == "0.weight" else value
        check(got[name].device == device and torch.equal(got[name].cpu(), want),
              f"reference checkpoint: {key} not placed on {name}")
        placed.add(name)
    check(placed == set(got), f"reference checkpoint: unset {sorted(set(got) - placed)}")
    b, n = cfg.train.batch_size, cfg.model.subsample_size
    cloud, xyz = serve_batch(b, n, torch.Generator(device=device).manual_seed(SEED + 13), device)
    step = make_predict_step(cfg, device=device)
    ck.reset_launches()
    rasters, pred_pl = step(model, cloud, xyz)
    torch.cuda.synchronize()
    check_launches(ck.launch_counts(), SERVE_LAUNCHES, "reference_checkpoint_serve_step")
    check_serve_outputs("reference checkpoint serve step", cfg, rasters, pred_pl, b)
    r_gpu, p_gpu = step(model, cloud[:2], xyz[:2])
    r_cpu, p_cpu = make_predict_step(cfg, device="cpu")(cpu_model, cloud[:2].cpu(), xyz[:2].cpu())
    check(torch.equal(torch.isnan(r_gpu.cpu()), torch.isnan(r_cpu)),
          "reference checkpoint: raster NaN pattern differs from CPU")
    err = max(float(torch.nan_to_num(r_gpu.cpu() - r_cpu).abs().max()),
              float((p_gpu.cpu() - p_cpu).abs().max()))
    print(json.dumps({"phase": "reference_checkpoint", "tensors": len(placed), "B": b,
                      "cpu_B2_max_abs_diff": err, "atol": CPU_ATOL, "card": card}), flush=True)
    check(err <= CPU_ATOL, f"reference checkpoint: card vs CPU differ by {err}")


def metascripts_phase(results):
    """Phase 17e: the three metascripts' `main` on phase 15f's
    cross-validation result CSVs, copied out of their DEV folder (the
    benchmark skips `/DEV/` paths): the benchmark CSV, the predictions
    analysis and the quantification study, whose figure is skipped with a
    warning where matplotlib is missing (and the confusion matrices where
    matplotlib or sklearn is)."""
    import importlib.util
    import os
    import tempfile

    from stratanet2_tpu_torch.metascripts import benchmark_all_models, predictions_analysis
    from stratanet2_tpu_torch.metascripts import quantification_errors

    check(any("summary" in name for name in results), f"no result CSV from phase 15f: {results}")
    warnings = []

    class Collect(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    logger = logging.getLogger("stratanet2_tpu_torch")
    handler = Collect(logging.WARNING)
    logger.addHandler(handler)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            run = os.path.join(tmp, "experiments", "learning", "PROD", "cv")
            os.makedirs(run)
            for name, text in results.items():
                with open(os.path.join(run, name), "w") as f:
                    f.write(text)
            csv = os.path.join(run, sorted(n for n in results if "summary" in n)[-1])
            bench = benchmark_all_models.main([
                "--results_files_lookup_expression",
                os.path.join(tmp, "experiments", "**", "*placettes*.csv"),
                "--benchmark_file_path", os.path.join(tmp, "benchmark.csv")])
            check(os.path.exists(os.path.join(tmp, "benchmark.csv")), "metascripts: no benchmark")
            analysis = predictions_analysis.main(
                ["--results_file", csv, "--out_dir", os.path.join(tmp, "analysis")])
            quant_dir = os.path.join(tmp, "quantification")
            quantification_errors.main(["--results_file", csv, "--out_dir", quant_dir])
            written = sorted(os.listdir(quant_dir))
    finally:
        logger.removeHandler(handler)
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    tables = ["expected_errors_under_gaussian_msrt_error.csv", "msrt_error_description.csv"]
    check(written == sorted(tables + ["quantification_error_1.png"] * has_mpl),
          f"metascripts: quantification_errors wrote {written}")
    check(has_mpl or any("quantification figure" in w for w in warnings),
          "metascripts: the quantification figure was not skipped with a warning")
    print(json.dumps({"phase": "metascripts", "result_files": sorted(results),
                      "benchmark_rows": len(bench), "analysis": analysis,
                      "quantification_files": written, "warnings": warnings,
                      "seconds": time.perf_counter() - t0}), flush=True)


def optin_phase(torch, ck, cfg, device, card, results):
    """Phase 17: 17a the nearest selection's kernel, 17b the nearest steps,
    17c the bfloat16 steps on both routes and the matmul probe, 17d a
    reference checkpoint, 17e the metascripts. Returns the nearest kernel's
    per-step row, its reference sites' row and the counted launches of the
    nearest serve step."""
    t0 = time.perf_counter()
    row, ref_row = nearest_phase(torch, ck, cfg, device)
    launches = optin_route(torch, ck, cfg, device, card, "nearest", baseline={})
    optin_route(torch, ck, cfg, device, card, "bf16_fused", baseline={})
    optin_route(torch, ck, cfg, device, card, "bf16_unfused", baseline=dict(use_pallas=False))
    bf16_matmul_probe(torch, device, card)
    reference_checkpoint_phase(torch, ck, cfg, device, card)
    metascripts_phase(results)
    print(json.dumps({"phase": "optin_seconds", "seconds": time.perf_counter() - t0}), flush=True)
    return row, ref_row, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from stratanet2_tpu_torch.config import default_config
    from stratanet2_tpu_torch.ops import _build, cuda_kernels as ck

    from stratanet2_tpu_torch.utils.profiling import card_name

    card = card_name(torch.device("cuda", 0))  # as --query-gpu=name,power.limit gives it
    print(card, flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().split(", ")
    clock_mhz = float(clocks[1].split()[0])
    print(json.dumps({"phase": "card", "clocks_sm": clocks[0], "clocks_max_sm": clocks[1]}),
          flush=True)
    kind = torch.cuda.get_device_name(0)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(json.dumps({"phase": "build", "s": time.perf_counter() - t0,
                      "libraries": sorted(p.name for p in libs.values())}), flush=True)

    def timeline(after):  # seconds since the start, after each phase
        print(json.dumps({"phase": "timeline", "after": after,
                          "seconds": time.perf_counter() - t0}), flush=True)

    cfg = default_config()
    serve_rows, serve_ref_rows, serve_launches = serve_phases(torch, ck, cfg, device, card)
    timeline("serve")
    train_rows, ref_rows, train_launches = train_phases(torch, ck, cfg, device, card)
    timeline("train")
    dense_rows = dense_phase(torch, ck, cfg, device, card)
    timeline("dense")
    graphs_phase(torch, ck, cfg, device, card)
    timeline("graphs")
    schedule_phase(torch, ck, card)
    timeline("schedule")
    ssl_cycle_phase(torch, ck, card)
    timeline("ssl_cycle")
    cap_studies_phase(torch, ck, card)
    timeline("cap_studies")
    tools_phase(torch, ck, card)
    timeline("tools")
    parcel_phase(torch, ck, cfg, device, card)
    timeline("parcel")
    results = cli_phase(torch, ck, card)
    timeline("cli")
    parallel_phase(torch, ck, card)
    timeline("parallel")
    optin_rows, optin_ref, optin_launches = optin_phase(torch, ck, cfg, device, card, results)
    timeline("optin")
    ref_rows.update(serve_ref_rows)
    ref_rows["ball_query_nearest"] = optin_ref
    scan_floor(torch, ck, libs, clock_mhz,
               {**serve_rows, **train_rows, "ball_query_nearest": optin_rows,
                **{path: dense_rows[path] for path in ("ball_query_grid", "sa_fused_eval_grid",
                                                       "knn_interpolate_grid")}})
    timeline("selection_floor")

    print(json.dumps({"reference_sites": [
        {"name": name, "sites": sites, **ref_rows[name]} for name, sites in REFERENCE_SITES.items()
    ]}), flush=True)
    sources = {name: src for name, src, _ in SERVE_KERNELS + TRAIN_KERNELS}
    print(json.dumps({"dense_kernels": [
        {"path": path, "wrapper": DENSE_WRAPPERS[path], "route": "cuda",
         "source": sources[DENSE_WRAPPERS[path]], "kernel": DENSE_KERNELS[path], **row}
        for path, row in dense_rows.items()
    ]}), flush=True)
    entries = [(k, serve_rows, serve_launches) for k in SERVE_KERNELS]
    entries += [(k, train_rows, train_launches) for k in TRAIN_KERNELS]
    entries.append((NEAREST_KERNEL, {"ball_query_nearest": optin_rows}, optin_launches))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"], "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name]["library_ms"],
         "grid_pass_ms": rows[name].get("grid_pass_ms"), "query_ms": rows[name].get("query_ms"),
         **{key: rows[name][key] for key in ("per_pick_us", "skipped_share") if key in rows[name]}}
        for (name, src, rep), rows, launches in entries
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
