#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``sciml_pde_torch/ops/csrc`` and drives the port's main paths through
their entry points: the fused FNO-2D diffusion-reaction baseline step (batch
4, 128x128, 2 channels, initial_step 10, width 20, modes 12) with the
rollout evaluation of its checkpoint and two-head aux joint training at the
same width, the same fused step on NS-2D at batch 16, 256^2, 3 channels with
the NS production step, Lie augmentation, remat, NS aux joint training
(8 + 192 windows a step) and the 3D FNO on the plume shape (and, phase 19,
on plume files the port's own generator writes), the NS-2D
VideoMAE transformer baseline at full width (img 256, patch 16, tubelet 2,
3 channels, 10 frames -> 1280 tokens; encoder 768 x 12 with 12 heads,
decoder 512 x 8 with 8 heads, head dim 64; batch 2 x accumulation 4, bf16,
and in f32 under bf16=False) and its aux joint training (2 + 6 windows a
micro-step) with SWA, early-window sampling, remat, masked-SSL pretraining
and the 3D VideoMAE,
the production FNO-2D step at the DR flagship width (the plain model
through the dft2 spectral conv, adaptive clip, torch-style Adam) with the
fused dft2 layer op and the native-kernel probe, the ported perf probe
(``sciml_pde_torch/experiments/perf_probe.py``: the K-step scans of both
FNO steps and the five split kernels), and the NS-2D FNO and VideoMAE
streamed from host RAM, rotated and sharded (ROADMAP A8):

  0. probe    build the probe kernel alone and launch it through the
              experiment's probe_native: native, and exactly 2 * x; its
              profiler device time beside torch.mul's, the median of three
              sessions of 200 launches of each, interleaved
  1. card     name and power limit (nvidia-smi), torch and CUDA versions
  2. build    nvcc for sm_90a, all sources in parallel; registers and
              spills of every attention and FNO kernel and the FNO kernels'
              stack frames (ptxas -v), none spilling at head dim 64 on the
              tensor cores (the bf16 bodies and the split-TF32 f32
              forward, dQ and dK/dV) nor in the six instances of the
              cluster bodies above head dim 256 (fwd_wide_kernel,
              dq_wide_kernel and dkv_wide_kernel, bf16 and f32; each with
              the clusters of 8 blocks the card holds at once) nor in the
              nine of the f32 forward, dQ and dK/dV of head dims 160-256
              (fwd_tf32w_kernel, dq_tf32w_kernel, dkv_tf32w_kernel at 160,
              192, 256; each with the blocks an SM holds at once) nor in
              the bf16 forward, dQ and dK/dV above head dim 1024
              (fwd_wide_tc_kernel, dq_wide_tc_kernel, dkv_wide_tc_kernel;
              the f32 instances' registers and spills printed beside
              them), HMMA instructions in both dq_wide_kernel instances'
              SASS and in those fifteen (their products on the tensor
              cores), none in
              wdft_kernel and
              reduce_rows_kernel, and
              neither spills nor a stack frame in both instances of
              lift_kernel, both paths of head_fwd_kernel and
              head_bwd_kernel, and every instance of corner_kernel,
              iwdft_pw_kernel, wdft_kernel and outer_partial_kernel (the
              four of the last by name) nor in the fused dft2 layer's
              sf_spectrum_kernel and sf_inverse_kernel; the order of each
              mix_wgrad_kernel instance's global loads, f32 arithmetic
              and stores in its SASS (cuobjdump)
  3. check    the fused forward and all ten gradients from the kernels
              against the plain PyTorch versions on the card, under
              `highest` (f32) and `default` (bf16 dot inputs); then every
              kernel against its own plain version on the inputs the main
              path gives it, with its profiler device time beside its
              library call's (fno_mix_wgrad's: one complex64 einsum, checked
              against the plain version), each device time read at or above
              its bound
              or "not measured"; fno_mix_wgrad within 1e-5 and the same
              bits twice at batches 1, 3, 4, 8 and widths 20, 40, 64 and at
              (K, R) = (6, 3) and (5, 3), with a bf16 and an f32 spectrum;
              fno_stats at three more shapes (X*Y not a
              multiple of 4, a pair larger than one cluster's shared
              memory, the flagship + 1e3 with a one-pass control);
              fno_wdft in all six variants its callers use (forward,
              gelu_in, adjoint with a bf16 or f32 pre, with and without
              gelu_grad) under both precisions; fno_reduce_rows at its
              three shapes (the head backward's, a layer's and the lift's
              outer-product partials) with its time beside torch.sum's;
              fno_lift, fno_head_fwd and fno_head_bwd under both precisions
              at (C, Co) = (20, 2), (40, 2) and (64, 9) (fault C6: widths and
              channel counts the first kernels refused; under `highest`
              within 1e-5 with a TF32-input control), the head kernels'
              times at the flagship under both; each of these with the same
              bits from a second launch; each head kernel at its widest C
              on each path, its wrapper naming that limit one channel
              above; fno_corner and fno_iwdft_pw in every variant their
              callers use (the corner forward with a bf16 or f32 spectrum,
              the adjoint, both spectrum-only; iwdft_pw with gelu and a bf16
              or f32 pre, the last layer, no pre, the adjoint) under both
              precisions (an output kept in bf16 exactly its f32 value
              rounded, that within 1e-3), under `highest` within
              1e-5 with a TF32-input control, the same bits twice, each
              device time beside its bound; fno_wdft, fno_corner,
              fno_iwdft_pw and fno_outer_partial at their widest J, C or nA
              (faults C7, C8) against their plain versions, one more
              raising a ValueError that names the limit; fno_outer_partial
              at the head kernels' widest C and the adjoint fno_wdft with
              gelu'(pre) at N 514 and 1154; fno_outer_partial's two
              main-path instances (a layer's weight gradient on the bf16
              pre with gelu, the lift's gradient on the f32 lift input)
              under both precisions, each with its device time and bound
              and the same bits twice; the fused forward with its ten
              gradients at width 40 against the plain composition, and
              printed beside it the same on random-normal inputs at widths
              20 and 40, with the head kernels and with their plain
              versions; at 512^2 (batch 1), 128 x 1152 (batch 2) and width
              120 (faults C7, C8), on smooth seeded windows, the same under
              `highest` against the plain composition and under `default`
              the W-DFT, corner, inverse-W and outer kernels on the step's
              inputs against their plain versions, with a printed witness
              of those fields' bf16 noise (the other kernels there, a
              one-f32-step nudge of the window, each kernel alone)
  4. train    one epoch of the DR baseline on a seeded in-memory store
              (10 trajectories x 101 frames x 128 x 128 x 2): finite and
              falling loss, launch counts of every kernel
  5. timing   fused step steps/s and per-launch kernel times (CUDA events;
              fno_stats also in profiler device time)
  4b. eval    phase 4's checkpoint through the evaluation entry on the card
              (plain FNO2d, `default`) at rollout 1 and 5 over the test split:
              six metrics and mse_time finite, within 1e-4 (rollout 1) and
              1e-3 (rollout 5) of the same evaluation on the CPU, the pickle
              six floats and the npz rollout_test steps, convention_table
              at 5; then aux joint training at the flagship width: an aux
              store of 27 trajectories x 50 frames x 96^2 upsampled on the
              card (within 1e-6 of the CPU), one aux step (3 aux samples,
              weight 0.7, `highest`) on the card against the CPU from one
              tree (loss, lp, la, grad norm and the updated parameters
              within 1e-4), the aux step's time (CUDA events), 2 epochs of
              train_aux with a best-primary-val checkpoint, and that
              checkpoint's primary head through the evaluation; each wall
              time with the card's name and power limit
  6. attention the three flash-attention kernels against their plain
              versions (and the same bits from a second launch) at the
              encoder (24, 1280, 64) and decoder
              (16, 1280, 64) shapes, at head dims 96, 24, 136 (at 200
              tokens), 160, 192, 256, 264, 320, 512, 1024, 1032 (also at
              200 tokens) and 2056 and at
              200 tokens (ragged tiles) at head dim 64, in f32 and bf16, at
              the encoder shape and at (8, 1280, 256), (4, 1280, 512) and
              (2, 256, 1032)
              with q and k times 3 (scores up to about 54) in f32 (from 160
              up with each kernel's time beside
              its bound and the SDPA forward or backward on the same
              inputs, and dQ + dK/dV beside the SDPA backward), and at
              batch*heads 70000 (70000, 16, 16) in bf16,
              with a control against a kernel that rounds p and ds to
              bf16 (f32 outputs held against the exact result, the plain
              versions' arithmetic in f64, within 1e-5 at every head
              dim); flash_attention at (2, 4,
              1280, 512) through the kernels against plain=True, values
              and q/k/v gradients, in both types
  7. model    one micro-step of the full-width VideoMAEOperator (loss and
              every gradient) through the kernels against the same model
              through the plain versions, with the bf16-vs-f32 gap as a
              control
  8. train    30 optimizer steps (3 epochs x 40 micro-steps) of the NS
              baseline on a seeded in-memory store (4 trajectories x 30
              frames x 256 x 256 x 3): finite and falling loss, best-val
              checkpoint, 20 launches of each attention kernel per
              micro-step
  9. timing   ms per micro-step and per optimizer step (CUDA events), the
              device-busy share and top device ops (torch.profiler), and
              per-launch attention kernel times (CUDA events and profiler
              device time) beside their bounds and the SDPA forward and
              backward, in bf16 and in f32 (the split-TF32 forward, dQ and
              dK/dV)
  9b. f32     the NS baseline through the trainer with bf16=False (2
              optimizer steps, batch 2 x accumulation 4, on 16 windows of
              the seeded store): finite losses, 20 launches of each f32
              attention kernel per micro-step; then the f32 micro-step in
              CUDA events and torch.profiler (device-busy share, top ops)
 10. layer    the fused dft2 layer (kernel: a thread-block cluster per
              element, then the inverse) at (4, 130, 130, 20), modes 12,
              through its autograd op: the gradients of sum(out^2) against
              autograd of the plain forward within 1e-5; then the kernel
              alone there and at (2, 18, 18, 6 -> 6, modes 4), (1, 13, 11,
              5 -> 3, modes 3, 4) and (3, 67, 50, 7 -> 5, modes 8, 5: bands
              of 5 rows, the last 2; 35 columns (k, c), not a multiple of
              4) against its plain f32 version within
              1e-5 of the largest magnitude, the same bits twice, with the
              plain version on bf16-rounded inputs more than 10x that away
              as the control, and the wrapper's shared-memory reckoning
              equal to the library's
 11. step     the plain FNO2d forward on the card under `highest` against
              the CPU in f32 within 1e-5 (the TF32 guard); 10 production
              steps against 10 fused steps from the same tree and batches
              (loss and grad norm rtol 2e-3, params rtol 5e-3 atol 1e-5,
              the JAX package's drop-in bounds)
 12. train    one DR epoch of the production step (cosine, `default`):
              finite and falling loss and a best-val checkpoint; a short
              StepLR run; a short autoregressive run whose windows run past
              the end of their trajectories (the gather clamps)
 13. timing   production steps/s (CUDA events), device-busy share and top
              device ops (torch.profiler), the dft vs dft2 A/B through the
              experiment's bench_shape, and per-launch times of the fused
              layer and the probe beside their bounds

 14. split    the five split functions (B1a-B2c) at the flagship shape under
              `highest` and `default`: each through the kernels against
              its plain version on the same inputs (phase 3's bounds), the
              stage-kernel launches of one call, a control under `default`
              (bf16 mix weights in `_bb_backward`, compared in mean error
              over dpre, with the ratios on the cotangents of seeds 1-3
              printed, dbb from the head kernel and from its plain
              version; a bf16 spectrum in `_bb_weight_grads`; each
              further from the plain version than the kernels by more than
              twice), the five chained against the plain fused VJP
              within 1e-4 (`highest`), and per-call times beside bounds;
              then the five again at 512^2, batch 1, width 20 (fault C7)
              against their plain versions under `highest` and under
              `default` against the control (the four kernels of faults C7
              and C8 in their plain versions)
 15. probe    the ported perf probe, all eleven configs in this process
              (PROBE_SCAN_K 25) and one more through its subprocess runner:
              no error, finite results, the steps/s table, and launches of
              every split function and stage kernel
 16. ns-fno   the FNO on NS-2D at full width (batch 16, 256^2, 3 channels,
              initial_step 10, width 20, modes 12; seeded store of 4 + 1
              trajectories x 50 frames): the fused forward and its ten
              gradients through the kernels against the plain versions
              under `highest` and `default` (phase 3's bounds and control),
              every FNO kernel against its plain version at this shape with
              its device time, one epoch of train_baseline(fast_step=True)
              (finite, falling, every kernel's launches, counted from 0),
              the fused step's time, device-busy share and top ops; 10
              production steps against 10 fused steps (phase 11's bounds),
              the production step's time and profile, an epoch on a bf16
              train store, one lie_augment step on the card against the CPU
              with both samplers fixed (phase 4b's rule), remat against no
              remat (loss and gradients within 1e-6, peak memory); NS aux at
              8 primary + 192 aux windows (aux store 128^2, explicit row
              map): aux_chunks 1 against 4 (1e-5, peak memory), one step
              under aux_native_compute and one on a bf16 aux store, one step
              at 2 + 4 windows on the card against the CPU (phase 4b's
              rule), 2 epochs of train_aux (aux_chunks 4) with its
              best-primary-val checkpoint evaluated; the 3D FNO at
              (50, 50, 89), 4 channels, modes 8, batch 1: the plain forward
              on the card against the CPU (1e-5), a step's time, 2 epochs of
              the baseline and of FNO3dAux (nA 3), each checkpoint evaluated
              at rollout 1
 17. aux-vmae the NS VideoMAE aux joint training (ROADMAP A5; the JAX
              package's experiments/ns_transformer.py: 3 aux windows a
              window, weight 0.7): a. the three attention kernels at the
              trunk's shapes (96, 1280, 64) and (64, 1280, 64) in bf16 and
              f32 (phase 6's checks, each time beside its bound and the SDPA
              call; their rows in the kernel table); b. one micro-step of
              VideoMAEOperatorAux at full width (2 + 6 windows, separate
              heads and shared_head) through the kernels against the plain
              versions (phase 7's bounds and control); c. one f32 aux
              micro-step (encoder 2, decoder 1 blocks at full width, 1 + 3
              windows) on the card against the CPU (phase 4b's rule); d. 2
              epochs of train_transformer_aux (bf16, drop-path 0.1, the aux
              store at 128^2 in bf16, upsampled at the gather): finite and
              falling losses, the best-primary-val checkpoint, each kernel's
              launches by shape (counted from 0), and 2 optimizer steps with
              bf16=False; e. the aux micro-step's time (CUDA events) and
              device-busy share (torch.profiler); f. a run with swa_frac 0.5
              and early_window_boost 4: swa_params finite and apart from the
              params; g. use_checkpoint against none on one bf16 micro-step:
              the same bits, lower peak memory, the forward launched again
              in the recompute; h. run_ssl_pretraining at full width
              (decoder through the kernels, the encoder's 320 tokens not),
              then pretrained_path into the aux trainer: the loaded count
              equals the shared leaves; i. the 3D VideoMAE through the FNO
              trainer's model_family="transformer3d" at (50, 50, 89), 4
              channels, encoder 2 and decoder 1 blocks: one baseline and
              one aux (nA 3) step on the card against the CPU, 2 epochs of
              each, no attention kernel launched at its 500 tokens
 18. data    the data and parity pipeline (ROADMAP A6 and the DR and NS-2D
              half of A7), on files the port writes (through h5py, or its
              own HDF5 subset where h5py is not installed): a. gen_diff_react
              at the generation config (128^2, 101 frames, t 5.0) for the
              primary (DR_SEEDS) and the diff form (DR_DIFF_SEEDS), the diff
              file downsampled to (50, 96) and loaded as an aux pool; one
              seed of each sim_type on the card against the CPU over the
              first DR_CHECK_FRAMES frames (1e-5), the written files too;
              the generator's time per RK4 substep and device-busy share; b.
              experiments/dr_parity.py for one epoch of basic_ds2, baseline
              on the fused step (--fast-step) and aux: finite losses, five
              horizons each in summary.json, every FNO kernel launched; c.
              rollout_study_fused on the baseline checkpoint through the
              module's forward and through fno2d_fused_apply on the packed
              tree, under `highest`, against each other (phase 4b's
              bounds); d. export_rollout_trajectories, the trainer's
              evaluation with plot=True, rollout_figure, field_panels,
              field_animation and preview_dataset write their files; e.
              simulate_ns_batch at the production grid (256^2, nu 0.05, dt
              5e-5; NS_GEN's steps) under both pressure solvers through
              gen_ns_incomp: the MAC divergence after project below
              max(1e-4 x before, 1e-4) at the JAX test's grid (24^2) and at
              256^2 below NS_DIV_256 x before and within NS_DIV_CPU x the
              CPU's (the f32 solve's level),
              with PyTorch's matmul precision at TF32 and at full f32 (the
              DCT solve the same bits under both), every stored frame finite
              with |velocity| < 100, NS_CPU_STEPS momentum steps on the card
              against the CPU (1e-4), the files read back through data/ns.py and a
              velocity file converted by velocity2vorticity; ms per
              momentum step and device-busy share (CG's over the
              generator's own steps)
 19. sim     the rest of the simulators (ROADMAP A7) on files the port
              writes: a. the 3D plume at the production config ((50, 50,
              89), 150 frames x 10 substeps, DCT): the card against the CPU
              over the first PLUME_CPU_FRAMES frames, the divergence after
              project3 (both solvers), PLUME_CG_STEPS substeps of CG against
              the DCT, PLUME_GRAPH_FRAMES frames replayed as a CUDA graph
              against op by op, the whole trajectory written as a test seed
              (finite, the smoke rising); ms a substep op by op and
              replayed, device-busy shares; b. the port's
              experiments/plume3d_parity.py at full width (FNO width 20,
              modes 12, initial_step 10) at a cut depth (PARITY_ARGS): the
              files generated, baseline and aux trained through
              run_training, the rollout 1..5 table finite, load_ns3d_aux
              reading every file back; c. Burgers at its defaults (32 x 201
              x 1024): the mean conserved, 2 frames on the card against the
              CPU; d. Darcy, one batch of 64 at 128^2: each sample's
              residual, the batch-coupled CG's iterations, a batch of 2 on
              the card against the CPU; e. BVP_CASES electro and magneto
              cases at grid 128 against the CPU; f. one airfoil sample at
              384^2 (AIRFOIL_FRAMES frames): AIRFOIL_STEPS steps on the card
              against the CPU and replayed as a graph against op by op, the
              npz and statistics written
 20. a8      scaling and I/O (ROADMAP A8): a. the NS-2D FNO at config_ns's
              width (256^2, 3 channels, initial_step 10, width 20, modes
              12; baseline batch 16, aux 8 + 24) on a seeded store of 4 +
              12 trajectories x 20 frames, one epoch through host_stream
              and one through the device store: the histories within
              1e-6 (the same bits printed), each path's step in the
              trainer's loop (CUDA events), the streamed step's busy share,
              the batches' GB/s, one pinned slot's alone, and the host's
              share (the gather, the loader, the pinned copies); b. the NS
              VideoMAE aux at full width (2 + 6 windows a micro-step, bf16,
              accumulation 4) through host_stream against the device
              store, the attention launches by shape, ms a micro-step and
              the busy share; c. resident_rotate=2 on two byte-identical
              slices under block and interleave against the unrotated run
              (JAX's oracle): the same history, each swap's time and
              GB/s, max_memory_allocated across each swap at most one
              chunk above its start; d. device_put_chunked of a 4.25 GiB
              store: every row's checksum, the chunks, the pinned staging,
              GB/s beside one pageable copy; e. distributed_init over NCCL
              at world size 1, run_training(shard_store=True) in the group
              against the process alone; f. export_apply of the NS
              production FNO, saved, loaded and run against the module; g.
              experiments/ns_production.py --host-stream end to end at a
              cut depth (A8_PROD_ARGS)
 21. cmp     tensor parallelism and the comparison models (ROADMAP A8b,
              A9): a. the column-parallel FNO2d at the DR flagship on two
              processes sharing the card through gloo with CUDA tensors:
              each rank's forward and shard gradients against the
              replicated FNO2d (`highest`, TOL_TP), its ms beside the
              replicated model's; b. run_rollout_protocol for OFormer and
              the Hyena hybrid at JAX's defaults (64^2, in 10, out 40,
              in_emb 96, latent 192, remat) on phase 18's DR files; c.
              run_oformer_burgers on phase 19's Burgers file; d.
              run_oformer_darcy at 128^2; e. run_pointset_training (both
              recipes) and run_airfoil_training on phase 19's BVP and
              airfoil files: each through its entry point on the card and
              on the CPU from one flax tree, the first C21_STEPS losses
              within TOL_C21, the depth cut printed, ms a step of the
              trainer's step (CUDA events)
 22. study   the study drivers (ROADMAP A10) through their entry points:
              a. experiments/dr_transformer.py at the reference's width
              (STUDY_WIDTHS), bf16, basic_ds2, one epoch, both variants, on
              phase 18's DR files: JAX's summary keys, finite losses and
              rollout tables, no attention kernel at its 640 tokens, ms a
              step (CUDA events around the trainer's steps) and peak
              memory, its best checkpoint in f32 on the card against the
              CPU (TOL_STUDY); b. dr_convention_eval, dr_vchannel_diag and
              dr_early_window_finetune on that checkpoint, the f32
              convention rows on the card against the CPU; c.
              dft_precision_gate on the production step and on the fused
              step (every FNO kernel launched); d. ns_demo at 128^2 and
              ns_lie_toy from a 256^2 source the phase writes; e.
              dr_data_audit at 64^2, its RK4 RMS on the card against the
              CPU (TOL_SIM);
              f. dr_seed_figure and make_round_figures, each PNG opened
 23. lzf     the compressed HDF5 stores without h5py (io/hdf5_lite.py): a.
              the host C LZF codec (io/csrc/lzf.c) built again and held
              to its plain Python version on LZF_CHECK_BYTES of phase
              18's DR store, as stored and shuffled, both ways, exactly;
              its MB/s each way over phase 18's DR store and phase 20's NS
              store in their own chunks; b. the h5py-written NS store of
              tests/_torch_h5_fixture.py read bit for bit; c. both stores
              read, written again through the port's writers (LZF) and as
              an uncompressed copy, each read back: seconds and file
              sizes; d. LZF_STEPS DR flagship fused steps (every FNO
              kernel) from the LZF store and from the uncompressed copy:
              the same losses bit for bit
 24. ckpt    the JAX package's checkpoints without orbax (orbax's
              directory, OCDBT, zarr v2, zstd; utils/orbax_tree.py): a. the
              host C zstd decoder (io/csrc/zstd.c) on zstandard's frames of
              tests/_torch_orbax_fixture.py (levels 1, 3, 19, with and
              without a checksum, one over 128 KiB): the same bytes, its
              MB/s; b. that file's JAX-written checkpoint (a narrow DR FNO,
              the production optimizer's state, meta): every leaf against
              its hash, the forward on the card against JAX's output under
              `highest` (TOL_CKPT_FORWARD); c. the DR flagship on phase 18's
              files through run_training, production and fused step: one
              epoch, the checkpoint read back against the state the trainer
              wrote (params, optax's moments and counts, meta) bit for bit,
              two resumes from copies (continue_training) with the same
              losses bit for bit; d. bytes, write and read seconds of those
              and of phase 22's DR VideoMAE checkpoint (the reference's
              width), read, written again and read back bit for bit

Every phase and sub-phase prints its duration on a ``[time]`` line with
the card's name and power limit.  The probe's row carries phase 0's profiler device time beside torch.mul's.
It prints the kernel table as one JSON line, the card line, a line saying
that no exchange between two cards was checked, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero and
prints no result.  Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

from sciml_pde_torch.utils.profiling import cuda_ms, profiler_ms

# flagship DR shape (configs/config_dr.yaml, the JAX package's bench.py)
B, T0, CC, XY, WIDTH, MODES, PAD, NH = 4, 10, 2, 128, 20, 12, 2, 128
FNO_LAYERS = 4
N_TRAJ, N_T = 10, 101
# kernels vs plain versions, error bound relative to the largest magnitude
# of the plain result: f32 sums in another order (highest); bf16 dot inputs
# whose rounding a different summation order can flip (default).  The
# default bound lies below the gap between bf16 and f32 inputs, which the
# run measures and checks, so a kernel that ignores its precision fails.
TOL = {"highest": 1e-4, "default": 2e-3}
TOL_KERNEL = 1e-3  # one kernel against its plain version, main-path inputs
# fno_mix_wgrad's library call (one complex64 einsum, no TF32) against the
# plain version: f32 sums of B = 4 products in another order
TOL_LIBRARY = 1e-5
# fno_mix_wgrad beyond the main path's calls: batches (the unrolled 1, 4 and
# 8, and 3 through the generic body), widths C = O, and (K, R): the
# flagship's 24 x 12 (16-byte vectors along k * r), 6 x 3 (k * r = 18:
# 8-byte vectors) and 5 x 3 (odd: 4-byte).  The kernel takes every product
# and sum in f32 as JAX writes them, the plain version through einsum (no
# TF32): f32 sums of B products in another order
MIX_BATCHES = (1, 3, 4, 8)
MIX_WIDTHS = (WIDTH, 40, 64)
MIX_KR = ((2 * MODES, MODES), (6, 3), (5, 3))
TOL_MIX = 1e-5
# fno_wdft under `highest` (exact f32 products, no TF32) against its plain
# version: readings were at most 1.2e-7 (gelu'), TF32 inputs ~1e-4
TOL_WDFT_F32 = 1e-5
# fno_lift, fno_head_fwd and fno_head_bwd under `highest` (exact f32
# products on the CUDA cores) against their plain versions: readings were
# at most 8.1e-7 (fno_head_bwd), 0 for the lift; the plain versions on TF32
# inputs lie above the bound (the control).  HEAD_TF32_ARGS: the inputs of
# each that enter a product
TOL_HEAD_F32 = 1e-5
HEAD_TF32_ARGS = {"lift": (0, 1, 4), "head_fwd": (0, 1, 3), "head_bwd": (0, 1, 2, 4)}
# fno_stats beyond the flagship: (what, win shape, offset added to N(0, 1))
STATS_SHAPES = (("X*Y not a multiple of 4", (3, 1, 3, 17, 13), 0.0),
                ("larger than one cluster's shared memory", (1, 10, 1, 256, 256), 0.0),
                ("flagship + 1e3", (B, T0, CC, XY, XY), 1e3))
# gradients against autograd of the independent plain forward in f32 (the
# exact gradient): under `default` the bound covers the bf16-vs-f32 gap
# (up to 9.2e-3 of the largest magnitude on an H100)
TOL_AUTOGRAD = {"highest": 1e-4, "default": 2e-2}
# H100 SXM data-sheet peaks: HBM bytes/s, and FLOP/s for the products'
# input type (f32 outside the tensor cores; bf16 dense)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"highest": 67e12, "default": 989e12}
TF32_FLOPS = 495e12  # dense TF32 on the tensor cores (the f32 attention kernels)
# NS-2D VideoMAE recipe (reference config_transformer_aux_ns.yaml, the JAX
# package's experiments/ns_transformer.py and run_transformer_training)
NS_MODEL = dict(img_size=256, patch_size=16, tubelet_size=2, in_chans=3, num_frames=10,
                encoder_dim=768, encoder_depth=12, encoder_heads=12, decoder_dim=512,
                decoder_depth=8, decoder_heads=8)
NS_BATCH, NS_ACCUM, NS_LR, NS_EPOCHS = 2, 4, 1e-3, 3
NS_TRAJ, NS_T, NS_TEST = 4, 30, 2
NS_LAYERS = NS_MODEL["encoder_depth"] + NS_MODEL["decoder_depth"]
ATT_SHAPES = {"encoder": (NS_BATCH * 12, 1280, 64), "decoder": (NS_BATCH * 8, 1280, 64)}
# shapes the JAX package's kernels take beyond the NS recipe: head dims
# padded in shared memory (96 is plume-3D's decoder, 768 / 8 heads; 24 pads
# to 32; 136 pads to 160, with ragged tiles at 200 tokens), head dims above
# 128 (the f32 forward and dK/dV as one block of two warpgroups per 96-query
# or 64-key tile, the f32 dQ over 32-row tiles; two bf16 blocks per row
# tile, each for half of the output columns), head dims above
# 256 (the wide bodies: ceil(d / 128) column groups, the forward, dQ and
# dK/dV as thread-block clusters of that many ranks up to 1024 (8 ranks);
# above, the forward, dQ and dK/dV as one block per two column groups that
# loops over all of d on the tensor cores (2056: no upper limit); 200 tokens leave ragged row and key tiles), 200 tokens at head
# dim 64 (the tensor-core bodies' ragged tiles), in both dtypes, and
# batch*heads above the 65535 of a grid's y axis
ATT_EXTRA = {"head dim 96": ((16, 1280, 96), ("float32", "bfloat16")),
             "head dim 24": ((16, 1280, 24), ("float32", "bfloat16")),
             "head dim 136": ((8, 200, 136), ("float32", "bfloat16")),
             "head dim 160": ((8, 1280, 160), ("float32", "bfloat16")),
             "head dim 192": ((8, 1280, 192), ("float32", "bfloat16")),
             "head dim 256": ((8, 1280, 256), ("float32", "bfloat16")),
             "head dim 264": ((4, 1280, 264), ("float32", "bfloat16")),
             "head dim 320": ((4, 200, 320), ("float32", "bfloat16")),
             "head dim 512": ((4, 1280, 512), ("float32", "bfloat16")),
             "head dim 1024": ((2, 1280, 1024), ("float32", "bfloat16")),
             "head dim 1032": ((2, 256, 1032), ("float32", "bfloat16")),
             "head dim 1032, ragged": ((2, 200, 1032), ("float32", "bfloat16")),
             "head dim 2056": ((1, 256, 2056), ("float32", "bfloat16")),
             "ragged tiles": ((8, 200, 64), ("float32", "bfloat16")),
             # q and k times 3: scores up to about 54 (the f32 dQ and dK/dV
             # sum each score a k8 step at a time, so that their size does
             # not scale the bias of the MMAs' rounding into p)
             "large logits": ((24, 1280, 64), ("float32",), 3.0),
             "large logits, head dim 256": ((8, 1280, 256), ("float32",), 3.0),
             "large logits, head dim 512": ((4, 1280, 512), ("float32",), 3.0),
             "large logits, head dim 1032": ((2, 256, 1032), ("float32",), 3.0),
             "batch*heads 70000": ((70_000, 16, 16), ("bfloat16",))}
# profiler keys of the attention kernels (their demangled names) at the NS
# head dim: the bf16 tensor-core bodies, and in f32 the split-TF32
# tensor-core bodies
ATT_KERNEL_KEYS = {"bf16": {"attention_fwd": "fwd_tc_kernel<", "attention_dq": "dq_tc_kernel<",
                            "attention_dkv": "dkv_tc_kernel<"},
                   "f32": {"attention_fwd": "fwd_tf32_kernel<", "attention_dq": "dq_tf32_kernel<",
                           "attention_dkv": "dkv_tf32_kernel<"}}
# attention kernels: f32 outputs within 1e-5 of the largest magnitude of the
# exact result (the plain version's arithmetic in f64: att_f64; with q and k
# times 3 at head dim 512 the f32 plain versions themselves lie up to 2.1e-5
# from it), at every head dim with no escape; bf16 outputs against the plain
# version, within one bf16 rounding step of the value (2^-7 of its
# magnitude: the two round f32 results that differ in the last f32 bits)
# plus the f32 bound
ATT_TOL_F32 = 1e-5
BF16_STEP = 2.0**-7
ATT_SITES = {"attention_fwd": "sciml_pde_tpu/ops/attention.py:52",
             "attention_dq": "sciml_pde_tpu/ops/attention.py:98",
             "attention_dkv": "sciml_pde_tpu/ops/attention.py:119"}
# the full-width model through the kernels vs through the plain versions,
# rel-to-max per output (loss and each gradient): f32 sums in another order
# through 20 layers; in bf16 a one-step rounding flip in one attention
# output moves every later bf16 rounding, so the two lie as far apart as
# bf16 noise (7.2e-3 measured on an H100; the bf16-vs-f32 gap is 1.0e-2)
TOL_MODEL = {"f32": 1e-4, "bf16": 2e-2}
FWD_SITE = "sciml_pde_tpu/ops/fno_fused_step.py:942"
BWD_SITE = "sciml_pde_tpu/ops/fno_fused_step.py:972"
KERNEL_SOURCE = {
    "fno_stats": "fwd", "fno_lift": "fwd", "fno_wdft": "fwd", "fno_wdft.adj": "fwd",
    "fno_corner": "fwd", "fno_corner.adj": "fwd", "fno_iwdft_pw": "fwd",
    "fno_iwdft_pw.adj": "fwd", "fno_head_fwd": "fwd", "fno_head_bwd": "bwd",
    "fno_mix_wgrad": "bwd", "fno_outer_partial": "bwd", "fno_reduce_rows": "bwd",
}
# profiler keys of the FNO kernels (their demangled names hold these)
FNO_KERNEL_KEYS = {
    "fno_stats": "stats_kernel", "fno_lift": "lift_kernel", "fno_wdft": "wdft_kernel",
    "fno_wdft.adj": "wdft_kernel", "fno_corner": "corner_kernel",
    "fno_corner.adj": "corner_kernel", "fno_iwdft_pw": "iwdft_pw_kernel",
    "fno_iwdft_pw.adj": "iwdft_pw_kernel", "fno_head_fwd": "head_fwd_kernel",
    "fno_head_bwd": "head_bwd_kernel", "fno_mix_wgrad": "mix_wgrad_kernel",
    "fno_outer_partial": "outer_partial_kernel", "fno_reduce_rows": "reduce_rows_kernel",
}
# fno_wdft's variants, as its callers use them: (what, input, pre dtype,
# gelu_grad, gelu_in); input "h" a layer input, "dh" a layer-output
# cotangent, "pre" a saved pre-activation (f32)
WDFT_VARIANTS = (("forward", "h", None, False, False),
                 ("gelu_in (B2c)", "pre", None, False, True),
                 ("adjoint, pre bf16", "dh", "bfloat16", False, False),
                 ("adjoint, pre bf16, gelu_grad", "dh", "bfloat16", True, False),
                 ("adjoint, pre f32", "dh", "float32", False, False),
                 ("adjoint, pre f32, gelu_grad", "dh", "float32", True, False))
# the records key of the main path's last fno_outer_partial call, the lift
# gradient (``record_calls``)
OUTER_LIFT = "fno_outer_partial (lift)"
# fno_lift, fno_head_fwd and fno_head_bwd at (width C, output channels Co):
# the flagship, and fault C6's widths and channel counts above the 32 and 8
# that the first lift and head kernels held in registers
HEAD_SHAPES = ((WIDTH, CC), (40, 2), (64, 9))
WIDE_WIDTH = 40  # the fused forward and its ten gradients at a C6 width
# fno_corner's variants, as its callers use them: (what, adj, spectrum dtype
# ("dot": the dot dtype), spectrum only)
CORNER_VARIANTS = (("forward, spectrum in the dot dtype (fused)", False, "dot", False),
                   ("forward, f32 spectrum (B1a)", False, "float32", False),
                   ("adjoint", True, "float32", False),
                   ("forward, spectrum only (B2c)", False, "float32", True),
                   ("adjoint, spectrum only (B2c)", True, "float32", True))
# fno_iwdft_pw's variants: (what, adj, gelu, pre dtype ("dot" or "float32"),
# or None where no pre is kept)
IWDFT_VARIANTS = (("forward, gelu, pre in the dot dtype (fused)", False, True, "dot"),
                  ("forward, last layer, pre in the dot dtype", False, False, "dot"),
                  ("forward, gelu, f32 pre (B1a)", False, True, "float32"),
                  ("forward, gelu, no pre (no grad)", False, True, None),
                  ("adjoint", True, False, None))
# fno_corner and fno_iwdft_pw under `highest` (exact f32 products on the CUDA
# cores) against their plain versions: TOL_HEAD_F32, which the plain versions
# on TF32 inputs must exceed.  In outputs kept in bf16 (the fused step's
# spectrum and pre) a kernel that sums in k16 steps rounds an f32 value
# that differs from the plain version's in its last bits, and the two can
# round one bf16 step apart: ``kernel_rel`` holds the f32 values and the
# rounding apart
# the fused forward and its ten gradients at the fields and widths of faults
# C7 and C8: (what, batch, X, Y, width, precisions); 1152 columns pass every
# Wp limit of the first wdft_kernel, width 120 the 113 channels of the first
# outer_partial_kernel (`default` only: the head kernels take 96 under
# `highest`)
C78_FIELDS = (("512^2", 1, 512, 512, WIDTH, ("highest", "default")),
              ("128 x 1152", 2, 128, 1152, WIDTH, ("highest", "default")),
              ("width 120", B, XY, XY, 120, ("default",)))
SPLIT_C78 = (1, 512, 512)  # phase 14's split functions again: batch, X, Y
# Under `default` the end-to-end error at C78_FIELDS is the fields' bf16
# noise: a one-f32-step nudge of the window moves the plain composition
# itself above TOL there (``c78_witness`` prints it).  So `default` holds the
# kernels of faults C7 and C8 (C78_KERNELS) there one by one on the step's
# own inputs (``check_c78_fields``), and the split functions at SPLIT_C78
# against the control: the same functions with C78_KERNELS plain.
C78_KERNELS = ("wdft", "corner", "iwdft_pw", "outer")
# outer_partial_kernel's instances: Bm in f32 or bf16, on the tensor cores
# (`default`) or the CUDA cores
OUTER_INSTANCES = sorted(f"outer_partial_kernel<{s}, {tc}>" for s in ("float", "__nv_bfloat16")
                         for tc in ("true", "false"))
# fno_outer_partial's two instances on the main path: (what, records key)
OUTER_CASES = (("a layer's weight gradient, bf16 pre with gelu", "fno_outer_partial"),
               ("the lift's weight gradient, f32 lift input", OUTER_LIFT))


def swap_ops(base, **fns):
    """The namespace ``base`` (``KERNELS`` or ``PLAIN``) with some functions
    replaced."""
    from types import SimpleNamespace

    return SimpleNamespace(**{**vars(base), **fns})


def c78_control_ops():
    """The kernels' namespace with C78_KERNELS swapped for their plain
    versions: the control of the `default` checks at the C7/C8 fields."""
    from sciml_pde_torch.ops import fno_kernels as fk

    return swap_ops(fk.KERNELS, **{n: getattr(fk.PLAIN, n) for n in C78_KERNELS})


def rr_shapes() -> dict:
    """fno_reduce_rows at the three shapes the fused step gives it under
    `default`: the head backward's partials (one row per persistent block of
    head_bwd_kernel), a layer's and the lift's outer-product partials (one
    row per persistent block of outer_partial_kernel over the padded field
    and over the image)."""
    from sciml_pde_torch.ops import fno_kernels as fk

    return {
        "head backward": (fk.head_bwd_rows(B * XY * XY), NH * WIDTH + NH + CC * NH + CC),
        "a layer's outer": (fk.outer_rows(B * (XY + PAD) ** 2), WIDTH * WIDTH + WIDTH),
        "the lift's outer": (fk.outer_rows(B * XY * XY), WIDTH * (T0 * CC + 2) + WIDTH),
    }


# fused dft2 layer (B6) against its plain f32 version and autograd of it:
# f32 sums in another order; the control (bf16-rounded inputs) must lie more
# than 10x the bound away, so a kernel that rounds or uses TF32 fails
SF_TOL = 1e-5
SF_SITE = "sciml_pde_tpu/ops/spectral_fused.py:63"
# profiler keys of its two kernels (the layer's device time is their sum)
SF_KERNEL_KEYS = ("sf_spectrum_kernel", "sf_inverse_kernel")
SF_FLAGSHIP = (B, XY + PAD, XY + PAD, WIDTH, WIDTH, MODES, MODES)  # phase 10's layer
# the fused dft2 layer beyond the flagship: (B, H, W, Ci, Co, modes1,
# modes2): the JAX test's shape, an odd one, an H that the cluster's bands of
# ceil(H / 16) rows do not divide (67: fourteen bands of 5, the last 2, with
# K * Ci = 35: the kernels' 4 x 4 tiles take strided columns), the NS-2D
# layer (config_ns.yaml: 256^2, width 20, modes 12; chunks of 2 rows), 16
# ranks of 8 rows (the largest cluster), 2 * modes1 > H, and the shapes that
# take the plan's smaller layouts (ops/spectral_fused.py::plan): passes over
# the modes with chunks of 1 row, passes over the corner rows, blocks of part
# of W, blocks of 1 row, the corner rows staged in halves
SF_SHAPES = {"JAX test": (2, 18, 18, 6, 6, 4, 4), "odd": (1, 13, 11, 5, 3, 3, 4),
             "bands not dividing H": (3, 67, 50, 7, 5, 8, 5),
             "NS-2D layer": (1, 256, 256, 20, 20, 12, 12),
             "16 ranks": (1, 128, 128, 20, 20, 12, 12),
             "2 modes1 > H": (1, 6, 10, 4, 3, 4, 3),
             "mode passes": (1, 32, 32, 128, 4, 16, 16),
             "corner-row passes": (1, 4, 4, 128, 1, 96, 1),
             "column tiles": (1, 4, 512, 1, 1, 64, 32),
             "1-row blocks": (1, 4, 512, 1, 8, 16, 32),
             "corner rows staged": (1, 4, 4, 1, 1, 64, 64)}
PROBE_SITE = "experiments/spectral_impl_bench.py:106"
# phase 0: launches of the probe and of torch.mul(x, 2) in one profiler
# session, and the profiler key of torch.mul's kernel
# (vectorized_elementwise_kernel<4, AUnaryFunctor<..., MulFunctor>>)
PROBE_REPS, MUL_KEY = 200, "elementwise_kernel"
# production step against the fused step over 10 steps under `highest`: the
# JAX package's drop-in bounds (tests/test_fast_step.py)
PROD_STEPS, PROD_RTOL, PARAM_RTOL, PARAM_ATOL = 10, 2e-3, 5e-3, 1e-5
TOL_FORWARD = 1e-5  # the plain FNO2d on the card vs the CPU in f32 (TF32 guard)
# the five split functions (B1a-B2c): each a sequence of the stage kernels
SPLIT_SITE = "sciml_pde_tpu/ops/fno_fused_step.py"
SPLIT_ROWS = {  # name: (TPU kernel body line, sources, packed params read)
    "bb_forward": (494, ("fwd",), ("wmr", "wmi", "pw", "pb", "w0t", "b0")),
    "head_forward": (542, ("fwd",), ("w1t", "b1", "w2t", "b2")),
    "head_backward": (559, ("bwd",), ("w1t", "b1", "w2t")),
    "bb_backward": (594, ("fwd", "bwd"), ("wmr", "wmi", "pw")),
    "bb_weight_grads": (636, ("fwd", "bwd"), ()),
}
SPLIT_STAGES = {  # stage-kernel launches of one call of each
    "bb_forward": {"fno_stats": 1, "fno_lift": 1, "fno_wdft": 4, "fno_corner": 4,
                   "fno_iwdft_pw": 4},
    "head_forward": {"fno_head_fwd": 1},
    "head_backward": {"fno_head_bwd": 1, "fno_reduce_rows": 1},
    "bb_backward": {"fno_lift": 1, "fno_wdft.adj": 4, "fno_corner.adj": 4,
                    "fno_iwdft_pw.adj": 4, "fno_outer_partial": 1, "fno_reduce_rows": 1},
    "bb_weight_grads": {"fno_wdft": 8, "fno_corner": 4, "fno_corner.adj": 4,
                        "fno_mix_wgrad": 4, "fno_outer_partial": 4, "fno_reduce_rows": 4},
}
TOL_SPLIT_CHAIN = 1e-4  # the five chained vs the plain fused VJP, `highest`
# steps per scan in the probe phase (the probe's own default is 200; 50 before a
# depth cut: its prod and fused configs time four scans each)
PROBE_SCAN_K = 25
# phase 4b: the rollout evaluation of phase 4's checkpoint, on the card against
# the CPU (relative, per metric): f32 sums in another order through the model,
# compounding over the unrolled steps
EVAL_ROLLOUTS = {1: 1e-4, 5: 1e-3}  # rollout_test: tolerance
# the aux store (the downsampled DR file's shape, 50 frames at 96^2), its
# pairing and loss weight (configs/config_dr.yaml)
AUX_T, AUX_XY, AUX_NA, AUX_WEIGHT = 50, 96, 3, 0.7
TOL_RESIZE = 1e-6  # the trilinear upsample on the card vs the CPU, rel-to-max
TOL_AUX_STEP = 1e-4  # one aux step on the card vs the CPU (`highest`), relative
# phase 16: the FNO on NS-2D (configs/config_ns.yaml; the JAX package's
# experiments/ns_production.py:179: batch 16 for the baseline, 8 with 24 aux
# samples for aux) on a seeded store of 4 train trajectories x 50 frames (1
# test), the aux store at 128^2 (48 trajectories x 30 frames, the primary 2 x
# 30); and the 3D FNO at configs/config_ns_3d.yaml's shape (3 primary, 9 aux
# trajectories x 20 frames)
NSF_B, NSF_XY, NSF_C, NSF_TRAJ, NSF_T = 16, 256, 3, 4, 50
NSF_AUX_B, NSF_AUX_NA, NSF_AUX_XY, NSF_AUX_T = 8, 24, 128, 30
NS3D_SP, NS3D_C, NS3D_MODES, NS3D_NA, NS3D_TRAJ, NS3D_T = (50, 50, 89), 4, 8, 3, 3, 20
# one aux step with aux_chunks 4 against 1 (`highest`): the same sums per
# sample, chunked; remat against no remat (`highest`): the same products
# recomputed
TOL_CHUNKS, TOL_REMAT = 1e-5, 1e-6
# phase 17: NS VideoMAE aux joint training (ROADMAP A5) at the JAX package's
# experiments/ns_transformer.py recipe: 3 aux windows a primary window, aux
# weight 0.7, separate per-pixel heads, --aux-grid 128 (the aux store at 128^2
# in bf16, upsampled at the gather).  The trunk's batch is 2 + 6 = 8, so the
# attention kernels run at (96, 1280, 64) in the encoder and (64, 1280, 64) in
# the decoder.  17c runs the card against the CPU at encoder 2 and decoder 1
# blocks (full width, 1280 tokens); 17i the 3D VideoMAE at the plume shape at
# the same depth.
AUXT_NA, AUXT_W, AUXT_XY, AUXT_EPOCHS = 3, 0.7, 128, 2
AUXT_ATT_SHAPES = {"aux encoder": (NS_BATCH * (1 + AUXT_NA) * 12, 1280, 64),
                   "aux decoder": (NS_BATCH * (1 + AUXT_NA) * 8, 1280, 64)}
AUXT_ROWS = tuple(f"{name} ({where})" for where in AUXT_ATT_SHAPES
                  for name in ("attention_fwd", "attention_dq", "attention_dkv"))
SHALLOW = dict(encoder_depth=2, decoder_depth=1)
# phase 18: the DR files at the generation config (sim/diff_react.py
# DiffReactConfig: 128^2, 101 frames, t 5.0): 10 primary seeds, the 90/10
# split's 9 train and 1 test, and 4 of the diff form (basic_ds2's aux pool
# takes 3); each sim_type held to the CPU over its first 6 frames (the same
# frame step and substeps as the 101-frame run: a depth cut)
DR_SEEDS, DR_DIFF_SEEDS, DR_CHECK_FRAMES, TOL_SIM = 10, 4, 6, 1e-5
# NS-2D at the production grid and step (sim/ns_incomp_2d.py NSIncompConfig:
# 256^2, nu 0.05, dt 5e-5; the files hold 100,000 steps), 2 trajectories: the
# DCT file cut to 201 steps (a frame each 50), the CG file to 11 (each 5; a
# CG step takes hundreds of iterations, and its time is read over the
# generator's own 10 steps): depth cuts.  The card against the CPU over
# NS_CPU_STEPS momentum steps (a depth cut from 10; about 0.5 s a step on the
# CPU under each solver) within 1e-4.  The projection's bound, max(1e-4 x the divergence
# before, 1e-4), is tests/test_ns_incomp.py::test_projection_removes_divergence's
# at its grid (24^2, tol 1e-5, 2000 iterations); at 256^2 the f32 solve
# itself leaves more (JAX's DCT projection of its PRNGKey(1) state on the
# CPU: 90.0 -> 2.68e-2, 3.0e-4 of before;
# tests/test_torch_sim_ns.py::test_projection_at_the_production_grid), so
# there the card is held to NS_DIV_256 x the divergence before, and to
# NS_DIV_CPU x the CPU's divergence after the same projection
NS_GEN = {"dct": (201, 50), "cg": (11, 5)}  # solver: (n_steps, frame_int)
NS_GEN_BATCH, TOL_NS_STEPS, NS_DIV_256, NS_DIV_CPU, NS_CPU_STEPS = 2, 1e-4, 1e-3, 2.0, 5
NS_TEST_CFG = dict(grid_size=(24, 24), dt=1e-3, n_steps=6, frame_int=2, n_batch=2, nu=0.01)
# phase 19: the rest of the simulators (ROADMAP A7).  19a: one plume
# trajectory at the production config (sim/ns_plume_3d.py Plume3DConfig:
# (50, 50, 89), 150 frames x 10 substeps, DCT), held to the CPU over its
# first PLUME_CPU_FRAMES frames (TOL_PLUME: f32 sums in another order
# through the DCT's contractions, compounding over 20 substeps); the
# projection's divergence below PLUME_DIV x the divergence before (DCT;
# 4.4e-6 on the CPU) and PLUME_DIV_CG x before (CG at its rel tol 1e-3;
# 4.4e-4 on the CPU); PLUME_CG_STEPS substeps of the CG solver against the
# DCT from the same state within PLUME_CG_TOL of each field's largest
# magnitude (CG's rel tol 1e-3; 3.5e-5 on the CPU); PLUME_GRAPH_FRAMES frames
# replayed as CUDA graphs against the same frames op by op (1e-6: the same
# kernels in the same order).  19b: the port's
# experiments/plume3d_parity.py at full width (grid (50, 50, 89), FNO width
# 20, modes 12, initial_step 10) at a cut depth: PARITY_ARGS.  19c: Burgers
# at its defaults (32 x 201 x 1024), the card against the CPU over 2 frames
# (TOL_SIM) and the mean conserved within 1e-5 (the JAX test's bound).  19d:
# Darcy, one batch of 64 at 128^2 (tol 1e-8): each sample's residual
# |A u - beta| / |beta| below DARCY_RES (f32 CG stalls there: JAX's own solve
# of a batch of 2 reads 2.2e-3 and 1.7e-3 on the CPU), and a batch of 2 on
# the card against the CPU within TOL_DARCY_CARD.  19e: BVP, BVP_CASES
# electro and magneto cases at grid 128, the card against the CPU (data_x
# equal, data_y within TOL_SIM of each column's largest magnitude).  19f: one
# airfoil sample at the default 384^2 with AIRFOIL_FRAMES frames (a depth
# cut), AIRFOIL_STEPS steps on the card against the CPU within TOL_AIRFOIL of
# each field's largest magnitude (f32 rounding through steps whose minmod
# branches can flip on one ulp; 8.5e-6 against JAX over 34 steps on the CPU)
PLUME_CPU_FRAMES, TOL_PLUME, PLUME_DIV, PLUME_DIV_CG = 2, 1e-4, 1e-4, 1e-2
PLUME_CG_STEPS, PLUME_CG_TOL, PLUME_GRAPH_FRAMES = 5, 1e-3, 10
PARITY_FRAMES = 20  # 30 before a depth cut: 10 windows a trajectory
PARITY_ARGS = ["--n-primary", "2", "--aux-primary", "1", "--n-aux-per", "3", "--n-test", "1",
               "--frames", str(PARITY_FRAMES), "--epochs", "1"]
DARCY_RES, TOL_DARCY_CARD, BVP_CASES = 1e-2, 1e-4, 20
AIRFOIL_FRAMES, AIRFOIL_STEPS, TOL_AIRFOIL = 6, 10, 1e-4  # steps 20 before a depth cut
# the generators' configurations phase 19 runs (their defaults but the
# airfoil's frames); each a dict of keyword arguments
SIM_PLUME = {}  # Plume3DConfig
SIM_BURGERS = dict(n_samples=32, nx=1024, n_frames=201, t_final=2.0, batch=32)
SIM_DARCY = dict(n_samples=64, nx=128, batch=64)
SIM_BVP = dict(grid=128)  # BVPConfig
SIM_AIRFOIL = dict(n_frames=AIRFOIL_FRAMES)  # AirfoilConfig

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def phase_done(card: str, what: str, t0: float) -> float:
    """Print how long ``what`` took since ``t0`` on a ``[time]`` line with
    the card's name and power limit; returns the time now."""
    now = time.perf_counter()
    print(f"[time] {card}: {what} in {now - t0:.1f} s", flush=True)
    return now


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, that over the largest magnitude of ``want``)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


def tensors(x) -> list:
    """The tensors of a tensor or of a nested tuple or list."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in tensors(y)] if isinstance(x, (tuple, list)) else []


def worst(outs_a, outs_b) -> tuple[float, float]:
    """The largest (max abs error, rel-to-max error) over paired outputs."""
    errs = [rel_err(a, b) for a, b in zip(tensors(outs_a), tensors(outs_b))]
    return max(e for e, _ in errs), max(r for _, r in errs)


def f32_call(fname: str, args: tuple):
    """The arguments of the same call with the output it keeps in bf16
    (``corner``'s spectrum, ``iwdft_pw``'s pre) kept in f32, or None where
    it keeps none in bf16."""
    import torch

    at = {"corner": 5, "iwdft_pw": 6}.get(fname)
    if at is None or args[at] != torch.bfloat16:
        return None
    return args[:at] + (torch.float32,) + args[at + 1:]


def kernel_rel(fname: str, args: tuple, got) -> tuple[float, bool]:
    """(the largest rel-to-max error of ``got``, the outputs of ``fno_kernels``'
    ``fname`` on ``args``, against its plain version; whether every output
    kept in bf16 is exactly its f32 value rounded).  Where the call keeps an
    output in bf16, the error is that of the same call with that output in
    f32 (the kernel's and the plain version's sums before rounding, which
    can round one bf16 step apart), and each output of ``got`` must equal
    that call's, rounded to its dtype, bit for bit."""
    import torch
    from sciml_pde_torch.ops import fno_kernels as fk

    full, pfn = f32_call(fname, args), getattr(fk, f"{fname}_plain")
    if full is None:
        return worst(got, pfn(*args))[1], True
    kout = getattr(fk, fname)(*full)
    exact = all(torch.equal(g, k.to(g.dtype)) for g, k in zip(tensors(got), tensors(kout)))
    return worst(kout, pfn(*full))[1], exact


def tf32(t):
    """f32 ``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away),
    as a TF32 tensor-core product reads it."""
    import torch

    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def moved_bytes(fname: str, args, out) -> int:
    """The bytes one FNO kernel call must move: each tensor input read once,
    each output written once.  ``wdft`` reads ``pre`` only with
    ``gelu_grad`` (args: x, fac, pre, gelu_grad, ...); the head kernels read
    only the logical (X, Y) region of ``hf`` (B, C, Hp, Wp) (args: hf, ...,
    x, y and dpred (B, Co, X, Y), hf, ...)."""
    ins = list(args)
    if fname == "wdft" and len(ins) > 3 and not ins[3]:
        ins[2] = None
    if fname == "head_fwd":
        ins[0] = ins[0][:, :, :ins[7], :ins[8]]
    if fname == "head_bwd":
        ins[1] = ins[1][:, :, :ins[0].shape[2], :ins[0].shape[3]]
    return sum(t.numel() * t.element_size() for t in tensors(ins) + tensors(out))


def kernel_flops(fname: str, args, out) -> int:
    """The floating-point operations one FNO kernel call needs (a multiply-add
    counts 2)."""
    if fname == "stats":
        return 4 * args[0].numel()
    if fname == "lift":
        h0, finp = out
        return 2 * finp.numel() * h0.shape[1]
    if fname == "wdft":
        x, fac = args[0], args[1]
        return 2 * (x.numel() // fac.shape[0]) * fac.numel()
    if fname == "corner":
        a, (pr, _), (w, _), d = args[0], args[1], args[2], out[2]
        bsz, cin, hp, k2 = a.shape
        r = pr.shape[1]
        if d is None:  # spectrum only
            return bsz * (k2 // 2) * 8 * cin * r * hp
        cout = d.shape[1]
        return bsz * (k2 // 2) * 8 * (cin * r * hp + cout * r * cin + cout * hp * r)
    if fname == "iwdft_pw":
        d, xin, o = args[0], args[2], out[0]
        return 2 * o.numel() * (d.shape[-1] + xin.shape[1])
    if fname == "head_fwd":
        hf, w1t, w2t, pr = args[0], args[1], args[3], out
        npix = pr.shape[0] * pr.shape[2] * pr.shape[3]
        return 2 * npix * (w1t.numel() + w2t.numel())
    if fname == "head_bwd":
        dpred, w1t, w2t = args[0], args[2], args[4]
        npix = dpred.shape[0] * dpred.shape[2] * dpred.shape[3]
        return 2 * npix * (3 * w1t.numel() + 2 * w2t.numel())
    if fname == "mix_wgrad":
        spr, dcr = args[0], args[2]
        return 8 * spr.numel() * dcr.shape[1]
    if fname == "outer":
        a, bm, nh, nw = args[0], args[1], args[3], args[4]
        return 2 * a.shape[0] * nh * nw * a.shape[1] * (bm.shape[1] + 1)
    if fname == "reduce_rows":
        return args[0].numel()
    raise KeyError(fname)


def fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def device_profile(card: str, run, n: int, unit: str, unprofiled_ms: float, ours) -> None:
    """Run ``run()`` (``n`` units of work) under torch.profiler and print the
    wall time, the device-busy share (kernel time on the card over wall
    time), the share of it in kernels whose name holds one of ``ours``, and
    the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [ev for ev in prof.key_averages() if ev.device_type.name == "CUDA"]
    busy_us = sum(ev.self_device_time_total for ev in evs)
    if busy_us == 0:
        print("[profile] the profiler recorded no device time: not measured", flush=True)
        return
    mine = sum(ev.self_device_time_total for ev in evs if any(k in ev.key for k in ours))
    print(f"[profile] {card}: {n} {unit}s, wall {wall_us / n:.1f} us/{unit} (profiler on), "
          f"device busy {busy_us / n:.1f} us/{unit} = {100 * busy_us / wall_us:.1f}% (idle "
          f"{100 - 100 * busy_us / wall_us:.1f}%), of it the port's kernels "
          f"{100 * mine / busy_us:.1f}%; device busy over the unprofiled {unit} "
          f"{unprofiled_ms * 1e3:.1f} us = {100 * busy_us / n / (unprofiled_ms * 1e3):.1f}%",
          flush=True)
    for ev in sorted(evs, key=lambda ev: -ev.self_device_time_total)[:12]:
        print(f"[profile]   {ev.self_device_time_total / n:9.1f} us/{unit} "
              f"{ev.count / n:6.1f}x  {ev.key[:90]}", flush=True)


def print_mix_wgrad_sass() -> None:
    """Phase 2: the order of each mix_wgrad_kernel instance's global loads,
    f32 arithmetic and global stores in its SASS (ptxas interleaves
    products with the later loads)."""
    from sciml_pde_torch.ops import _build

    kernels = _build.sass(_build.library_path("fno_bwd"))
    for kern in sorted(k for k in kernels if k.startswith("mix_wgrad_kernel<")):
        print(f"[build] fno_bwd.cu {kern} in SASS (L global loads, F f32 arithmetic, S global "
              f"stores): {_build.memory_order(kernels[kern])}", flush=True)


def plain_call(fname: str, args: tuple):
    from sciml_pde_torch.ops import fno_kernels as fk

    return getattr(fk, f"{fname}_plain")(*args)


def check_kernels(records: dict, tag: str) -> dict:
    """Every FNO kernel of KERNEL_NAMES against its plain version on the
    recorded main-path inputs ``records`` (``record_calls``), under the
    current precision: the error, the same bits for outputs kept in bf16, the
    bf16-vs-f32 control; its time in events beside its plain version's, its
    library call's and its bound, then each device time (torch.profiler).
    Returns the kernel table's rows (launches 0)."""
    import torch
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral

    def library_fn(key, fname, args):
        if key == "fno_stats":
            return lambda: torch.std_mean(args[0], dim=(1, 3, 4))
        if key in ("fno_wdft", "fno_wdft.adj"):
            return lambda: torch.matmul(args[0], args[1])
        if key == "fno_reduce_rows":
            return lambda: torch.sum(args[0], dim=0)
        if key == "fno_mix_wgrad":  # dwr + i dwi = sum_b conj(spec) * dspec
            x = torch.complex(args[0].float(), args[1].float())
            gc = torch.complex(args[2], args[3])
            return lambda: torch.einsum("bckr,bokr->cokr", x.conj(), gc)
        return None

    kernel_rows = {}
    for key in fk.KERNEL_NAMES:
        fname, args, kw = records[key]
        kfn = getattr(fk, fname)
        out_k = kfn(*args, **kw)
        out_p = plain_call(fname, args)
        worst_abs, raw_rel = worst(out_k, out_p)
        worst_rel, exact = kernel_rel(fname, args, out_k)
        # control: the kernel lies nearer its plain version than the plain
        # version with f32 dot inputs does (kernels that take ``bf``)
        gap = None
        if fname not in ("stats", "mix_wgrad", "reduce_rows") and args[-1] is True:
            gap = worst(plain_call(fname, args[:-1] + (False,)), out_p)[1]
        torch.cuda.synchronize()
        check(worst_rel <= TOL_KERNEL and exact and (gap is None or worst_rel < gap / 2),
              f"{tag} {key}: max abs err {worst_abs:.3e}, rel-to-max {raw_rel:.3e} "
              f"({worst_rel:.3e} before bf16 rounding; tol {TOL_KERNEL:.0e}; bf16 outputs its "
              f"f32 values rounded: {exact}; plain bf16-vs-f32 gap "
              + ("n/a" if gap is None else f"{gap:.3e}") + ")")
        nbytes = moved_bytes(fname, args, out_k)
        fl = kernel_flops(fname, args, out_k)
        peak = PEAK_FLOPS[spectral.get_dft_precision()]
        bound_s = max(nbytes / HBM_BPS, fl / peak)
        lib = library_fn(key, fname, args)
        if key == "fno_mix_wgrad":  # the library call computes the same function
            got_lib = lib()
            lib_rel = worst((got_lib.real, got_lib.imag), out_p)[1]
            check(lib_rel <= TOL_LIBRARY, f"{tag} fno_mix_wgrad's library call (complex64 "
                  f"einsum of conj(spec) and dspec) vs the plain version: rel-to-max "
                  f"{lib_rel:.3e} (tol {TOL_LIBRARY:.0e})")
        kernel_rows[key] = {
            "name": key, "route": "cuda",
            "source": f"sciml_pde_torch/ops/csrc/fno_{KERNEL_SOURCE[key]}.cu",
            "replaces": FWD_SITE if KERNEL_SOURCE[key] == "fwd" else BWD_SITE,
            "launches": 0, "max_abs_err": worst_abs,
            "ms": cuda_ms(lambda: kfn(*args, **kw)),
            "plain_ms": cuda_ms(lambda: plain_call(fname, args)),
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BPS >= fl / peak else "operations",
            "library_ms": cuda_ms(lib) if lib is not None else None,
        }

    # every row's device time (torch.profiler), and its library call's
    for key in fk.KERNEL_NAMES:
        fname, args, kw = records[key]
        kfn, lib = getattr(fk, fname), library_fn(key, fname, args)
        bound_ms = kernel_rows[key]["bound_ms"]
        kernel_rows[key]["device_ms"] = profiler_ms(lambda: kfn(*args, **kw),
                                                    FNO_KERNEL_KEYS[key], bound_ms=bound_ms)
        kernel_rows[key]["library_device_ms"] = (None if lib is None
                                                 else profiler_ms(lib, bound_ms=bound_ms))
    return kernel_rows


def check_mix_wgrad(dev) -> None:
    """Phase 3: fno_mix_wgrad against its plain version (TOL_MIX) and a
    second launch of itself (the same bits) at every batch of MIX_BATCHES
    and width of MIX_WIDTHS at the flagship's modes, and at the other
    (K, R) of MIX_KR at the flagship width, each with a bf16 and an f32
    spectrum."""
    import torch
    from sciml_pde_torch.ops import fno_kernels as fk

    g = torch.Generator().manual_seed(12)
    cases = [(b, w, MIX_KR[0]) for b in MIX_BATCHES for w in MIX_WIDTHS]
    cases += [(b, WIDTH, kr) for kr in MIX_KR[1:] for b in MIX_BATCHES]
    for b, w, (k, r) in cases:
        for sdt in (torch.bfloat16, torch.float32):
            spr, spi = (torch.randn(b, w, k, r, generator=g).to(dev, sdt) for _ in range(2))
            dcr, dci = (torch.randn(b, w, k, r, generator=g).to(dev) for _ in range(2))
            got = fk.mix_wgrad(spr, spi, dcr, dci)
            again = fk.mix_wgrad(spr, spi, dcr, dci)
            want = fk.mix_wgrad_plain(spr, spi, dcr, dci)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            err, rel = worst(got, want)
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            check(same and finite and rel <= TOL_MIX,
                  f"[kernel] fno_mix_wgrad B {b}, C = O = {w}, (K, R) = ({k}, {r}), spectrum "
                  f"{str(sdt)[6:]}: max abs err {err:.3e}, rel-to-max {rel:.3e} (tol "
                  f"{TOL_MIX:.0e}); same bits twice {same}")


def check_stats(dev) -> None:
    """Phase 3: ``fno_stats`` against its plain version beyond the flagship
    shape: X*Y not a multiple of 4 (misaligned runs), a pair larger than
    one cluster's shared memory, and the flagship with a +1e3 offset, where
    a one-pass E[x^2] - E[x]^2 (the control) must lie outside the bound
    that the kernel meets."""
    import torch
    from sciml_pde_torch.ops import fno_kernels as fk

    g = torch.Generator().manual_seed(10)
    for what, shape, off in STATS_SHAPES:
        win = (torch.randn(*shape, generator=g) + off).to(dev)
        got, want = fk.stats(win), fk.stats_plain(win)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        worst_rel = max(r for _, r in errs)
        msg = (f"[kernel] fno_stats {what} {shape}: max abs err {max(e for e, _ in errs):.3e}, "
               f"rel-to-max {worst_rel:.3e} (tol {TOL_KERNEL:.0e})")
        ok = all(bool(torch.isfinite(t).all()) for t in got) and worst_rel <= TOL_KERNEL
        if off:
            n = shape[1] * shape[3] * shape[4]
            mean = win.mean(dim=(1, 3, 4))
            var1 = ((win * win).mean(dim=(1, 3, 4)) - mean * mean) * (n / (n - 1))
            ctl = rel_err(torch.sqrt(var1.clamp_min(0)) + 1e-7, want[1])[1]
            ok &= ctl > TOL_KERNEL
            msg += f"; control: one-pass std {ctl:.3e} from the plain version, above the tol"
        check(ok, msg)


def check_wdft(dev, card: str, h, dh, pre) -> None:
    """Phase 3: ``fno_wdft`` in every variant of WDFT_VARIANTS at the
    flagship shape under `highest` and `default`: against its plain version
    within TOL_KERNEL, under `default` also below half the plain bf16-vs-f32
    gap, under `highest` within TOL_WDFT_F32, which the plain version with
    TF32 products must exceed (the control); the same bits from a second
    launch, and its profiler device time beside its bound and ``matmul``'s
    device time on the same input.  ``h``, ``dh`` and ``pre`` (B, C, Hp, Wp)
    f32 come from the main path."""
    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk

    hp, wp = h.shape[2:]
    inputs = {"h": h, "dh": dh, "pre": pre}
    for prec, bf in (("highest", False), ("default", True)):
        f = ff.kernel_factors(hp, wp, MODES, MODES, str(dev), bf)
        for what, src, pre_dt, gelu_grad, gelu_in in WDFT_VARIANTS:
            fac = f.fwd_w if src != "dh" else f.adj_w
            pr = None if pre_dt is None else pre.to(getattr(torch, pre_dt))
            args = (inputs[src], fac, pr, gelu_grad)
            got, again = fk.wdft(*args, bf, gelu_in), fk.wdft(*args, bf, gelu_in)
            want = fk.wdft_plain(*args, bf, gelu_in)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(tensors(got), tensors(again)))
            err, rel = worst(got, want)
            finite = all(bool(torch.isfinite(t).all()) for t in tensors(got))
            msg = (f"[kernel] fno_wdft {what} {prec} {tuple(h.shape)}: max abs err {err:.3e}, "
                   f"rel-to-max {rel:.3e} (tol {TOL_KERNEL:.0e}); same bits twice {same}")
            ok = finite and same and rel <= TOL_KERNEL
            if bf:
                gap = worst(fk.wdft_plain(*args, False, gelu_in), want)[1]
                ok &= rel < gap / 2
                msg += f"; plain bf16-vs-f32 gap {gap:.3e}"
            else:
                v = want[1] if pr is not None else fk._gelu(args[0]) if gelu_in else args[0]
                ctl = rel_err(torch.matmul(tf32(v), tf32(fac)), tensors(want)[0])[1]
                ok &= rel <= TOL_WDFT_F32 < ctl
                msg += (f"; f32 tol {TOL_WDFT_F32:.0e}; control: plain with TF32 inputs "
                        f"{ctl:.3e}, above it")
            check(ok, msg)
            by_bytes = moved_bytes("wdft", args, got) / HBM_BPS
            by_ops = 2 * (args[0].numel() // fac.shape[0]) * fac.numel() / PEAK_FLOPS[prec]
            by = "bytes" if by_bytes >= by_ops else "operations"
            bound_ms = max(by_bytes, by_ops) * 1e3
            bound = f"{bound_ms:.5f} ms ({by})"
            dev_ms = profiler_ms(lambda: fk.wdft(*args, bf, gelu_in), "wdft_kernel",
                                 bound_ms=bound_ms)
            lib_ms = profiler_ms(lambda: torch.matmul(args[0], fac), bound_ms=bound_ms)
            print(f"[timing] {card}: fno_wdft {what} {prec}: profiler device time "
                  f"{fmt(dev_ms)}; bound {bound}; matmul {fmt(lib_ms)}",
                  flush=True)


def check_reduce_rows(dev, card: str) -> None:
    """Phase 3: ``fno_reduce_rows`` at the three shapes of ``rr_shapes`` against
    its plain version within TOL_KERNEL, the same bits from a second launch,
    and its time (CUDA events and profiler device time) beside its bound
    and ``torch.sum(part, 0)``'s."""
    import torch
    from sciml_pde_torch.ops import fno_kernels as fk

    g = torch.Generator().manual_seed(12)
    for what, shape in rr_shapes().items():
        part = torch.randn(*shape, generator=g).to(dev)
        got, again, want = fk.reduce_rows(part), fk.reduce_rows(part), fk.reduce_rows_plain(part)
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        same = bool(torch.equal(got, again))
        check(bool(torch.isfinite(got).all()) and same and rel <= TOL_KERNEL,
              f"[kernel] fno_reduce_rows {what} {shape}: max abs err {err:.3e}, rel-to-max "
              f"{rel:.3e} (tol {TOL_KERNEL:.0e}); same bits twice {same}")
        bound_ms = (part.numel() + shape[1]) * 4 / HBM_BPS * 1e3
        dev_ms = profiler_ms(lambda: fk.reduce_rows(part), "reduce_rows_kernel",
                             bound_ms=bound_ms)
        print(f"[timing] {card}: fno_reduce_rows {what} {shape}: "
              f"{cuda_ms(lambda: fk.reduce_rows(part)):.4f} ms/launch, profiler device time "
              f"{fmt(dev_ms)}; "
              f"bound {bound_ms:.5f} ms (bytes); torch.sum(part, 0) "
              f"{cuda_ms(lambda: torch.sum(part, dim=0)):.4f} ms, profiler device time "
              f"{fmt(profiler_ms(lambda: torch.sum(part, dim=0), bound_ms=bound_ms))}",
              flush=True)


def check_head(dev, card: str) -> None:
    """Phase 3: ``fno_lift``, ``fno_head_fwd`` and ``fno_head_bwd`` at the
    (C, Co) of HEAD_SHAPES under `highest` and `default`, on seeded inputs of
    the flagship's batch and image: each against its plain version within
    TOL_KERNEL, under `default` also below half the plain bf16-vs-f32 gap,
    under `highest` within TOL_HEAD_F32, which the plain version on TF32
    inputs must exceed (the control), and the same bits from a second
    launch; the head kernels' CUDA-event and profiler device times beside
    their bounds and plain times."""
    import torch
    from sciml_pde_torch.ops import fno_kernels as fk

    g = torch.Generator().manual_seed(13)
    hp = XY + PAD
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(dev)  # noqa: E731
    uni = lambda *shape: (2 * torch.rand(*shape, generator=g) - 1).to(dev)  # noqa: E731
    for c, co in HEAD_SHAPES:
        f = T0 * co + 2
        win, grid2 = rnd(B, T0, co, XY, XY), torch.rand(2, XY, XY, generator=g).to(dev)
        mean, std = fk.stats_plain(win)
        w0t, b0 = uni(c, f) / f**0.5, uni(c) / f**0.5
        hf, dpred = rnd(B, c, hp, hp), rnd(B, co, XY, XY)
        w1t, b1 = uni(NH, c) / c**0.5, uni(NH) / c**0.5
        w2t, b2 = uni(co, NH) / NH**0.5, uni(co) / NH**0.5
        for prec, bf in (("highest", False), ("default", True)):
            rd = lambda t: fk._rd(t, bf)  # noqa: E731
            cases = {"fno_lift": ("lift", (win, grid2, mean, std, rd(w0t), b0, hp, hp)),
                     "fno_head_fwd": ("head_fwd", (hf, rd(w1t), b1, rd(w2t), b2, mean, std,
                                                   XY, XY)),
                     "fno_head_bwd": ("head_bwd", (dpred, hf, rd(w1t), b1, rd(w2t), std))}
            for key, (fname, args) in cases.items():
                kfn, pfn = getattr(fk, fname), getattr(fk, f"{fname}_plain")
                got, again, want = kfn(*args, bf), kfn(*args, bf), pfn(*args, bf)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(tensors(got), tensors(again)))
                err, rel = worst(got, want)
                finite = all(bool(torch.isfinite(t).all()) for t in tensors(got))
                ok = finite and same and rel <= TOL_KERNEL
                msg = (f"[kernel] {key} C={c} Co={co} {prec}: max abs err {err:.3e}, rel-to-max "
                       f"{rel:.3e} (tol {TOL_KERNEL:.0e}); same bits twice {same}")
                if bf:
                    gap = worst(pfn(*args, False), want)[1]
                    ok &= rel < gap / 2
                    msg += f"; plain bf16-vs-f32 gap {gap:.3e}"
                else:
                    ctl_args = tuple(tf32(a) if i in HEAD_TF32_ARGS[fname] else a
                                     for i, a in enumerate(args))
                    ctl = worst(pfn(*ctl_args, False), want)[1]
                    ok &= rel <= TOL_HEAD_F32 < ctl
                    msg += (f"; f32 tol {TOL_HEAD_F32:.0e}; control: plain with TF32 inputs "
                            f"{ctl:.3e}, above it")
                check(ok, msg)
                if key == "fno_lift" or (c, co) != HEAD_SHAPES[0]:
                    continue
                out = kfn(*args, bf)
                by_b = moved_bytes(fname, args, out) / HBM_BPS
                by_o = kernel_flops(fname, args, out) / PEAK_FLOPS[prec]
                by = "bytes" if by_b >= by_o else "operations"
                bound_ms = max(by_b, by_o) * 1e3
                dev_ms = profiler_ms(lambda: kfn(*args, bf), FNO_KERNEL_KEYS[key],
                                     bound_ms=bound_ms)
                print(f"[timing] {card}: {key} {prec} (C={c}, Co={co}, {B * XY * XY} pixels): "
                      f"{cuda_ms(lambda: kfn(*args, bf)):.4f} ms/launch, profiler device time "
                      f"{fmt(dev_ms)}; bound {bound_ms:.5f} ms ({by}); plain "
                      f"{cuda_ms(lambda: pfn(*args, bf)):.4f} ms", flush=True)


def check_head_limits(dev) -> None:
    """Phase 3: each head kernel's widest C at the flagship's NH and Co on
    each path, from its library's shared-memory layout: the kernel at that C
    (on seeded inputs of one image) agrees with its plain version within
    TOL_KERNEL, and the wrapper raises at one channel more, naming it."""
    import torch
    from sciml_pde_torch.ops import fno_kernels as fk

    g = torch.Generator().manual_seed(14)
    hp = XY + PAD
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(dev)  # noqa: E731
    uni = lambda *shape: (2 * torch.rand(*shape, generator=g) - 1).to(dev)  # noqa: E731
    mean, std, b1, b2 = rnd(1, CC), 1 + uni(1, CC).abs(), uni(NH) / 8, uni(CC) / 8
    dpred, w2t = rnd(1, CC, XY, XY), uni(CC, NH) / NH**0.5

    def args_at(name, c, bf):
        hf, w1t = rnd(1, c, hp, hp), fk._rd(uni(NH, c) / c**0.5, bf)
        if name == "head_fwd":
            return (hf, w1t, b1, fk._rd(w2t, bf), b2, mean, std, XY, XY)
        return (dpred, hf, w1t, b1, fk._rd(w2t, bf), std)

    for name in ("head_fwd", "head_bwd"):
        smem = fk.head_smem_bytes(name)
        kfn, pfn = getattr(fk, name), getattr(fk, f"{name}_plain")
        for prec, bf in (("highest", False), ("default", True)):
            widest = fk._widest(lambda m: smem(m, NH, CC, bf) <= fk.SMEM_MAX, 4096)
            args = args_at(name, widest, bf)
            got, want = kfn(*args, bf), pfn(*args, bf)
            torch.cuda.synchronize()
            err, rel = worst(got, want)
            finite = all(bool(torch.isfinite(t).all()) for t in tensors(got))
            try:
                kfn(*args_at(name, widest + 1, bf), bf)
                raised = "nothing"
            except ValueError as e:
                raised = str(e)
            names_it = raised.endswith(f"it takes C up to {widest} at this NH and Co")
            check(finite and rel <= TOL_KERNEL and names_it,
                  f"[kernel] fno_{name} {prec} at its widest C = {widest} (NH = {NH}, Co = "
                  f"{CC}: {smem(widest, NH, CC, bf)} bytes of shared memory a block): max abs "
                  f"err {err:.3e}, rel-to-max {rel:.3e} (tol {TOL_KERNEL:.0e}); at C = "
                  f"{widest + 1} the wrapper names that limit: {names_it}")


def check_wide_fused(dev, win, grid2, cot) -> None:
    """Phase 3: fault C6 end to end, the fused forward and its ten gradients
    at width WIDE_WIDTH on the main path's window and cotangent, through the
    kernels against the plain composition (``fno2d_fused_reference`` and
    ``fno2d_fused_vjp_reference``) under `highest` and `default`, within
    TOL."""
    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.train.fno_train import default_init_tree

    p = ff.pack_params(default_init_tree(CC, MODES, WIDE_WIDTH, T0, seed=2), MODES, MODES, dev)
    names = ["pred"] + [f"d{n}" for n in ff.FastFNOParams._fields]
    for prec in ("highest", "default"):
        spectral.set_dft_precision(prec)
        pk = ff.FastFNOParams(*(t.detach().clone().requires_grad_(True) for t in p))
        pred = ff.fno2d_fused_apply(win, grid2, pk, MODES, MODES, PAD)
        (pred * cot).sum().backward()
        want = [ff.fno2d_fused_reference(win, grid2, p, MODES, MODES, PAD)]
        want += list(ff.fno2d_fused_vjp_reference(cot, win, grid2, p, MODES, MODES, PAD))
        torch.cuda.synchronize()
        got = [pred.detach()] + [a.grad for a in pk]
        errs = {n: rel_err(a, b)[1] for n, a, b in zip(names, got, want)}
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        name = max(errs, key=errs.get)
        check(finite and errs[name] <= TOL[prec],
              f"[check {prec}] width {WIDE_WIDTH} (fault C6): pred and ten grads through the "
              f"kernels vs plain, worst rel-to-max {errs[name]:.3e} ({name}; tol "
              f"{TOL[prec]:.0e})")
    spectral.set_dft_precision("default")


def wide_fused_witness(dev, grid2) -> None:
    """Phase 3, printed only: the fused forward and its ten gradients under
    `default` on a random-normal window and cotangent (seed 4) at widths
    WIDTH and WIDE_WIDTH, through every kernel and with the head kernels
    swapped for their plain versions, worst rel-to-max against the plain
    composition.  TOL was set on the DR store's smooth fields, where the
    checks run; these readings show how far random fields move the
    backbone's bf16 rounding, with the head kernels and without them."""
    from types import SimpleNamespace

    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.train.fno_train import default_init_tree

    g = torch.Generator().manual_seed(4)
    win = torch.randn(B, T0, CC, XY, XY, generator=g).to(dev)
    cot = torch.randn(B, CC, XY, XY, generator=g).to(dev)
    plain_head = SimpleNamespace(**{**vars(fk.KERNELS), "head_fwd": fk.head_fwd_plain,
                                    "head_bwd": fk.head_bwd_plain})
    names = ["pred"] + [f"d{n}" for n in ff.FastFNOParams._fields]
    spectral.set_dft_precision("default")
    for width in (WIDTH, WIDE_WIDTH):
        p = ff.pack_params(default_init_tree(CC, MODES, width, T0, seed=2), MODES, MODES, dev)
        want = [ff.fno2d_fused_reference(win, grid2, p, MODES, MODES, PAD)]
        want += list(ff.fno2d_fused_vjp_reference(cot, win, grid2, p, MODES, MODES, PAD))
        for what, ops in (("every kernel", fk.KERNELS), ("plain head", plain_head)):
            pred, sv = ff._fused_forward(ops, win, grid2, p, MODES, MODES, PAD, save=True)
            got = [pred] + list(ff._fused_backward(ops, cot, sv, p, MODES, MODES, PAD))
            errs = {n: rel_err(a, b)[1] for n, a, b in zip(names, got, want)}
            name = max(errs, key=errs.get)
            print(f"[witness default] width {width}, random-normal window and cotangent, "
                  f"{what}: pred and ten grads vs plain, worst rel-to-max {errs[name]:.3e} "
                  f"({name}; TOL {TOL['default']:.0e} holds on the store)", flush=True)


def check_corner_iwdft(dev, card: str, records, p) -> None:
    """Phase 3: ``fno_corner`` and ``fno_iwdft_pw`` in every variant of
    CORNER_VARIANTS and IWDFT_VARIANTS at the flagship, on the main path's
    inputs (the first layer's forward, the last layer's adjoint), under
    `highest` and `default`: each against its plain version within
    TOL_KERNEL (``kernel_rel``), under `default` also below half the plain
    bf16-vs-f32 gap, under `highest` within TOL_HEAD_F32, which the plain
    version on TF32-rounded product inputs must exceed (the control); the
    same bits from a second launch; its profiler device time beside its
    bound."""
    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk

    a_f, a_b = records["fno_corner"][1][0], records["fno_corner.adj"][1][0]
    d_f, h = records["fno_iwdft_pw"][1][0], records["fno_iwdft_pw"][1][2]
    d_b, dpre = records["fno_iwdft_pw.adj"][1][0], records["fno_iwdft_pw.adj"][1][2]
    hp, wp = h.shape[2:]
    same = lambda t: t  # noqa: E731
    for prec, bf in (("highest", False), ("default", True)):
        f = ff.kernel_factors(hp, wp, MODES, MODES, str(dev), bf)
        dot = torch.bfloat16 if bf else torch.float32
        cases = []
        for what, adj, sdt, so in CORNER_VARIANTS:
            a, pf, qf = (a_b, f.adj_p, f.adj_q) if adj else (a_f, f.fwd_p, f.fwd_q)
            w = (fk._rd(p.wmr[3], bf), fk._rd(p.wmi[3], bf)) if adj else (p.wmr[0], p.wmi[0])
            spec = dot if sdt == "dot" else torch.float32

            def run(fn, b_, cv=same, a=a, pf=pf, w=w, qf=qf, adj=adj, spec=spec, so=so):
                return fn(cv(a), (cv(pf[0]), cv(pf[1])), w, (cv(qf[0]), cv(qf[1])), adj, spec,
                          b_, so)
            cases.append(("fno_corner" + ".adj" * adj, what, "corner", run))
        for what, adj, gelu, pdt in IWDFT_VARIANTS:
            if adj:
                d, z, xin, mw, bias = d_b, f.adj_z, dpre, fk._rd(p.pw[3], bf), None
            else:
                d, z, xin, mw, bias = d_f, f.fwd_z, h, fk._rd(p.pw[0].T.contiguous(), bf), p.pb[0]
            pre_dt = None if pdt is None else dot if pdt == "dot" else torch.float32

            def run(fn, b_, cv=same, d=d, z=z, xin=xin, mw=mw, bias=bias, gelu=gelu,
                    pre_dt=pre_dt, adj=adj):
                kw = {"adj": adj} if fn is fk.iwdft_pw else {}
                return fn(cv(d), cv(z), cv(xin), cv(mw), bias, gelu, pre_dt, b_, **kw)
            cases.append(("fno_iwdft_pw" + ".adj" * adj, what, "iwdft_pw", run))
        for key, what, fname, run in cases:
            kfn, pfn = getattr(fk, fname), getattr(fk, f"{fname}_plain")
            got, again, want = run(kfn, bf), run(kfn, bf), run(pfn, bf)
            torch.cuda.synchronize()
            same_bits = all(torch.equal(x, y) for x, y in zip(tensors(got), tensors(again)))
            err, raw = worst(got, want)
            args = run(lambda *a, **kw: a, bf)
            rel, exact = kernel_rel(fname, args, got)
            finite = all(bool(torch.isfinite(t).all()) for t in tensors(got))
            ok = finite and same_bits and rel <= TOL_KERNEL and exact
            msg = (f"[kernel] {key} {what} {prec}: max abs err {err:.3e}, rel-to-max {raw:.3e} "
                   f"({rel:.3e} before bf16 rounding; tol {TOL_KERNEL:.0e}; bf16 outputs its f32 "
                   f"values rounded: {exact}); same bits twice {same_bits}")
            if bf:
                gap = worst(run(pfn, False), want)[1]
                ok &= rel < gap / 2
                msg += f"; plain bf16-vs-f32 gap {gap:.3e}"
            else:
                ctl = worst(run(pfn, False, tf32), want)[1]
                ok &= rel <= TOL_HEAD_F32 < ctl
                msg += (f"; f32 tol {TOL_HEAD_F32:.0e}; control: plain with TF32 inputs "
                        f"{ctl:.3e}, above it")
            check(ok, msg)
            by_b = moved_bytes(fname, args, got) / HBM_BPS
            by_o = kernel_flops(fname, args, got) / PEAK_FLOPS[prec]
            by = "bytes" if by_b >= by_o else "operations"
            bound_ms = max(by_b, by_o) * 1e3
            dev_ms = profiler_ms(lambda: run(kfn, bf), FNO_KERNEL_KEYS[key], bound_ms=bound_ms)
            print(f"[timing] {card}: {key} {what} {prec}: profiler device time "
                  f"{fmt(dev_ms)}; bound {bound_ms:.5f} ms ({by})", flush=True)


def check_outer(dev, card: str, records) -> None:
    """Phase 3: ``fno_outer_partial``'s two instances on the main path
    (OUTER_CASES, the recorded calls' inputs) under `highest` and
    `default`: each against its plain version within TOL_KERNEL, under
    `default` also below half the plain bf16-vs-f32 gap, under `highest`
    within TOL_HEAD_F32, which the plain product on TF32-rounded inputs must
    exceed (the control); the same bits from a second launch; its profiler
    device time beside its bound."""
    import torch
    from sciml_pde_torch.ops import fno_kernels as fk

    for what, key in OUTER_CASES:
        a, bm, gelu, nh, nw, _ = records[key][1]
        for prec, bf in (("highest", False), ("default", True)):
            args = (a, bm, gelu, nh, nw, bf)
            got, again, want = fk.outer(*args), fk.outer(*args), fk.outer_plain(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            err, rel = worst(got, want)
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            ok = finite and same and rel <= TOL_KERNEL
            msg = (f"[kernel] fno_outer_partial {what} {prec} (nA {a.shape[1]}, nB "
                   f"{bm.shape[1]}, {a.shape[0] * nh * nw} pixels): max abs err {err:.3e}, "
                   f"rel-to-max {rel:.3e} (tol {TOL_KERNEL:.0e}); same bits twice {same}")
            if bf:
                gap = worst(fk.outer_plain(*args[:-1], False), want)[1]
                ok &= rel < gap / 2
                msg += f"; plain bf16-vs-f32 gap {gap:.3e}"
            else:
                av = a[:, :, :nh, :nw]
                bv = bm[:, :, :nh, :nw].float()
                bv = fk._gelu(bv) if gelu else bv
                ctl = rel_err(torch.einsum("bixy,bjxy->ij", tf32(av), tf32(bv)), want[0])[1]
                ok &= rel <= TOL_HEAD_F32 < ctl
                msg += (f"; f32 tol {TOL_HEAD_F32:.0e}; control: plain with TF32 inputs "
                        f"{ctl:.3e}, above it")
            check(ok, msg)
            by_b = moved_bytes("outer", args, got) / HBM_BPS
            by_o = kernel_flops("outer", args, got) / PEAK_FLOPS[prec]
            by = "bytes" if by_b >= by_o else "operations"
            bound_ms = max(by_b, by_o) * 1e3
            dev_ms = profiler_ms(lambda: fk.outer(*args), "outer_partial_kernel",
                                 bound_ms=bound_ms)
            print(f"[timing] {card}: fno_outer_partial {what} {prec}: "
                  f"{cuda_ms(lambda: fk.outer(*args)):.4f} ms/launch with its reduce_rows, "
                  f"profiler device time {fmt(dev_ms)}; bound {bound_ms:.5f} ms ({by}); "
                  f"{fk.outer_rows(a.shape[0] * nh * nw)} partial rows", flush=True)


def smooth_window(b: int, x: int, y: int, seed: int):
    """A smooth DR-shaped window (b, T0, CC, x, y) and grid2 (2, x, y), both
    numpy f32: make_store's decaying superposed sinusoids on an x by y
    field."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(-1, 1, x, dtype=np.float32),
                         np.linspace(-1, 1, y, dtype=np.float32), indexing="ij")
    t = np.linspace(0, 5, N_T, dtype=np.float32)[:T0]
    win = np.empty((b, T0, CC, x, y), np.float32)
    for n in range(b):
        for c in range(CC):
            field = np.zeros((T0, x, y), np.float32)
            for _ in range(4):
                a, kx, ky = rng.normal(), rng.integers(1, 5), rng.integers(1, 5)
                px, py, lam = rng.uniform(0, 2 * np.pi, 2).tolist() + [rng.uniform(0.1, 0.6)]
                mode = np.sin(np.pi * kx * gx + px) * np.cos(np.pi * ky * gy + py)
                field += (a * np.exp(-lam * t))[:, None, None] * mode[None]
            win[n, :, c] = field + 0.1 * rng.normal()
    return win, np.stack([gx, gy])


def record_calls(win, grid2, cot, p) -> tuple[dict, tuple]:
    """The fused forward and backward through the kernels, recording the
    arguments of the first call of each kernel of KERNEL_NAMES but
    fno_reduce_rows, and of the last ``outer`` call (the lift gradient) under
    OUTER_LIFT: ({key: (function name, args, kwargs)}, the forward's (pred,
    saved))."""
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk

    records: dict[str, tuple] = {}

    def recorder(fname):
        kfn = getattr(fk.KERNELS, fname)

        def call(*args, **kw):
            before = dict(fk.LAUNCHES)
            out = kfn(*args, **kw)
            for key in fk.KERNEL_NAMES:
                if (fk.LAUNCHES[key] != before[key] and key not in records
                        and key != "fno_reduce_rows"):
                    records[key] = (fname, args, kw)
            if fname == "outer":
                records[OUTER_LIFT] = (fname, args, kw)
            return out
        return call

    rec_ops = swap_ops(fk.KERNELS, **{n: recorder(n) for n in vars(fk.KERNELS)})
    pred, sv = ff._fused_forward(rec_ops, win, grid2, p, MODES, MODES, PAD, save=True)
    ff._fused_backward(rec_ops, cot, sv, p, MODES, MODES, PAD)
    return records, (pred, sv)


def fused_outs(ops, win, grid2, cot, p) -> list:
    """pred and the ten parameter cotangents of ``sum(pred * cot)`` through
    the composition ``ops``."""
    from sciml_pde_torch.ops import fno_fused_step as ff

    pred, sv = ff._fused_forward(ops, win, grid2, p, MODES, MODES, PAD, save=True)
    return [pred] + list(ff._fused_backward(ops, cot, sv, p, MODES, MODES, PAD))


def c78_inputs(dev, b: int, x: int, y: int, width: int, seed: int):
    """A smooth seeded window (``smooth_window``), its grid, a seeded normal
    cotangent (seed + 1) and the packed parameters of width ``width``."""
    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.train.fno_train import default_init_tree

    win, grid2 = (torch.from_numpy(a).to(dev) for a in smooth_window(b, x, y, seed=seed))
    cot = torch.randn(b, CC, x, y, generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    p = ff.pack_params(default_init_tree(CC, MODES, width, T0, seed=2), MODES, MODES, dev)
    return win, grid2, cot, p


def check_c78_fields(dev) -> None:
    """Phase 3: faults C7 and C8 at each field and width of C78_FIELDS
    (``c78_inputs``, seed 5).  Under `highest`, the fused forward and its
    ten gradients through ``fno2d_fused_apply`` against the plain
    composition (``fno2d_fused_reference`` and ``fno2d_fused_vjp_reference``)
    within TOL.  Under `default`, where a one-f32-step nudge of the window
    moves the plain composition itself by more than TOL (``c78_witness``),
    the same outputs must be finite, and each kernel of C78_KERNELS on its
    first call's inputs there (``record_calls``) is held to its plain
    version within TOL_KERNEL (``kernel_rel``), below half the plain
    bf16-vs-f32 gap where it takes ``bf``, with the same bits from a second
    launch.  The other kernels' readings there are printed, each beside its
    plain version's move when its first input is nudged one step: the
    head kernels round a hidden layer to bf16 inside, and at these fields
    one flip of that rounding can reach TOL_KERNEL of pred."""
    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral

    names = ["pred"] + [f"d{n}" for n in ff.FastFNOParams._fields]
    for what, b, x, y, width, precs in C78_FIELDS:
        win, grid2, cot, p = c78_inputs(dev, b, x, y, width, seed=5)
        field = f"{what} (batch {b}, {x} x {y}, width {width}; faults C7/C8)"
        for prec in precs:
            spectral.set_dft_precision(prec)
            pk = ff.FastFNOParams(*(t.detach().clone().requires_grad_(True) for t in p))
            pred = ff.fno2d_fused_apply(win, grid2, pk, MODES, MODES, PAD)
            (pred * cot).sum().backward()
            torch.cuda.synchronize()
            got = [pred.detach()] + [a.grad for a in pk]
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            if prec == "default":
                check(finite, f"[check default] {field}: pred and ten grads through the kernels "
                      f"finite")
                break
            want = [ff.fno2d_fused_reference(win, grid2, p, MODES, MODES, PAD)]
            want += list(ff.fno2d_fused_vjp_reference(cot, win, grid2, p, MODES, MODES, PAD))
            errs = {n: rel_err(a, w)[1] for n, a, w in zip(names, got, want)}
            name = max(errs, key=errs.get)
            check(finite and errs[name] <= TOL[prec],
                  f"[check {prec}] {field}: pred and ten grads through the kernels vs the plain "
                  f"composition, worst rel-to-max {errs[name]:.3e} ({name}; tol {TOL[prec]:.0e})")
        spectral.set_dft_precision("default")
        records = record_calls(win, grid2, cot, p)[0]
        for key, (fname, args, kw) in records.items():
            kfn, pfn = getattr(fk, fname), getattr(fk, f"{fname}_plain")
            got, again, want = kfn(*args, **kw), kfn(*args, **kw), pfn(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(a, w) for a, w in zip(tensors(got), tensors(again)))
            rel, exact = kernel_rel(fname, args, got)
            finite = all(bool(torch.isfinite(t).all()) for t in tensors(got))
            gap = None
            if fname not in ("stats", "mix_wgrad") and args[-1] is True:
                gap = worst(pfn(*args[:-1], False), want)[1]
            nudged = torch.nextafter(args[0], torch.full_like(args[0], float("inf")))
            noise = worst(pfn(nudged, *args[1:]), want)[1]
            pairs = list(zip(tensors(got), tensors(want)))
            above = sum(int(((a.float() - w.float()).abs()
                             > TOL_KERNEL * w.float().abs().max()).sum()) for a, w in pairs)
            msg = (f"{key} at {field}, on the step's inputs: rel-to-max {rel:.3e} before bf16 "
                   f"rounding (tol {TOL_KERNEL:.0e}; bf16 outputs its f32 values rounded: "
                   f"{exact}; plain bf16-vs-f32 gap " + ("n/a" if gap is None else f"{gap:.3e}")
                   + f"); same bits twice {same}; {above} of {sum(a.numel() for a, _ in pairs)} "
                   f"output elements above the tol as stored; the plain version with its first "
                   f"input nudged one step of its dtype moves {noise:.3e}")
            if fname in C78_KERNELS:
                check(finite and same and exact and rel <= TOL_KERNEL
                      and (gap is None or rel < gap / 2), f"[kernel default] {msg}")
            else:
                print(f"[witness default] {msg}", flush=True)
    spectral.set_dft_precision("default")


def c78_witness(dev) -> None:
    """Phase 3, printed only: where the `default` error at the C7/C8 fields
    comes from.  At each field of C78_FIELDS, for window seeds 5 (the
    checks') and 9, the fused forward and its ten gradients under
    `default` against the plain composition (every function plain), worst
    rel-to-max, for: the plain composition on the window nudged up one f32
    step in every element (the noise floor: no arithmetic changes, only
    which bf16 roundings flip); each kernel alone on the card, the rest
    plain; the control (C78_KERNELS plain, the rest on the card); and every
    kernel."""
    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral

    names = ["pred"] + [f"d{n}" for n in ff.FastFNOParams._fields]
    spectral.set_dft_precision("default")
    for what, b, x, y, width, _ in C78_FIELDS:
        for seed in (5, 9):
            win, grid2, cot, p = c78_inputs(dev, b, x, y, width, seed=seed)
            ref = fused_outs(fk.PLAIN, win, grid2, cot, p)
            nudged = torch.nextafter(win, torch.full_like(win, float("inf")))
            variants = {"the plain composition, window nudged one f32 step":
                        fused_outs(fk.PLAIN, nudged, grid2, cot, p)}
            for n in vars(fk.KERNELS):
                variants[f"{n} alone on the card"] = fused_outs(
                    swap_ops(fk.PLAIN, **{n: getattr(fk.KERNELS, n)}), win, grid2, cot, p)
            variants["the control"] = fused_outs(c78_control_ops(), win, grid2, cot, p)
            variants["every kernel"] = fused_outs(fk.KERNELS, win, grid2, cot, p)
            top = ref[0].abs().max()
            for v, outs in variants.items():
                errs = {n: rel_err(a, w)[1] for n, a, w in zip(names, outs, ref)}
                name = max(errs, key=errs.get)
                above = ((outs[0] - ref[0]).abs() > TOL["default"] * top).float().mean().item()
                print(f"[witness default] {what} (batch {b}, {x} x {y}, width {width}), window "
                      f"seed {seed}: {v} vs the plain composition, worst rel-to-max "
                      f"{errs[name]:.3e} ({name}; pred {errs['pred']:.3e}, its elements above "
                      f"TOL {above:.3e})", flush=True)


def check_layout_mirrors() -> None:
    """Phase 3: ``fno_kernels``' mirrors of the shared-memory layouts of
    ``wdft_kernel``, ``corner_kernel``, ``iwdft_pw_kernel`` and
    ``outer_partial_kernel`` (the plans and the CPU tests read them) against
    the sizes the library lays out, over a sweep of shapes on both paths."""
    from sciml_pde_torch.ops import fno_kernels as fk

    cases = {
        "wdft": [((n, j, tc, ps, kc), fk.wdft_smem_bytes)
                 for n in (3, 130, 258, 514, 1154) for j in (2, 24, 40)
                 for tc in (True, False) for ps in (0, 2, 4) for kc in (1, 5, 16)],
        "corner": [((c, o, r, hc, tc), fk.corner_smem_bytes)
                   for c in (1, 20, 21, 149) for o in (3, 20, 120) for r in (2, 24, 25)
                   for hc in (8, 40, 64) for tc in (True, False)],
        "iwdft": [((c, o, k, wc, tc), fk.iwdft_smem_bytes)
                  for c in (1, 20, 149) for o in (3, 20, 120) for k in (1, 12, 13)
                  for wc in (16, 144, 256) for tc in (True, False)],
        "outer": [((na,), fk.outer_smem_bytes)
                  for na in (1, 16, 17, 20, 22, 64, 65, 128, 149, 194, 197, 198, 400)],
    }
    for name, rows in cases.items():
        lib = fk._fn(f"fno_{name}_smem")
        bad = [args for args, mirror in rows if mirror(*args) != lib(*map(int, args))]
        check(not bad, f"[kernel] fno_kernels' {name} layout mirror equals the library's over "
              f"{len(rows)} shapes" + (f"; differs at {bad[:3]}" if bad else ""))


def check_limits(dev) -> None:
    """Phase 3: the widest value each of ``wdft`` (J at N = 130), ``corner``
    and ``iwdft_pw`` (C at the flagship's Hp, Wp, R and K) and ``outer`` (nA)
    takes on each path, from its plan: the kernel there agrees with its
    plain version within TOL_KERNEL (``kernel_rel``) on seeded inputs of one
    element, and one more raises a ValueError naming that limit; each limit
    lies at or above the widest width the head kernels take."""
    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk

    g = torch.Generator().manual_seed(15)
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(dev)  # noqa: E731
    hp, k, r = XY + PAD, MODES, 2 * MODES
    head = {True: 149, False: 96}  # the head kernels' widest C at NH 128, Co 2
    for prec, bf in (("highest", False), ("default", True)):
        f = ff.kernel_factors(hp, hp, MODES, MODES, str(dev), bf)
        dot = torch.bfloat16 if bf else torch.float32
        lim = {
            "wdft": fk._widest(lambda m: min(fk.wdft_smem_bytes(hp, m, bf, 0, kc)
                                             for kc in range(1, 10)) <= fk.SMEM_MAX, 4096),
            "corner": fk._widest(lambda m: fk.corner_smem_bytes(m, m, r, 8, bf) <= fk.SMEM_MAX,
                                 4096),
            "iwdft_pw": fk._widest(lambda m: fk.iwdft_smem_bytes(m, m, k, 16, bf)
                                   <= fk.SMEM_MAX, 4096),
            "outer": fk._widest(lambda m: fk.outer_smem_bytes(m) <= fk.SMEM_MAX, 4096),
        }

        def call_args(name, n):
            if name == "wdft":
                return (rnd(1, 1, 32, hp), fk._rd(rnd(hp, n) / hp**0.5, bf), None, False, bf)
            if name == "corner":
                w = (rnd(n, n, k, r) / n, rnd(n, n, k, r) / n)
                return (rnd(1, n, hp, 2 * k), f.fwd_p, w, f.fwd_q, False, dot, bf)
            if name == "iwdft_pw":
                return (rnd(1, n, hp, 2 * k), f.fwd_z, rnd(1, n, hp, hp),
                        fk._rd(rnd(n, n) / n**0.5, bf), rnd(n), True, dot, bf)
            return (rnd(1, n, hp, hp), rnd(1, n, hp, hp), False, hp, hp, bf)

        for name, widest in lim.items():
            args = call_args(name, widest)
            got = getattr(fk, name)(*args)
            torch.cuda.synchronize()
            rel, exact = kernel_rel(name, args, got)
            finite = all(bool(torch.isfinite(t).all()) for t in tensors(got))
            try:
                getattr(fk, name)(*call_args(name, widest + 1))
                raised = "nothing"
            except ValueError as e:
                raised = str(e)
            what = {"wdft": "J", "outer": "nA"}.get(name, "C")
            names_it = f"{what} up to {widest}" in raised
            above = name == "wdft" or widest >= head[bf]
            check(finite and rel <= TOL_KERNEL and exact and names_it and above,
                  f"[kernel] fno_{name} {prec} at its widest {what} = {widest}"
                  + (f" (nB = {widest})" if name == "outer" else "") + f": rel-to-max "
                  f"{rel:.3e} before bf16 rounding (tol {TOL_KERNEL:.0e}; bf16 outputs its f32 "
                  f"values rounded: {exact}); at {widest + 1} the wrapper names that "
                  f"limit: {names_it} ({raised[-60:]!r})"
                  + ("" if name == "wdft" else f"; at or above the head kernels' {head[bf]}"))


def check_c78_paths(dev) -> None:
    """Phase 3: two paths of the C7/C8 repairs that the flagship does not
    take, each against its plain version within TOL_KERNEL,
    under `highest` also within TOL_HEAD_F32, which the plain version on
    TF32-rounded product inputs must exceed (the control), with the same
    bits from a second launch: ``outer`` at nA = nB = the head kernels'
    widest C (149 under `default`, 96 under `highest`, NH 128, Co 2), where
    ``outer_partial_kernel`` takes Bm in chunks of OUTER_BT channels, with
    gelu on a Bm in the dot dtype as a layer's weight gradient has it; and
    the adjoint ``wdft`` with gelu'(pre), pre f32 and bf16, at N = 514
    (512^2, batch 1) and 1154 (128 x 1152, batch 2), where
    ``wdft_kernel`` streams N in several chunks and reads pre from device
    memory."""
    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk

    g = torch.Generator().manual_seed(16)
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(dev)  # noqa: E731
    hp = XY + PAD
    head = {True: 149, False: 96}
    for prec, bf in (("highest", False), ("default", True)):
        dot = torch.bfloat16 if bf else torch.float32
        c = head[bf]
        cases = [(f"fno_outer_partial at nA = nB = {c} (the head kernels' widest C), gelu",
                  fk.outer, fk.outer_plain,
                  (rnd(B, c, hp, hp), rnd(B, c, hp, hp).to(dot), True, hp, hp, bf))]
        for nb, x, y in ((1, 512, 512), (2, 128, 1152)):
            f = ff.kernel_factors(x + PAD, y + PAD, MODES, MODES, str(dev), bf)
            dh = rnd(nb, WIDTH, x + PAD, y + PAD)
            for pdt in (torch.float32, torch.bfloat16):
                cases.append((f"fno_wdft.adj at N = {y + PAD} ({x} x {y}), gelu', pre "
                              f"{str(pdt)[6:]}", fk.wdft, fk.wdft_plain,
                              (dh, f.adj_w, rnd(*dh.shape).to(pdt), True, bf)))
        for what, kfn, pfn, args in cases:
            got, again, want = kfn(*args), kfn(*args), pfn(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(tensors(got), tensors(again)))
            rel = worst(got, want)[1]
            finite = all(bool(torch.isfinite(t).all()) for t in tensors(got))
            ok = finite and same and rel <= TOL_KERNEL
            msg = (f"[kernel] {what} {prec}: rel-to-max {rel:.3e} (tol {TOL_KERNEL:.0e}); same "
                   f"bits twice {same}")
            if not bf:
                if kfn is fk.outer:
                    a, bm = args[0], fk._gelu(args[1].float())
                    ctl = rel_err(torch.einsum("bixy,bjxy->ij", tf32(a), tf32(bm)), want[0])[1]
                else:
                    ctl = rel_err(torch.matmul(tf32(want[1]), tf32(args[1])), want[0])[1]
                ok &= rel <= TOL_HEAD_F32 < ctl
                msg += (f"; f32 tol {TOL_HEAD_F32:.0e}; control: plain with TF32 inputs "
                        f"{ctl:.3e}, above it")
            check(ok, msg)


def split_c78(dev) -> None:
    """Phase 14: the five split functions at 512^2 (SPLIT_C78: batch 1, width
    20; fault C7 stopped ``_bb_backward``'s adjoint W-DFT with an f32 pre at
    Wp 514), on a smooth seeded window, through the kernels within TOL of
    their plain versions under `highest` and of the control (C78_KERNELS in
    their plain versions) under `default`, whose own distance from the
    plain versions is printed, with the stage-kernel launches of each
    call."""
    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.train.fno_train import default_init_tree

    ctl_ops = c78_control_ops()
    b, x, y = SPLIT_C78
    win, grid2 = (torch.from_numpy(a).to(dev) for a in smooth_window(b, x, y, seed=7))
    cot = torch.randn(b, CC, x, y, generator=torch.Generator().manual_seed(8)).to(dev)
    p = ff.pack_params(default_init_tree(CC, MODES, WIDTH, T0, seed=1), MODES, MODES, dev)
    for prec in ("highest", "default"):
        spectral.set_dft_precision(prec)
        pre, bbout, stats, h0p = ff._bb_forward(win, grid2, p, MODES, MODES, PAD)
        dbb = ff._head_backward(cot, bbout, stats, p)[0]
        dpre = ff._bb_backward(dbb, pre, win, grid2, stats, p, MODES, MODES, PAD)[0]
        calls = {
            "bb_forward": (ff._bb_forward, (win, grid2, p, MODES, MODES, PAD)),
            "head_forward": (ff._head_forward, (bbout, stats, p)),
            "head_backward": (ff._head_backward, (cot, bbout, stats, p)),
            "bb_backward": (ff._bb_backward, (dbb, pre, win, grid2, stats, p, MODES, MODES, PAD)),
            "bb_weight_grads": (ff._bb_weight_grads, (pre, h0p, dpre, p, MODES, MODES, PAD, x, y)),
        }
        for name, (fn, args) in calls.items():
            fk.reset_launch_counts()
            out_k = fn(*args)
            torch.cuda.synchronize()
            stages = {k: v for k, v in fk.LAUNCHES.items() if v}
            out_p = fn(*args, ops=fk.PLAIN)
            against = "plain"
            want = out_p
            if prec == "default":
                want, against = fn(*args, ops=ctl_ops), "the control"
            err, rel = worst(out_k, want)
            finite = all(bool(torch.isfinite(t).all()) for t in tensors(out_k))
            msg = (f"[split {prec}] {name} at {x} x {y} (batch {b}; fault C7) vs {against}: "
                   f"max abs err {err:.3e}, rel-to-max {rel:.3e} (tol {TOL[prec]:.0e})")
            if prec == "default":
                msg += (f"; the control vs plain {worst(want, out_p)[1]:.3e}, the kernels vs "
                        f"plain {worst(out_k, out_p)[1]:.3e}")
            check(finite and rel <= TOL[prec] and stages == SPLIT_STAGES[name],
                  msg + f"; stage launches per call {json.dumps(stages)}")
    spectral.set_dft_precision("default")


def bb_backward_witness(dev, args, p_bf16_mix, bbout, stats, p) -> None:
    """Phase 14, printed only: ``_bb_backward`` under `default` through the
    kernels, for the cotangents of seeds 1-3 (seed 1 the main path's) and
    dbb from the head kernel and from its plain version, against the plain
    version beside its control (the plain version with bf16-rounded mix
    weights): the kernels' error over the control's, as the largest
    rel-to-max over all outputs and as the mean abs error of each output.
    ``args`` are the call's arguments after dbb."""
    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk

    for seed in (1, 2, 3):
        cot = torch.randn(B, CC, XY, XY, generator=torch.Generator().manual_seed(seed)).to(dev)
        for what, ops in (("head kernel", fk.KERNELS), ("plain head", fk.PLAIN)):
            a = (ff._head_backward(cot, bbout, stats, p, ops=ops)[0],) + tuple(args)
            out_k, out_p = ff._bb_backward(*a), ff._bb_backward(*a, ops=fk.PLAIN)
            ctl = ff._bb_backward(*a[:5], p_bf16_mix, *a[6:], ops=fk.PLAIN)
            ratio = worst(out_k, out_p)[1] / worst(ctl, out_p)[1]
            means = ", ".join(
                f"{n} {(k - w).abs().mean().item() / (c - w).abs().mean().item():.3f}"
                for n, k, c, w in zip(("dpre", "dw0t", "db0"), out_k, ctl, out_p))
            print(f"[witness default] bb_backward, cotangent seed {seed}, dbb from the {what}: "
                  f"kernels' error over the control's, largest rel-to-max {ratio:.3f}; mean "
                  f"abs {means}", flush=True)


def make_store(seed: int = 0, n_traj: int = N_TRAJ, n_t: int = N_T, xy: int = XY):
    """Smooth DR-shaped trajectories (N, T, X, Y, C): decaying superposed
    sinusoids with seeded amplitudes, wave numbers, phases and rates."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lin = np.linspace(-1, 1, xy, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    t = np.linspace(0, 5, n_t, dtype=np.float32)
    data = np.empty((n_traj, n_t, xy, xy, CC), np.float32)
    for n in range(n_traj):
        for c in range(CC):
            field = np.zeros((n_t, xy, xy), np.float32)
            for _ in range(4):
                a, kx, ky = rng.normal(), rng.integers(1, 5), rng.integers(1, 5)
                px, py, lam = rng.uniform(0, 2 * np.pi, 2).tolist() + [rng.uniform(0.1, 0.6)]
                mode = np.sin(np.pi * kx * gx + px) * np.cos(np.pi * ky * gy + py)
                field += (a * np.exp(-lam * t))[:, None, None] * mode[None]
            data[n, ..., c] = field + 0.1 * rng.normal()
    return data, np.stack([gx, gy], axis=-1)


def make_ns_store(n_traj: int, n_t: int, seed: int, dev, xy: int = NS_MODEL["img_size"]):
    """Smooth NS-shaped trajectories (N, T, xy, xy, 3) made on the card:
    per channel four travelling, decaying sinusoids with seeded amplitudes,
    wave numbers, phases, speeds and rates."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lin = torch.linspace(-1, 1, xy, device=dev)
    gx, gy = torch.meshgrid(lin, lin, indexing="ij")
    t = torch.linspace(0, 3, n_t, device=dev)[:, None, None]
    data = torch.zeros(n_traj, n_t, xy, xy, NS_MODEL["in_chans"], device=dev)
    for n in range(n_traj):
        for c in range(NS_MODEL["in_chans"]):
            for _ in range(4):
                a, kx, ky = rng.normal(), int(rng.integers(1, 5)), int(rng.integers(1, 5))
                px, py, cx, cy = rng.uniform(0, 2 * np.pi, 4).tolist()
                lam = rng.uniform(0.1, 0.5)
                data[n, ..., c] += (a * torch.exp(-lam * t)
                                    * torch.sin(np.pi * kx * gx + px + cx * t)
                                    * torch.cos(np.pi * ky * gy + py + cy * t))
            data[n, ..., c] += 0.1 * rng.normal()
    return data


def att_work(name: str, bh: int, n: int, d: int, bf: bool) -> tuple[int, float]:
    """(bytes each input read and each output written once, seconds of the
    products at the card's peak for their input type).  The bf16 kernels
    count the products their designs need to be exact to their bounds, all
    at the bf16 tensor-core rate (989 TFLOP/s), each f32 operand (p, ds) as
    two bf16 terms: the forward q.k^T and p.v (three products), dQ q.k^T,
    do.v^T and ds.k (four), dK/dV k.q^T, v.do^T, ds^T.q and p^T.do (six);
    at the encoder shape (24, 1280, 64) 0.01527, 0.02036 and 0.03054 ms.
    The f32 kernels up to head dim 128 take each product as three TF32
    passes at the TF32 tensor-core rate (495 TFLOP/s): the forward 6, dQ 9
    and dK/dV 12 passes, 0.06101, 0.09150 and 0.12200 ms at the encoder
    shape; before those designs they took two, three and four products at
    the CUDA cores' f32 rate (67 TFLOP/s), 0.15024, 0.22537 and 0.30049 ms.
    From 160 to 256 the f32 forward, dQ and dK/dV
    count their TF32 passes (at (8, 1280, 256) 0.08134, 0.12202 and 0.16269
    ms; 0.20032, 0.30049 and 0.40065 on the CUDA cores before their
    tensor-core bodies).  Above 256 the three cluster bodies count the same
    TF32 passes (at (4, 1280, 512) 0.08134, 0.12202 and 0.16269 ms; dQ
    0.30050 on the CUDA cores before its cluster body), and the bf16 wide
    bodies their bf16 products (0.02036, 0.02714 and 0.04071 ms there).
    The bodies above CLUSTER_MAX_D take the same bounds, though they form
    the scores once for each block of 256 output columns: the bound is what
    the function needs, not what its body does.  Before
    their tensor-core designs the bf16 kernels' bounds counted the products
    that take p or ds at the f32 rate: 0.08021 (forward), 0.08530 (dQ) and
    0.16042 ms (dK/dV) at the encoder shape."""
    es = 2 if bf else 4
    panel, row = bh * n * d * es, bh * n * 4
    prod = 2 * bh * n * n * d
    nbytes = {"attention_fwd": 3 * panel + panel + row,
              "attention_dq": 4 * panel + 2 * row + panel,
              "attention_dkv": 4 * panel + 2 * row + 2 * panel}[name]
    if bf:
        products = {"attention_fwd": 3, "attention_dq": 4, "attention_dkv": 6}[name]
        return nbytes, products * prod / PEAK_FLOPS["default"]
    passes = {"attention_fwd": 6, "attention_dq": 9, "attention_dkv": 12}[name]
    return nbytes, passes * prod / TF32_FLOPS


def att_bf16p(name: str, q, k, v, do=None, l=None, delta=None, scale: float = 1.0):
    """The plain version of one attention kernel with p and ds rounded to
    bf16 before their products, as ``jnp_attention`` rounds p: the
    control a kernel must lie nearer to its own plain version than."""
    import torch

    r = lambda t: t.bfloat16().float()  # noqa: E731
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if name == "attention_fwd":
        e = torch.exp(s - s.amax(-1, keepdim=True))
        return (torch.matmul(r(e / e.sum(-1, keepdim=True)), v.float()).to(q.dtype),)
    p = torch.exp(s - l)
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta)
    if name == "attention_dq":
        return ((torch.matmul(r(ds), k.float()) * scale).to(q.dtype),)
    return ((torch.matmul(r(ds).transpose(-1, -2), q.float()) * scale).to(q.dtype),
            torch.matmul(r(p).transpose(-1, -2), do.float()).to(q.dtype))


def att_f64(name: str, q, k, v, do=None, l=None, delta=None, scale: float = 1.0):
    """The exact result of one attention kernel: its plain version's
    arithmetic in f64 on the same inputs (the f32 bound's reference: at
    (4, 1280, 512) with q and k times 3 the f32 plain versions themselves
    lie up to 2.1e-5 from it)."""
    import torch

    q, k, v = q.double(), k.double(), v.double()
    s = (q * scale) @ k.transpose(-1, -2)
    if name == "attention_fwd":
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        return e / e.sum(-1, keepdim=True) @ v, m + torch.log(e.sum(-1, keepdim=True))
    do = do.double()
    p = torch.exp(s - l.double())
    ds = p * (do @ v.transpose(-1, -2) - delta.double())
    if name == "attention_dq":
        return (ds @ k * scale,)
    return ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ do


def att_kernel_key(name: str, d: int, bf: bool) -> str:
    """The profiler key of the CUDA kernel that attention kernel ``name``
    launches: up to head dim 128 those of ATT_KERNEL_KEYS; from 160 to 256
    the bf16 tensor-core bodies (*_tc_kernel), in f32 the split-TF32
    forward, dQ and dK/dV of two warpgroups (*_tf32w_kernel); above 256 the
    cluster bodies (*_wide_kernel) up to CLUSTER_MAX_D; above it the
    tensor-core bodies that loop over all of d (*_wide_tc_kernel)."""
    from sciml_pde_torch.ops.attention import CLUSTER_MAX_D

    short = name.replace("attention_", "")
    if d <= 128:
        return ATT_KERNEL_KEYS["bf16" if bf else "f32"][name]
    if d <= 256:
        return f"{short}_tc_kernel<" if bf else f"{short}_tf32w_kernel<"
    if d <= CLUSTER_MAX_D:
        return f"{short}_wide_kernel<"
    return f"{short}_wide_tc_kernel<"


def check_flash_wide(ta, dev) -> None:
    """Phase 6: flash_attention at (2, 4, 1280, 512) through the kernels (the
    wide bodies) against plain=True, values and q/k/v gradients, in both
    dtypes: f32 within the f32 bound; bf16 the output within one bf16 step
    plus the f32 bound, the gradients (from the kernels' own bf16 output,
    whose one-step flips move delta) within the model's bf16 bound."""
    import torch

    g = torch.Generator().manual_seed(5)
    b, h, n, d = 2, 4, 1280, 512
    q, k, v, go = (torch.randn(b, h, n, d, generator=g) for _ in range(4))
    for dt in (torch.float32, torch.bfloat16):
        outs = {}
        for plain in (False, True):
            qq, kk, vv = (t.to(dev, dt).requires_grad_(True) for t in (q, k, v))
            o = ta.flash_attention(qq, kk, vv, d**-0.5, plain=plain)
            grads = torch.autograd.grad(o, (qq, kk, vv), go.to(dev, dt))
            outs[plain] = [o.detach(), *grads]
        torch.cuda.synchronize()
        msgs, ok = [], all(bool(torch.isfinite(t).all()) for t in outs[False])
        for what, a, w in zip(("o", "dq", "dk", "dv"), outs[False], outs[True]):
            rel = rel_err(a, w)[1]
            if dt == torch.float32:
                ok &= rel <= ATT_TOL_F32
            elif what == "o":
                lim = BF16_STEP * torch.maximum(a.float().abs(), w.float().abs()) \
                    + ATT_TOL_F32 * w.float().abs().max()
                ok &= ((a.float() - w.float()).abs() / lim).max().item() <= 1.0
            else:
                ok &= rel <= TOL_MODEL["bf16"]
            msgs.append(f"{what} rel-to-max {rel:.3e}")
        tol = (f"tol {ATT_TOL_F32:.0e}" if dt == torch.float32 else
               f"o one bf16 step + {ATT_TOL_F32:.0e}, grads {TOL_MODEL['bf16']:.0e}")
        check(ok, f"[attention] flash_attention {(b, h, n, d)} {str(dt)[6:]} through the "
              f"kernels vs plain=True: " + ", ".join(msgs) + f" ({tol})")


def sdpa_calls(q, k, v, do, scale: float) -> dict:
    """One PyTorch call per attention kernel on its inputs (bh, n, d): the
    SDPA forward, and for dQ and dK/dV the SDPA backward (both together)."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t[None].detach().requires_grad_(True) for t in (q, k, v))
    o4 = sdpa(q4, k4, v4, scale=scale)
    bwd = lambda: torch.autograd.grad(o4, (q4, k4, v4), do[None], retain_graph=True)  # noqa: E731
    return {"attention_fwd": lambda: sdpa(q[None], k[None], v[None], scale=scale),
            "attention_dq": bwd, "attention_dkv": bwd}


def att_case(ta, dev, card: str, where: str, shape: tuple, dt, amp: float, g,
             timed: bool) -> dict:
    """Phase 6's checks of the three kernels at one shape (bh, n, d) and
    dtype on seeded inputs (q and k times ``amp``): each against its plain
    version and a second launch of itself; f32 outputs against the exact
    result (att_f64) within ATT_TOL_F32, bf16 outputs within one bf16 step
    of the plain version with the bf16-p control.  ``timed``: each kernel's
    time in events and profiler device time beside its bound, its plain
    version and the SDPA call on the same inputs, and dQ + dK/dV beside the
    SDPA backward.  Returns {name: (args, scale, timings or None)}."""
    import torch

    bh, n, d = shape
    bf = dt == torch.bfloat16
    q, k, v, do = (torch.randn(bh, n, d, generator=g).to(dev, dt) for _ in range(4))
    q, k = q * amp, k * amp
    scale = d**-0.5
    o_p, l_p = ta.attention_fwd_plain(q, k, v, scale)
    delta = torch.sum(do.float() * o_p.float(), dim=-1, keepdim=True)
    args = {"attention_fwd": (q, k, v),
            "attention_dq": (q, k, v, do, l_p, delta),
            "attention_dkv": (q, k, v, do, l_p, delta)}
    out, dev_times = {}, {}
    for name in ta.KERNEL_NAMES:
        got = as_tuple(getattr(ta, name)(*args[name], scale))
        again = as_tuple(getattr(ta, name)(*args[name], scale))
        want = as_tuple(getattr(ta, f"{name}_plain")(*args[name], scale))
        exact = att_f64(name, *args[name], scale=scale)
        torch.cuda.synchronize()
        ok = all(torch.equal(a, b) for a, b in zip(got, again))
        msgs = [f"same bits twice {ok}"]
        for i, (a, b, x) in enumerate(zip(got, want, exact)):
            err, rel = rel_err(a, b)
            ok &= bool(torch.isfinite(a).all()) and a.dtype == b.dtype
            if a.dtype == torch.float32:
                rel_x, plain_x = rel_err(a, x)[1], rel_err(b, x)[1]
                ok &= rel_x <= ATT_TOL_F32
                msgs.append(f"out{i} rel-to-max {rel_x:.3e} from the exact result (tol "
                            f"{ATT_TOL_F32:.0e}; the f32 plain version {plain_x:.3e} "
                            f"from it; the plain version {rel:.3e} from the kernel)")
            else:
                a32, b32 = a.float(), b.float()
                lim = (BF16_STEP * torch.maximum(a32.abs(), b32.abs())
                       + ATT_TOL_F32 * b32.abs().max())
                worst = ((a32 - b32).abs() / lim).max().item()
                ok &= worst <= 1.0
                msgs.append(f"out{i} rel-to-max {rel:.3e}, worst error over one bf16 "
                            f"step {worst:.3f} (tol 1)")
        if bf:
            # control: rounding p and ds to bf16 moves the outputs further
            # (mean abs error) than the kernel lies from its plain version
            ctl = att_bf16p(name, *args[name], scale=scale)
            outs = [(a, b, c) for a, b, c in zip(got, want, ctl) if a.dtype == dt]
            k_mean = max((a.float() - b.float()).abs().mean().item() for a, b, _ in outs)
            c_mean = min((c.float() - b.float()).abs().mean().item() for _, b, c in outs)
            ok &= k_mean < c_mean / 2
            msgs.append(f"mean abs err {k_mean:.3e} vs bf16-p control {c_mean:.3e}")
        check(ok, f"[attention] {name} {where} {tuple(q.shape)} {str(dt)[6:]}: "
              + "; ".join(msgs))
        row = None
        if timed:
            kfn, pfn = getattr(ta, name), getattr(ta, f"{name}_plain")
            key = att_kernel_key(name, d, bf)
            nbytes, ops_s = att_work(name, *q.shape, bf)
            bound_ms = max(nbytes / HBM_BPS, ops_s) * 1e3
            why = []
            dev_ms = profiler_ms(lambda: kfn(*args[name], scale), key, bound_ms=bound_ms,
                                 reasons=why)
            if dev_ms is None:  # one more reading, and why the sessions came back empty
                dev_ms = profiler_ms(lambda: kfn(*args[name], scale), key, bound_ms=bound_ms,
                                     sessions=1, reasons=why)
                print(f"[timing] {card}: {name} {where} {tuple(q.shape)} {str(dt)[6:]}: the "
                      f"profiler's sessions not kept: {'; '.join(why)}; the retry read "
                      f"{fmt(dev_ms)}", flush=True)
            lib = sdpa_calls(q, k, v, do, scale)[name]
            lib_dev = profiler_ms(lib)
            dev_times[name], dev_times["library " + name] = dev_ms, lib_dev
            row = {"max_abs_err": max(rel_err(a, b)[0] for a, b in zip(got, want)),
                   "ms": cuda_ms(lambda: kfn(*args[name], scale)),
                   "plain_ms": cuda_ms(lambda: pfn(*args[name], scale)), "bound_ms": bound_ms,
                   "bound_by": "operations" if ops_s >= nbytes / HBM_BPS else "bytes",
                   "library_ms": cuda_ms(lib), "device_ms": dev_ms, "library_device_ms": lib_dev}
            print(f"[timing] {card}: {name} {where} {tuple(q.shape)} {str(dt)[6:]} "
                  f"({key[:-1]}): {row['ms']:.4f} ms/launch, profiler device time "
                  f"{fmt(dev_ms)}, bound {bound_ms:.5f} ms ({row['bound_by']}); plain "
                  f"{row['plain_ms']:.4f} ms; library {row['library_ms']:.4f} ms, profiler "
                  f"device time {fmt(lib_dev)} (scaled_dot_product_attention "
                  f"{'forward' if name == 'attention_fwd' else 'backward, dQ and dK/dV'})",
                  flush=True)
        out[name] = (args[name], scale, row)
    if timed:
        dq_ms, dkv_ms = dev_times["attention_dq"], dev_times["attention_dkv"]
        lib_ms = dev_times["library attention_dq"]
        both = None if dq_ms is None or dkv_ms is None else dq_ms + dkv_ms
        ratio = "not measured" if both is None or lib_ms is None else f"{both / lib_ms:.2f}x"
        print(f"[timing] {card}: dQ + dK/dV {where} {tuple(q.shape)} {str(dt)[6:]}: "
              f"profiler device time {fmt(both)} against the SDPA backward's "
              f"{fmt(lib_ms)} ({ratio})", flush=True)
    return out


def check_attention(ta, dev, card: str) -> dict:
    """Phase 6: each kernel against its plain version (and a second launch
    of itself, which must give the same bits) at the encoder and decoder
    shapes and at the head dims of ATT_EXTRA in f32 and bf16 (from 160 up
    with its profiler device time beside its bound and the SDPA call's, and
    dQ + dK/dV beside the SDPA backward), at batch*heads 70000 in bf16, and
    with q and k times 3 (scores up to about 54) in f32 (att_case).
    Returns the bf16 encoder-shape inputs of each kernel (the main path's
    most frequent launch) for timing."""
    import torch

    g = torch.Generator().manual_seed(3)
    main_inputs = {}
    cases = [(where, shape, ("float32", "bfloat16"), 1.0) for where, shape in ATT_SHAPES.items()]
    cases += [(where, spec[0], spec[1], spec[2] if len(spec) > 2 else 1.0)
              for where, spec in ATT_EXTRA.items()]
    for where, shape, dts, amp in cases:
        for dt in (getattr(torch, name) for name in dts):
            timed = shape[2] >= 160 and amp == 1.0  # on no configuration's path
            res = att_case(ta, dev, card, where, shape, dt, amp, g, timed)
            if dt == torch.bfloat16 and where == "encoder":
                main_inputs = {name: (args, scale) for name, (args, scale, _) in res.items()}
            del res
    check_flash_wide(ta, dev)
    return main_inputs


def check_model(dev, x, y, tag: str = "[model]", build=None, loss_of=None) -> None:
    """Phase 7: one micro-step of the full-width VideoMAEOperator (loss and
    every gradient) through the kernels against the same weights through
    the plain versions, in f32 and in bf16.  The plain bf16-vs-f32 gap is
    the control: it must lie far above the f32 bound.  ``build(dtype,
    attn_impl)`` and ``loss_of(model)`` give another model and its loss
    (phase 17's aux model on both streams)."""
    import torch
    from sciml_pde_torch.models.transformer import VideoMAEOperator
    from sciml_pde_torch.train.transformer_train import transformer_nrmse

    if build is None:
        def build(dt, impl):
            return VideoMAEOperator(**NS_MODEL, dtype=dt, attn_impl=impl,
                                    generator=torch.Generator().manual_seed(2))

        def loss_of(model):
            return transformer_nrmse(model(x), y)
    sd = None
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        for impl in ("flash", "plain"):
            model = build(dt, impl)
            if sd is None:
                sd = model.state_dict()
            model.load_state_dict(sd)
            model.to(dev)
            names = [n for n, _ in model.named_parameters()]
            loss = loss_of(model)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            outs[str(dt)[6:], impl] = dict(zip(["loss"] + names, [loss.detach()] + list(grads)))
            del model, loss, grads
    torch.cuda.synchronize()

    def errs(a, b):
        return {n: rel_err(outs[a][n], outs[b][n])[1] for n in outs[b]}

    def worst(e):
        n = max(e, key=e.get)
        return f"{e[n]:.3e} ({n})"

    e32 = errs(("float32", "flash"), ("float32", "plain"))
    e16 = errs(("bfloat16", "flash"), ("bfloat16", "plain"))
    gap = errs(("bfloat16", "plain"), ("float32", "plain"))
    gap_k = errs(("bfloat16", "flash"), ("float32", "plain"))
    finite = all(bool(torch.isfinite(t).all()) for o in outs.values() for t in o.values())
    print(f"{tag} loss f32 kernels {outs['float32', 'flash']['loss'].item():.6g}, plain "
          f"{outs['float32', 'plain']['loss'].item():.6g}; bf16 kernels "
          f"{outs['bfloat16', 'flash']['loss'].item():.6g}, plain "
          f"{outs['bfloat16', 'plain']['loss'].item():.6g}; {len(e32)} outputs", flush=True)
    check(finite and max(e32.values()) <= TOL_MODEL["f32"]
          and max(gap.values()) > 10 * TOL_MODEL["f32"],
          f"{tag} f32 kernels vs plain, worst rel-to-max {worst(e32)} (tol "
          f"{TOL_MODEL['f32']:.0e}); control: plain bf16-vs-f32 gap {worst(gap)} above 10x the "
          f"tol")
    check(max(e16.values()) <= TOL_MODEL["bf16"]
          and max(gap_k.values()) <= 2 * max(gap.values()),
          f"{tag} bf16 kernels vs plain, worst rel-to-max {worst(e16)} (tol "
          f"{TOL_MODEL['bf16']:.0e}); kernels vs f32 {worst(gap_k)}, at most twice the plain "
          f"version's {worst(gap)}")


def train_ns(ds, run_dir: Path, dev, bf16: bool, epochs: int, model_name: str):
    """The NS baseline through the trainer at the full recipe (NS_MODEL,
    batch NS_BATCH x accumulation NS_ACCUM); returns its result, its seconds
    and the attention kernels' launches in it."""
    import torch
    from sciml_pde_torch.ops import attention as ta
    from sciml_pde_torch.train.transformer_train import train_transformer_baseline

    ta.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_transformer_baseline(ds, run_dir=str(run_dir), model_name=model_name, device=dev,
                                     **ns_recipe(bf16, epochs))
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(ta.LAUNCHES)


def check_ns_launches(what: str, launches: dict, micro: int, val_batches: int) -> None:
    """NS_LAYERS launches of each attention kernel a micro-step, and of the
    forward a val batch too."""
    want = {"attention_fwd": NS_LAYERS * (micro + val_batches),
            "attention_dq": NS_LAYERS * micro, "attention_dkv": NS_LAYERS * micro}
    for name, n in want.items():
        check(launches[name] == n > 0,
              f"{what} launched {name} {launches[name]}x ({NS_LAYERS} per micro-step"
              f"{' and per val batch' if name == 'attention_fwd' else ''}: {n} expected)")


def time_ns_micro_step(dev, card: str, ds, batches, dtype, ours) -> float:
    """ms per micro-step (CUDA events over ``batches``, after NS_ACCUM warm
    ones) of a fresh full-width NS model in ``dtype`` through the trainer's
    step; then one optimizer step under ``device_profile`` (``ours``: the
    profiler keys of the port's kernels)."""
    import torch
    from sciml_pde_torch.models.transformer import VideoMAEOperator
    from sciml_pde_torch.train.transformer_train import (
        build_transformer_baseline_step,
        make_transformer_optimizer,
    )

    model = VideoMAEOperator(**NS_MODEL, drop_path_rate=0.1, dtype=dtype,
                             generator=torch.Generator().manual_seed(0)).to(dev)
    opt = make_transformer_optimizer(dict(model.named_parameters()), NS_LR, NS_LR, 1000,
                                     grad_accum=NS_ACCUM)
    step, _ = build_transformer_baseline_step(model, opt, NS_MODEL["num_frames"])
    for b in batches[:NS_ACCUM]:
        step(ds.train.data, b)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for b in batches:
        loss, _ = step(ds.train.data, b)
    e.record()
    e.synchronize()
    micro_ms = s.elapsed_time(e) / len(batches)
    label = str(dtype)[6:]
    check(bool(torch.isfinite(loss)), f"[timing] NS {label} loss finite")
    print(f"[timing] {card}: NS VideoMAE micro-step {micro_ms:.4f} ms, optimizer step "
          f"{micro_ms * NS_ACCUM:.4f} ms ({NS_ACCUM} micro-steps, batch {NS_BATCH}, "
          f"1280 tokens, {label})", flush=True)
    device_profile(card, lambda: [step(ds.train.data, b) for b in batches[:NS_ACCUM]],
                   NS_ACCUM, "micro-step", micro_ms, ours)
    return micro_ms


def transformer_path(dev, card: str, run_dir: Path) -> dict:
    """Phases 6-9 (the NS VideoMAE path); returns the attention kernels'
    rows of the kernel table."""
    import torch

    from sciml_pde_torch.data.ns import NSBaselineDataset
    from sciml_pde_torch.data.windows import WindowedTrajectories
    from sciml_pde_torch.ops import attention as ta

    rows = {}
    t = time.perf_counter()
    # ---- 6. attention kernels vs plain versions -------------------------------
    att_inputs = check_attention(ta, dev, card)

    t = phase_done(card, "phase 6", t)
    # ---- 7. the full-width model through the kernels --------------------------
    store = make_ns_store(NS_TRAJ + NS_TEST, NS_T, seed=4, dev=dev)
    t_in = NS_MODEL["num_frames"]
    x = store[:NS_BATCH, :t_in]
    check_model(dev, x, store[:NS_BATCH, t_in])

    t = phase_done(card, "phase 7", t)
    # ---- 8. train: the NS transformer baseline, through the trainer -----------
    ns_grid = torch.zeros(NS_MODEL["img_size"], NS_MODEL["img_size"], 2, device=dev)
    ns_ds = NSBaselineDataset(
        train=WindowedTrajectories(store[:NS_TRAJ], ns_grid, initial_step=t_in, rollout=1,
                                   train=True, device=dev),
        test=WindowedTrajectories(store[NS_TRAJ:, :t_in + 1], ns_grid, initial_step=t_in,
                                  rollout=1, train=False, device=dev),
    )
    micro = len(ns_ds.train.window_index()) // NS_BATCH * NS_EPOCHS
    val_batches = -(-NS_TEST // NS_BATCH) * NS_EPOCHS
    res, train_s, att_launches = train_ns(ns_ds, run_dir, dev, True, NS_EPOCHS, "NS_smoke_VMAE")
    hist = res.history
    print(f"[train] NS VideoMAE, {micro} micro-steps = {micro // NS_ACCUM} optimizer steps "
          f"(batch {NS_BATCH} x accumulation {NS_ACCUM}, lr {NS_LR} cosine, bf16) + "
          f"{val_batches} val batches in {train_s:.3f} s: first step loss "
          f"{hist[0]['first_step_loss']:.6g}; per epoch train loss "
          + ", ".join(f"{h['train_loss']:.6g}" for h in hist) + "; val loss "
          + ", ".join(f"{h['val_loss']:.6g}" for h in hist), flush=True)
    losses = [hist[0]["first_step_loss"]] + [h[k] for h in hist
                                             for k in ("train_loss", "val_loss", "last_step_loss")]
    check(all(math.isfinite(v) for v in losses), "[train] NS losses finite")
    check(hist[-1]["train_loss"] < hist[0]["train_loss"] < hist[0]["first_step_loss"],
          "[train] NS loss falls (first epoch mean below the first step, last epoch mean "
          "below the first)")
    check((run_dir / "NS_smoke_VMAE_ckpt").exists(), "[train] NS best-val checkpoint written")
    print(f"[train] launches: {json.dumps(att_launches)}", flush=True)
    check_ns_launches("[train] main path", att_launches, micro, val_batches)

    t = phase_done(card, "phase 8", t)
    # ---- 9. timing of the transformer path ------------------------------------
    idx_all = torch.as_tensor(ns_ds.train.window_index(), dtype=torch.long, device=dev)
    batches = [idx_all[i * NS_BATCH:(i + 1) * NS_BATCH] for i in range(2 * NS_ACCUM)]
    time_ns_micro_step(dev, card, ns_ds, batches, torch.bfloat16,
                       tuple(key for keys in ATT_KERNEL_KEYS.values() for key in keys.values()))

    sdpa = torch.nn.functional.scaled_dot_product_attention
    (q, k, v), scale = att_inputs["attention_fwd"]
    (_, _, _, do, _, _), _ = att_inputs["attention_dq"]
    bh, n, d = q.shape
    as4 = lambda t: t.view(NS_BATCH, bh // NS_BATCH, n, d)  # noqa: E731
    q4, k4, v4 = (as4(t).detach().requires_grad_(True) for t in (q, k, v))
    o4 = sdpa(q4, k4, v4, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(o4, (q4, k4, v4), as4(do), retain_graph=True)  # noqa: E731
    lib = {"attention_fwd": cuda_ms(lambda: sdpa(as4(q), as4(k), as4(v), scale=scale))}
    lib["attention_dq"] = lib["attention_dkv"] = cuda_ms(sdpa_bwd)
    work = {name: att_work(name, bh, n, d, bf=True) for name in ta.KERNEL_NAMES}
    bounds = {name: max(nbytes / HBM_BPS, ops_s) * 1e3 for name, (nbytes, ops_s) in work.items()}
    lib_dev = {"attention_fwd": profiler_ms(lambda: sdpa(as4(q), as4(k), as4(v), scale=scale),
                                            bound_ms=bounds["attention_fwd"])}
    lib_dev["attention_dq"] = lib_dev["attention_dkv"] = profiler_ms(
        sdpa_bwd, bound_ms=max(bounds["attention_dq"], bounds["attention_dkv"]))
    for name in ta.KERNEL_NAMES:
        args, scale = att_inputs[name]
        nbytes, ops_s = att_work(name, bh, n, d, bf=True)
        rows[name] = {
            "name": name, "route": "cuda", "source": "sciml_pde_torch/ops/csrc/attention.cu",
            "replaces": ATT_SITES[name], "launches": att_launches[name],
            "max_abs_err": max(rel_err(a, b)[0] for a, b in zip(
                as_tuple(getattr(ta, name)(*args, scale)),
                as_tuple(getattr(ta, f"{name}_plain")(*args, scale)))),
            "ms": cuda_ms(lambda: getattr(ta, name)(*args, scale)),
            "plain_ms": cuda_ms(lambda: getattr(ta, f"{name}_plain")(*args, scale)),
            "bound_ms": max(nbytes / HBM_BPS, ops_s) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BPS >= ops_s else "operations",
            "library_ms": lib[name],
            "device_ms": profiler_ms(lambda: getattr(ta, name)(*args, scale),
                                     ATT_KERNEL_KEYS["bf16"][name], bound_ms=bounds[name]),
            "library_device_ms": lib_dev[name],
        }
        r = rows[name]
        print(f"[timing] {card}: {name} at {tuple(q.shape)} bf16: {r['ms']:.4f} ms/launch "
              f"(profiler device time {fmt(r['device_ms'])}), "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
              f"library {r['library_ms']:.4f} ms (scaled_dot_product_attention "
              f"{'forward' if name == 'attention_fwd' else 'backward, dQ and dK/dV together'}"
              f"; profiler device time {fmt(r['library_device_ms'])}), "
              f"{r['launches']} launches in the training run", flush=True)
    for where, (bh_d, n_d, d_d) in ATT_SHAPES.items():
        if where == "encoder":
            continue
        g = torch.Generator().manual_seed(5)
        qd, kd, vd, dod = (torch.randn(bh_d, n_d, d_d, generator=g).to(dev, torch.bfloat16)
                           for _ in range(4))
        od, ld = ta.attention_fwd(qd, kd, vd, scale)
        deltad = torch.sum(dod.float() * od.float(), dim=-1, keepdim=True)
        print(f"[timing] {card}: {where} shape {(bh_d, n_d, d_d)} bf16: attention_fwd "
              f"{cuda_ms(lambda: ta.attention_fwd(qd, kd, vd, scale)):.4f} ms, attention_dq "
              f"{cuda_ms(lambda: ta.attention_dq(qd, kd, vd, dod, ld, deltad, scale)):.4f} ms, "
              f"attention_dkv "
              f"{cuda_ms(lambda: ta.attention_dkv(qd, kd, vd, dod, ld, deltad, scale)):.4f} ms",
              flush=True)
    # the f32 kernels (split TF32): their times at the encoder shape beside
    # their plain versions and the f32 SDPA forward and backward on the same
    # inputs
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    q4f, k4f, v4f = (as4(t).detach().requires_grad_(True) for t in (qf, kf, vf))
    o4f = sdpa(q4f, k4f, v4f, scale=scale)
    of, lf = ta.attention_fwd(qf, kf, vf, scale)
    deltaf = torch.sum(dof * of, dim=-1, keepdim=True)
    f32_args = {"attention_fwd": (qf, kf, vf), "attention_dq": (qf, kf, vf, dof, lf, deltaf),
                "attention_dkv": (qf, kf, vf, dof, lf, deltaf)}
    sdpa_f32 = {"attention_fwd": lambda: sdpa(as4(qf), as4(kf), as4(vf), scale=scale)}
    sdpa_f32["attention_dq"] = sdpa_f32["attention_dkv"] = lambda: torch.autograd.grad(
        o4f, (q4f, k4f, v4f), as4(dof), retain_graph=True)
    for name in ta.KERNEL_NAMES:
        r, args = rows[name], f32_args[name]
        r["f32_ms"] = cuda_ms(lambda: getattr(ta, name)(*args, scale))
        f32_bytes, f32_ops_s = att_work(name, bh, n, d, bf=False)
        r["f32_bound_ms"] = max(f32_bytes / HBM_BPS, f32_ops_s) * 1e3
        r["f32_device_ms"] = profiler_ms(lambda: getattr(ta, name)(*args, scale),
                                         ATT_KERNEL_KEYS["f32"][name],
                                         bound_ms=r["f32_bound_ms"])
        r["f32_plain_ms"] = cuda_ms(lambda: getattr(ta, f"{name}_plain")(*args, scale))
        r["f32_library_ms"] = cuda_ms(sdpa_f32[name])
        r["f32_library_device_ms"] = profiler_ms(sdpa_f32[name], bound_ms=r["f32_bound_ms"])
        print(f"[timing] {card}: {name} at {tuple(q.shape)} f32 (split-TF32 tensor-core body): "
              f"{r['f32_ms']:.4f} ms/launch (profiler device time {fmt(r['f32_device_ms'])}), "
              f"plain {r['f32_plain_ms']:.4f} ms, bound {r['f32_bound_ms']:.5f} ms "
              f"(operations), library {r['f32_library_ms']:.4f} ms "
              f"(scaled_dot_product_attention "
              f"{'forward' if name == 'attention_fwd' else 'backward, dQ and dK/dV together'}"
              f", f32; profiler device time {fmt(r['f32_library_device_ms'])})", flush=True)
    del q4f, k4f, v4f, o4f, f32_args

    t = phase_done(card, "phase 9", t)
    # ---- 9b. the f32 path: the trainer with bf16=False, then its micro-step -
    f32_ds = NSBaselineDataset(
        train=WindowedTrajectories(store[:1, :t_in + 2 * NS_ACCUM * NS_BATCH], ns_grid,
                                   initial_step=t_in, rollout=1, train=True, device=dev),
        test=WindowedTrajectories(store[NS_TRAJ:NS_TRAJ + 1, :t_in + 1], ns_grid,
                                  initial_step=t_in, rollout=1, train=False, device=dev),
    )
    micro32 = len(f32_ds.train.window_index()) // NS_BATCH
    val32 = -(-len(f32_ds.test.window_index()) // NS_BATCH)
    res32, train32_s, launches32 = train_ns(f32_ds, run_dir, dev, False, 1, "NS_smoke_VMAE_f32")
    h32 = res32.history[0]
    print(f"[train f32] NS VideoMAE with bf16=False, {micro32} micro-steps = "
          f"{micro32 // NS_ACCUM} optimizer steps (batch {NS_BATCH} x accumulation {NS_ACCUM}) "
          f"+ {val32} val batch in {train32_s:.3f} s: first step loss "
          f"{h32['first_step_loss']:.6g}, last step loss {h32['last_step_loss']:.6g}, train "
          f"loss {h32['train_loss']:.6g}, val loss {h32['val_loss']:.6g}; launches "
          f"{json.dumps(launches32)}", flush=True)
    check(micro32 // NS_ACCUM >= 2 and all(math.isfinite(h32[k]) for k in (
        "first_step_loss", "last_step_loss", "train_loss", "val_loss")),
          f"[train f32] {micro32 // NS_ACCUM} optimizer steps, losses finite")
    check_ns_launches("[train f32] the f32 path", launches32, micro32, val32)
    for name in ta.KERNEL_NAMES:
        rows[name]["f32_launches"] = launches32[name]
    time_ns_micro_step(dev, card, ns_ds, batches, torch.float32,
                       tuple(ATT_KERNEL_KEYS["f32"].values()))

    phase_done(card, "phase 9b", t)
    return rows


def sf_work(x, w1, w2, pw, bias, out, m1: int, m2: int) -> tuple[int, int]:
    """(bytes each input read and each output written once, f32 FLOPs) of one
    fused dft2 layer: the W-axis rDFT, the corner DFT, the mode mix, the
    inverse corner DFT, the inverse W step and the pointwise product."""
    b, h, w, c = x.shape
    o, r, k = out.shape[-1], 2 * m1, m2
    nbytes = sum(t.numel() * 4 for t in (x, w1, w2, pw, bias, out))
    flops = 2 * b * (h * w * c * 2 * k + 2 * h * 2 * r * k * c + 2 * c * 2 * o * r * k
                     + 2 * r * 2 * h * k * o + h * w * o * 2 * k + h * w * c * o)
    return nbytes, flops


def sf_layer_checks(sf, what: str, ins: tuple, m1: int, m2: int):
    """The fused layer kernel on ``ins`` (x, w1, w2, pw, bias) against its
    plain f32 version: within SF_TOL of the largest magnitude, the same bits
    from a second launch, and the plain version on bf16-rounded inputs more
    than 10x SF_TOL away (the control).  Prints the wrapper's plan.  Returns
    the output and its largest absolute error."""
    import torch

    x = ins[0]
    b, h, w, ci = x.shape
    co = ins[3].shape[1]
    out = sf.spectral_fused_layer(*ins, m1, m2)
    again = sf.spectral_fused_layer(*ins, m1, m2)
    ref = sf.fused_fno_layer_2d_plain(*ins, m1, m2)
    ctl = sf.fused_fno_layer_2d_plain(*(t.bfloat16().float() for t in ins), m1, m2)
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref)
    ctl_rel = rel_err(ctl, ref)[1]
    same = torch.equal(out, again)
    pl = sf.plan(h, w, ci, co, m1, m2)
    layout = ", ".join(f"{k} {pl[k]}" for k in ("P", "HB", "RB", "S", "KP", "RP", "smem1", "RT",
                                                 "WT", "URC", "smem2"))
    check(bool(torch.isfinite(out).all()) and rel <= SF_TOL and ctl_rel > 10 * SF_TOL and same,
          f"[layer] spectral_fused {what} {tuple(x.shape)} -> {co}, modes ({m1}, {m2}), plan "
          f"({layout}): max abs err {err:.3e}, rel-to-max {rel:.3e} (tol {SF_TOL:.0e}); same "
          f"bits twice {same}; control: plain on bf16-rounded inputs {ctl_rel:.3e} above 10x "
          "the tol")
    return out, err


def check_layer(dev) -> tuple:
    """Phase 10: the fused dft2 layer through its autograd op at the flagship
    layer shape, with its gradients, then the kernel alone there and at
    SF_SHAPES (``sf_layer_checks``).  Returns the flagship's inputs, output,
    largest error and the launches of the op's run."""
    import torch
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.ops import spectral_fused as sf

    g = torch.Generator().manual_seed(6)
    hp = XY + PAD
    k = 1.0 / math.sqrt(WIDTH)
    x = torch.randn(B, hp, hp, WIDTH, generator=g).to(dev)
    w1, w2 = ((torch.rand(2, WIDTH, WIDTH, MODES, MODES, generator=g) / WIDTH**2).to(dev)
              for _ in range(2))
    pw = ((2 * torch.rand(WIDTH, WIDTH, generator=g) - 1) * k).to(dev)
    bias = ((2 * torch.rand(WIDTH, generator=g) - 1) * k).to(dev)
    spectral.set_dft_precision("highest")
    ins = [t.clone().requires_grad_(True) for t in (x, w1, w2, pw, bias)]
    sf.reset_launch_counts()
    out = sf.fused_fno_layer_2d(*ins, MODES, MODES)
    (out * out).sum().backward()
    torch.cuda.synchronize()
    launches = sf.LAUNCHES["spectral_fused"]
    check(launches == 1, f"[layer] the op launched the fused layer kernel {launches}x (1 expected)")
    ref_in = [t.clone().requires_grad_(True) for t in (x, w1, w2, pw, bias)]
    ref = sf.fused_fno_layer_2d_plain(*ref_in, MODES, MODES)
    (ref * ref).sum().backward()
    torch.cuda.synchronize()
    rel = rel_err(out.detach(), ref.detach())[1]
    check(bool(torch.isfinite(out).all()) and rel <= SF_TOL,
          f"[layer] the op's output at {tuple(x.shape)}: rel-to-max {rel:.3e} (tol {SF_TOL:.0e})")
    for name, a, b in zip(("dx", "dw1", "dw2", "dpw", "dbias"), ins, ref_in):
        gerr, grel = rel_err(a.grad, b.grad)
        check(grel <= SF_TOL, f"[layer] {name} of sum(out^2) vs autograd of the plain forward: "
              f"max abs err {gerr:.3e}, rel-to-max {grel:.3e} (tol {SF_TOL:.0e})")
    _, err = sf_layer_checks(sf, "flagship", (x, w1, w2, pw, bias), MODES, MODES)
    for what, (b_, h_, w_, ci, co, m1, m2) in SF_SHAPES.items():
        gs = torch.Generator().manual_seed(7)
        small = (torch.randn(b_, h_, w_, ci, generator=gs),
                 *(torch.rand(2, ci, co, m1, m2, generator=gs) / (ci * co) for _ in range(2)),
                 (2 * torch.rand(ci, co, generator=gs) - 1) * ci**-0.5,
                 (2 * torch.rand(co, generator=gs) - 1) * ci**-0.5)
        sf_layer_checks(sf, what, tuple(t.to(dev) for t in small), m1, m2)
    spectral.set_dft_precision("default")
    return (x, w1, w2, pw, bias), out.detach(), err, launches


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat_leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def production_path(dev, card: str, run_dir: Path, store, grid, tree, ds) -> dict:
    """Phases 10-13 (the production FNO step, the fused dft2 layer and the
    probe's timing); returns the layer's row of the kernel table."""
    import numpy as np
    import torch

    from sciml_pde_torch.data.dr import DRBaselineDataset
    from sciml_pde_torch.data.windows import WindowedTrajectories, gather_windows
    from sciml_pde_torch.experiments.spectral_impl_bench import bench_shape
    from sciml_pde_torch.models.fno import FNO2d
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.ops import spectral_fused as sf
    from sciml_pde_torch.train import fast_step as fs
    from sciml_pde_torch.train.fno_train import build_baseline_step, train_baseline
    from sciml_pde_torch.train.optim import make_optimizer
    from sciml_pde_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

    t = time.perf_counter()
    # ---- 10. the fused dft2 layer ---------------------------------------------
    layer_in, layer_out, layer_err, layer_launches = check_layer(dev)

    t = phase_done(card, "phase 10", t)
    # ---- 11. the production step against the fused step ----------------------
    spectral.set_dft_precision("highest")
    model = FNO2d(CC, MODES, MODES, WIDTH, T0)
    model.load_state_dict(flax_to_state_dict(tree))
    x = torch.from_numpy(store[:B, :T0]).permute(0, 2, 3, 1, 4).contiguous()
    gb = torch.from_numpy(grid)[None].expand(B, *grid.shape)
    with torch.no_grad():
        on_cpu = model(x, gb)
        on_card = model.to(dev)(x.to(dev), gb.to(dev)).cpu()
    err, rel = rel_err(on_card, on_cpu)
    check(rel <= TOL_FORWARD, f"[step] plain FNO2d forward ({spectral.get_spectral_impl()}, "
          f"highest) on the card vs the CPU in f32: max abs err {err:.3e}, rel-to-max "
          f"{rel:.3e} (tol {TOL_FORWARD:.0e})")
    data, gridd = ds.train.data, ds.train.grid
    rng = np.random.default_rng(7)
    widx = ds.train.window_index()
    idxs = [torch.as_tensor(widx[rng.choice(len(widx), B, replace=False)], dtype=torch.long,
                            device=dev) for _ in range(PROD_STEPS)]
    params = dict(model.named_parameters())
    step, _ = build_baseline_step(model, make_optimizer(params, 1e-3, 10_000), T0, 1)
    theta, spec = fs.fast_state_from_tree(tree, MODES, dev)
    fopt = fs.init_opt(theta)
    fstep, _ = fs.build_fast_baseline_step(MODES, T0, spec, 1e-3, 10_000)
    grid2 = gridd.permute(2, 0, 1).contiguous()
    worst = {"loss": 0.0, "grad norm": 0.0}
    for idx in idxs:
        loss_p, gn_p = step(data, gridd, idx)
        theta, fopt, loss_f, gn_f = fstep(theta, fopt, data, grid2, idx)
        for key, a, b in (("loss", loss_f, loss_p), ("grad norm", gn_f, gn_p)):
            worst[key] = max(worst[key], abs(float(a) - float(b)) / abs(float(b)))
    got = flat_leaves(fs.tree_from_fast_state(theta, spec, MODES))
    want = flat_leaves(state_dict_to_flax(params))
    excess = max(((got[k].to(dev) - torch.as_tensor(v, device=dev)).abs()
                  - PARAM_RTOL * torch.as_tensor(v, device=dev).abs()).max().item()
                 for k, v in want.items())
    check(max(worst.values()) <= PROD_RTOL and excess <= PARAM_ATOL,
          f"[step] {PROD_STEPS} production steps vs fused steps (highest): worst rel loss "
          f"{worst['loss']:.3e}, grad norm {worst['grad norm']:.3e} (rtol {PROD_RTOL:.0e}); "
          f"params |a-b| - {PARAM_RTOL:.0e}|b| at most {excess:.3e} (atol {PARAM_ATOL:.0e})")
    del model, params, step, theta, fopt, fstep

    t = phase_done(card, "phase 11", t)
    # ---- 12. train on the production step -------------------------------------
    spectral.set_dft_precision("default")
    t0 = time.perf_counter()
    res = train_baseline(ds, modes=MODES, width=WIDTH, initial_step=T0, num_channels=CC,
                         batch_size=B, epochs=1, learning_rate=1e-3, seed=0,
                         run_dir=str(run_dir), model_name="DR_smoke_prod_FNO", log_every=0,
                         fast_step=False, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    h = res.history[0]
    n_steps = len(ds.train.window_index()) // B
    print(f"[train] production step ({spectral.get_spectral_impl()}, default, cosine), "
          f"{n_steps} steps + val in {train_s:.3f} s: first step loss {h['first_step_loss']:.6g}, "
          f"last step loss {h['last_step_loss']:.6g}, epoch train loss {h['train_loss']:.6g}, "
          f"val loss {h['val_loss']:.6g}", flush=True)
    check(all(math.isfinite(h[k]) for k in ("first_step_loss", "last_step_loss", "train_loss",
                                            "val_loss")), "[train] production losses finite")
    check(h["last_step_loss"] < h["first_step_loss"] and h["train_loss"] < h["first_step_loss"],
          "[train] production loss falls (last step and epoch mean below the first step)")
    check((run_dir / "DR_smoke_prod_FNO_ckpt").exists(),
          "[train] production best-val checkpoint written")

    def small(n_t, rollout=1):
        return DRBaselineDataset(
            train=WindowedTrajectories(ds.train.data[:1, :n_t], grid, initial_step=T0,
                                       rollout=rollout, train=True, device=dev),
            test=WindowedTrajectories(ds.test.data[:, :n_t], grid, initial_step=T0,
                                      rollout=rollout, train=False, device=dev))
    res = train_baseline(small(30), modes=MODES, width=WIDTH, initial_step=T0,
                         num_channels=CC, batch_size=B, epochs=2, scheduler="step",
                         scheduler_step=3, scheduler_gamma=0.5, seed=0, run_dir=str(run_dir),
                         model_name="DR_smoke_steplr_FNO", log_every=0, fast_step=False,
                         device=dev)
    losses = [v for hh in res.history for v in (hh["train_loss"], hh["val_loss"])]
    print(f"[train] StepLR (step 3, gamma 0.5), 2 epochs x 5 steps: train/val losses "
          + ", ".join(f"{v:.6g}" for v in losses), flush=True)
    check(len(res.history) == 2 and all(map(math.isfinite, losses))
          and (run_dir / "DR_smoke_steplr_FNO_ckpt").exists(),
          "[train] StepLR run: finite losses and a checkpoint")
    n_t, t_train = 40, T0 + 5
    ar = small(n_t)
    widx = ar.train.window_index()
    idx = torch.as_tensor(widx[-B:], dtype=torch.long, device=dev)
    _, y = gather_windows(ar.train.data, idx, T0, t_train - T0)
    frames = np.minimum(widx[-B:, 1, None] + T0 + np.arange(t_train - T0)[None], n_t - 1)
    want_y = np.moveaxis(ar.train.data.cpu().numpy()[widx[-B:, 0, None], frames], 1, -2)
    check(bool(torch.equal(y.cpu(), torch.from_numpy(want_y))),
          f"[train] the gather clamps frames past the end on the card (t0 up to "
          f"{int(widx[-1, 1])}, {t_train - T0} target frames of {n_t})")
    res = train_baseline(ar, modes=MODES, width=WIDTH, initial_step=T0, num_channels=CC,
                         batch_size=B, epochs=1, training_type="autoregressive",
                         t_train=t_train, seed=0, run_dir=str(run_dir),
                         model_name="DR_smoke_ar_FNO", log_every=0, fast_step=False, device=dev)
    torch.cuda.synchronize()
    h = res.history[0]
    print(f"[train] autoregressive, t_train {t_train} ({t_train - T0} teacher-forced steps), "
          f"{len(widx) // B} steps: first step loss {h['first_step_loss']:.6g}, train loss "
          f"{h['train_loss']:.6g}, val loss {h['val_loss']:.6g}", flush=True)
    check(all(math.isfinite(h[k]) for k in ("first_step_loss", "train_loss", "val_loss")),
          "[train] autoregressive run finite, no device assert")

    t = phase_done(card, "phase 12", t)
    # ---- 13. timing -------------------------------------------------------------
    model = FNO2d(CC, MODES, MODES, WIDTH, T0)
    model.load_state_dict(flax_to_state_dict(tree))
    model.to(dev)
    params = dict(model.named_parameters())
    step, _ = build_baseline_step(model, make_optimizer(params, 1e-3, 10_000), T0, 1)
    idx = idxs[0]
    for _ in range(3):
        step(data, gridd, idx)
    torch.cuda.synchronize()
    n = 30
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        loss, _ = step(data, gridd, idx)
    e.record()
    e.synchronize()
    step_ms = s.elapsed_time(e) / n
    check(bool(torch.isfinite(loss)), "[timing] production loss finite")
    print(f"[timing] {card}: production step ({spectral.get_spectral_impl()}, default) "
          f"{step_ms:.4f} ms = {1e3 / step_ms:.2f} steps/s (batch {B}, 128^2, width {WIDTH}, "
          f"modes {MODES})", flush=True)

    def prod_steps():
        for _ in range(10):
            step(data, gridd, idx)
    device_profile(card, prod_steps, 10, "step", step_ms, ())
    ab = bench_shape("dr", B, XY, CC, steps=30, windows=3, device=dev)
    print(f"[timing] {card}: bench_shape dr: dft {ab['dft']['steps_per_sec_median']:.2f} "
          f"steps/s, dft2 {ab['dft2']['steps_per_sec_median']:.2f} steps/s, dft2/dft "
          f"{ab['speedup_dft2_vs_dft']:.4f} (median of 3 windows of 30 steps)", flush=True)
    print(json.dumps({"bench_shape": ab}), flush=True)

    nbytes, flops = sf_work(*layer_in, layer_out, MODES, MODES)
    row = {
        "name": "spectral_fused", "route": "cuda",
        "source": "sciml_pde_torch/ops/csrc/spectral_fused.cu", "replaces": SF_SITE,
        "launches": layer_launches, "max_abs_err": layer_err,
        "ms": cuda_ms(lambda: sf.spectral_fused_layer(*layer_in, MODES, MODES)),
        "device_ms": None,
        "plain_ms": cuda_ms(lambda: sf.fused_fno_layer_2d_plain(*layer_in, MODES, MODES)),
        "bound_ms": max(nbytes / HBM_BPS, flops / PEAK_FLOPS["highest"]) * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BPS >= flops / PEAK_FLOPS["highest"]
        else "operations",
        "library_ms": None,
    }
    parts = [profiler_ms(lambda: sf.spectral_fused_layer(*layer_in, MODES, MODES), key)
             for key in SF_KERNEL_KEYS]
    row["device_ms"] = None if None in parts else sum(parts)
    print(f"[timing] {card}: spectral_fused at {tuple(layer_in[0].shape)} f32: "
          f"{row['ms']:.4f} ms/launch (profiler device time of its kernels "
          f"{fmt(row['device_ms'])}: " + ", ".join(f"{k} {fmt(t)}" for k, t in
                                                     zip(SF_KERNEL_KEYS, parts))
          + f"), plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}: {nbytes} bytes, {flops} FLOP), "
          f"{row['launches']} launch in the layer run", flush=True)
    phase_done(card, "phase 13", t)
    return {"spectral_fused": row}


def rel_to_max(got, want) -> float:
    """max |got - want| over max |want| of tensors or arrays on any device,
    or the largest of that over the leaves of two flax trees."""
    import torch

    if isinstance(want, dict):
        return max(rel_to_max(got[k], v) for k, v in want.items())
    return rel_err(torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu())[1]


def eval_aux_path(dev, card: str, run_dir: Path, store, grid, ds) -> None:
    """Phase 4b: the rollout evaluation of phase 4's checkpoint (trained on
    the fused step) and aux joint training at the flagship width."""
    import pickle
    import shutil

    import numpy as np
    import torch

    from sciml_pde_torch.data.dr import DRAuxDataset, _resize_trilinear
    from sciml_pde_torch.data.windows import WindowedTrajectories
    from sciml_pde_torch.eval.rollout import METRIC_NAMES, convention_table
    from sciml_pde_torch.models.fno import FNO2d, FNO2dAux
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.train.fno_train import (
        build_aux_step,
        default_init_tree,
        evaluate_checkpoint,
        train_aux,
    )
    from sciml_pde_torch.train.optim import aux_group_of, make_grouped_optimizer
    from sciml_pde_torch.utils.checkpoint import restore_checkpoint
    from sciml_pde_torch.utils.weights import flax_to_state_dict

    # ---- the main path's evaluation: the card against the CPU --------------------
    name, cpu_dir = "DR_smoke_FNO", run_dir / "cpu"
    cpu_dir.mkdir(parents=True, exist_ok=True)
    shutil.copytree(run_dir / f"{name}_ckpt", cpu_dir / f"{name}_ckpt", dirs_exist_ok=True)
    test_cpu = WindowedTrajectories(ds.test.data.cpu(), grid, initial_step=T0, train=False)
    kw = dict(modes=MODES, width=WIDTH, batch_size=B, model_name=name)
    # Under `default`, the main path's precision, the card and the CPU round
    # f32 values that differ in their last bits to bf16 DFT inputs, and a
    # value on a rounding step moves by 2^-8 of itself: their distance is
    # printed as that noise.  Under `highest` the two differ only in f32
    # summation order and are held to EVAL_ROLLOUTS.
    for prec in ("default", "highest"):
        spectral.set_dft_precision(prec)
        for rollout, tol in EVAL_ROLLOUTS.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = evaluate_checkpoint(ds.test, rollout_test=rollout, run_dir=str(run_dir),
                                      device=dev, **kw)
            eval_s = time.perf_counter() - t0
            errs = res.history[0]
            with (run_dir / f"{name}.pickle").open("rb") as f:
                six = pickle.load(f)
            mse = np.load(run_dir / f"{name}_mse_time.npz")
            want = evaluate_checkpoint(test_cpu, rollout_test=rollout, run_dir=str(cpu_dir),
                                       device="cpu", **kw).history[0]
            vals = [errs[k] for k in METRIC_NAMES] + errs["mse_time"]
            rels = {k: abs(errs[k] - want[k]) / abs(want[k]) for k in METRIC_NAMES}
            rels["mse_time"] = max(abs(a - b) / abs(b) for a, b in zip(errs["mse_time"],
                                                                      want["mse_time"]))
            what = f"[eval] {prec}, rollout {rollout}"
            print(f"{what}, {card}: {ds.test.num_trajectories} test trajectories (batch {B}) "
                  f"in {eval_s:.3f} s wall: "
                  + ", ".join(f"{k} {errs[k]:.6g}" for k in METRIC_NAMES)
                  + f", mse_time {errs['mse_time']}", flush=True)
            check(all(map(math.isfinite, vals)), f"{what}: six metrics and mse_time finite")
            dist = (", ".join(f"{k} {v:.3e}" for k, v in rels.items())
                    + " relative")
            if prec == "highest":
                check(max(rels.values()) <= tol, f"{what} on the card vs the CPU: {dist} "
                      f"(tol {tol:.0e})")
            else:
                print(f"{what} on the card vs the CPU (bf16 noise, not checked): {dist}",
                      flush=True)
            check(isinstance(six, tuple) and len(six) == 6
                  and all(isinstance(v, float) for v in six)
                  and [float(v) for v in six] == [errs[k] for k in METRIC_NAMES]
                  and list(mse["t"]) == list(range(T0, T0 + rollout))
                  and mse["mse"].shape == (rollout,),
                  f"{what}: the pickle reads back as six floats and the npz holds {rollout} "
                  "steps")
    model = FNO2d(CC, MODES, MODES, WIDTH, T0)
    model.load_state_dict(flax_to_state_dict(res.params))
    model.to(dev)
    table = convention_table(model, ds.test, 5, batch_size=B)
    print(f"[eval] convention_table, rollout 1..5: {json.dumps(table)}", flush=True)
    check(all(math.isfinite(v) for row in table.values() for v in row)
          and all(len(row) == 5 for row in table.values())
          and abs(table["perch_final"][-1] - errs["nRMSE"]) <= 1e-5 * errs["nRMSE"],
          f"[eval] convention_table finite, perch_final at 5 ({table['perch_final'][-1]:.6g}) "
          f"is the rollout-5 nRMSE ({errs['nRMSE']:.6g})")

    # ---- aux: the store, upsampled on the card and on the CPU ---------------------
    n_train = ds.train.num_trajectories
    aux_np, _ = make_store(seed=5, n_traj=n_train * AUX_NA, n_t=AUX_T, xy=AUX_XY)
    t0 = time.perf_counter()
    aux_dev = _resize_trilinear(aux_np, (N_T, XY, XY), device=dev)
    torch.cuda.synchronize()
    resize_s = time.perf_counter() - t0
    aux_cpu = _resize_trilinear(aux_np, (N_T, XY, XY), device="cpu")
    rel = rel_to_max(aux_dev, aux_cpu)
    check(tuple(aux_dev.shape) == (n_train * AUX_NA, N_T, XY, XY, CC) and rel <= TOL_RESIZE,
          f"[aux] {aux_np.shape} upsampled to {tuple(aux_dev.shape)} on the card in "
          f"{resize_s:.3f} s: rel-to-max {rel:.3e} from the CPU's (tol {TOL_RESIZE:.0e})")

    # ---- one aux step on the card and on the CPU from the same tree ---------------
    spectral.set_dft_precision("highest")
    tree = default_init_tree(CC, MODES, WIDTH, T0, seed=1, aux=True)
    lrs = {"shared": 1e-3, "primary_head": 1e-3, "aux_head": 1e-3}
    idx = np.array([[0, 0], [3, 17], [5, 40], [n_train - 1, 90]])

    def make_aux(where):
        m = FNO2dAux(CC, MODES, MODES, WIDTH, T0)
        m.load_state_dict(flax_to_state_dict(tree))
        m.to(where)
        opt = make_grouped_optimizer(dict(m.named_parameters()), aux_group_of, lrs, 1000)
        return build_aux_step(m, opt, T0, 1, AUX_NA, AUX_WEIGHT)[0], m, opt
    gd, idx_d = torch.from_numpy(grid).to(dev), torch.as_tensor(idx, device=dev)
    card_vs_cpu(f"[aux] one step ({AUX_NA} aux samples, weight {AUX_WEIGHT}, highest)",
                make_aux, (ds.train.data, aux_dev, gd, idx_d),
                (ds.train.data.cpu(), aux_cpu, torch.from_numpy(grid), torch.as_tensor(idx)),
                TOL_AUX_STEP)
    step, data, aux = make_aux(dev)[0], ds.train.data, aux_dev
    spectral.set_dft_precision("default")
    aux_ms = timed_steps(lambda: step(data, aux, gd, idx_d), 20)
    (loss, _, _), _ = step(data, aux, gd, idx_d)
    check(math.isfinite(float(loss)), "[timing] aux step loss finite")
    print(f"[timing] {card}: aux step (default, {B} primary + {B * AUX_NA} aux windows, "
          f"{XY}^2, width {WIDTH}, modes {MODES}) {aux_ms:.4f} ms = {1e3 / aux_ms:.2f} "
          "steps/s (CUDA events, warm)", flush=True)
    del step, aux_cpu

    # ---- aux joint training through the trainer, then its evaluation --------------
    aux_ds = DRAuxDataset(primary_train=ds.train, primary_test=ds.test,
                          aux_train=WindowedTrajectories(aux_dev, grid, initial_step=T0,
                                                         train=True, device=dev))
    t0 = time.perf_counter()
    res = train_aux(aux_ds, modes=MODES, width=WIDTH, initial_step=T0, num_channels=CC,
                    batch_size=B, epochs=2, num_aux_samples=AUX_NA,
                    auxiliary_weight=AUX_WEIGHT, seed=0, run_dir=str(run_dir),
                    model_name="DR_smoke_aux_FNO", log_every=0, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = len(ds.train.window_index()) // B
    print(f"[aux] train_aux, 2 epochs x {steps} steps + val in {train_s:.3f} s: "
          + "; ".join(f"epoch {h['epoch']} train loss {h['train_loss']:.6g}, val loss "
                      f"{h['val_loss']:.6g}" for h in res.history), flush=True)
    ckpt = run_dir / "DR_smoke_aux_FNO_ckpt"
    vals = [v for h in res.history for v in (h["train_loss"], h["val_loss"])]
    best = min(res.history, key=lambda h: h["val_loss"])
    ck = restore_checkpoint(ckpt) if ckpt.exists() else {"meta": {}, "params": {}}
    check(len(res.history) == 2 and all(map(math.isfinite, vals))
          and ck["meta"].get("epoch") == best["epoch"]
          and sorted(ck["params"]) == ["backbone", "fc2_auxiliary", "fc2_primary"],
          f"[aux] losses finite; the checkpoint holds the best primary val loss's epoch "
          f"({best['epoch']}) and both heads")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluate_checkpoint(ds.test, if_aux=True, rollout_test=5, run_dir=str(run_dir),
                              modes=MODES, width=WIDTH, batch_size=B,
                              model_name="DR_smoke_aux_FNO", device=dev)
    eval_s = time.perf_counter() - t0
    errs = res.history[0]
    print(f"[eval] {card}: the aux checkpoint's primary head, rollout 5 in {eval_s:.3f} s "
          "wall: " + ", ".join(f"{k} {errs[k]:.6g}" for k in METRIC_NAMES), flush=True)
    check(all(math.isfinite(errs[k]) for k in METRIC_NAMES),
          "[eval] the aux checkpoint's six metrics finite")


def split_flops(name: str, b: int, t: int) -> int:
    """FLOPs one call of a split function needs at the flagship shape: the
    products of the JAX kernel's body, dot and mode mix, 2 per
    multiply-add (8 per complex one); sums and activations not counted."""
    c, k, r, hp, nx = WIDTH, MODES, 2 * MODES, XY + PAD, XY
    npix, field, f = b * nx * nx, b * hp * hp, t * CC + 2
    wdft, corner_dft = 2 * field * c * 2 * k, 8 * b * k * c * r * hp
    mix = 8 * b * k * r * c * c
    layer = wdft + 2 * corner_dft + mix + 2 * field * c * (2 * k + c)
    return {
        "bb_forward": 2 * npix * f * c + FNO_LAYERS * layer,
        "head_forward": 2 * npix * (NH * c + CC * NH),
        "head_backward": 2 * npix * (3 * NH * c + 2 * CC * NH),
        "bb_backward": FNO_LAYERS * layer + 2 * npix * c * f,
        "bb_weight_grads": FNO_LAYERS * (2 * wdft + 2 * corner_dft + mix + 2 * field * c * c),
    }[name]


def split_path(dev, card: str, win, grid2, p, cot) -> dict:
    """Phase 14: the five split functions at the flagship shape; returns
    their rows of the kernel table (launches filled in by phase 15)."""
    from types import SimpleNamespace

    import torch
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral

    def bf16_spectrum_corner(a, pf, w, q, adj, spec_dtype, bf, spec_only=False):
        return fk.corner_plain(a, pf, w, q, adj, spec_dtype if adj else torch.bfloat16, bf,
                               spec_only)

    ops_bf16_spec = SimpleNamespace(**{**vars(fk.PLAIN), "corner": bf16_spectrum_corner})
    rd = lambda t: t.bfloat16().float()  # noqa: E731
    p_bf16_mix = p._replace(wmr=rd(p.wmr), wmi=rd(p.wmi))
    rows, timing = {}, {}
    for prec in ("highest", "default"):
        spectral.set_dft_precision(prec)
        # the chain through the kernels; each call's inputs kept for the checks
        pre, bbout, stats, h0p = ff._bb_forward(win, grid2, p, MODES, MODES, PAD)
        pred = ff._head_forward(bbout, stats, p)
        dbb, dw1t, db1, dw2t, db2 = ff._head_backward(cot, bbout, stats, p)
        dpre, dw0t, db0 = ff._bb_backward(dbb, pre, win, grid2, stats, p, MODES, MODES, PAD)
        dwmr, dwmi, dpw, dpb = ff._bb_weight_grads(pre, h0p, dpre, p, MODES, MODES, PAD, XY, XY)
        calls = {
            "bb_forward": (ff._bb_forward, (win, grid2, p, MODES, MODES, PAD)),
            "head_forward": (ff._head_forward, (bbout, stats, p)),
            "head_backward": (ff._head_backward, (cot, bbout, stats, p)),
            "bb_backward": (ff._bb_backward, (dbb, pre, win, grid2, stats, p, MODES, MODES, PAD)),
            "bb_weight_grads": (ff._bb_weight_grads, (pre, h0p, dpre, p, MODES, MODES, PAD, XY,
                                                      XY)),
        }
        for name, (fn, args) in calls.items():
            fk.reset_launch_counts()
            out_k = fn(*args)
            torch.cuda.synchronize()
            stages = {k: v for k, v in fk.LAUNCHES.items() if v}
            out_p = fn(*args, ops=fk.PLAIN)
            err, rel = worst(out_k, out_p)
            finite = all(bool(torch.isfinite(t).all()) for t in tensors(out_k))
            check(finite and rel <= TOL[prec] and stages == SPLIT_STAGES[name],
                  f"[split {prec}] {name}: max abs err {err:.3e}, rel-to-max {rel:.3e} (tol "
                  f"{TOL[prec]:.0e}); stage launches per call {json.dumps(stages)}")
            if prec == "default" and name == "bb_backward":
                # the mix weights reach dpre directly; dw0t and db0 are pixel
                # sums of the lift cotangent, where the chain's bf16 rounding
                # noise outweighs them, so their largest errors (printed) do
                # not tell f32 mix weights from bf16 ones: mean errors over
                # dpre do, as the bf16 attention controls compare
                ctl = fn(*args[:5], p_bf16_mix, *args[6:], ops=fk.PLAIN)
                k_mean = (out_k[0] - out_p[0]).abs().mean().item()
                c_mean = (ctl[0] - out_p[0]).abs().mean().item()
                check(k_mean < c_mean / 2,
                      f"[split default] {name} control: over dpre the plain version with "
                      f"bf16-rounded mix weights lies {c_mean:.3e} (mean abs) from the plain "
                      f"version, the kernels {k_mean:.3e} (below half); largest rel-to-max "
                      f"errors of all outputs: control {worst(ctl, out_p)[1]:.3e}, kernels "
                      f"{rel:.3e}")
                bb_backward_witness(dev, args[1:], p_bf16_mix, bbout, stats, p)
            if prec == "default" and name == "bb_weight_grads":
                ctl_rel = worst(fn(*args, ops=ops_bf16_spec), out_p)[1]
                check(rel < ctl_rel / 2, f"[split default] {name} control: the plain version "
                      f"with a bf16 spectrum lies {ctl_rel:.3e} from the plain version, the "
                      f"kernels {rel:.3e} (below half)")
            ms = cuda_ms(lambda: fn(*args))
            plain_ms = cuda_ms(lambda: fn(*args, ops=fk.PLAIN))
            timing[name, prec] = (ms, plain_ms)
            if prec == "highest":
                _, sources, fields = SPLIT_ROWS[name]
                nbytes = sum(t.numel() * t.element_size() for t in
                             tensors([a for a in args if not isinstance(a, ff.FastFNOParams)])
                             + [getattr(p, f) for f in fields] + tensors(out_k))
                fl = split_flops(name, B, T0)
                bound_s = max(nbytes / HBM_BPS, fl / PEAK_FLOPS[prec])
                rows[name] = {
                    "name": name, "route": "cuda",
                    "source": f"sciml_pde_torch/ops/csrc/fno_{sources[0]}.cu",
                    "sources": [f"sciml_pde_torch/ops/csrc/fno_{s}.cu" for s in sources],
                    "replaces": f"{SPLIT_SITE}:{SPLIT_ROWS[name][0]}", "launches": 0,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_s * 1e3,
                    "bound_by": "bytes" if nbytes / HBM_BPS >= fl / PEAK_FLOPS[prec]
                    else "operations",
                    "library_ms": None, "stage_launches_per_call": stages,
                    "bytes": nbytes, "flops": fl,
                }
        if prec == "highest":
            want = ff.fno2d_fused_reference(win, grid2, p, MODES, MODES, PAD)
            want_g = ff.fno2d_fused_vjp_reference(cot, win, grid2, p, MODES, MODES, PAD)
            got_g = ff.FastFNOParams(dwmr, dwmi, dpw, dpb, dw0t, db0, dw1t, db1, dw2t, db2)
            errs = {"pred": rel_err(pred, want)[1]}
            errs.update({f"d{n}": rel_err(a, b)[1]
                         for n, a, b in zip(ff.FastFNOParams._fields, got_g, want_g)})
            n_worst = max(errs, key=errs.get)
            check(max(errs.values()) <= TOL_SPLIT_CHAIN,
                  f"[split highest] the five chained vs the plain fused forward and VJP: worst "
                  f"rel-to-max {errs[n_worst]:.3e} ({n_worst}; tol {TOL_SPLIT_CHAIN:.0e})")
    spectral.set_dft_precision("default")
    for name, r in rows.items():
        ms_d, plain_d = timing[name, "default"]
        print(f"[timing] {card}: {name} (split, flagship): {r['ms']:.4f} ms/call `highest` "
              f"({ms_d:.4f} `default`), plain {r['plain_ms']:.4f} ms ({plain_d:.4f}), bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {r['bytes']} bytes, {r['flops']} FLOP "
              f"at 67 TFLOP/s f32)", flush=True)
    return rows


def probe_path(dev, card: str, run_dir: Path) -> dict:
    """Phase 15: the ported perf probe, all eleven configs in this process
    with the launch counts set to 0 before and read after, then one config
    through the probe's own subprocess runner on its default device.
    Returns the launches of the split functions and the stage kernels."""
    import os

    import torch
    from sciml_pde_torch.experiments import perf_probe as pp
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk

    os.environ["PROBE_SCAN_K"] = str(PROBE_SCAN_K)
    fk.reset_launch_counts()
    ff.reset_split_counts()
    results = {}
    for name in pp.CONFIGS:
        t0 = time.perf_counter()
        results[name] = pp.run_config(name, dev)
        results[name]["wall_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(results[name]), flush=True)
    launches = {**ff.SPLIT_LAUNCHES, **fk.LAUNCHES}
    print(f"[probe] {card}: PROBE_SCAN_K {PROBE_SCAN_K}, PROBE_ITERS 20, flagship shape\n"
          + pp.table(results), flush=True)
    for name, res in results.items():
        check(pp.ok(res), f"[probe] {name}: no error, finite result"
              + (f" ({res['error']}: {res.get('error_lines', [])[-1:]})" if "error" in res
                 else ""))
    print(f"[probe] launches: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"[probe] the probe run launched {name} {n}x")
    out = run_dir / "perf_probe_main.json"
    pp.main(["--configs", "iso_headfwd", "--out", str(out)])
    res = json.loads(out.read_text())["iso_headfwd"]
    check(pp.ok(res) and res["device"] == torch.cuda.get_device_name(0),
          f"[probe] the subprocess runner on its default device: iso_headfwd "
          f"{res.get('steps_per_sec', float('nan')):.2f} calls/s on {res.get('device')}")
    return launches


def make_plume_store(n_traj: int, n_t: int, seed: int, dev):
    """Smooth plume-shaped trajectories (N, T, 50, 50, 89, 4) made on the
    card: per channel four travelling, decaying 3D sinusoids with seeded
    amplitudes, wave numbers, phases, speeds and rates."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    axes = [torch.linspace(-1, 1, n, device=dev) for n in NS3D_SP]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    t = torch.linspace(0, 3, n_t, device=dev)[:, None, None, None]
    data = torch.zeros(n_traj, n_t, *NS3D_SP, NS3D_C, device=dev)
    for n in range(n_traj):
        for c in range(NS3D_C):
            for _ in range(4):
                a = rng.normal()
                kx, ky, kz = (int(k) for k in rng.integers(1, 4, 3))
                px, py, pz, cz = rng.uniform(0, 2 * np.pi, 4).tolist()
                lam = rng.uniform(0.1, 0.5)
                data[n, ..., c] += (a * torch.exp(-lam * t)
                                    * torch.sin(np.pi * kx * gx + px)
                                    * torch.cos(np.pi * ky * gy + py)
                                    * torch.sin(np.pi * kz * gz + pz + cz * t))
            data[n, ..., c] += 0.1 * rng.normal()
    return data


def timed_steps(step, n: int) -> float:
    """ms per call of ``step()`` in CUDA events over ``n`` warm calls."""
    import torch

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        step()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def card_vs_cpu(what: str, make_step, args_card: tuple, args_cpu: tuple, tol: float,
                to_tree=None) -> None:
    """One step on the card and on the CPU from the same tree (``make_step(dev)
    -> (step, model, opt)``; ``step(*args) -> (losses, g_norm)``): the losses
    and the grad norm relative, Adam's first moment leaf by leaf, and the
    updated parameters against the tree's largest magnitude, each within
    ``tol`` (phase 4b's rule: Adam's first update amplifies f32 noise in
    gradients near 1e-8, so single leaves are printed, not checked).
    ``to_tree``: the model's state_dict -> flax tree (the FNO's by default)."""
    import numpy as np
    import torch

    from sciml_pde_torch.utils.weights import state_dict_to_flax

    to_tree = to_tree or state_dict_to_flax
    outs = {}
    for where, args in (("card", args_card), ("cpu", args_cpu)):
        step, model, opt = make_step(args[0].device)
        losses, g_norm = step(*args)
        losses = losses if isinstance(losses, tuple) else (losses,)
        outs[where] = ([float(v) for v in (*losses, g_norm)], to_tree(model.state_dict()),
                       to_tree(opt.m))
    (lc, tc, mc), (lw, tw, mw) = outs["card"], outs["cpu"]
    rels = [abs(a - b) / abs(b) for a, b in zip(lc, lw)]
    mrel = rel_to_max(mc, mw)
    fc, fw = flat_leaves(tc), flat_leaves(tw)
    tree_max = max(float(np.abs(v).max()) for v in fw.values())
    prel = max(float(np.abs(np.asarray(v) - np.asarray(fw[k])).max()) for k, v in fc.items())
    leaf = {k: rel_to_max(v, fw[k]) for k, v in fc.items()}
    worst_leaf = max(leaf, key=leaf.get)
    check(max(rels) <= tol and mrel <= tol and prel / tree_max <= tol,
          f"{what} on the card vs the CPU: losses and grad norm "
          + ", ".join(f"{v:.6g} ({r:.3e})" for v, r in zip(lc, rels))
          + f"; Adam's first moment, each leaf rel-to-max {mrel:.3e}; updated params "
          f"{prel / tree_max:.3e} of the tree's largest magnitude {tree_max:.4g} (tol "
          f"{tol:.0e}; worst leaf {worst_leaf} {leaf[worst_leaf]:.3e} of its own)")
    torch.cuda.synchronize()


def ns_recipe(bf16: bool, epochs: int) -> dict:
    """The transformer trainers' keywords of the NS recipe (NS_MODEL, batch
    NS_BATCH x accumulation NS_ACCUM, drop-path 0.1)."""
    return dict(
        img_size=NS_MODEL["img_size"], patch_size=NS_MODEL["patch_size"],
        tubelet_size=NS_MODEL["tubelet_size"], in_chans=NS_MODEL["in_chans"],
        encoder_embed_dim=NS_MODEL["encoder_dim"], encoder_depth=NS_MODEL["encoder_depth"],
        encoder_num_heads=NS_MODEL["encoder_heads"], decoder_embed_dim=NS_MODEL["decoder_dim"],
        decoder_depth=NS_MODEL["decoder_depth"], decoder_num_heads=NS_MODEL["decoder_heads"],
        drop_path_rate=0.1, bf16=bf16, initial_step=NS_MODEL["num_frames"],
        batch_size=NS_BATCH, grad_accum=NS_ACCUM, epochs=epochs, learning_rate_share=NS_LR,
        learning_rate_heads=NS_LR, seed=0, log_every=0)


def check_aux_launches(what: str, shapes: dict, micro: int, val_batches: int, dt: str) -> None:
    """Each attention kernel's launches by shape in an NS aux run: per
    micro-step 12 at the aux encoder shape and 8 at the aux decoder shape
    (the trunk's batch 2 + 6), per val batch the forward at the primary
    batch's shapes (the primary stream alone), nothing else."""
    want = {}
    for (where, (bh, n, d)), (_, (bh_v, _, _)) in zip(AUXT_ATT_SHAPES.items(),
                                                     ATT_SHAPES.items()):
        layers = NS_MODEL["encoder_depth" if "encoder" in where else "decoder_depth"]
        for name in ("attention_fwd", "attention_dq", "attention_dkv"):
            want[name, bh, n, d, dt] = layers * micro
        if val_batches:
            want["attention_fwd", bh_v, n, d, dt] = layers * val_batches
    got = {k: v for k, v in shapes.items() if v}
    check(got == want, f"{what} launches by (kernel, bh, n, d, type): "
          + ", ".join(f"{k[0]} {k[1:4]} {v}x" for k, v in sorted(got.items()))
          + f" ({micro} micro-steps: 12 and 8 a micro-step at the aux encoder and decoder "
          f"shapes; {val_batches} val batches on the primary stream alone)")


def aux_transformer_path(dev, card: str, run_dir: Path) -> dict:
    """Phase 17: the NS VideoMAE aux joint training (ROADMAP A5) at full
    width, the kernels at its shapes, SWA, early-window sampling, remat,
    masked-SSL pretraining with partial loading and the 3D VideoMAE.
    Returns the kernel table's rows at the aux shapes."""
    import numpy as np
    import torch

    from sciml_pde_torch.data.ns import NSAuxDataset, NSBaselineDataset, ns_aux_row_map
    from sciml_pde_torch.data.ns3d import NS3DAuxDataset, unit_grid_3d
    from sciml_pde_torch.data.windows import WindowedTrajectories
    from sciml_pde_torch.models.transformer import VideoMAEOperatorAux
    from sciml_pde_torch.models.transformer3d import Transformer3DAux, Transformer3DBaseline
    from sciml_pde_torch.ops import attention as ta
    from sciml_pde_torch.train import transformer_train as ttt
    from sciml_pde_torch.train.fno_train import (
        build_aux_step,
        build_baseline_step,
        train_aux,
        train_baseline,
        transformer3d_core_kwargs,
    )
    from sciml_pde_torch.train.optim import aux_group_of, make_grouped_optimizer, make_optimizer
    from sciml_pde_torch.train.ssl_pretrain import run_ssl_pretraining
    from sciml_pde_torch.utils.checkpoint import partial_load_counts, restore_checkpoint
    from sciml_pde_torch.utils.weights import transformer_state_dict_to_flax

    t_phase = time.perf_counter()
    t_in = NS_MODEL["num_frames"]
    xy = NS_MODEL["img_size"]
    to_tree = transformer_state_dict_to_flax

    t_sub = time.perf_counter()
    # ---- 17a. the three kernels at the aux shapes, both types ----------------------
    rows = {}
    g = torch.Generator().manual_seed(17)
    for where, shape in AUXT_ATT_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            for name, (_, _, r) in att_case(ta, dev, card, where, shape, dt, 1.0, g,
                                            timed=True).items():
                key = f"{name} ({where})"
                if dt == torch.bfloat16:
                    rows[key] = {"name": key, "route": "cuda",
                                 "source": "sciml_pde_torch/ops/csrc/attention.cu",
                                 "replaces": ATT_SITES[name], "shape": list(shape),
                                 "launches": 0, **r}
                else:
                    rows[key].update({f"f32_{k}": v for k, v in r.items()})

    t_sub = phase_done(card, "17a", t_sub)
    # ---- 17b. one aux micro-step of the full-width model, kernels vs plain -----------
    store = make_ns_store(NS_TRAJ + NS_TEST, NS_T, seed=4, dev=dev, xy=xy)
    aux_full = make_ns_store(NS_TRAJ * AUXT_NA, NS_T, seed=31, dev=dev, xy=xy)
    nb, na = NS_BATCH, NS_BATCH * AUXT_NA
    x, y = store[:nb, :t_in], store[:nb, t_in]
    xa, ya = aux_full[:na, :t_in], aux_full[:na, t_in]
    for shared in (False, True):
        def build(dt, impl, shared=shared):
            return VideoMAEOperatorAux(**NS_MODEL, dtype=dt, attn_impl=impl, shared_head=shared,
                                       generator=torch.Generator().manual_seed(2))

        def loss_of(model):
            pp, pa = model(x, xa)
            return ttt.transformer_nrmse(pp, y) + AUXT_W * ttt.transformer_nrmse(pa, ya)
        check_model(dev, x, y, f"[aux model, {'shared head' if shared else 'separate heads'}, "
                    f"{nb} + {na} windows]", build, loss_of)

    t_sub = phase_done(card, "17b", t_sub)
    # ---- 17c. one f32 aux micro-step on the card against the CPU ---------------------
    small = dict(NS_MODEL, **SHALLOW)
    sd_small = VideoMAEOperatorAux(**small, generator=torch.Generator().manual_seed(5)).state_dict()

    def make_aux_step(d):
        model = VideoMAEOperatorAux(**small)
        model.load_state_dict(sd_small)
        model.to(d)
        opt = ttt.make_transformer_optimizer(dict(model.named_parameters()), NS_LR, NS_LR, 100)
        step, _ = ttt.build_transformer_aux_step(model, opt, t_in, AUXT_NA, AUXT_W)
        return step, model, opt
    prim_c, aux_c = store[:1, :t_in + 2], aux_full[:AUXT_NA, :t_in + 2]
    idx_c = torch.tensor([[0, 1]])
    card_vs_cpu(f"[aux step] one f32 aux micro-step (encoder {SHALLOW['encoder_depth']} and "
                f"decoder {SHALLOW['decoder_depth']} blocks at full width, 1280 tokens, 1 + "
                f"{AUXT_NA} windows)", make_aux_step, (prim_c, aux_c, idx_c.to(dev)),
                (prim_c.cpu(), aux_c.cpu(), idx_c), TOL_AUX_STEP, to_tree=to_tree)
    del aux_full, prim_c, aux_c

    t_sub = phase_done(card, "17c", t_sub)
    # ---- 17d. the trainer: NS aux, aux store at 128^2 in bf16 -------------------------
    grid = torch.zeros(xy, xy, 2, device=dev)
    aux128 = make_ns_store(NS_TRAJ * AUXT_NA, NS_T, seed=32, dev=dev, xy=AUXT_XY)

    def aux_ds(prim, test, per_file):
        return NSAuxDataset(
            primary_train=WindowedTrajectories(prim, grid, initial_step=t_in, rollout=1,
                                               train=True, device=dev),
            primary_test=WindowedTrajectories(test, grid, initial_step=t_in, rollout=1,
                                              train=False, device=dev),
            aux_train=WindowedTrajectories(aux128, grid[:AUXT_XY, :AUXT_XY], initial_step=t_in,
                                           rollout=1, train=True, device=dev,
                                           dtype=torch.bfloat16),
            aux_row_map=ns_aux_row_map(per_file, AUXT_NA, NS_TRAJ))
    ds = aux_ds(store[:NS_TRAJ], store[NS_TRAJ:, :t_in + 1], [list(range(NS_TRAJ))])
    micro = len(ds.primary_train.window_index()) // NS_BATCH * AUXT_EPOCHS
    val_batches = -(-NS_TEST // NS_BATCH) * AUXT_EPOCHS
    ta.reset_launch_counts()
    t0 = time.perf_counter()
    res = ttt.train_transformer_aux(ds, num_aux_samples=AUXT_NA, auxiliary_weight=AUXT_W,
                                    run_dir=str(run_dir), model_name="NS_smoke_VMAE_aux",
                                    device=dev, **ns_recipe(True, AUXT_EPOCHS))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches, shapes = dict(ta.LAUNCHES), dict(ta.LAUNCH_SHAPES)
    hist = res.history
    print(f"[aux train] {card}: NS VideoMAE aux (separate heads, {AUXT_NA} aux windows a "
          f"window, weight {AUXT_W}, aux store {AUXT_XY}^2 bf16 upsampled at the gather), "
          f"{micro} micro-steps = {micro // NS_ACCUM} optimizer steps (batch {NS_BATCH} + "
          f"{NS_BATCH * AUXT_NA} aux x accumulation {NS_ACCUM}, bf16, drop-path 0.1) + "
          f"{val_batches} val batches in {train_s:.3f} s: first step loss "
          f"{hist[0]['first_step_loss']:.6g}; per epoch train loss "
          + ", ".join(f"{h['train_loss']:.6g}" for h in hist) + "; primary val loss "
          + ", ".join(f"{h['val_loss']:.6g}" for h in hist), flush=True)
    losses = [hist[0]["first_step_loss"]] + [h[k] for h in hist
                                             for k in ("train_loss", "val_loss", "last_step_loss")]
    check(all(math.isfinite(v) for v in losses), "[aux train] losses finite")
    check(hist[-1]["train_loss"] < hist[0]["train_loss"] < hist[0]["first_step_loss"],
          "[aux train] loss falls (first epoch mean below the first step, last epoch mean "
          "below the first)")
    ck_path = run_dir / "NS_smoke_VMAE_aux_ckpt"
    check(ck_path.exists() and restore_checkpoint(ck_path)["meta"]["loss"] == res.best_val
          == min(h["val_loss"] for h in hist),
          f"[aux train] the best-primary-val checkpoint written (val {res.best_val:.6g})")
    print(f"[aux train] launches: {json.dumps(launches)}", flush=True)
    check_ns_launches("[aux train] main path", launches, micro, val_batches)
    check_aux_launches("[aux train] main path", shapes, micro, val_batches, "bf16")
    for key, row in rows.items():
        name, where = key.split(" (")
        row["launches"] = shapes.get((name, *AUXT_ATT_SHAPES[where[:-1]], "bf16"), 0)
    # the f32 path: 2 optimizer steps with bf16=False
    f32_ds = aux_ds(store[:1, :t_in + 2 * NS_ACCUM * NS_BATCH], store[NS_TRAJ:, :t_in + 1],
                    [[0]])
    micro32 = len(f32_ds.primary_train.window_index()) // NS_BATCH
    ta.reset_launch_counts()
    res32 = ttt.train_transformer_aux(f32_ds, num_aux_samples=AUXT_NA, auxiliary_weight=AUXT_W,
                                      run_dir=str(run_dir), model_name="NS_smoke_VMAE_aux_f32",
                                      device=dev, **ns_recipe(False, 1))
    shapes32 = dict(ta.LAUNCH_SHAPES)
    h32 = res32.history[0]
    print(f"[aux train f32] {card}: bf16=False, {micro32} micro-steps = {micro32 // NS_ACCUM} "
          f"optimizer steps: first step loss {h32['first_step_loss']:.6g}, train loss "
          f"{h32['train_loss']:.6g}, val loss {h32['val_loss']:.6g}", flush=True)
    check(all(math.isfinite(h32[k]) for k in ("first_step_loss", "train_loss", "val_loss")),
          "[aux train f32] losses finite")
    check_aux_launches("[aux train f32] the f32 path", shapes32, micro32, 1, "f32")
    for key, row in rows.items():
        name, where = key.split(" (")
        row["f32_launches"] = shapes32.get((name, *AUXT_ATT_SHAPES[where[:-1]], "f32"), 0)

    t_sub = phase_done(card, "17d", t_sub)
    # ---- 17e. timing of the aux micro-step ------------------------------------------------
    model = VideoMAEOperatorAux(**NS_MODEL, drop_path_rate=0.1, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0)).to(dev)
    opt = ttt.make_transformer_optimizer(dict(model.named_parameters()), NS_LR, NS_LR, 1000,
                                         grad_accum=NS_ACCUM)
    step, _ = ttt.build_transformer_aux_step(model, opt, t_in, AUXT_NA, AUXT_W, ds.aux_row_map,
                                             aux_resize_to=(xy, xy))
    idx_all = torch.as_tensor(ds.primary_train.window_index(), dtype=torch.long, device=dev)
    batches = [idx_all[i * NS_BATCH:(i + 1) * NS_BATCH] for i in range(2 * NS_ACCUM)]
    data_p, data_a = ds.primary_train.data, ds.aux_train.data
    for b in batches[:NS_ACCUM]:
        step(data_p, data_a, b)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for b in batches:
        (loss, _, _), _ = step(data_p, data_a, b)
    e.record()
    e.synchronize()
    micro_ms = s.elapsed_time(e) / len(batches)
    check(bool(torch.isfinite(loss)), "[aux timing] loss finite")
    print(f"[aux timing] {card}: NS VideoMAE aux micro-step {micro_ms:.4f} ms, optimizer step "
          f"{micro_ms * NS_ACCUM:.4f} ms ({NS_ACCUM} micro-steps, batch {NS_BATCH} + "
          f"{NS_BATCH * AUXT_NA} aux, 1280 tokens, bf16; CUDA events over {len(batches)} "
          f"micro-steps after {NS_ACCUM} warm ones)", flush=True)
    device_profile(card, lambda: [step(data_p, data_a, b) for b in batches[:NS_ACCUM]],
                   NS_ACCUM, "micro-step", micro_ms, tuple(ATT_KERNEL_KEYS["bf16"].values()))
    del model, opt, step

    t_sub = phase_done(card, "17e", t_sub)
    # ---- 17f. SWA and early-window sampling ------------------------------------------------
    swa_ds = aux_ds(store[:1, :t_in + 4], store[NS_TRAJ:NS_TRAJ + 1, :t_in + 1], [[0]])
    res_swa = ttt.train_transformer_aux(
        swa_ds, num_aux_samples=AUXT_NA, auxiliary_weight=AUXT_W, run_dir=str(run_dir),
        model_name="NS_smoke_VMAE_swa", device=dev,
        **dict(ns_recipe(True, 4), grad_accum=1, swa_frac=0.5, early_window_boost=4.0,
               early_window_t0=1))
    fp, fs_ = flat_leaves(res_swa.params), flat_leaves(res_swa.swa_params)
    gap = max(float(np.abs(fs_[k] - v).max()) for k, v in fp.items())
    finite = all(np.isfinite(v).all() for v in fs_.values())
    print(f"[swa] {card}: 4 epochs x 2 micro-steps (grad_accum 1), swa_frac 0.5 (the mean of "
          f"epochs 2 and 3 at lr x 0.1), early_window_boost 4 (t0 <= 1 weighted 5): train loss "
          + ", ".join(f"{h['train_loss']:.6g}" for h in res_swa.history)
          + f"; swa_params vs params, largest difference {gap:.3e}", flush=True)
    check(finite and sorted(fs_) == sorted(fp) and gap > 0,
          "[swa] swa_params finite, of the params' leaves, and apart from the last epoch's")

    t_sub = phase_done(card, "17f", t_sub)
    # ---- 17g. remat: use_checkpoint against none, one bf16 micro-step ----------------------
    sd = None
    outs, peaks, fwd = {}, {}, {}
    for remat in (False, True):
        model = VideoMAEOperatorAux(**NS_MODEL, dtype=torch.bfloat16, use_checkpoint=remat,
                                    generator=torch.Generator().manual_seed(2))
        sd = sd or model.state_dict()
        model.load_state_dict(sd)
        model.to(dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ta.reset_launch_counts()
        pp, pa = model(x, xa)
        loss = ttt.transformer_nrmse(pp, y) + AUXT_W * ttt.transformer_nrmse(pa, ya)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**30
        fwd[remat] = ta.LAUNCHES["attention_fwd"]
        outs[remat] = [loss.detach()] + list(grads)
        del model, pp, pa, loss, grads
    same = all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))
    print(f"[remat] {card}: one bf16 aux micro-step ({nb} + {na} windows), peak memory above "
          f"the weights {peaks[False]:.3f} GiB without use_checkpoint, {peaks[True]:.3f} GiB "
          f"with it; attention_fwd launches {fwd[False]} and {fwd[True]} (the recompute)",
          flush=True)
    check(same and peaks[True] < peaks[False] and fwd[True] == 2 * fwd[False] == 2 * NS_LAYERS,
          "[remat] use_checkpoint: the loss and every gradient the same bits, lower peak "
          "memory, the forward kernel launched again in the recompute")
    del outs

    t_sub = phase_done(card, "17g", t_sub)
    # ---- 17h. masked-SSL pretraining, then partial loading -----------------------------------
    ssl_w = WindowedTrajectories(store[:1, :t_in + 6], grid, initial_step=t_in, rollout=0,
                                 train=True, device=dev)
    ssl_steps = len(ssl_w.window_index()) // NS_BATCH * 3
    ta.reset_launch_counts()
    t0 = time.perf_counter()
    ssl_tree, ssl_hist = run_ssl_pretraining(
        ssl_w, model_kwargs=dict(NS_MODEL, dtype=torch.bfloat16), mask_ratio=0.75,
        initial_step=t_in, batch_size=NS_BATCH, epochs=3, learning_rate=1e-3,
        run_dir=str(run_dir), model_name="NS_smoke_VMAE_ssl", seed=0, log_every=1, device=dev)
    torch.cuda.synchronize()
    ssl_s = time.perf_counter() - t0
    ssl_shapes = dict(ta.LAUNCH_SHAPES)
    step_losses = [json.loads(line)["ssl_loss"] for line in
                   (run_dir / "NS_smoke_VMAE_ssl.jsonl").read_text().splitlines()[-ssl_steps:]]
    dec_shape = (NS_BATCH * NS_MODEL["decoder_heads"], 1280, 64)
    dec = {name: ssl_shapes.get((name, *dec_shape, "bf16"), 0) for name in ta.KERNEL_NAMES}
    enc = sum(v for k, v in ssl_shapes.items() if k[2] != 1280)
    print(f"[ssl] {card}: masked-SSL pretraining at full width, mask ratio 0.75 (the encoder "
          f"sees 320 tokens, the decoder 1280), {ssl_steps} steps of batch {NS_BATCH} (bf16, "
          f"adamw lr 1e-3 cosine) in {ssl_s:.3f} s: step losses "
          + ", ".join(f"{v:.6g}" for v in step_losses)
          + f"; decoder kernel launches {json.dumps(dec)} ({NS_MODEL['decoder_depth']} a step), "
          f"encoder launches {enc} (320 tokens: JAX's shape rule takes jnp_attention)",
          flush=True)
    check(len(step_losses) == ssl_steps and all(math.isfinite(v) for v in step_losses)
          and np.mean(step_losses[-3:]) < np.mean(step_losses[:3]),
          "[ssl] losses finite, the last three steps' mean below the first three's")
    check(set(dec.values()) == {NS_MODEL["decoder_depth"] * ssl_steps} and enc == 0
          and sum(ssl_shapes.values()) == 3 * NS_MODEL["decoder_depth"] * ssl_steps,
          "[ssl] the decoder's attention through the kernels, the encoder's 320 tokens not")
    ssl_ck = run_dir / "NS_smoke_VMAE_ssl_ckpt"
    fresh = to_tree(VideoMAEOperatorAux(**NS_MODEL,
                                        generator=torch.Generator().manual_seed(0)).state_dict())
    loaded, kept = partial_load_counts(fresh, restore_checkpoint(ssl_ck)["params"])
    res_pre = ttt.train_transformer_aux(ds, num_aux_samples=AUXT_NA, auxiliary_weight=AUXT_W,
                                        run_dir=str(run_dir), model_name="NS_smoke_VMAE_pre",
                                        pretrained_path=str(ssl_ck), device=dev,
                                        **ns_recipe(True, 0))
    fr, fssl = flat_leaves(res_pre.params), flat_leaves(ssl_tree)
    shared_leaves = [k for k in fr if k in fssl and fssl[k].shape == fr[k].shape]
    same = all(np.array_equal(fr[k], fssl[k]) for k in shared_leaves)
    print(f"[ssl] pretrained_path into the aux trainer: {loaded} leaves loaded, {kept} kept "
          f"fresh (of {len(fr)}; fresh: "
          + ", ".join(k for k in fr if k not in shared_leaves) + ")", flush=True)
    check(loaded == len(shared_leaves) == len(fr) - 6 and kept == 6 and same,
          "[ssl] the loaded count equals the leaves the aux model shares with the SSL tree, "
          "each equal to the checkpoint's")
    del ssl_w, store, aux128, ds, f32_ds, swa_ds, x, y, xa, ya
    torch.cuda.empty_cache()

    t_sub = phase_done(card, "17h", t_sub)
    # ---- 17i. the 3D VideoMAE at the plume shape ------------------------------------------
    grid3_np = unit_grid_3d(*NS3D_SP)
    grid3 = torch.from_numpy(grid3_np).to(dev)
    prim3 = make_plume_store(2, T0 + 3, seed=41, dev=dev)
    test3 = make_plume_store(1, T0 + 1, seed=42, dev=dev)
    aux3 = make_plume_store(2 * NS3D_NA, T0 + 3, seed=43, dev=dev)
    core = transformer3d_core_kwargs(SHALLOW, NS3D_SP, NS3D_C, T0)
    sp3 = (f"{NS3D_SP}, {NS3D_C} channels, patch {core['patch_size']}, tubelet "
           f"{core['tubelet_size']}, encoder {SHALLOW['encoder_depth']} and decoder "
           f"{SHALLOW['decoder_depth']} blocks at full width, f32")
    ta.reset_launch_counts()
    for what, cls in (("baseline", Transformer3DBaseline), ("aux (nA 3)", Transformer3DAux)):
        sd3 = cls(**core, generator=torch.Generator().manual_seed(6)).state_dict()

        def make_step3(d, cls=cls, sd3=sd3):
            model = cls(**core)
            model.load_state_dict(sd3)
            model.to(d)
            params = dict(model.named_parameters())
            if cls is Transformer3DBaseline:
                opt = make_optimizer(params, 1e-3, 100)
                return build_baseline_step(model, opt, T0, 1)[0], model, opt
            opt = make_grouped_optimizer(params, aux_group_of, {"shared": 1e-3,
                                                                "primary_head": 1e-3,
                                                                "aux_head": 1e-3}, 100)
            return build_aux_step(model, opt, T0, 1, NS3D_NA, AUXT_W)[0], model, opt
        i3 = torch.tensor([[1, 2]])
        args = ((prim3, grid3, i3.to(dev)) if cls is Transformer3DBaseline
                else (prim3, aux3, grid3, i3.to(dev)))
        card_vs_cpu(f"[3d vmae] one {what} step ({sp3})", make_step3, args,
                    tuple(a.cpu() for a in args), TOL_AUX_STEP, to_tree=to_tree)
    train3 = WindowedTrajectories(prim3, grid3_np, initial_step=T0, train=True, device=dev)
    test3_w = WindowedTrajectories(test3, grid3_np, initial_step=T0, train=False, device=dev)
    kw3 = dict(initial_step=T0, num_channels=NS3D_C, batch_size=1, epochs=2, seed=0,
               run_dir=str(run_dir), log_every=0, model_family="transformer3d",
               transformer_kwargs=SHALLOW, device=dev)
    for what, name in (("baseline", "NS3D_smoke_VMAE"), ("aux (nA 3)", "NS3D_smoke_aux_VMAE")):
        t0 = time.perf_counter()
        if name == "NS3D_smoke_VMAE":
            res3 = train_baseline(NSBaselineDataset(train=train3, test=test3_w),
                                  model_name=name, **kw3)
        else:
            res3 = train_aux(NS3DAuxDataset(
                primary_train=train3, primary_test=test3_w,
                aux_train=WindowedTrajectories(aux3, grid3_np, initial_step=T0, train=True,
                                               device=dev)),
                num_aux_samples=NS3D_NA, auxiliary_weight=AUXT_W, model_name=name, **kw3)
        torch.cuda.synchronize()
        hs = res3.history
        print(f"[3d vmae train] {card}: {what} through run_training's model_family="
              f"'transformer3d' ({sp3}), 2 epochs x {len(train3.window_index())} steps + val in "
              f"{time.perf_counter() - t0:.3f} s: "
              + "; ".join(f"epoch {h['epoch']} train loss {h['train_loss']:.6g}, val loss "
                          f"{h['val_loss']:.6g}" for h in hs), flush=True)
        check(len(hs) == 2 and all(math.isfinite(h[k]) for h in hs
                                   for k in ("train_loss", "val_loss"))
              and (run_dir / f"{name}_ckpt").exists(),
              f"[3d vmae train] {what}: finite losses and a checkpoint")
    launches3 = dict(ta.LAUNCHES)
    print(f"[3d vmae] attention kernel launches {json.dumps(launches3)}: 500 tokens, which "
          "JAX's shape rule sends to jnp_attention", flush=True)
    check(sum(launches3.values()) == 0, "[3d vmae] no attention kernel launched at 500 tokens")
    del prim3, test3, aux3
    torch.cuda.empty_cache()
    phase_done(card, "17i", t_sub)
    print(f"[aux] {card}: phase 17 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def ns_fno_path(dev, card: str, run_dir: Path) -> dict:
    """Phase 16: the FNO on NS-2D at full width (the fused baseline through the
    kernels, the production step and its knobs, NS aux joint training) and
    the 3D FNO on the plume shape.  Returns each FNO kernel's launches in the
    NS fused epoch."""
    import numpy as np
    import torch

    from sciml_pde_torch.data.dr import resize_linear
    from sciml_pde_torch.data.ns import NSAuxDataset, NSBaselineDataset, ns_aux_row_map, unit_grid
    from sciml_pde_torch.data.ns3d import NS3DAuxDataset, unit_grid_3d
    from sciml_pde_torch.data.windows import WindowedTrajectories, gather_windows
    from sciml_pde_torch.eval.rollout import METRIC_NAMES
    from sciml_pde_torch.metrics import nrmse_loss
    from sciml_pde_torch.models.fno import FNO2d, FNO3d
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.sim import lie
    from sciml_pde_torch.train import fast_step as fs
    from sciml_pde_torch.train.fno_train import (
        build_aux_step,
        build_baseline_step,
        default_init_tree,
        evaluate_checkpoint,
        make_fno,
        train_aux,
        train_baseline,
    )
    from sciml_pde_torch.train.optim import aux_group_of, make_grouped_optimizer, make_optimizer
    from sciml_pde_torch.utils.checkpoint import restore_checkpoint
    from sciml_pde_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

    t_phase = time.perf_counter()
    xy, cc, b = NSF_XY, NSF_C, NSF_B
    shape = f"batch {b}, {xy}^2, {cc} channels, width {WIDTH}, modes {MODES}"

    t_sub = time.perf_counter()
    # ---- 16a. the fused NS-2D baseline through the kernels ----------------------
    tree = default_init_tree(cc, MODES, WIDTH, T0, seed=1)
    p = ff.pack_params(tree, MODES, MODES, dev)
    store = make_ns_store(NSF_TRAJ + 1, NSF_T, seed=11, dev=dev, xy=xy)
    grid_np = unit_grid(xy, xy)
    grid = torch.from_numpy(grid_np).to(dev)
    grid2 = grid.permute(2, 0, 1).contiguous()
    train_w = WindowedTrajectories(store[:NSF_TRAJ], grid_np, initial_step=T0, train=True,
                                   device=dev)
    test_w = WindowedTrajectories(store[NSF_TRAJ:, :T0 + 1], grid_np, initial_step=T0,
                                  train=False, device=dev)
    widx = train_w.window_index()
    rng = np.random.default_rng(12)
    batches = [torch.as_tensor(widx[rng.choice(len(widx), b, replace=False)], dtype=torch.long,
                               device=dev) for _ in range(PROD_STEPS)]
    win, _ = fs.fast_gather(train_w.data, batches[0], T0)
    cot = torch.randn(b, cc, xy, xy, generator=torch.Generator().manual_seed(13)).to(dev)
    names = ["pred"] + [f"d{n}" for n in ff.FastFNOParams._fields]
    plain_outs = {}
    for prec in ("highest", "default"):
        spectral.set_dft_precision(prec)
        pk = ff.FastFNOParams(*(t.detach().clone().requires_grad_(True) for t in p))
        pred = ff.fno2d_fused_apply(win, grid2, pk, MODES, MODES, PAD)
        (pred * cot).sum().backward()
        plain_outs[prec] = ([ff.fno2d_fused_reference(win, grid2, p, MODES, MODES, PAD)]
                            + list(ff.fno2d_fused_vjp_reference(cot, win, grid2, p, MODES,
                                                                MODES, PAD)))
        for name, got, ref in zip(names, [pred.detach()] + [a.grad for a in pk],
                                  plain_outs[prec]):
            err, rel = rel_err(got, ref)
            check(bool(torch.isfinite(got).all()) and rel <= TOL[prec],
                  f"[ns check {prec}] {name} at {tuple(win.shape)}: max abs err {err:.3e}, "
                  f"rel-to-max {rel:.3e} (tol {TOL[prec]:.0e})")
        del pk, pred
    gaps = {n: rel_err(lo, hi)[1]
            for n, lo, hi in zip(names, plain_outs["default"], plain_outs["highest"])}
    check(max(gaps.values()) > 2 * TOL["default"],
          f"[ns check] the default tolerance {TOL['default']:.0e} lies below half the largest "
          f"plain bf16-vs-f32 gap ({max(gaps.values()):.3e}; "
          + ", ".join(f"{n} {v:.3e}" for n, v in gaps.items()) + ")")
    del plain_outs

    # every FNO kernel against its plain version at this shape (`default`)
    spectral.set_dft_precision("default")
    records, _ = record_calls(win, grid2, cot, p)
    # reduce_rows at the shape the head backward hands it at this size
    part = torch.randn(fk.head_bwd_rows(b * xy * xy), NH * WIDTH + NH + cc * NH + cc,
                       generator=torch.Generator().manual_seed(15)).to(dev)
    records["fno_reduce_rows"] = ("reduce_rows", (part,), {})
    rows = check_kernels(records, "[ns kernel]")
    for key in fk.KERNEL_NAMES:
        r = rows[key]
        lib = ("n/a" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms (profiler device time {fmt(r['library_device_ms'])})")
        print(f"[ns timing] {card}: {key} at the NS shape: {r['ms']:.4f} ms/launch (profiler "
              f"device time {fmt(r['device_ms'])}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), library {lib}", flush=True)
    del records

    # one epoch of the fused step through the trainer: the path's launches
    ds = NSBaselineDataset(train=train_w, test=test_w)
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_baseline(ds, modes=MODES, width=WIDTH, initial_step=T0, num_channels=cc,
                         batch_size=b, epochs=1, learning_rate=1e-3, seed=0,
                         run_dir=str(run_dir), model_name="NS_smoke_fused_FNO", log_every=0,
                         fast_step=True, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    h = res.history[0]
    print(f"[ns train] {card}: fused step, {len(widx) // b} steps + val in {train_s:.3f} s "
          f"({shape}): first step loss {h['first_step_loss']:.6g}, last step loss "
          f"{h['last_step_loss']:.6g}, epoch train loss {h['train_loss']:.6g}, val loss "
          f"{h['val_loss']:.6g}; launches {json.dumps(launches)}", flush=True)
    check(all(math.isfinite(h[k]) for k in ("first_step_loss", "last_step_loss", "train_loss",
                                            "val_loss"))
          and h["last_step_loss"] < h["first_step_loss"]
          and (run_dir / "NS_smoke_fused_FNO_ckpt").exists(),
          "[ns train] fused NS epoch: losses finite, the last step below the first, a "
          "best-val checkpoint")
    for key in fk.KERNEL_NAMES:
        check(launches[key] > 0, f"[ns train] the NS fused path launched {key} "
              f"({launches[key]}x)")
    theta, spec = fs.fast_state_from_tree(tree, MODES, dev)
    fopt = fs.init_opt(theta)
    fstep, _ = fs.build_fast_baseline_step(MODES, T0, spec, 1e-3, 10_000)

    def fused_step():
        nonlocal theta, fopt
        theta, fopt, _, _ = fstep(theta, fopt, train_w.data, grid2, batches[0])
    fused_ms = timed_steps(fused_step, 20)
    print(f"[ns timing] {card}: fused step {fused_ms:.4f} ms = {1e3 / fused_ms:.2f} steps/s "
          f"({shape}, default; CUDA events over 20 warm steps)", flush=True)

    def fused_steps():
        for _ in range(10):
            fused_step()
    device_profile(card, fused_steps, 10, "step", fused_ms, tuple(set(FNO_KERNEL_KEYS.values())))
    del theta, fopt, fstep

    t_sub = phase_done(card, "16a", t_sub)
    # ---- 16b. the production step at the NS shape ---------------------------------
    spectral.set_dft_precision("highest")
    model = FNO2d(cc, MODES, MODES, WIDTH, T0)
    model.load_state_dict(flax_to_state_dict(tree))
    model.to(dev)
    params = dict(model.named_parameters())
    step, _ = build_baseline_step(model, make_optimizer(params, 1e-3, 10_000), T0, 1)
    theta, spec = fs.fast_state_from_tree(tree, MODES, dev)
    fopt = fs.init_opt(theta)
    fstep, _ = fs.build_fast_baseline_step(MODES, T0, spec, 1e-3, 10_000)
    worst_rel = {"loss": 0.0, "grad norm": 0.0}
    for idx in batches:
        loss_p, gn_p = step(train_w.data, grid, idx)
        theta, fopt, loss_f, gn_f = fstep(theta, fopt, train_w.data, grid2, idx)
        for key, x, y in (("loss", loss_f, loss_p), ("grad norm", gn_f, gn_p)):
            worst_rel[key] = max(worst_rel[key], abs(float(x) - float(y)) / abs(float(y)))
    got = flat_leaves(fs.tree_from_fast_state(theta, spec, MODES))
    want = flat_leaves(state_dict_to_flax(params))
    excess = max(((got[k].to(dev) - torch.as_tensor(v, device=dev)).abs()
                  - PARAM_RTOL * torch.as_tensor(v, device=dev).abs()).max().item()
                 for k, v in want.items())
    check(max(worst_rel.values()) <= PROD_RTOL and excess <= PARAM_ATOL,
          f"[ns step] {PROD_STEPS} production steps vs fused steps ({shape}, highest): worst "
          f"rel loss {worst_rel['loss']:.3e}, grad norm {worst_rel['grad norm']:.3e} (rtol "
          f"{PROD_RTOL:.0e}); params |a-b| - {PARAM_RTOL:.0e}|b| at most {excess:.3e} (atol "
          f"{PARAM_ATOL:.0e})")
    del theta, fopt, fstep
    spectral.set_dft_precision("default")
    prod_ms = timed_steps(lambda: step(train_w.data, grid, batches[0]), 10)
    print(f"[ns timing] {card}: production step (dft2, default) {prod_ms:.4f} ms = "
          f"{1e3 / prod_ms:.2f} steps/s ({shape}; CUDA events over 10 warm steps)", flush=True)

    def prod_steps():
        for _ in range(5):
            step(train_w.data, grid, batches[0])
    device_profile(card, prod_steps, 5, "step", prod_ms, ())
    del model, params, step

    # primary_store_dtype="bf16": the train store in bf16 through the trainer
    ds_bf = NSBaselineDataset(
        train=WindowedTrajectories(store[:NSF_TRAJ], grid_np, initial_step=T0, train=True,
                                   device=dev, dtype=torch.bfloat16), test=test_w)
    res = train_baseline(ds_bf, modes=MODES, width=WIDTH, initial_step=T0, num_channels=cc,
                         batch_size=b, epochs=1, seed=0, run_dir=str(run_dir),
                         model_name="NS_smoke_bf16_FNO", log_every=0, fast_step=False,
                         device=dev)
    h = res.history[0]
    check(ds_bf.train.data.dtype == torch.bfloat16
          and all(math.isfinite(h[k]) for k in ("first_step_loss", "train_loss", "val_loss")),
          f"[ns step] production epoch on a bf16 train store ({ds_bf.train.data.numel() * 2} "
          f"bytes): train loss {h['train_loss']:.6g}, val loss {h['val_loss']:.6g}, finite")
    del ds_bf

    # lie_augment: one step on the card and on the CPU, both samplers fixed
    spectral.set_dft_precision("highest")
    vec = torch.tensor([0.05, -0.07, 0.03, 0.02, -0.1, 0.15, -0.12, 0.04, -0.03])
    sampler = lie.sample_strengths
    lie.sample_strengths = lambda gen, batch, device=None: vec.to(device).expand(batch, 9)
    data_cpu, grid_cpu, idx_cpu = train_w.data.cpu(), grid.cpu(), batches[1].cpu()

    def lie_step(where):
        m = FNO2d(cc, MODES, MODES, WIDTH, T0)
        m.load_state_dict(flax_to_state_dict(tree))
        m.to(where)
        opt = make_optimizer(dict(m.named_parameters()), 1e-3, 10_000)
        st, _ = build_baseline_step(m, opt, T0, 1, lie_augment=True)
        return st, m, opt
    try:
        card_vs_cpu(f"[ns lie] one lie_augment step ({shape}, highest, strengths "
                    f"{vec.tolist()})", lie_step, (train_w.data, grid, batches[1]),
                    (data_cpu, grid_cpu, idx_cpu), TOL_AUX_STEP)
    finally:
        lie.sample_strengths = sampler
    del data_cpu

    # remat: the same loss and gradients, less memory
    x, y = gather_windows(train_w.data, batches[2], T0, 1)
    gb = grid.expand(b, *grid.shape)
    res_r = {}
    for remat in (False, True):
        m = FNO2d(cc, MODES, MODES, WIDTH, T0, remat=remat)
        m.load_state_dict(flax_to_state_dict(tree))
        m.to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = nrmse_loss(m(x, gb), y)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        torch.cuda.synchronize()
        res_r[remat] = (float(loss.detach()), grads, (torch.cuda.max_memory_allocated() - base) / 2**20)
        del m
    grel = max(rel_err(a, c)[1] for a, c in zip(res_r[True][1], res_r[False][1]))
    lrel = abs(res_r[True][0] - res_r[False][0]) / abs(res_r[False][0])
    check(lrel <= TOL_REMAT and grel <= TOL_REMAT,
          f"[ns remat] {card}: remat=True vs False ({shape}, highest): loss {lrel:.3e}, "
          f"gradients rel-to-max {grel:.3e} (tol {TOL_REMAT:.0e}); peak memory above the "
          f"inputs {res_r[True][2]:.1f} MiB (remat) vs {res_r[False][2]:.1f} MiB")
    del res_r, x, y, gb

    t_sub = phase_done(card, "16b", t_sub)
    # ---- 16c. NS aux at full width ---------------------------------------------
    na = NSF_AUX_NA
    prim = store[:2, :NSF_AUX_T]
    aux = make_ns_store(2 * na, NSF_AUX_T, seed=14, dev=dev, xy=NSF_AUX_XY)
    row_map = ns_aux_row_map([[0, 1]], na, 2)  # one primary file of 2, 24 aux files of 2
    aux_ds = NSAuxDataset(
        primary_train=WindowedTrajectories(prim, grid_np, initial_step=T0, train=True,
                                           device=dev),
        primary_test=test_w,
        aux_train=WindowedTrajectories(aux, grid_np, initial_step=T0, train=True, device=dev),
        aux_row_map=row_map)
    awidx = aux_ds.primary_train.window_index()
    aidx = torch.as_tensor(awidx[rng.choice(len(awidx), NSF_AUX_B, replace=False)],
                           dtype=torch.long, device=dev)
    tree_a = default_init_tree(cc, MODES, WIDTH, T0, seed=2, aux=True)
    lrs = {"shared": 1e-3, "primary_head": 1e-3, "aux_head": 1e-3}
    aux_shape = (f"{NSF_AUX_B} primary at {xy}^2 + {NSF_AUX_B * na} aux windows at "
                 f"{NSF_AUX_XY}^2")

    def aux_step(where, n_aux=na, rmap=row_map, **kw):
        m = make_fno(cc, MODES, WIDTH, T0, aux=True)
        m.load_state_dict(flax_to_state_dict(tree_a))
        m.to(where)
        opt = make_grouped_optimizer(dict(m.named_parameters()), aux_group_of, lrs, 1000)
        st, _ = build_aux_step(m, opt, T0, 1, n_aux, AUX_WEIGHT, aux_row_map=rmap, **kw)
        return st, m, opt

    spectral.set_dft_precision("highest")
    chunk_out = {}
    for chunks in (1, 4):
        st, _, _ = aux_step(dev, aux_chunks=chunks, aux_resize_to=(xy, xy))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, g_norm = st(prim, aux, grid, aidx)
        torch.cuda.synchronize()
        chunk_out[chunks] = ([float(v) for v in (*losses, g_norm)],
                             (torch.cuda.max_memory_allocated() - base) / 2**20)
        del st
    rels = [abs(x - y) / abs(y) for x, y in zip(chunk_out[4][0], chunk_out[1][0])]
    check(max(rels) <= TOL_CHUNKS,
          f"[ns aux] {card}: one step upsampled in the step ({aux_shape}, highest), "
          f"aux_chunks 4 vs 1: loss, lp, la, grad norm "
          + ", ".join(f"{v:.6g} ({r:.3e})" for v, r in zip(chunk_out[4][0], rels))
          + f" (tol {TOL_CHUNKS:.0e}); peak memory above the stores "
          f"{chunk_out[4][1]:.1f} MiB (4 chunks) vs {chunk_out[1][1]:.1f} MiB (1)")
    spectral.set_dft_precision("default")
    native = resize_linear(grid, {0: NSF_AUX_XY, 1: NSF_AUX_XY})
    for what, data_a, kw, profiled in (
            ("aux_chunks 4, upsampled in the step (train_aux's setting below)", aux,
             dict(aux_resize_to=(xy, xy), aux_chunks=4), True),
            ("aux_native_compute (the aux stream at 128^2)", aux, dict(aux_native_grid=native),
             False),
            ("aux_store_dtype bf16, upsampled in the step", aux.to(torch.bfloat16),
             dict(aux_resize_to=(xy, xy), aux_chunks=4), False)):
        st, _, _ = aux_step(dev, **kw)
        ms = timed_steps(lambda: st(prim, data_a, grid, aidx), 3)
        (loss, lp, la), g_norm = st(prim, data_a, grid, aidx)
        check(all(math.isfinite(float(v)) for v in (loss, lp, la, g_norm)),
              f"[ns aux] {card}: one step under {what} ({aux_shape}, default): loss "
              f"{float(loss):.6g}, lp {float(lp):.6g}, la {float(la):.6g}, finite; "
              f"{ms:.4f} ms a step (CUDA events over 3 warm steps)")
        if profiled:
            def aux_steps():
                for _ in range(3):
                    st(prim, data_a, grid, aidx)
            device_profile(card, aux_steps, 3, "step", ms, ())
        del st
    spectral.set_dft_precision("highest")
    prim_cpu, aux_cpu, grid_cpu = prim.cpu(), aux.cpu(), grid.cpu()
    card_vs_cpu("[ns aux] one aux step at a reduced batch (2 primary + 4 aux windows: the "
                f"full {NSF_AUX_B} + {NSF_AUX_B * na} at {xy}^2 are too slow on the CPU; "
                "upsampled in the step, row map, highest)",
                lambda where: aux_step(where, n_aux=2, rmap=row_map[:, :2],
                                       aux_resize_to=(xy, xy)),
                (prim, aux, grid, aidx[:2]), (prim_cpu, aux_cpu, grid_cpu, aidx[:2].cpu()),
                TOL_AUX_STEP)
    del prim_cpu, aux_cpu
    spectral.set_dft_precision("default")
    t0 = time.perf_counter()
    res = train_aux(aux_ds, modes=MODES, width=WIDTH, initial_step=T0, num_channels=cc,
                    batch_size=NSF_AUX_B, epochs=2, num_aux_samples=na,
                    auxiliary_weight=AUX_WEIGHT, aux_chunks=4, seed=0, run_dir=str(run_dir),
                    model_name="NS_smoke_aux_FNO", log_every=0, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = len(awidx) // NSF_AUX_B
    ck_path = run_dir / "NS_smoke_aux_FNO_ckpt"
    ck = restore_checkpoint(ck_path) if ck_path.exists() else {"meta": {}, "params": {}}
    best = min(res.history, key=lambda hh: hh["val_loss"])
    vals = [v for hh in res.history for v in (hh["train_loss"], hh["val_loss"])]
    print(f"[ns aux] {card}: train_aux, 2 epochs x {steps} steps ({aux_shape}, aux_chunks 4, "
          f"default) + val in {train_s:.3f} s ({train_s / (2 * steps):.3f} s a step with the "
          "epoch's validation): "
          + "; ".join(f"epoch {hh['epoch']} train loss {hh['train_loss']:.6g}, val loss "
                      f"{hh['val_loss']:.6g}" for hh in res.history), flush=True)
    check(all(map(math.isfinite, vals)) and ck["meta"].get("epoch") == best["epoch"]
          and sorted(ck["params"]) == ["backbone", "fc2_auxiliary", "fc2_primary"],
          f"[ns aux] losses finite; the checkpoint holds the best primary val loss's epoch "
          f"({best['epoch']}) and both heads")
    ev = evaluate_checkpoint(test_w, if_aux=True, rollout_test=1, run_dir=str(run_dir),
                             modes=MODES, width=WIDTH, batch_size=NSF_AUX_B,
                             model_name="NS_smoke_aux_FNO", device=dev).history[0]
    print(f"[ns eval] {card}: the NS aux checkpoint's primary head at rollout 1: "
          + ", ".join(f"{k} {ev[k]:.6g}" for k in METRIC_NAMES), flush=True)
    check(all(math.isfinite(ev[k]) for k in METRIC_NAMES),
          "[ns eval] the NS aux checkpoint's six metrics finite")
    del aux_ds, aux, prim, store, train_w
    torch.cuda.empty_cache()

    t_sub = phase_done(card, "16c", t_sub)
    # ---- 16d. the 3D FNO at the plume shape ---------------------------------------
    sp3 = f"{NS3D_SP}, {NS3D_C} channels, width {WIDTH}, modes {NS3D_MODES}, batch 1"
    grid3_np = unit_grid_3d(*NS3D_SP)
    grid3 = torch.from_numpy(grid3_np).to(dev)
    prim3 = make_plume_store(NS3D_TRAJ, NS3D_T, seed=21, dev=dev)
    test3 = make_plume_store(1, T0 + 1, seed=22, dev=dev)
    aux3 = make_plume_store(NS3D_TRAJ * NS3D_NA, NS3D_T, seed=23, dev=dev)
    tree3 = default_init_tree(NS3D_C, NS3D_MODES, WIDTH, T0, seed=3, ndim=3)
    spectral.set_dft_precision("highest")
    m3 = FNO3d(NS3D_C, NS3D_MODES, NS3D_MODES, NS3D_MODES, WIDTH, T0)
    m3.load_state_dict(flax_to_state_dict(tree3))
    x3, _ = gather_windows(prim3, torch.tensor([[0, 3]], device=dev), T0, 1)
    with torch.no_grad():
        on_cpu = m3(x3.cpu(), grid3.cpu()[None])
        on_card = m3.to(dev)(x3, grid3[None]).cpu()
    err, rel = rel_err(on_card, on_cpu)
    check(on_card.shape == (1, *NS3D_SP, 1, NS3D_C) and rel <= TOL_FORWARD,
          f"[ns3d] plain FNO3d forward ({sp3}, highest) on the card vs the CPU in f32: max abs "
          f"err {err:.3e}, rel-to-max {rel:.3e} (tol {TOL_FORWARD:.0e})")
    spectral.set_dft_precision("default")
    params3 = dict(m3.named_parameters())
    st3, _ = build_baseline_step(m3, make_optimizer(params3, 1e-3, 10_000), T0, 1)
    i3 = torch.tensor([[1, 2]], device=dev)
    ms3 = timed_steps(lambda: st3(prim3, grid3, i3), 10)
    print(f"[ns3d timing] {card}: production step of FNO3d (dft2, default, {sp3}) "
          f"{ms3:.4f} ms = {1e3 / ms3:.2f} steps/s (CUDA events over 10 warm steps)", flush=True)

    def steps3():
        for _ in range(10):
            st3(prim3, grid3, i3)
    device_profile(card, steps3, 10, "step", ms3, ())
    del m3, st3, params3
    test3_w = WindowedTrajectories(test3, grid3_np, initial_step=T0, train=False, device=dev)
    train3_w = WindowedTrajectories(prim3, grid3_np, initial_step=T0, train=True, device=dev)
    runs = (("baseline", "NS3D_smoke_FNO", False),
            ("aux (nA 3)", "NS3D_smoke_aux_FNO", True))
    for what, name, if_aux in runs:
        t0 = time.perf_counter()
        kw = dict(modes=NS3D_MODES, width=WIDTH, initial_step=T0, num_channels=NS3D_C,
                  batch_size=1, epochs=2, seed=0, run_dir=str(run_dir), model_name=name,
                  log_every=0, device=dev)
        if if_aux:
            res = train_aux(NS3DAuxDataset(
                primary_train=train3_w, primary_test=test3_w,
                aux_train=WindowedTrajectories(aux3, grid3_np, initial_step=T0, train=True,
                                               device=dev)),
                num_aux_samples=NS3D_NA, auxiliary_weight=AUX_WEIGHT, **kw)
        else:
            res = train_baseline(NSBaselineDataset(train=train3_w, test=test3_w),
                                 fast_step=False, **kw)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        hs = res.history
        n3 = len(train3_w.window_index())
        ev = evaluate_checkpoint(test3_w, if_aux=if_aux, rollout_test=1, run_dir=str(run_dir),
                                 modes=NS3D_MODES, width=WIDTH, batch_size=1,
                                 model_name=name, device=dev).history[0]
        print(f"[ns3d train] {card}: {what}, 2 epochs x {n3} steps + val in {train_s:.3f} s: "
              + "; ".join(f"epoch {hh['epoch']} train loss {hh['train_loss']:.6g}, val loss "
                          f"{hh['val_loss']:.6g}" for hh in hs)
              + "; evaluation at rollout 1: "
              + ", ".join(f"{k} {ev[k]:.6g}" for k in METRIC_NAMES), flush=True)
        check(len(hs) == 2 and all(math.isfinite(v) for hh in hs
                                   for v in (hh["train_loss"], hh["val_loss"]))
              and hs[1]["train_loss"] < hs[0]["train_loss"]
              and (run_dir / f"{name}_ckpt").exists()
              and all(math.isfinite(ev[k]) for k in METRIC_NAMES),
              f"[ns3d train] {what}: finite losses, the second epoch's train loss below the "
              "first's, a checkpoint, six finite metrics from it")
    del prim3, aux3, test3
    torch.cuda.empty_cache()
    phase_done(card, "16d", t_sub)
    print(f"[ns] {card}: phase 16 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def data_parity_path(dev, card: str, run_dir: Path) -> dict:
    """Phase 18: the port's DR parity pipeline from simulation to rollout
    table, its outputs, and the NS-2D generator, on files the port writes.
    Returns each FNO kernel's launches in dr_parity's training."""
    import functools
    import shutil

    import numpy as np
    import torch

    from sciml_pde_torch.data.dr import AUX_FILE, PRIMARY_FILE, load_dr_aux, load_dr_baseline
    from sciml_pde_torch.data.ns import load_ns_baseline
    from sciml_pde_torch.eval.prediction import export_rollout_trajectories
    from sciml_pde_torch.eval.rollout import METRIC_NAMES
    from sciml_pde_torch.eval.rollout_experiment import fused_fno_apply, rollout_study_fused
    from sciml_pde_torch.experiments import dr_parity
    from sciml_pde_torch.io import h5 as h5io
    from sciml_pde_torch.models.fno import FNO2d
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.plots.figures import field_animation, field_panels, rollout_figure
    from sciml_pde_torch.sim import diff_react as dr
    from sciml_pde_torch.sim import ns_incomp_2d as ns
    from sciml_pde_torch.sim.downsample_dr import downsample_file
    from sciml_pde_torch.sim.gen_diff_react import generate_dataset
    from sciml_pde_torch.sim.gen_ns_incomp import generate_ns_file
    from sciml_pde_torch.sim.preview import preview_dataset
    from sciml_pde_torch.sim.velocity2vorticity import convert_velocity
    from sciml_pde_torch.sim.vorticity import compute_spectral_vorticity_np
    from sciml_pde_torch.train.fno_train import run_training
    from sciml_pde_torch.utils.checkpoint import restore_checkpoint
    from sciml_pde_torch.utils.weights import flax_to_packed, flax_to_state_dict

    t_phase = t_sub = time.perf_counter()
    h5py = h5io.h5py_module()
    print(f"[data] HDF5 through {h5py.__name__}", flush=True)
    data_dir, out = run_dir / "dr_data", run_dir / "dr_parity"
    for d in (data_dir, out):
        shutil.rmtree(d, ignore_errors=True)
    data_dir.mkdir(parents=True)

    # ---- 18a. DR generation at the generation config ---------------------------
    cfg_all, cfg_diff = dr.DiffReactConfig(), dr.DiffReactConfig(sim_type="diff")
    gen_s = {}
    for name, cfg, n in ((PRIMARY_FILE, cfg_all, DR_SEEDS), (AUX_FILE, cfg_diff, DR_DIFF_SEEDS)):
        t0 = time.perf_counter()
        generate_dataset(data_dir / name, n, cfg, device_batch=n, verbose=False, device=dev)
        gen_s[name] = time.perf_counter() - t0
        with h5py.File(data_dir / name, "r") as f:
            keys = sorted(f.keys())
            shapes = {f[k]["data"].shape for k in keys}
            finite = all(bool(np.isfinite(np.asarray(f[k]["data"])).all()) for k in keys)
        check(keys == [f"{i:04d}" for i in range(n)] and shapes == {(101, 128, 128, 2)} and finite,
              f"[data] gen_diff_react {cfg.sim_type}: {n} seed groups of (101, 128, 128, 2), "
              f"finite, in {gen_s[name]:.2f} s ({dr.stability_substeps(cfg)} RK4 substeps a "
              "frame, the seeds integrated together)")
    down = "2D_diff-react_decomp_downsample.h5"
    n_down = downsample_file(data_dir / AUX_FILE, data_dir / down, 50, 96, verbose=False)
    with h5py.File(data_dir / down, "r") as f:
        dshape = f["0000"]["data"].shape
    aux_ds = load_dr_aux(str(data_dir), str(data_dir), train_subsample=(2, 1, 3),
                         if_downsample=True, aux_file=down, device=dev)
    check(n_down == DR_DIFF_SEEDS and dshape == (50, 96, 96, 2)
          and tuple(aux_ds.aux_train.data.shape) == (3, 101, 128, 128, 2)
          and bool(torch.isfinite(aux_ds.aux_train.data).all()),
          f"[data] downsample_dr: {n_down} seeds at {dshape}, loaded as the aux pool and "
          f"upsampled on the card to {tuple(aux_ds.aux_train.data.shape)}")
    del aux_ds
    for st in ("all", "react", "diff"):
        cfg = dr.DiffReactConfig(sim_type=st, t=cfg_all.t * (DR_CHECK_FRAMES - 1) / 100,
                                 tdim=DR_CHECK_FRAMES)
        ic = dr.initial_condition(1, cfg)
        card_traj = dr.simulate_diff_react(ic, cfg, device=dev).cpu()
        cpu_traj = dr.simulate_diff_react(ic, cfg, device="cpu")
        err, rel = rel_err(card_traj, cpu_traj)
        msg = (f"[data] DR {st} seed 1, {DR_CHECK_FRAMES} frames ({dr.stability_substeps(cfg)} "
               f"substeps a frame, as at 101 frames): the card against the CPU max abs err "
               f"{err:.3e}, rel-to-max {rel:.3e}")
        ok = rel <= TOL_SIM and dr.stability_substeps(cfg) == dr.stability_substeps(
            dr.DiffReactConfig(sim_type=st))
        if st != "react":
            with h5py.File(data_dir / (PRIMARY_FILE if st == "all" else AUX_FILE), "r") as f:
                written = torch.from_numpy(np.asarray(f["0001"]["data"])[:DR_CHECK_FRAMES])
            rel_f = rel_err(written, cpu_traj)[1]
            ok &= rel_f <= TOL_SIM
            msg += f"; the written file's seed 1 {rel_f:.3e}"
        check(ok, msg + f" (tol {TOL_SIM:.0e})")
    # the generator's loop: 10 seeds, 1 frame (2 before a depth cut)
    cfg_t = dr.DiffReactConfig(t=cfg_all.t / 100, tdim=2)
    n_sub = dr.stability_substeps(cfg_t)
    ics = np.stack([dr.initial_condition(i, cfg_t) for i in range(DR_SEEDS)])
    run_gen = lambda: dr.simulate_diff_react(ics, cfg_t, device=dev)  # noqa: E731
    gen_ms = cuda_ms(run_gen, reps=3) / n_sub
    print(f"[timing] {card}: DR generator (all, {DR_SEEDS} seeds at 128^2): {gen_ms:.4f} ms per "
          f"RK4 substep (CUDA events over {n_sub} substeps); the primary file "
          f"{gen_s[PRIMARY_FILE]:.2f} s, the diff file {gen_s[AUX_FILE]:.2f} s with the writes",
          flush=True)
    device_profile(card, run_gen, n_sub, "RK4 substep", gen_ms, ())

    print(f"[data] 18a in {time.perf_counter() - t_sub:.1f} s", flush=True)
    t_sub = time.perf_counter()
    # ---- 18b. experiments/dr_parity.py for one epoch -----------------------------
    spectral.set_dft_precision("default")
    trained = {}  # the trainer's results, for their loss histories

    @functools.wraps(dr_parity.run_training)
    def recording(**kw):
        trained[kw["model_name"]] = res = run_training(**kw)
        return res

    fk.reset_launch_counts()
    t0 = time.perf_counter()
    dr_parity.run_training = recording
    try:
        summary = dr_parity.main(["--data", str(data_dir) + "/", "--dataset", "basic_ds2",
                                  "--epochs", "1", "--out", str(out), "--fast-step",
                                  "--device", dev.type])
    finally:
        dr_parity.run_training = run_training
    torch.cuda.synchronize()
    launches = dict(fk.LAUNCHES)
    saved = json.loads((out / "summary.json").read_text())
    print(f"[data] dr_parity basic_ds2, 1 epoch, both variants in "
          f"{time.perf_counter() - t0:.2f} s; launches: {json.dumps(launches)}", flush=True)
    for variant in ("baseline", "aux"):
        hist = trained[f"dr_basic_ds2_{variant}"].history
        losses = [h[k] for h in hist for k in ("first_step_loss", "last_step_loss", "train_loss",
                                               "val_loss")]
        nrmse = saved.get(variant, {}).get("rollout_nrmse", [])
        check(saved == summary and len(nrmse) == 5 and len(hist) == 1
              and all(math.isfinite(v) for v in losses + nrmse),
              f"[data] dr_parity {variant}: losses {', '.join(f'{v:.5g}' for v in losses)} "
              f"finite; summary.json rollout nRMSE at horizons 1-5 "
              f"{', '.join(f'{v:.5f}' for v in nrmse)}")
    for key in fk.KERNEL_NAMES:
        check(launches[key] > 0, f"[data] dr_parity's fused baseline launched {key} "
              f"({launches[key]}x)")

    print(f"[data] 18b in {time.perf_counter() - t_sub:.1f} s", flush=True)
    t_sub = time.perf_counter()
    # ---- 18c. the rollout study through the module and through B1's kernels ------
    tree = restore_checkpoint(out / "dr_basic_ds2_baseline_ckpt")["params"]
    model = FNO2d(2, MODES, MODES, width=WIDTH, initial_step=T0)
    model.load_state_dict(flax_to_state_dict(tree))
    model = model.to(dev).eval()
    test = load_dr_baseline(str(data_dir), train_subsample=1, initial_step=T0, rollout_test=5,
                            device=dev).test
    packed = flax_to_packed(tree, MODES, device=dev)
    fused = functools.partial(fused_fno_apply, modes=MODES)
    spectral.set_dft_precision("highest")
    horizons = (1, 2, 3, 4, 5)
    plain = rollout_study_fused(lambda x, g: model(x, g), None, test, horizons=horizons,
                                batch_size=5, device=dev)
    fk.reset_launch_counts()
    via = rollout_study_fused(fused, packed, test, horizons=horizons, batch_size=5,
                              out_path=out / "rollout_fused.json", device=dev)
    study_launches = sum(fk.LAUNCHES.values())
    spectral.set_dft_precision("default")
    for k in horizons:
        tol = EVAL_ROLLOUTS[1] if k == 1 else EVAL_ROLLOUTS[5]
        rels = {m: abs(via[k][m] - plain[k][m]) / max(abs(plain[k][m]), 1e-30)
                for m in METRIC_NAMES}
        rels["mse_time"] = max(abs(a - b) / max(abs(b), 1e-30)
                               for a, b in zip(via[k]["mse_time"], plain[k]["mse_time"]))
        check(all(math.isfinite(via[k][m]) for m in METRIC_NAMES) and max(rels.values()) <= tol,
              f"[data] rollout_study_fused horizon {k} (`highest`): fno2d_fused_apply's kernels "
              f"({study_launches} launches) against the module, nRMSE {via[k]['nRMSE']:.6f} "
              f"against {plain[k]['nRMSE']:.6f}, worst relative error "
              f"{max(rels.values()):.3e} ({max(rels, key=rels.get)}; tol {tol:.0e})")
    check(study_launches > 0, f"[data] the fused rollout study launched B1's kernels "
          f"({study_launches}x)")

    print(f"[data] 18c in {time.perf_counter() - t_sub:.1f} s", flush=True)
    t_sub = time.perf_counter()
    # ---- 18d. outputs ----------------------------------------------------------------
    paths = export_rollout_trajectories(fused, packed, test, steps=5, out_dir=out / "pred",
                                        prefix="2D_DR_pred_trj", batch_size=5, device=dev)
    shapes = []
    for path in paths:
        with h5py.File(path, "r") as f:
            arr = np.asarray(f["data"])
            shapes.append(arr.shape if np.isfinite(arr).all() else None)
    check(len(paths) == test.num_trajectories and set(shapes) == {(5, 128, 128, 2)},
          f"[data] export_rollout_trajectories: {len(paths)} file(s) "
          f"{', '.join(p.name for p in paths)}, data {shapes}")
    run_training(base_path=str(data_dir) + "/", if_training=False, plot=True,
                 run_dir=str(out), model_name="dr_basic_ds2_baseline", rollout_test=2,
                 device=dev)
    x, y = test.data[0, :T0].permute(1, 2, 0, 3)[None], test.data[0, T0].cpu().numpy()
    with torch.no_grad():
        pred = model(x, test.grid[None])[0, ..., 0, :].cpu().numpy()
    figs = [out / "dr_basic_ds2_baseline_pred.png",
            rollout_figure(out / "rollout_dr_fno.png", "2D_DR", "FNO",
                           ours=summary["baseline"]["rollout_nrmse"]),
            field_panels(out / "field_panels.png", pred, y, channel=0, title="DR step 1"),
            field_animation(out / "trajectory.gif", test.data[0].cpu().numpy(), fps=10),
            *preview_dataset(data_dir / PRIMARY_FILE, gif=True)]
    sizes = {f.name: f.stat().st_size if f.exists() else 0 for f in figs}
    check(all(v > 0 for v in sizes.values()),
          f"[data] figures written: {json.dumps(sizes)}")

    print(f"[data] 18d in {time.perf_counter() - t_sub:.1f} s", flush=True)
    t_sub = time.perf_counter()
    # ---- 18e. NS-2D at the production grid under both pressure solvers -----------------
    # the CPU references' CG loops (thousands of small ops a step) run several
    # times slower with a thread on every core than on half of them
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    print(f"[data] 18e: the CPU references on {torch.get_num_threads()} of {threads} threads",
          flush=True)
    g = torch.Generator().manual_seed(18)
    prev = torch.get_float32_matmul_precision()

    def projected_div(u, v, cfg, solver, setting):
        """The divergence after project with the caller's matmul precision
        at ``setting``, and the setting found afterwards."""
        torch.set_float32_matmul_precision(setting)
        try:
            u1, v1 = ns.project(u, v, cfg.dx, cfg.dy, 1e-5, 2000, method=solver)
            kept = torch.get_float32_matmul_precision()
        finally:
            torch.set_float32_matmul_precision(prev)
        return ns.divergence(u1, v1, cfg.dx, cfg.dy), kept

    for solver, idx in (("dct", 0), ("cg", 250)):
        # the JAX test's bound at its grid, with the caller's precision at
        # full f32 and at TF32
        cfg_t = ns.NSIncompConfig(**NS_TEST_CFG, pressure_solver=solver)
        ut, vt, *_ = ns.init_state(g, cfg_t, device=dev)
        div0 = ns.divergence(ut, vt, cfg_t.dx, cfg_t.dy).abs().max().item()
        for setting in ("highest", "high"):
            div1, kept = projected_div(ut, vt, cfg_t, solver, setting)
            div1 = div1.abs().max().item()
            check(div1 < max(1e-4 * div0, 1e-4) and kept == setting,
                  f"[data] NS {solver} project at 24^2 (the JAX test's grid) with matmul "
                  f"precision {setting!r}: MAC divergence {div0:.3e} -> {div1:.3e} (bound "
                  f"{max(1e-4 * div0, 1e-4):.3e}); the caller's setting {kept!r} after it")
        steps_n, frame_int = NS_GEN[solver]
        cfg = ns.NSIncompConfig(n_steps=steps_n, frame_int=frame_int, n_batch=NS_GEN_BATCH,
                                pressure_solver=solver)
        u, v, c, fu, fv = ns.init_state(g, cfg, device=dev)
        div0 = ns.divergence(u, v, cfg.dx, cfg.dy).abs().max().item()
        div_f32, _ = projected_div(u, v, cfg, solver, "highest")
        div_tf32, kept = projected_div(u, v, cfg, solver, "high")
        cpu_div = ns.divergence(*ns.project(u.cpu(), v.cpu(), cfg.dx, cfg.dy, 1e-5, 2000,
                                            method=solver), cfg.dx, cfg.dy).abs().max().item()
        card_div = div_f32.abs().max().item()
        same = bool(torch.equal(div_f32, div_tf32)) if solver == "dct" else True
        check(card_div <= NS_DIV_256 * div0 and card_div <= NS_DIV_CPU * cpu_div and same
              and kept == "high",
              f"[data] NS {solver} project at 256^2: MAC divergence {div0:.3e} -> {card_div:.3e} "
              f"on the card ({card_div / div0:.2e} of before; bound {NS_DIV_256:g}), "
              f"{cpu_div:.3e} on the CPU (bound {NS_DIV_CPU:g} x the CPU's)"
              + ("; the same bits with the caller's matmul precision "
                 f"at TF32: {same}" if solver == "dct" else ""))
        # momentum steps on the card against the CPU from the same state
        state_c = (u, v, c)
        state_h = tuple(t.cpu() for t in (u, v, c))
        for _ in range(NS_CPU_STEPS):
            state_c = ns.momentum_step(*state_c, fu, fv, cfg)
            state_h = ns.momentum_step(*state_h, fu.cpu(), fv.cpu(), cfg)
        errs = [rel_err(a.cpu(), b) for a, b in zip(state_c, state_h)]
        check(max(r for _, r in errs) <= TOL_NS_STEPS,
              f"[data] NS {solver}: {NS_CPU_STEPS} momentum steps on the card against the CPU, "
              "rel-to-max "
              f"u {errs[0][1]:.3e}, v {errs[1][1]:.3e}, particles {errs[2][1]:.3e} "
              f"(tol {TOL_NS_STEPS:.0e})")
        # the file through gen_ns_incomp (the streaming path for cg), read back
        path = data_dir / f"ns_incom_inhom_2d_256-{idx}.h5"
        chunk = 0 if solver == "dct" else 1
        t0 = time.perf_counter()
        generate_ns_file(path, idx, cfg, frames_per_chunk=chunk, device=dev)
        gen_t = time.perf_counter() - t0
        # ms per momentum step: DCT over a loop of steps, CG (hundreds of
        # iterations a step) over the generator's own run, its set-up and
        # writes included; the device's busy share over one CG step (the
        # profiler's table of ~18,000 ops a step takes seconds a step to build)
        n_t = 20 if solver == "dct" else (cfg.n_frames - 1) * frame_int

        def steps(n=n_t, st=(u, v, c)):
            for _ in range(n):
                st = ns.momentum_step(*st, fu, fv, cfg)
            return st
        if solver == "dct":
            step_ms, how = cuda_ms(steps, reps=1) / n_t, f"CUDA events over {n_t} steps"
        else:
            step_ms, how = 1e3 * gen_t / n_t, f"gen_ns_incomp's {n_t} steps, its writes included"
        print(f"[timing] {card}: NS-2D momentum step ({solver}, {NS_GEN_BATCH} trajectories at "
              f"256^2): {step_ms:.4f} ms ({how})", flush=True)
        n_prof = n_t if solver == "dct" else 1
        device_profile(card, functools.partial(steps, n_prof), n_prof, "momentum step", step_ms,
                       ())
        with h5py.File(path, "r") as f:
            vel = np.asarray(f["velocity"])
            par = np.asarray(f["particles"])
            latest = int(f.attrs["latestIndex"])
        check(vel.shape == (NS_GEN_BATCH, cfg.n_frames, 256, 256, 2)
              and par.shape[:-1] == vel.shape[:-1] and np.isfinite(vel).all()
              and np.isfinite(par).all() and float(np.abs(vel).max()) < 100
              and latest == cfg.n_frames - 1,
              f"[data] gen_ns_incomp {solver} ({steps_n} steps, a frame each {frame_int}, "
              f"frames_per_chunk {chunk}) in {gen_t:.2f} s: velocity {vel.shape}, every frame "
              f"finite, max |velocity| {float(np.abs(vel).max()):.4f} (< 100)")
    ds = load_ns_baseline(str(data_dir) + "/", train_subsample=1, initial_step=2,
                          rollout_test=1, test_range=(250, 251), device=dev)
    with h5py.File(data_dir / "ns_incom_inhom_2d_256-0.h5", "r") as f:
        want = np.concatenate([np.asarray(f["velocity"]), np.asarray(f["particles"])], -1)
    check(tuple(ds.train.data.shape) == want.shape
          and np.array_equal(ds.train.data.cpu().numpy(), want)
          and tuple(ds.test.data.shape) == (NS_GEN_BATCH, 3, *want.shape[2:]),
          f"[data] data/ns.py reads the written files: train {tuple(ds.train.data.shape)}, "
          f"test {tuple(ds.test.data.shape)}")
    # a velocity file (Vx, Vy, Vz of one z layer) through velocity2vorticity
    cfd = data_dir / "ns_velocity.h5"
    with h5py.File(cfd, "w") as f:
        for k, comp in (("Vx", want[..., 0]), ("Vy", want[..., 1]),
                        ("Vz", np.zeros_like(want[..., 0]))):
            f.create_dataset(k, data=comp[..., None].astype(np.float32))
        xy = want.shape[2]
        for k, n in (("x-coordinate", xy), ("y-coordinate", xy), ("z-coordinate", 2)):
            f.create_dataset(k, data=(np.arange(n) / xy).astype(np.float32))
    vort = convert_velocity(cfd, batch=1, device=dev)
    with h5py.File(vort, "r") as f:
        om = np.stack([np.asarray(f[k]) for k in ("omega_x", "omega_y", "omega_z")], -1)
    vel3 = np.stack([want[..., 0], want[..., 1], np.zeros_like(want[..., 0])], -1)[..., None, :]
    ref = compute_spectral_vorticity_np(vel3.reshape(-1, xy, xy, 1, 3), 1.0, 1.0,
                                        1 / xy).reshape(om.shape)
    err, rel = rel_err(torch.from_numpy(om), torch.from_numpy(ref))
    check(om.shape == want.shape[:-1] + (1, 3) and rel <= TOL_SIM,
          f"[data] velocity2vorticity on the card: omega {om.shape} against the CPU, max abs "
          f"err {err:.3e}, rel-to-max {rel:.3e} (tol {TOL_SIM:.0e})")
    torch.set_num_threads(threads)
    print(f"[data] 18e (NS-2D) in {time.perf_counter() - t_sub:.1f} s; phase 18 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def simulators_path(dev, card: str, run_dir: Path) -> None:
    """Phase 19: the rest of ROADMAP A7 on the card, on files the port
    writes: the 3D plume at the production config (19a), the port's
    plume3d_parity.py training the 3D FNO on its own plume files (19b),
    Burgers (19c), Darcy (19d), the BVP cases (19e) and the airfoil (19f)."""
    import dataclasses
    import functools
    import shutil

    import numpy as np
    import torch

    from sciml_pde_torch.data.ns3d import load_ns3d_aux
    from sciml_pde_torch.experiments import plume3d_parity
    from sciml_pde_torch.io import h5 as h5io
    from sciml_pde_torch.sim import airfoil_2d as af
    from sciml_pde_torch.sim import burgers_1d as bg
    from sciml_pde_torch.sim import bvp_2d as bvp
    from sciml_pde_torch.sim import darcy_2d as dc
    from sciml_pde_torch.sim import ns_plume_3d as pl

    from sciml_pde_torch.utils.cuda_graph import graphed

    t_phase = t_sub = time.perf_counter()
    h5py = h5io.h5py_module()
    # the CPU references (gathers and stencils on ~2M-element arrays) run
    # faster on half the cores than with a thread on each (phase 18e)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    print(f"[sim] HDF5 through {h5py.__name__}; the CPU references on "
          f"{torch.get_num_threads()} of {threads} threads", flush=True)
    base = run_dir / "sim"
    shutil.rmtree(base, ignore_errors=True)
    plume_dir = base / "plume"
    plume_dir.mkdir(parents=True)

    def per_field(got, want) -> list:
        return [rel_err(a.cpu(), b)[1] for a, b in zip(got, want)]

    # ---- 19a. the plume at the production config -----------------------------------
    cfg = pl.Plume3DConfig(**SIM_PLUME)
    d = tuple(1.0 / n for n in cfg.res)
    jitter = pl.buoyancy_jitter(torch.Generator().manual_seed(19), cfg)
    short = dataclasses.replace(cfg, n_frames=PLUME_CPU_FRAMES)
    card_fr = pl.simulate_plume_jitter(jitter, short, device=dev)
    cpu_fr = pl.simulate_plume_jitter(jitter, short, device="cpu")
    errs = per_field(card_fr, cpu_fr)
    check(max(errs) <= TOL_PLUME,
          f"[sim] plume {cfg.res}, jitter ({jitter[0]:.3e}, {jitter[1]:.3e}): the first "
          f"{PLUME_CPU_FRAMES} frames ({PLUME_CPU_FRAMES * cfg.substeps} substeps) on the card "
          f"against the CPU, rel-to-max velocity {errs[0]:.3e}, smoke {errs[1]:.3e} "
          f"(tol {TOL_PLUME:.0e})")
    # the projection after 2 frames' substeps, and CG against the DCT from there
    inflow = torch.as_tensor(pl.inflow_field(cfg), device=dev)
    f_vec = (*jitter, cfg.buoyancy_z)
    state = pl.rest_state(cfg, dev)
    for _ in range(PLUME_CPU_FRAMES * cfg.substeps):
        state = pl.substep(state, f_vec, inflow, cfg)
    free = pl.substep(state, f_vec, inflow, dataclasses.replace(cfg, enable_projection=False))
    div0 = pl.divergence3(*free[:3], d).abs().max().item()
    for method, bound in (("dct", PLUME_DIV), ("cg", PLUME_DIV_CG)):
        out = pl.project3(*free[:3], d, cfg.cg_tol, cfg.cg_max_iter, state[4], method)
        div1 = pl.divergence3(*out[:3], d).abs().max().item()
        check(div1 <= bound * div0,
              f"[sim] plume project3 {method} at {cfg.res}: MAC divergence {div0:.3e} -> "
              f"{div1:.3e} ({div1 / div0:.2e} of before; bound {bound:g})")
    cg_cfg = dataclasses.replace(cfg, pressure_solver="cg")
    st_dct, st_cg = state, state
    t0 = time.perf_counter()
    for _ in range(PLUME_CG_STEPS):
        st_cg = pl.substep(st_cg, f_vec, inflow, cg_cfg)
    torch.cuda.synchronize()
    cg_ms = 1e3 * (time.perf_counter() - t0) / PLUME_CG_STEPS
    for _ in range(PLUME_CG_STEPS):
        st_dct = pl.substep(st_dct, f_vec, inflow, cfg)
    errs = per_field(st_cg[:4], [t.cpu() for t in st_dct[:4]])
    check(max(errs) <= PLUME_CG_TOL,
          f"[sim] plume: {PLUME_CG_STEPS} substeps under CG (rel tol {cfg.cg_tol:g}) against "
          f"the DCT from the same state, rel-to-max u {errs[0]:.3e}, v {errs[1]:.3e}, w "
          f"{errs[2]:.3e}, smoke {errs[3]:.3e} (tol {PLUME_CG_TOL:.0e})")

    def substeps(n=10, st=state):
        for _ in range(n):
            st = pl.substep(st, f_vec, inflow, cfg)
        return st
    sub_ms = cuda_ms(substeps, reps=1) / 10
    # the CUDA graph's replays against the same frames op by op, with the
    # frames' clones in between (as simulate_plume allocates them)
    n_gr = PLUME_GRAPH_FRAMES
    graph_fr = pl.simulate_plume_jitter(jitter, dataclasses.replace(cfg, n_frames=n_gr),
                                        device=dev)
    frame, st, eager_fr = pl.frame_fn(jitter, cfg, dev), pl.rest_state(cfg, dev), []
    for _ in range(n_gr):
        *st, vel_f = frame(*st)
        eager_fr.append((vel_f, st[3]))
    eager_fr = [torch.stack(t) for t in zip(*eager_fr)]
    same = all(torch.equal(a, b) for a, b in zip(graph_fr, eager_fr))
    errs = per_field(graph_fr, [t.cpu() for t in eager_fr])
    injected = n_gr * cfg.substeps * inflow.sum().item()
    check(max(errs) <= 1e-6,
          f"[sim] plume: {n_gr} frames through a frame's CUDA graph against op by op on the "
          f"card, rel-to-max velocity {errs[0]:.3e}, smoke {errs[1]:.3e} (tol 1e-06; the same "
          f"bits: {same}); smoke {graph_fr[1][-1].sum().item():.6g} after {injected:.6g} "
          "injected")
    del graph_fr, eager_fr
    frame = graphed(pl.frame_fn(jitter, cfg, dev), *state)
    graph_ms = cuda_ms(lambda: frame(*state), reps=5) / cfg.substeps
    print(f"[timing] {card}: plume substep ({cfg.res}, DCT): op by op {sub_ms:.4f} ms (CUDA "
          f"events over 10 substeps), a frame's CUDA graph replayed {graph_ms:.4f} ms a substep "
          f"(over 5 frames); CG op by op {cg_ms:.4f} ms (host clock over {PLUME_CG_STEPS})",
          flush=True)
    device_profile(card, functools.partial(substeps, 5), 5, "plume substep", sub_ms, ())
    device_profile(card, lambda: [frame(*state) for _ in range(2)], 2 * cfg.substeps,
                   "graphed plume substep", graph_ms, ())
    del frame
    # the whole trajectory, written as 19b's test seed
    t0 = time.perf_counter()
    pl.generate_plume_files(plume_dir, 275, cfg, "_interp", device=dev)
    plume_s = time.perf_counter() - t0
    with h5py.File(plume_dir / "v_trj_seed275_interp.h5", "r") as f:
        vel = np.asarray(f["data"])
    with h5py.File(plume_dir / "s_trj_seed275_interp.h5", "r") as f:
        smk = np.asarray(f["data"])
    zc = np.arange(cfg.out_res[2])
    com = [float((m.sum((0, 1)) * zc).sum() / m.sum()) for m in (smk[0], smk[-1])]
    check(vel.shape == (*cfg.out_res, cfg.out_frames, 3) and smk.shape == (cfg.out_frames,
                                                                            *cfg.out_res)
          and np.isfinite(vel).all() and np.isfinite(smk).all()
          and smk[-1].sum() > smk[0].sum() and com[1] > com[0],
          f"[sim] generate_plume_files seed 275 ({cfg.n_frames} frames x {cfg.substeps} "
          f"substeps) in {plume_s:.2f} s: v {vel.shape}, s {smk.shape}, finite; smoke "
          f"{smk[0].sum():.4g} -> {smk[-1].sum():.4g}, its centre of mass rises from z "
          f"{com[0]:.3f} to {com[1]:.3f} cells")
    print(f"[sim] 19a in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 19b. experiments/plume3d_parity.py on the port's own files ----------------
    t_sub = time.perf_counter()
    out = base / "plume3d_parity"
    summary = plume3d_parity.main(["--folder", str(plume_dir), "--out", str(out), *PARITY_ARGS,
                                   "--res", *map(str, cfg.res), "--device", dev.type])
    saved = json.loads((out / "summary.json").read_text())
    for variant in ("baseline", "aux"):
        row = saved.get(variant, {})
        nrmse = row.get("rollout_nrmse", [])
        check(saved == summary and len(nrmse) == 5
              and all(math.isfinite(v) for v in nrmse + [row.get("best_val", math.nan)]),
              f"[sim] plume3d_parity {variant} ({' '.join(PARITY_ARGS)}; width 20, modes 12, "
              f"initial_step 10 at {cfg.res}): best_val {row.get('best_val', math.nan):.5g}, "
              f"rollout nRMSE at horizons 1-5 {', '.join(f'{v:.5f}' for v in nrmse)} in "
              f"{row.get('train_seconds', math.nan):.1f} s of training")
    ds = load_ns3d_aux(str(plume_dir), train_subsample=(1, 1, 3), num_aux_samples=3,
                       initial_step=10, rollout_test=5, test_seeds=[275], device=dev)
    want = np.concatenate([np.moveaxis(vel, 3, 0), smk[..., None]], -1)[:15]
    check(tuple(ds.primary_train.data.shape) == (1, PARITY_FRAMES, *cfg.res, 4)
          and tuple(ds.aux_train.data.shape) == (3, PARITY_FRAMES, *cfg.res, 4)
          and np.array_equal(ds.primary_test.data[0].cpu().numpy(), want),
          f"[sim] load_ns3d_aux reads the port's plume files: primary "
          f"{tuple(ds.primary_train.data.shape)}, aux {tuple(ds.aux_train.data.shape)}, the test "
          "seed's first 15 frames as 19a wrote them")
    del ds
    print(f"[sim] 19b in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 19c. Burgers at its defaults --------------------------------------------------
    t_sub = time.perf_counter()
    bk = SIM_BURGERS
    t0 = time.perf_counter()
    bg.generate_burgers_file(base / "burgers.h5", **bk, device=dev)
    burgers_s = time.perf_counter() - t0
    with h5py.File(base / "burgers.h5", "r") as f:
        u = np.asarray(f["tensor"])
    means = u.mean(axis=2)
    drift = float(np.abs(means - means[:, :1]).max())
    check(u.shape == (bk["n_samples"], bk["n_frames"], bk["nx"]) and np.isfinite(u).all()
          and drift <= 1e-5 and float(np.abs(u).max()) <= 1.0 + 1e-4,
          f"[sim] generate_burgers_file {u.shape} in {burgers_s:.2f} s: finite, the mean drifts "
          f"{drift:.2e} (bound 1e-5), max |u| {float(np.abs(u).max()):.6f}")
    sub = bg.burgers_substeps(bk["nx"], bk["n_frames"], bk["t_final"])
    t2 = 2 * bk["t_final"] / (bk["n_frames"] - 1)
    u0 = bg.random_sine_ic(torch.Generator().manual_seed(19), bk["batch"], bk["nx"],
                           device="cpu")
    err, rel = rel_err(bg.simulate_burgers(u0.to(dev), 0.01, t2, bk["nx"], 3, sub).cpu(),
                       bg.simulate_burgers(u0, 0.01, t2, bk["nx"], 3, sub))
    check(rel <= TOL_SIM, f"[sim] Burgers {bk['batch']} x {bk['nx']}: 2 frames ({2 * sub} "
          f"substeps, as in the file; on the card a frame's CUDA graph) on the card against the "
          f"CPU, max abs err {err:.3e}, rel-to-max {rel:.3e} (tol {TOL_SIM:.0e})")
    # one frame alone runs op by op (a graph pays off from two frames on)
    run_b = functools.partial(bg.simulate_burgers, u0.to(dev), 0.01, t2 / 2, bk["nx"], 2, sub)
    b_ms = cuda_ms(run_b, reps=3) / sub
    print(f"[timing] {card}: Burgers substep ({bk['batch']} x {bk['nx']}): op by op {b_ms:.4f} "
          f"ms (CUDA events over {sub} substeps); the file ({bk['n_frames'] - 1} frames x {sub} "
          f"substeps, graphs replayed, the writes included) {burgers_s:.2f} s = "
          f"{1e3 * burgers_s / ((bk['n_frames'] - 1) * sub):.4f} ms a substep", flush=True)
    device_profile(card, run_b, sub, "Burgers substep", b_ms, ())
    print(f"[sim] 19c in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 19d. Darcy, one batch of 64 at 128^2 --------------------------------------------
    t_sub = time.perf_counter()
    dk = SIM_DARCY
    t0 = time.perf_counter()
    dc.generate_darcy_file(base / "darcy.h5", **dk, device=dev)
    darcy_s = time.perf_counter() - t0
    with h5py.File(base / "darcy.h5", "r") as f:
        a = torch.as_tensor(np.asarray(f["nu"]), device=dev)
        u = torch.as_tensor(np.asarray(f["tensor"])[:, 0], device=dev)
    mv64, _ = dc.darcy_operator(a.double(), 1.0 / dk["nx"])
    res = ((mv64(u.double()) - 1.0).flatten(1).norm(dim=1) / dk["nx"]).max().item()
    check(res <= DARCY_RES and bool(torch.isfinite(u).all()) and u.min().item() >= 0.0,
          f"[sim] generate_darcy_file ({dk['n_samples']} at {dk['nx']}^2, one batch) in "
          f"{darcy_s:.2f} s: the worst sample's residual |A u - 1| / |1| {res:.3e} (in f64; "
          f"bound {DARCY_RES:g}), u >= 0")
    matvec, diag = dc.darcy_operator(a, 1.0 / dk["nx"])
    t0 = time.perf_counter()
    u_again, iters = dc.cg_jacobi(matvec, torch.ones_like(a), diag, 1e-8, 4000)
    cg_s = time.perf_counter() - t0
    print(f"[timing] {card}: Darcy CG ({dk['n_samples']} x {dk['nx']}^2, batch-coupled): "
          f"{iters} iterations in {cg_s:.3f} s = {1e3 * cg_s / iters:.4f} ms an iteration (host "
          f"clock); the file {darcy_s:.2f} s", flush=True)
    check(bool(torch.equal(u_again, u)), "[sim] Darcy: the solve again gives the file's bits")
    a2 = dc.sample_coefficient(torch.Generator().manual_seed(19), 2, dk["nx"], dk["nx"],
                               device="cpu")
    err, rel = rel_err(dc.solve_darcy(a2.to(dev)).cpu(), dc.solve_darcy(a2))
    check(rel <= TOL_DARCY_CARD, f"[sim] Darcy batch of 2 at {dk['nx']}^2 on the card against "
          f"the CPU, max abs err {err:.3e}, rel-to-max {rel:.3e} (tol {TOL_DARCY_CARD:.0e})")
    print(f"[sim] 19d in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 19e. BVP cases at grid 128 -----------------------------------------------------
    t_sub = time.perf_counter()
    for kind in ("electro", "magneto"):
        bcfg = bvp.BVPConfig(kind=kind, **SIM_BVP)
        t0 = time.perf_counter()
        cases = bvp.generate_dataset(base / f"{kind}.pkl", BVP_CASES, bcfg, device=dev)
        bvp_s = time.perf_counter() - t0
        ref = [bvp.generate_case(s, bcfg, device="cpu") for s in range(BVP_CASES)]
        same_x = all(np.array_equal(c["data_x"], r["data_x"]) for c, r in zip(cases, ref))
        worst_y = max(rel_err(torch.from_numpy(c["data_y"][:, k]),
                              torch.from_numpy(r["data_y"][:, k]))[1]
                      for c, r in zip(cases, ref) for k in range(3))
        pts = bvp.load_pointset(base / f"{kind}.pkl")
        check(same_x and worst_y <= TOL_SIM and pts["features"].shape[0] == BVP_CASES,
              f"[sim] BVP {kind}: {BVP_CASES} cases at grid {bcfg.grid} in {bvp_s:.2f} s on the "
              f"card, against the CPU: data_x equal {same_x}, data_y worst rel-to-max "
              f"{worst_y:.3e} (tol {TOL_SIM:.0e}); load_pointset {pts['features'].shape}")
    print(f"[sim] 19e in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 19f. one airfoil sample at 384^2 -------------------------------------------------
    t_sub = time.perf_counter()
    acfg = af.AirfoilConfig(**SIM_AIRFOIL)
    _, _, chi, sponge = af.setup(acfg)
    u_inf = af.freestream_state(acfg)
    f32 = dict(dtype=torch.float32)
    steps = {}
    for where in (dev, torch.device("cpu")):
        step = af.make_step(acfg, torch.as_tensor(chi, **f32, device=where),
                            torch.as_tensor(sponge, **f32, device=where),
                            torch.as_tensor(u_inf, **f32, device=where))
        U = torch.as_tensor(u_inf, **f32, device=where)[:, None, None].expand(
            4, acfg.nx, acfg.ny).contiguous()
        for _ in range(AIRFOIL_STEPS):
            U = step(U)
        steps[where.type] = (step, U)
    errs = per_field(steps[dev.type][1], steps["cpu"][1])
    check(max(errs) <= TOL_AIRFOIL,
          f"[sim] airfoil {acfg.nx}^2: {AIRFOIL_STEPS} steps from the free stream on the card "
          f"against the CPU, rel-to-max rho {errs[0]:.3e}, rho u {errs[1]:.3e}, rho v "
          f"{errs[2]:.3e}, E {errs[3]:.3e} (tol {TOL_AIRFOIL:.0e})")

    step_c, U_c = steps[dev.type]

    def air_steps(U=U_c):
        for _ in range(AIRFOIL_STEPS):
            U = step_c(U)
        return (U,)
    a_ms = cuda_ms(air_steps, reps=1) / AIRFOIL_STEPS
    air_graph = graphed(air_steps, U_c)
    (want,), (got,) = air_steps(), air_graph(U_c)
    check(rel_err(got, want)[1] <= 1e-6,
          f"[sim] airfoil: a CUDA graph of {AIRFOIL_STEPS} steps against them op by op on the "
          f"card, rel-to-max {rel_err(got, want)[1]:.3e} (tol 1e-06; the same bits: "
          f"{bool(torch.equal(got, want))})")
    a_graph_ms = cuda_ms(lambda: air_graph(U_c), reps=5) / AIRFOIL_STEPS
    t0 = time.perf_counter()
    af.generate_dataset(str(base / "airfoil"), [0], acfg, verbose=False, device=dev)
    air_s = time.perf_counter() - t0
    npz = np.load(base / "airfoil" / "airfoil_0000.npz")
    stats = np.load(base / "airfoil" / "af_train_data_statistics.npz")
    n = npz["pos"].shape[1]
    want = {"pos": (acfg.n_frames, n, 2), "node_type": (acfg.n_frames, n, 1),
            "vel": (acfg.n_frames, n, 2), "prs": (acfg.n_frames, n, 1),
            "dns": (acfg.n_frames, n, 1), "meta": (5,)}
    shapes = {k: npz[k].shape for k in npz.files}
    check(all(shapes.get(k) == v for k, v in want.items()) and npz["cells"].shape[2] == 3
          and all(np.isfinite(npz[k]).all() for k in ("vel", "prs", "dns"))
          and 5e4 < float(npz["prs"].mean()) < 2e5 and len(stats.files) == 14,
          f"[sim] airfoil generate_dataset seed 0 ({acfg.n_frames} frames at {acfg.nx}^2) in "
          f"{air_s:.2f} s: {json.dumps({k: list(v) for k, v in shapes.items()})}, mean pressure "
          f"{float(npz['prs'].mean()):.6g}; statistics {len(stats.files)} keys")
    print(f"[timing] {card}: airfoil step ({acfg.nx}^2): op by op {a_ms:.4f} ms (CUDA events "
          f"over {AIRFOIL_STEPS} steps), a CUDA graph of {AIRFOIL_STEPS} steps replayed "
          f"{a_graph_ms:.4f} ms a step; a sample of {acfg.n_frames} frames {air_s:.2f} s",
          flush=True)
    device_profile(card, air_steps, AIRFOIL_STEPS, "airfoil step", a_ms, ())
    device_profile(card, lambda: air_graph(U_c), AIRFOIL_STEPS,
                   "graphed airfoil step", a_graph_ms, ())
    torch.set_num_threads(threads)
    print(f"[sim] 19f in {time.perf_counter() - t_sub:.1f} s; phase 19 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


# ---- phase 20: scaling and I/O (ROADMAP A8) ---------------------------------------
A8_NS = dict(num_channels=3, modes=12, width=20, initial_step=10)  # config_ns.yaml
# 4 + 12 aux trajectories x 20 frames (a depth cut from 40: 2 baseline steps of 16
# and 5 aux steps of 8 an epoch; 20f's files take the first 20 frames)
A8_TRAJ, A8_NA, A8_T, A8_TEST = 4, 3, 20, 2
A8_BATCH = {"baseline": 16, "aux": 8}  # config_ns.yaml: 16 baseline, 8 (+ 24 aux) aux
# the VideoMAE aux: 8 windows = 4 micro-steps of 2 + 6, one optimizer step (18
# frames, 8 micro-steps, before a depth cut)
A8_TF_TRAJ, A8_TF_T = 2, 14
A8_ROT_T, A8_ROT_CHUNK = 20, 16 << 20  # rotation: 2 slices of 2 + 6 trajectories
A8_PUT_SHAPE = (4352, 256, 1024)  # f32, 4.25 GiB: 4 chunks of 1 GiB and a tail
TOL_A8_HISTORY = 1e-6  # host-streamed against device-store losses, relative
TOL_A8_EXPORT = 1e-5  # the exported FNO against the module, rel-to-max
A8_PROD_ARGS = ["--grid", "256", "--frames", "24", "--frame-int", "1", "--dt", "5e-4",
                "--n-batch", "1", "--n-primary", "2", "--n-aux-per", "3", "--n-test", "1",
                "--epochs", "1", "--host-stream"]


def a8_histories(what: str, got: list, want: list) -> None:
    """Two runs' per-epoch losses within TOL_A8_HISTORY relative; prints
    whether they agree bit for bit."""
    keys = ("first_step_loss", "last_step_loss", "train_loss", "val_loss")
    pairs = [(g[k], w[k]) for g, w in zip(got, want) for k in keys]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in pairs)
    check(len(got) == len(want) > 0 and rel <= TOL_A8_HISTORY,
          f"{what}: {len(got)} epoch(s), losses " + ", ".join(f"{a:.9g}" for a, _ in pairs)
          + f"; largest relative difference {rel:.3e} (tol {TOL_A8_HISTORY:.0e}), the same "
          f"bits: {all(a == b for a, b in pairs)}")


def a8_loop_ms(run, n: int) -> float:
    """ms a step of ``run()`` (``n`` steps, the trainer's loop), CUDA events
    around the whole loop: the host's stalls between steps count."""
    import torch

    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    run()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def a8_path(dev, card: str, run_dir: Path) -> dict:
    """Phase 20: host streaming, pool rotation, the chunked transfer, the
    process group, the export and the NS production driver (ROADMAP A8).
    Returns the attention launches of 20b by (kernel, bh, n, d, type)."""
    import numpy as np
    import torch

    from sciml_pde_torch.data.ns import NSAuxDataset, NSBaselineDataset, ns_aux_row_map, unit_grid
    from sciml_pde_torch.data.stream import AuxHostWindowLoader, HostWindowLoader
    from sciml_pde_torch.data.windows import WindowedTrajectories, epoch_batches
    from sciml_pde_torch.experiments import ns_production
    from sciml_pde_torch.ops import attention as ta
    from sciml_pde_torch.parallel import distributed_init
    from sciml_pde_torch.sim.gen_ns_incomp import write_ns_h5
    from sciml_pde_torch.train import fno_train as ft
    from sciml_pde_torch.train import placement
    from sciml_pde_torch.train import transformer_train as ttt
    from sciml_pde_torch.train.optim import aux_group_of, make_grouped_optimizer, make_optimizer
    from sciml_pde_torch.models.transformer import VideoMAEOperatorAux
    from sciml_pde_torch.utils import export, transfer

    t_phase = t_sub = time.perf_counter()
    t_in, xy = A8_NS["initial_step"], NS_MODEL["img_size"]
    grid = unit_grid(xy, xy)
    host = make_ns_store(A8_TRAJ + A8_TEST, A8_T, seed=20, dev=dev, xy=xy).cpu().numpy()
    aux_host = make_ns_store(A8_TRAJ * A8_NA, A8_T, seed=21, dev=dev, xy=xy).cpu().numpy()
    row_map = ns_aux_row_map([list(range(A8_TRAJ))], A8_NA, A8_TRAJ)
    test = host[A8_TRAJ:, :t_in + 1]

    def win(data, train=True, to_device=True, dtype=torch.float32):
        return WindowedTrajectories(data, grid, initial_step=t_in, rollout=1, train=train,
                                    device=dev, to_device=to_device, dtype=dtype)

    def datasets(kind, to_device):
        if kind == "baseline":
            return NSBaselineDataset(train=win(host[:A8_TRAJ], to_device=to_device),
                                     test=win(test, False))
        return NSAuxDataset(primary_train=win(host[:A8_TRAJ], to_device=to_device),
                            primary_test=win(test, False),
                            aux_train=win(aux_host, to_device=to_device), aux_row_map=row_map)

    fit = dict(seed=0, epochs=1, log_every=0, run_dir=str(run_dir), **A8_NS)
    train_idx = win(host[:A8_TRAJ], to_device=False).window_index()

    # ---- 20a. the NS-2D FNO through host_stream against the device store -------------
    for kind in ("baseline", "aux"):
        bsz = A8_BATCH[kind]
        train = ft.train_baseline if kind == "baseline" else ft.train_aux
        extra = {} if kind == "baseline" else dict(num_aux_samples=A8_NA)
        runs = {}
        for stream in (False, True):
            runs[stream] = train(datasets(kind, not stream), batch_size=bsz,
                                 model_name=f"NS_a8_{kind}_{int(stream)}", host_stream=stream,
                                 device=dev, **extra, **fit)
        torch.cuda.synchronize()
        moved = placement.LAST_RUN["bytes_to_device"]
        a8_histories(f"[a8 stream] NS-2D FNO {kind} (batch {bsz}"
                     + ("" if kind == "baseline" else f" + {bsz * A8_NA} aux")
                     + f", 256^2, width 20, modes 12): host_stream against the device store",
                     runs[True].history, runs[False].history)
        check(placement.LAST_RUN["host_batches"] == len(train_idx) // bsz
              and moved > 0, f"[a8 stream] {kind}: {placement.LAST_RUN['host_batches']} "
              f"host batches, {moved / 2**20:.1f} MiB to the card through the pinned ring")
        # the step time of each path: the trainer's loop, rebuilt from its parts
        model = ft.make_fno(3, 12, 20, t_in, aux=kind == "aux",
                            generator=torch.Generator().manual_seed(0)).to(dev)
        params = dict(model.named_parameters())
        if kind == "baseline":
            opt = make_optimizer(params, 1e-3, 1000)
            step, _ = ft.build_baseline_step(model, opt, t_in, 1)
            loader = HostWindowLoader(host[:A8_TRAJ], train_idx, t_in, 1, bsz, seed=0)
            data = (transfer.device_put_chunked(host[:A8_TRAJ], device=dev),)
        else:
            opt = make_grouped_optimizer(params, aux_group_of, {"shared": 1e-3,
                                                                 "primary_head": 1e-3,
                                                                 "aux_head": 1e-3}, 1000)
            step, _ = ft.build_aux_step(model, opt, t_in, 1, A8_NA, 0.7, aux_row_map=row_map)
            loader = AuxHostWindowLoader(host[:A8_TRAJ], aux_host, train_idx, t_in, 1, bsz,
                                         A8_NA, row_map=row_map, seed=0)
            data = (transfer.device_put_chunked(host[:A8_TRAJ], device=dev),
                    transfer.device_put_chunked(aux_host, device=dev))
        g_dev = torch.as_tensor(grid, device=dev)
        idx = torch.as_tensor(np.stack(list(epoch_batches(train_idx, bsz,
                                                          np.random.default_rng(0)))),
                              dtype=torch.long, device=dev)
        n = len(idx)
        step(*data, g_dev, idx[0])  # warm
        ms_dev = a8_loop_ms(lambda: [step(*data, g_dev, i) for i in idx], n)
        ring, inflight = placement.PinnedRing(dev), placement.InFlight(dev)

        def streamed():
            for batch in loader:
                step.xy(*ring(batch), g_dev)
                inflight.add()
        streamed()  # warm: the ring's pinned slots
        moved0 = ring.bytes_moved
        ms_stream = a8_loop_ms(streamed, n)
        per_batch = (ring.bytes_moved - moved0) / n
        slot = ring.slots[0][0]  # x's pinned slot: one copy to the card, timed alone
        link_ms = cuda_ms(lambda: slot.to(dev, non_blocking=True), reps=10)
        print(f"[a8 timing] {card}: NS-2D FNO {kind} step, the trainer's loop (CUDA events "
              f"over the {n} steps of an epoch): device store {ms_dev:.4f} ms, host_stream "
              f"{ms_stream:.4f} ms ({ms_stream / ms_dev:.2f}x); the batches to the card "
              f"{per_batch / 2**20:.1f} MiB a step = {per_batch / ms_stream / 1e6:.3f} GB/s over "
              f"the streamed step; one pinned {tuple(slot.shape)} f32 slot alone "
              f"{slot.numel() * 4 / link_ms / 1e6:.3f} GB/s", flush=True)
        device_profile(card, streamed, n, "host_stream step", ms_stream, ())
        # where the streamed step's host time goes: the gather alone (on the
        # caller's thread, then behind the prefetch thread) and the copies
        # into the pinned slots
        t0 = time.perf_counter()
        batches = list(HostWindowLoader(host[:A8_TRAJ], train_idx, t_in, 1, bsz, seed=0,
                                        prefetch=False)._batches()) if kind == "baseline" \
            else list(AuxHostWindowLoader(host[:A8_TRAJ], aux_host, train_idx, t_in, 1, bsz,
                                          A8_NA, row_map=row_map, seed=0,
                                          prefetch=False)._batches())
        gather_ms = 1e3 * (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for _ in loader:
            pass
        loader_ms = 1e3 * (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for b in batches:
            for slot_t, leaf in zip(ring.slots[0], b):
                slot_t.copy_(torch.from_numpy(leaf))
        pin_ms = 1e3 * (time.perf_counter() - t0) / n
        print(f"[a8 timing] {card}: NS-2D FNO {kind}, the host's share of a streamed step: "
              f"the numpy gather {gather_ms:.2f} ms a batch on one thread, the loader with its "
              f"prefetch thread {loader_ms:.2f} ms a batch, the copies into the pinned slots "
              f"{pin_ms:.2f} ms (host clock)", flush=True)
        del model, opt, step, data, ring, batches
    print(f"[a8] 20a in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 20b. the NS VideoMAE aux at full width through host_stream ---------------------
    t_sub = time.perf_counter()
    tf_host = host[:A8_TF_TRAJ, :A8_TF_T]
    tf_aux = aux_host[:A8_TF_TRAJ * A8_NA, :A8_TF_T]
    tf_map = ns_aux_row_map([list(range(A8_TF_TRAJ))], A8_NA, A8_TF_TRAJ)
    tf_idx = win(tf_host, to_device=False).window_index()
    micro = len(tf_idx) // NS_BATCH
    runs, shapes = {}, {}
    for stream in (False, True):
        ds = NSAuxDataset(primary_train=win(tf_host, to_device=not stream),
                          primary_test=win(test, False),
                          aux_train=win(tf_aux, to_device=not stream), aux_row_map=tf_map)
        ta.reset_launch_counts()
        runs[stream] = ttt.train_transformer_aux(
            ds, num_aux_samples=A8_NA, auxiliary_weight=AUXT_W, run_dir=str(run_dir),
            model_name=f"NS_a8_vmae_{int(stream)}", host_stream=stream, device=dev,
            **ns_recipe(True, 1))
        torch.cuda.synchronize()
        shapes[stream] = dict(ta.LAUNCH_SHAPES)
    a8_histories(f"[a8 stream] NS VideoMAE aux (1280 tokens, bf16, batch {NS_BATCH} + "
                 f"{NS_BATCH * A8_NA} aux x accumulation {NS_ACCUM}, {micro} micro-steps): "
                 "host_stream against the device store", runs[True].history,
                 runs[False].history)
    check_aux_launches("[a8 stream] the VideoMAE aux through host_stream", shapes[True], micro,
                       1, "bf16")
    model = VideoMAEOperatorAux(**NS_MODEL, drop_path_rate=0.1, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0)).to(dev)
    opt = ttt.make_transformer_optimizer(dict(model.named_parameters()), NS_LR, NS_LR, 1000,
                                         grad_accum=NS_ACCUM)
    step, _ = ttt.build_transformer_aux_step(model, opt, t_in, A8_NA, AUXT_W, tf_map)
    loader = AuxHostWindowLoader(tf_host, tf_aux, tf_idx, t_in, 1, NS_BATCH, A8_NA,
                                 row_map=tf_map, seed=0)
    ring, inflight = placement.PinnedRing(dev), placement.InFlight(dev)

    def tf_streamed():
        for batch in loader:
            step.xy(*ring(batch))
            inflight.add()
    tf_streamed()
    ms_tf = a8_loop_ms(tf_streamed, micro)
    print(f"[a8 timing] {card}: NS VideoMAE aux micro-step through host_stream {ms_tf:.4f} ms "
          f"(CUDA events over {micro} micro-steps, batch {NS_BATCH} + {NS_BATCH * A8_NA} aux, "
          "bf16)", flush=True)
    device_profile(card, tf_streamed, micro, "host_stream micro-step", ms_tf,
                   tuple(ATT_KERNEL_KEYS["bf16"].values()))
    del model, opt, step, ring
    print(f"[a8] 20b in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 20c. resident_rotate=2 on two byte-identical slices: JAX's oracle ---------------
    t_sub = time.perf_counter()
    half_p, half_a = host[:2, :A8_ROT_T], aux_host[:2 * A8_NA, :A8_ROT_T]
    pool_p, pool_a = np.concatenate([half_p, half_p]), np.concatenate([half_a, half_a])
    slice_bytes = half_p.nbytes + half_a.nbytes
    swaps = []
    real_load = placement.ResidentPool.load

    def measured_load(pool, k):
        first = pool.current is None
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        real_load(pool, k)
        if not first:
            swaps.append((before, torch.cuda.max_memory_allocated(), pool.swap_s[-1]))
    transfer._DEFAULT_CHUNK_BYTES, chunk0 = A8_ROT_CHUNK, transfer._DEFAULT_CHUNK_BYTES
    placement.ResidentPool.load = measured_load
    try:
        for schedule, epochs in (("block", 2), ("interleave", 4)):
            rot = ft.train_aux(
                NSAuxDataset(primary_train=win(pool_p, to_device=False),
                             primary_test=win(test, False), aux_train=win(pool_a, to_device=False),
                             aux_row_map=ns_aux_row_map([[0, 1], [2, 3]], A8_NA, 2)),
                batch_size=A8_BATCH["aux"], num_aux_samples=A8_NA, resident_rotate=2,
                resident_rotate_schedule=schedule, device=dev,
                model_name=f"NS_a8_rot_{schedule}", **dict(fit, epochs=epochs))
            one = ft.train_aux(
                NSAuxDataset(primary_train=win(half_p), primary_test=win(test, False),
                             aux_train=win(half_a),
                             aux_row_map=ns_aux_row_map([[0, 1]], A8_NA, 2)),
                batch_size=A8_BATCH["aux"], num_aux_samples=A8_NA, device=dev,
                model_name=f"NS_a8_one_{schedule}", **dict(fit, epochs=epochs))
            a8_histories(f"[a8 rotate] resident_rotate=2 '{schedule}', {epochs} epochs, on "
                         "two byte-identical slices against the unrotated run on one slice",
                         rot.history, one.history)
    finally:
        placement.ResidentPool.load = real_load
        transfer._DEFAULT_CHUNK_BYTES = chunk0
    rise = max(peak - before for before, peak, _ in swaps)
    swap_s = [s for _, _, s in swaps]
    print(f"[a8 rotate] {card}: {len(swaps)} swaps of a {slice_bytes / 2**20:.1f} MiB slice "
          f"(primary + aux, {A8_ROT_CHUNK >> 20} MiB chunks): "
          + ", ".join(f"{1e3 * s:.2f} ms = {slice_bytes / s / 1e9:.3f} GB/s" for s in swap_s)
          + "; max_memory_allocated across each swap "
          + ", ".join(f"{(peak - before) / 2**20:+.1f} MiB" for before, peak, _ in swaps)
          + " from before it", flush=True)
    check(len(swaps) == 1 + 3 and rise <= A8_ROT_CHUNK < slice_bytes,
          f"[a8 rotate] each swap releases the outgoing slice before it builds the incoming "
          f"one: the peak across a swap rises {rise / 2**20:.1f} MiB, at most one chunk "
          f"({A8_ROT_CHUNK >> 20} MiB) above the run's memory with one slice (a slice is "
          f"{slice_bytes / 2**20:.1f} MiB)")
    print(f"[a8] 20c in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 20d. device_put_chunked of a 4.25 GiB store --------------------------------------
    t_sub = time.perf_counter()
    rows = A8_PUT_SHAPE[0]
    big = np.random.default_rng(22).integers(-2**31, 2**31, A8_PUT_SHAPE, dtype=np.int32)
    want_rows = big.reshape(rows, -1).sum(axis=1, dtype=np.int64)
    big = big.view(np.float32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = transfer.device_put_chunked(big, device=dev)
    put_s = time.perf_counter() - t0
    stats = dict(transfer.LAST_STATS)
    got_rows = torch.cat([out[i:i + 256].view(torch.int32).reshape(len(out[i:i + 256]), -1)
                          .sum(dim=1, dtype=torch.int64) for i in range(0, rows, 256)])
    same = bool(np.array_equal(got_rows.cpu().numpy(), want_rows))
    del out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plain = torch.from_numpy(big).to(dev)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del plain
    try:
        pinned = torch.cuda.host_memory_stats().get("allocated_bytes.current", "not measured")
    except (AttributeError, RuntimeError):
        pinned = "not measured"
    per_chunk = transfer._DEFAULT_CHUNK_BYTES // (big.nbytes // rows)
    check(same and stats["chunks"] == -(-rows // per_chunk)
          and stats["staging_bytes"] <= 2 * transfer._DEFAULT_CHUNK_BYTES,
          f"[a8 put] device_put_chunked of a {big.nbytes / 2**30:.2f} GiB f32 store "
          f"{A8_PUT_SHAPE}: every row's int32 checksum on the card equals numpy's; "
          f"{stats['chunks']} chunks through {stats['staging_bytes'] / 2**30:.2f} GiB of pinned "
          f"staging (two slots of one 1 GiB chunk)")
    print(f"[a8 put] {card}: {big.nbytes / put_s / 1e9:.3f} GB/s chunked through pinned "
          f"staging ({put_s:.3f} s, host copies into the slots included), one pageable copy "
          f"{big.nbytes / plain_s / 1e9:.3f} GB/s ({plain_s:.3f} s); the caching host "
          f"allocator's pinned bytes after: {pinned}", flush=True)
    del big
    print(f"[a8] 20d in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 20e. the process group over NCCL at world size 1, shard_store -------------------
    t_sub = time.perf_counter()
    ns_dir = run_dir / "a8_ns"
    ns_dir.mkdir(parents=True, exist_ok=True)
    for name, part in (("ns_incom_inhom_2d_256-0", host[:2, :20]),
                       ("ns_incom_inhom_2d_256-1", host[2:4, :20]),
                       ("ns_incom_inhom_2d_256-250", host[A8_TRAJ:A8_TRAJ + 1, :20])):
        write_ns_h5(ns_dir / f"{name}.h5", part[..., :2], part[..., 2:],
                    np.zeros((len(part), xy, xy, 2), np.float32),
                    np.zeros((len(part), part.shape[1]), np.float32), {})
    kw = dict(fit, base_path=str(ns_dir), dataset_family="ns", test_range=(250, 251),
              train_subsample=(2, 2, 2), batch_size=A8_BATCH["baseline"], shard_store=True,
              device=dev, epochs=2)
    alone = ft.run_training(model_name="NS_a8_shard_alone", **kw)
    with __import__("socket").socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed_init(f"localhost:{port}", 1, 0)
    backend = torch.distributed.get_backend()
    try:
        grouped = ft.run_training(model_name="NS_a8_shard_nccl", **kw)
    finally:
        torch.distributed.destroy_process_group()
    check(backend == "nccl", f"[a8 dist] distributed_init at world size 1 on "
          f"tcp://localhost:{port}: backend {backend} (parallel.mean_over_ranks all-reduces "
          "the gradients and losses in the group)")
    a8_histories("[a8 dist] run_training(shard_store=True), 2 epochs, in the NCCL group of "
                 "one rank against the process without a group", grouped.history,
                 alone.history)
    print(f"[a8] 20e in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 20f. export of the NS production FNO ---------------------------------------------
    t_sub = time.perf_counter()
    model = ft.make_fno(3, 12, 20, t_in, generator=torch.Generator().manual_seed(3)).to(dev)
    model.eval()
    x = torch.as_tensor(host[:2, :t_in], device=dev).movedim(1, -2).contiguous()
    g2 = torch.as_tensor(grid, device=dev).expand(2, xy, xy, 2).contiguous()
    art = export.export_apply(lambda a, b: model(a, b), (x, g2))
    served = export.load_exported(export.save_exported(art, run_dir / "ns_fno.pt2"))
    with torch.no_grad():
        want, got = model(x, g2), served(x, g2)
    err, rel = rel_err(got, want)
    check(got.shape == want.shape and rel <= TOL_A8_EXPORT,
          f"[a8 export] the NS production FNO (256^2, width 20, modes 12) through torch.export, "
          f"saved as .pt2, loaded and run on the card: max abs err {err:.3e}, rel-to-max "
          f"{rel:.3e} (tol {TOL_A8_EXPORT:.0e}); exported, served and checked in "
          f"{time.perf_counter() - t_sub:.1f} s")
    del model, art, served

    # ---- 20g. the ported ns_production.py end to end through host_stream -----------------
    t_sub = time.perf_counter()
    prod = run_dir / "a8_prod"
    summary = ns_production.main(["--folder", str(prod / "data"), "--out", str(prod / "out")]
                                 + A8_PROD_ARGS)
    rows_ok = all(len(v["rollout_nrmse"]) == 5 and all(math.isfinite(r)
                                                      for r in v["rollout_nrmse"])
                  for v in summary.values())
    check(sorted(summary) == ["aux", "baseline"] and rows_ok,
          f"[a8 prod] experiments/ns_production.py {' '.join(A8_PROD_ARGS)} (2 primary + 2 x 3 "
          f"aux + 1 test trajectories, 256^2, 24 frames): rollout 1..5 nRMSE "
          + "; ".join(f"{k} " + ", ".join(f"{r:.5g}" for r in v["rollout_nrmse"])
                      for k, v in summary.items())
          + f" in {time.perf_counter() - t_sub:.1f} s")
    print(f"[a8] phase 20 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return shapes[True]


# ---- phase 21: tensor parallelism and the comparison models (ROADMAP A8b, A9) -----
# 21a: the column-parallel FNO2d (parallel/tp.py) at the DR flagship (batch
# B, 128^2, width WIDTH, modes MODES, head NH: Cout 20 splits over two) on
# TP_WORLD processes sharing the one card through a gloo group with CUDA
# tensors (NCCL refuses two ranks on one device); each rank's forward and
# shard gradients against the replicated FNO2d's on the card (`highest`)
# within TOL_TP of the largest magnitude.  21b-e: every comparison trainer
# at JAX's default widths through its entry point, on the card and on the
# CPU from one flax tree (the port's seeded init): the first C21_STEPS
# steps' losses within TOL_C21 relative (f32 sums in another order through
# the model, Adam's first updates; the port's CPU parity bound against JAX,
# tests/test_torch_comparison_*.py; the L1 losses below), ms a step of the
# trainer's step in CUDA events.  Depth cuts (printed): 21b the DR protocol (in 10, out 40, 64^2
# after spatial_down 2, in_emb 96, latent 192, heads 4, depth 2, remat) on
# 3 of phase 18's train trajectories at batch 1 (JAX's default 4; 9 at batch
# 3 before a further depth cut: the CPU's run took 16-34 s) so that one epoch
# is 3 steps; 21c OFormer1D on phase 19's Burgers file (1024 points),
# 3 trajectories x 18 frames (24 windows of batch 8); 21d the Darcy OFormer
# on 4 of phase 19's 128^2 samples (one step of batch 4 an epoch, 3
# epochs); 21e the point-set BVP (both recipes; bvp_study's widths, batch
# 16: 20 electro cases, one step an epoch) and the airfoil operator
# (airfoil_flow's widths; phase 19's one 6-frame sample: one window).
# The L1 losses (the point-set adamw recipe's p = 1, the airfoil's): their
# gradient is sign(pred - target), so a residual within f32 noise of zero
# flips its sign and Adam's first updates (~ lr * sign) carry the flip (1.1e-4
# at step 3 on an H100 in the first run).  Each of their steps is held to
# max(TOL_C21, C21_WITNESS_X x the witness): the CPU against itself from the
# tree nudged by one ulp (on the CPU at a tiny airfoil, 1.7e-3 at step 3).
TP_WORLD, TOL_TP, TOL_C21, C21_WITNESS_X, C21_STEPS, C21_TIMED = 2, 1e-5, 1e-4, 10, 3, 5
C21_PROTOCOL = dict(in_seq_len=10, out_seq_len=40, spatial_down=2, channel=0, in_emb_dim=96,
                    latent_channels=192, heads=4, depth=2, train_subsample=3, batch_size=1,
                    epochs=1, log_every=1)
C21_BURGERS = dict(traj=3, frames=18, initial_step=10, batch_size=8, in_emb_dim=64, depth=3,
                   heads=4)
C21_DARCY = dict(n=4, batch_size=4, epochs=3, in_emb_dim=64, depth=3, heads=4)
C21_BVP = {"adamw": dict(latent_channels=64, heads=1, depth=2, batch_size=8, epochs=2,
                         learning_rate=8e-4),
           "reference": dict(latent_channels=64, heads=1, depth=2, batch_size=16, epochs=3,
                             learning_rate=3e-4, reference_recipe=True)}
C21_AIRFOIL = dict(time_window=4, forward_steps=2, emb_dim=96, latent_channels=96, depth=3,
                   batch_size=4, epochs=3)


def tp_rank(rank: int, world: int, port: int, out: str, device: str = "cuda:0") -> None:
    """One rank of 21a: the column-parallel FNO2d on ``device`` (card 0)
    beside the replicated model; writes its errors and timings to
    ``out.{rank}`` (timings on a card only)."""
    import pickle

    import numpy as np
    import torch

    from sciml_pde_torch import parallel
    from sciml_pde_torch.models.fno import FNO2d
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.parallel.tp import fno2d_tp_apply, shard_params_tp
    from sciml_pde_torch.utils.weights import state_dict_to_flax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spectral.set_dft_precision("highest")
    dev = torch.device(device)
    parallel.distributed_init(f"localhost:{port}", world, rank, device="cpu")  # gloo
    mesh = parallel.make_mesh(model=world)
    g = torch.Generator().manual_seed(21)
    model = FNO2d(CC, MODES, MODES, WIDTH, T0, generator=g).to(dev)
    x = torch.randn(B, XY, XY, T0, CC, generator=g).to(dev)
    lin = torch.linspace(0, 1, XY)
    grid = torch.stack(torch.meshgrid(lin, lin, indexing="ij"), -1).expand(B, XY, XY, 2)
    grid = grid.contiguous().to(dev)
    cot = torch.randn(B, XY, XY, 1, CC, generator=g).to(dev)
    sharded = shard_params_tp(state_dict_to_flax(model.state_dict()), mesh, dev)

    def leaves(node, prefix=()):
        if isinstance(node, dict):
            return [lf for k, v in node.items() for lf in leaves(v, prefix + (k,))]
        return [(prefix, node)]
    shards = leaves(sharded)
    for _, leaf in shards:
        leaf.value.requires_grad_(True)
    y = fno2d_tp_apply(sharded, x, grid, mesh)
    (y * cot).sum().backward()
    want = model(x, grid)
    (want * cot).sum().backward()
    ref = state_dict_to_flax({n: p.grad for n, p in model.named_parameters()})
    errs, n_split = {}, 0
    for path, leaf in shards:
        full = ref
        for k in path:
            full = full[k]
        block = full
        if "model" in leaf.sharding.spec:
            n_split += 1
            ax = leaf.sharding.spec.index("model")
            size = full.shape[ax] // world
            block = np.take(full, np.arange(rank * size, (rank + 1) * size), axis=ax)
        got = leaf.value.grad.cpu().numpy()
        errs["/".join(path)] = (float(np.abs(got - block).max() / np.abs(full).max())
                                if got.shape == block.shape else float("inf"))
    out_err = rel_err(y.detach(), want.detach())

    def tp_step():
        for _, leaf in shards:
            leaf.value.grad = None
        (fno2d_tp_apply(sharded, x, grid, mesh) * cot).sum().backward()

    def plain_step():
        model.zero_grad(set_to_none=True)
        (model(x, grid) * cot).sum().backward()
    tp_ms = plain_ms = None
    if dev.type == "cuda":
        tp_ms, plain_ms = timed_steps(tp_step, C21_TIMED), timed_steps(plain_step, C21_TIMED)
    res = dict(model_rank=mesh.model_rank, out_err=out_err, errs=errs, n_split=n_split,
               n_leaves=len(shards), backend=torch.distributed.get_backend(),
               tp_ms=tp_ms, plain_ms=plain_ms, device=str(y.device))
    torch.distributed.destroy_process_group()
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(res, f)


def tp_path(card: str, run_dir: Path, device: str = "cuda:0") -> None:
    """21a: TP_WORLD spawned ranks of the column-parallel FNO2d on card 0."""
    import pickle
    import socket

    import torch.multiprocessing as mp

    t_sub = time.perf_counter()
    print("[tp] NCCL refuses two ranks on one device: the two ranks share card 0 through a "
          "gloo group with CUDA tensors (gloo stages each all_gather and all_reduce through "
          "host memory)", flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = run_dir / "tp" / "res"
    out.parent.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tp_rank, args=(r, TP_WORLD, port, str(out), device))
             for r in range(TP_WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    check(not alive and codes == [0] * TP_WORLD,
          f"[tp] {TP_WORLD} ranks ran and exited (exit codes {codes})")
    if alive or any(codes):
        return
    for r in range(TP_WORLD):
        with open(f"{out}.{r}", "rb") as f:
            res = pickle.load(f)
        worst_leaf = max(res["errs"], key=res["errs"].get)
        check(res["model_rank"] == r and res["backend"] == "gloo" and res["device"] == device
              and res["out_err"][1] <= TOL_TP and res["errs"][worst_leaf] <= TOL_TP
              and res["n_split"] == 22,
              f"[tp] rank {r} (model position {res['model_rank']}, {res['backend']}, "
              f"{res['device']}): the column-parallel FNO2d (batch {B}, {XY}^2, width {WIDTH}, "
              f"modes {MODES}, head {NH}; {res['n_split']} of {res['n_leaves']} leaves split) "
              f"against the replicated FNO2d, forward rel-to-max {res['out_err'][1]:.3e}, its "
              f"shards' gradients against their blocks of the replicated gradient, worst "
              f"{worst_leaf} {res['errs'][worst_leaf]:.3e} (tol {TOL_TP:.0e}, `highest`)")
        if res["tp_ms"] is not None:
            print(f"[timing] {card}: rank {r}: TP forward+backward {res['tp_ms']:.4f} ms (CUDA "
                  f"events, {C21_TIMED} steps; two ranks on one card, the exchanges through "
                  f"host memory), the replicated FNO2d's {res['plain_ms']:.4f} ms on the same "
                  "card", flush=True)
    print(f"[tp] {card}: 21a in {time.perf_counter() - t_sub:.1f} s", flush=True)


def c21_rels(got: list, want: list) -> list:
    return [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want)]


def c21_losses(what: str, card_losses: list, cpu_losses: list, cut: str,
               witness: list | None = None) -> None:
    """The card's first C21_STEPS losses against the CPU's, relative: within
    TOL_C21, or for an L1 loss within max(TOL_C21, C21_WITNESS_X x the
    witness) step by step (``witness``: the CPU's losses from the tree
    nudged by one ulp)."""
    rels = c21_rels(card_losses, cpu_losses)[:C21_STEPS]
    tols = [TOL_C21] * C21_STEPS
    seen = ""
    if witness is not None:
        wit = c21_rels(witness, cpu_losses)[:C21_STEPS]
        tols = [max(TOL_C21, C21_WITNESS_X * w) for w in wit]
        seen = ("; an L1 loss, the CPU from the tree nudged by one ulp against the CPU "
                + ", ".join(f"{w:.2e}" for w in wit))
    ok = (len(rels) == C21_STEPS and all(r <= t for r, t in zip(rels, tols))
          and all(math.isfinite(v) for v in card_losses))
    check(ok, f"{what}: the card against the CPU from one flax tree, the first {C21_STEPS} "
          "losses " + ", ".join(f"{a:.7g} ({r:.2e}, tol {t:.1e})"
                                for a, r, t in zip(card_losses, rels, tols))
          + f" (relative){seen}; depth cut: {cut}")


def nudged(tree):
    """A flax tree with every leaf one ulp up (the L1 witness)."""
    import numpy as np

    if isinstance(tree, dict):
        return {k: nudged(v) for k, v in tree.items()}
    return np.nextafter(tree, np.inf).astype(tree.dtype)


def comparisons_path(dev, card: str, run_dir: Path) -> None:
    """Phase 21: tensor parallelism (21a) and every comparison trainer at
    JAX's default widths (21b-e) on files phases 18 and 19 wrote."""
    import torch

    from sciml_pde_torch.comparisons import oformer_dr2d as cdr
    from sciml_pde_torch.comparisons import oformer_generic as cgen
    from sciml_pde_torch.comparisons import pointset_bvp as cpt
    from sciml_pde_torch.io import h5 as h5io
    from sciml_pde_torch.sim.airfoil_2d import load_airfoil_dataset
    from sciml_pde_torch.sim.bvp_2d import load_pointset
    from sciml_pde_torch.sim.darcy_2d import load_pdebench_darcy
    from sciml_pde_torch.train.optim import (
        AdamW,
        AMSGrad,
        make_lr_schedule,
        warmup_cosine_decay_schedule,
    )

    import shutil

    t_phase = time.perf_counter()
    tp_path(card, run_dir, str(dev) if dev.type == "cpu" else "cuda:0")
    out = run_dir / "comparisons"
    shutil.rmtree(out, ignore_errors=True)
    cpu = torch.device("cpu")

    def jsonl(d: Path, name: str, key: str) -> list:
        return [json.loads(line)[key] for line in (d / f"{name}.jsonl").read_text().splitlines()]

    def step_ms(step, args) -> float:
        return timed_steps(lambda: step(*args), C21_TIMED)

    # ---- 21b. the DR rollout protocol, OFormer and Hyena ------------------------------
    t_sub = time.perf_counter()
    arrs = cdr._protocol_arrays(run_dir / "dr_data", train_subsample=9, extra_train_files=None,
                                in_seq_len=10, out_seq_len=40, spatial_down=2, channel=0)
    n_tok, cin = arrs["x_train"].shape[1:]
    for mt in ("oformer", "hyena"):
        model = cdr.protocol_model(mt, cin, 1, n_tok, generator=torch.Generator().manual_seed(16))
        tree = cdr.trained_tree(model)
        runs = {}
        for where in (dev, cpu):
            d = out / f"protocol_{mt}_{where.type}"
            t0 = time.perf_counter()
            metrics, _ = cdr.run_rollout_protocol(
                base_path=str(run_dir / "dr_data"), model_type=mt, run_dir=str(d),
                model_name="rollout", init_params=tree, device=where, **C21_PROTOCOL)
            runs[where.type] = (jsonl(d, "rollout", "train_rel_l2"), metrics,
                                time.perf_counter() - t0)
        (lc, mc, sc), (lw, _, sw) = runs[dev.type], runs["cpu"]
        c21_losses(f"[cmp] run_rollout_protocol {mt} ({n_tok} tokens, in 10, out 40, in_emb 96, "
                   "latent 192, heads 4, depth 2, remat)", lc, lw,
                   f"{C21_PROTOCOL['train_subsample']} train trajectories at batch "
                   f"{C21_PROTOCOL['batch_size']} (JAX's default 4), one epoch")
        check(all(math.isfinite(v) for v in mc.values()),
              f"[cmp] {mt} protocol metrics on the card: "
              + ", ".join(f"{k} {v:.5g}" for k, v in mc.items())
              + f" ({card}: {sc:.1f} s on the card, {sw:.1f} s on the CPU, the evaluation "
              "included)")
        m = cdr.protocol_model(mt, cin, 1, n_tok).to(dev)
        m.load_state_dict(model.state_dict())
        params = dict(m.named_parameters())
        opt = AdamW(params, make_lr_schedule("cosine", 3e-4, 3), clip=1.0)
        step = cdr.protocol_step(m, opt, torch.as_tensor(arrs["pos"], device=dev), 40, 1)
        xb = torch.as_tensor(arrs["x_train"][:4], device=dev)
        yb = torch.as_tensor(arrs["y_train"][:4], device=dev)
        torch.cuda.reset_peak_memory_stats()
        ms = step_ms(step, (xb, yb))
        print(f"[timing] {card}: run_rollout_protocol {mt} step at JAX's batch 4 ({n_tok} "
              f"tokens, 40 frames under remat): {ms:.3f} ms (CUDA events, {C21_TIMED} steps); "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        del m, opt, step
    print(f"[cmp] {card}: 21b in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 21c. OFormer1D on the Burgers file ---------------------------------------------
    t_sub = time.perf_counter()
    sim = run_dir / "sim"
    kb = dict(C21_BURGERS)
    nt, nf = kb.pop("traj"), kb.pop("frames")
    data = cgen.load_pdebench_1d(sim / "burgers.h5")
    nx = data.shape[-1]
    model = cgen._make_burgers_model(kb["initial_step"], kb["in_emb_dim"], kb["depth"],
                                     kb["heads"], torch.Generator().manual_seed(16))
    tree = cdr.trained_tree(model)
    hist = {}
    for where in (dev, cpu):
        d = out / f"burgers_{where.type}"
        cgen.run_oformer_burgers(data[:nt, :nf], epochs=1, run_dir=str(d), log_every=1,
                                 init_params=tree, device=where, **kb)
        hist[where.type] = jsonl(d, "oformer_burgers", "rel_l2")
    c21_losses(f"[cmp] run_oformer_burgers ({nx} points, initial_step 10, in_emb 64, depth 3, "
               "heads 4, batch 8)", hist[dev.type], hist["cpu"],
               f"{nt} of {data.shape[0]} trajectories x {nf} of {data.shape[1]} frames")
    m = model.to(dev)
    opt = AdamW(dict(m.named_parameters()), make_lr_schedule("cosine", 3e-4, 3))
    dat = torch.as_tensor(data[:nt, :nf], device=dev)
    rows = torch.as_tensor([[0, 0], [1, 1], [2, 2], [0, 3], [1, 4], [2, 5], [0, 6], [1, 7]],
                           device=dev)
    ms = step_ms(cgen.supervised_step(m, opt),
                 cgen._burgers_batch(dat, cgen._line(nx, dev), rows, kb["initial_step"]))
    print(f"[timing] {card}: the Burgers OFormer1D step (batch 8, {nx} points): {ms:.3f} ms "
          f"(CUDA events, {C21_TIMED} steps)", flush=True)
    print(f"[cmp] {card}: 21c in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 21d. the Darcy OFormer at 128^2 ------------------------------------------------
    t_sub = time.perf_counter()
    kd = dict(C21_DARCY)
    n = kd.pop("n")
    af, uf = load_pdebench_darcy(sim / "darcy.h5")
    model = cgen._make_darcy_model(kd["in_emb_dim"], kd["depth"], kd["heads"],
                                   torch.Generator().manual_seed(16))
    tree = cdr.trained_tree(model)
    hist = {}
    for where in (dev, cpu):
        res = cgen.run_oformer_darcy(af[:n], uf[:n], run_dir=str(out / f"darcy_{where.type}"),
                                     init_params=tree, device=where, **kd)
        hist[where.type] = [h["rel_l2"] for h in res.history]
    c21_losses(f"[cmp] run_oformer_darcy ({af.shape[1]}^2 = {af.shape[1] * af.shape[2]} "
               "tokens, in_emb 64, depth 3, heads 4, batch 4)", hist[dev.type], hist["cpu"],
               f"{n} of {af.shape[0]} samples, one step an epoch, 3 epochs")
    m = model.to(dev)
    opt = AdamW(dict(m.named_parameters()), make_lr_schedule("cosine", 3e-4, 3))
    hw = af.shape[1] * af.shape[2]
    p = torch.as_tensor(cgen._darcy_grid(af.shape[1], af.shape[2]), device=dev).expand(4, hw, 2)
    a_in = torch.as_tensor(af[:4].reshape(4, hw, 1), device=dev)
    ms = step_ms(cgen.supervised_step(m, opt),
                 (torch.cat([a_in, p], dim=-1), p,
                  torch.as_tensor(uf[:4].reshape(4, hw, 1), device=dev)))
    print(f"[timing] {card}: the Darcy OFormer step (batch 4, {hw} tokens): {ms:.3f} ms (CUDA "
          f"events, {C21_TIMED} steps)", flush=True)
    print(f"[cmp] {card}: 21d in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 21e. the point-set BVP (both recipes) and the airfoil operator -----------------
    t_sub = time.perf_counter()
    train, _ = cpt.standardize_features(load_pointset(sim / "electro.pkl"))
    for recipe, kw in C21_BVP.items():
        model = cpt.OFormerIrreg2D(train["features"].shape[-1], kw["latent_channels"],
                                   kw["heads"], kw["depth"],
                                   generator=torch.Generator().manual_seed(6))
        tree = cdr.trained_tree(model)
        l1 = not kw.get("reference_recipe")  # the adamw recipe's loss_p = 1
        hist = {}
        for where, start in ((dev, tree), (cpu, tree)) + (((cpu, nudged(tree)),) if l1 else ()):
            key = where.type if start is tree else "witness"
            d = out / f"bvp_{recipe}_{key}"
            cpt.run_pointset_training(train, run_dir=str(d), log_every=1, init_params=start,
                                      device=where, **kw)
            hist[key] = jsonl(d, "pointset_bvp", "loss")
        pts = train["features"].shape[1]
        c21_losses(f"[cmp] run_pointset_training {recipe} recipe ({pts} nodes padded, latent "
                   f"64, depth 2, batch {kw['batch_size']})", hist[dev.type], hist["cpu"],
                   f"the {train['features'].shape[0]} electro cases phase 19 wrote, "
                   f"{kw['epochs']} epochs", hist.get("witness"))
        m = model.to(dev)
        params = dict(m.named_parameters())
        opt = (AMSGrad(params, warmup_cosine_decay_schedule(3e-6, 3e-4, 1, 3, 3e-8), 1e-4,
                       clip=2.0) if kw.get("reference_recipe")
               else AdamW(params, make_lr_schedule("cosine", 8e-4, 3)))
        step = cpt.pointset_step(m, opt, 1.0 if kw.get("reference_recipe") else 0.5,
                                 2 if kw.get("reference_recipe") else 1)
        batch = {k: torch.as_tensor(v[:kw["batch_size"]], device=dev) for k, v in train.items()}
        ms = step_ms(step, (batch,))
        print(f"[timing] {card}: the point-set BVP step, {recipe} recipe (batch "
              f"{kw['batch_size']}, {pts} nodes): {ms:.3f} ms (CUDA events, {C21_TIMED} "
              "steps)", flush=True)
    air = load_airfoil_dataset(str(sim / "airfoil"))
    ka = dict(C21_AIRFOIL)
    c = air["fields"].shape[-1]
    model = cpt._st_model(c, ka["time_window"], ka["emb_dim"], ka["latent_channels"],
                          ka["depth"], torch.Generator().manual_seed(6))
    tree = cdr.trained_tree(model)
    hist = {}
    for where, start, key in ((dev, tree, dev.type), (cpu, tree, "cpu"),
                              (cpu, nudged(tree), "witness")):
        d = out / f"airfoil_{key}"
        cpt.run_airfoil_training(air, run_dir=str(d), log_every=1, init_params=start,
                                 device=where, **ka)
        hist[key] = jsonl(d, "pointset_airfoil", "l1")
    n_nodes = air["fields"].shape[2]
    c21_losses(f"[cmp] run_airfoil_training ({n_nodes} nodes, time_window 4, forward_steps 2, "
               "emb 96, latent 96, depth 3)", hist[dev.type], hist["cpu"],
               f"phase 19's one sample of {air['fields'].shape[1]} frames: one window, batch 1, "
               "3 epochs", hist["witness"])
    m = model.to(dev)
    opt = AdamW(dict(m.named_parameters()), make_lr_schedule("cosine", 8e-4, 3))
    rows = torch.zeros(1, 2, dtype=torch.long, device=dev)
    args = cpt._st_batch(torch.as_tensor(air["fields"], device=dev),
                         torch.as_tensor(air["coords"], device=dev),
                         torch.as_tensor(air["node_type"], device=dev).long(), rows, 4, 2)
    ms = step_ms(cpt.airfoil_step(m, opt, 2), args)
    print(f"[timing] {card}: the airfoil operator step (batch 1, {n_nodes} nodes, 2 frames "
          f"ahead): {ms:.3f} ms (CUDA events, {C21_TIMED} steps)", flush=True)
    print(f"[cmp] {card}: 21e in {time.perf_counter() - t_sub:.1f} s; phase 21 in "
          f"{time.perf_counter() - t_phase:.1f} s; HDF5 through "
          f"{h5io.h5py_module().__name__}", flush=True)


# ---- phase 22: the study drivers (ROADMAP A10) ------------------------------------------
# 22a: experiments/dr_transformer.py at the reference's width (STUDY_WIDTHS: encoder
# 1024 x 16 blocks x 16 heads, decoder 512 x 8 x 8, dr_convention_eval.py's defaults),
# bf16, batch 4, basic_ds2, one epoch, both variants, on phase 18's DR files (128^2,
# patch 16, tubelet 1, 10 frames: 640 tokens, which the attention's shape rule sends to
# the plain path, as JAX's does); its best baseline checkpoint in f32 on the test
# window at horizon 1, on the card against the CPU within TOL_STUDY of the largest
# magnitude (the VideoMAE f32 bound: f32 sums in another order through 24 blocks).
# 22b: the three diagnostics on that checkpoint; the f32 convention rows (rollout
# STUDY_CPU_ROLLOUT, the test window) on the card against the CPU within TOL_STUDY
# relative.  22c: experiments/dft_precision_gate.py on the production step, then under
# SCIML_FAST_STEP=1 (the fused step: every FNO kernel).  22d: experiments/ns_demo.py
# at 128^2 x 16 frames (STUDY_NS_DEMO), then experiments/ns_lie_toy.py from a 256^2
# source of 4 trajectories x 20 frames the phase writes (ns_production's config: dt
# 5e-4, the exact diffusion).  22e: experiments/dr_data_audit.py at 64^2, its RK4
# RMS on the card against the same trajectory's on the CPU within TOL_SIM relative.  22f: the seed figure and the round
# figures from the summaries of phases 18 and 22 and the tracked snapshots.
STUDY_WIDTHS = ["--encoder-dim", "1024", "--encoder-depth", "16", "--encoder-heads", "16",
                "--decoder-dim", "512", "--decoder-depth", "8", "--decoder-heads", "8"]
TOL_STUDY, STUDY_CPU_ROLLOUT, STUDY_WARM_STEPS = 1e-4, 2, 3
STUDY_NS_DEMO = ["--grid", "128", "--frames", "16", "--frame-int", "5", "--n-primary", "1",
                 "--n-aux-per", "1", "--n-test", "1", "--epochs", "1"]
STUDY_LIE_SRC = dict(grid=256, frames=20, frame_int=5, n_batch=4)


# ---- phase 23: the compressed HDF5 stores without h5py ------------------------------------
# 23a: the codec on LZF_CHECK_BYTES of phase 18's DR store (seed 0's data as stored,
# unshuffled f32, and shuffled as the NS store holds it), C against plain, exactly;
# MB/s of the C codec over every chunk of both stores.  23d: LZF_STEPS fused steps of
# the DR flagship (batch B, 128^2, width WIDTH, modes MODES) from each copy.
LZF_CHECK_BYTES, LZF_STEPS = 256 << 10, 3
LZF_NS_STORE = "ns_incom_inhom_2d_256-0.h5"  # phase 20e's NS file (2 x 20 frames, 256^2)


def store_chunks(arr, chunks) -> list:
    """The chunks of ``arr`` as a chunked dataset of chunk shape ``chunks``
    holds them, each contiguous and padded with zeros at the edges."""
    import itertools

    import numpy as np

    out = []
    for pos in itertools.product(*[range(-(-n // c)) for n, c in zip(arr.shape, chunks)]):
        block = np.zeros(chunks, arr.dtype)
        part = arr[tuple(slice(p * c, (p + 1) * c) for p, c in zip(pos, chunks))]
        block[tuple(slice(0, n) for n in part.shape)] = part
        out.append(block)
    return out


def lzf_store_path(dev, card: str, run_dir: Path, root: Path) -> None:
    """Phase 23: the LZF codec, the h5py-written fixture, phase 18's DR and
    phase 20's NS stores read and written through the port's HDF5 path,
    and fused steps from an LZF store against an uncompressed copy."""
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from sciml_pde_torch.data.dr import PRIMARY_FILE, load_dr_baseline
    from sciml_pde_torch.io import filters, lzf
    from sciml_pde_torch.io import h5 as h5io
    from sciml_pde_torch.ops import _build
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.sim.gen_ns_incomp import write_ns_h5
    from sciml_pde_torch.train import fast_step as fs
    from sciml_pde_torch.train.fno_train import default_init_tree

    t_phase = t_sub = time.perf_counter()
    h5py = h5io.h5py_module()
    out = run_dir / "lzf"
    shutil.rmtree(out, ignore_errors=True)
    (out / "dr_lzf").mkdir(parents=True)
    (out / "dr_raw").mkdir()
    print(f"[lzf] HDF5 through {h5py.__name__}; the codec library in use: "
          f"{_build.host_library_path(lzf.SOURCE).name}", flush=True)

    # ---- 23a. the codec: built, against its plain version, MB/s --------------------------
    t0 = time.perf_counter()
    built = subprocess.run([_build.host_cc(), *_build.HOST_CFLAGS, "-o", str(out / "liblzf.so"),
                            str(lzf.SOURCE)], capture_output=True, text=True)
    build_s = time.perf_counter() - t0
    check(built.returncode == 0, f"[lzf] {Path(_build.host_cc()).name} "
          f"{' '.join(_build.HOST_CFLAGS)} io/csrc/lzf.c in {build_s:.3f} s "
          + (built.stdout + built.stderr)[-2000:])
    dr_path = run_dir / "dr_data" / PRIMARY_FILE
    t0 = time.perf_counter()
    dr = {}
    with h5py.File(dr_path, "r") as f:
        for k in sorted(f.keys()):
            dr[k] = (np.asarray(f[k]["data"]), {g: np.asarray(f[k]["grid"][g]) for g in "xyt"},
                     f[k].attrs.get("config", ""))
        dr_layout = (f["0000"]["data"].chunks, f["0000"]["data"].compression)
    dr_read_s = time.perf_counter() - t0
    ns_path = run_dir / "a8_ns" / LZF_NS_STORE
    t0 = time.perf_counter()
    with h5py.File(ns_path, "r") as f:
        ns = {k: np.asarray(f[k]) for k in ("velocity", "particles", "force", "t")}
        ns_attrs = dict(f.attrs)
        ns_layout = (f["velocity"].chunks, f["velocity"].compression, f["velocity"].shuffle)
    ns_read_s = time.perf_counter() - t0
    check(dr_layout[1] == "lzf" and dr_layout[0] is not None and ns_layout[1:] == ("lzf", True),
          f"[lzf] phase 18's DR store is chunked LZF (chunks {dr_layout[0]}), phase 20's NS "
          f"store chunked, shuffled LZF (chunks {ns_layout[0]}): written so through "
          f"{h5py.__name__}")
    sample = np.ascontiguousarray(dr["0000"][0]).reshape(-1).view(np.uint8)[:LZF_CHECK_BYTES]
    for form, data in (("as stored", sample), ("shuffled", filters.shuffle(sample, 4))):
        room = data.size + data.size // 16 + 64  # a stream always fits
        t0 = time.perf_counter()
        c = lzf.compress(data, room)
        c_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = lzf.lzf_compress_plain(data, room)
        p_s = time.perf_counter() - t0
        ok = c is not None and c == p
        ok = ok and bytes(lzf.decompress(p, data.size)) == data.tobytes() \
            == bytes(lzf.lzf_decompress_plain(c, data.size))
        check(ok, f"[lzf] the C codec against its plain version on {data.size} bytes of the DR "
              f"store {form}: the same {len(c or b'')}-byte stream (C {1e3 * c_s:.3f} ms, plain "
              f"{1e3 * p_s:.1f} ms), each decoding the other's to the input exactly")
    rates = {}
    for name, arrays, chunks, shuffle in (
            ("DR", [a for a, _, _ in dr.values()], dr_layout[0], False),
            ("NS", list(ns.values()), None, True)):
        blocks = []
        for a in arrays:
            ch = chunks or ((1, 1, *a.shape[2:]) if a.ndim > 2 else a.shape)
            blocks += [filters.shuffle(b, 4) if shuffle else b.reshape(-1).view(np.uint8)
                       for b in store_chunks(a, ch)]
        t0 = time.perf_counter()
        streams = [lzf.compress(b) for b in blocks]
        enc_s = time.perf_counter() - t0
        packed = [(s, b.size) for s, b in zip(streams, blocks) if s is not None]
        t0 = time.perf_counter()
        for s, n in packed:
            lzf.decompress(s, n)
        dec_s = time.perf_counter() - t0
        n_in = sum(b.size for b in blocks)
        n_out = sum(n for _, n in packed)
        rates[name] = (n_in / enc_s / 1e6, n_out / max(dec_s, 1e-9) / 1e6)
        print(f"[timing] {card}: LZF codec (C, host) on the {name} store's {len(blocks)} chunks "
              f"({n_in} bytes{', shuffled' if shuffle else ''}): compress "
              f"{rates[name][0]:.1f} MB/s; {len(packed)} chunks compressed to "
              f"{sum(len(s) for s, _ in packed)} bytes, {len(blocks) - len(packed)} stored raw; "
              f"decompress {rates[name][1]:.1f} MB/s of output", flush=True)
    phase_done(card, "23a", t_sub)

    # ---- 23b. the h5py-written fixture --------------------------------------------------
    t_sub = time.perf_counter()
    spec = importlib.util.spec_from_file_location("_torch_h5_fixture",
                                                  root / "tests" / "_torch_h5_fixture.py")
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    want = fx.fixture_arrays()
    with h5py.File(fx.write_fixture(out / "fixture.h5"), "r") as f:
        ok = sorted(f.keys()) == sorted(want)
        for k, a in want.items():
            ok &= np.asarray(f[k]).tobytes() == a.tobytes() \
                and (f[k].chunks, f[k].compression, f[k].shuffle) == fx.LAYOUT[k]
    check(ok, f"[lzf] the h5py-written NS store of tests/_torch_h5_fixture.py (chunks of one "
          f"frame, shuffle, LZF; the noise stored raw) read through {h5py.__name__}: every "
          "array bit for bit, h5py's chunks and filters")
    phase_done(card, "23b", t_sub)

    # ---- 23c. the stores read, written again (LZF) and uncompressed ----------------------
    t_sub = time.perf_counter()
    x, y, t = (dr["0000"][1][g] for g in "xyt")
    t0 = time.perf_counter()
    h5io.write_seed_groups(out / "dr_lzf" / PRIMARY_FILE, {int(k): a for k, (a, _, _) in
                                                           dr.items()}, x, y, t, dr["0000"][2])
    dr_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with h5py.File(out / "dr_raw" / PRIMARY_FILE, "w") as f:
        for k, (a, grid, cfg) in dr.items():
            f.create_dataset(f"{k}/data", data=a)
            for g, v in grid.items():
                f.create_dataset(f"{k}/grid/{g}", data=v)
            if cfg:
                f[k].attrs["config"] = cfg
    dr_raw_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_ns_h5(out / "ns_lzf.h5", ns["velocity"], ns["particles"], ns["force"], ns["t"],
                json.loads(ns_attrs["config"]))
    ns_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with h5py.File(out / "ns_raw.h5", "w") as f:
        for k, a in ns.items():
            f.create_dataset(k, data=a)
    ns_raw_write_s = time.perf_counter() - t0
    reads = {}
    for name, path, keys in (("DR LZF", out / "dr_lzf" / PRIMARY_FILE, None),
                             ("DR uncompressed", out / "dr_raw" / PRIMARY_FILE, None),
                             ("NS LZF", out / "ns_lzf.h5", ns), ("NS uncompressed",
                                                                 out / "ns_raw.h5", ns)):
        t0 = time.perf_counter()
        with h5py.File(path, "r") as f:
            got = ({k: np.asarray(f[k]) for k in keys} if keys else
                   {k: np.asarray(f[k]["data"]) for k in sorted(f.keys())})
        reads[name] = time.perf_counter() - t0
        ref = ns if keys else {k: a for k, (a, _, _) in dr.items()}
        check(sorted(got) == sorted(ref) and all(got[k].tobytes() == ref[k].tobytes()
                                                 for k in ref),
              f"[lzf] {name} copy read back bit for bit ({path.stat().st_size} bytes)")
    size = {n: p.stat().st_size for n, p in (
        ("dr", dr_path), ("dr_lzf", out / "dr_lzf" / PRIMARY_FILE),
        ("dr_raw", out / "dr_raw" / PRIMARY_FILE), ("ns", ns_path),
        ("ns_lzf", out / "ns_lzf.h5"), ("ns_raw", out / "ns_raw.h5"))}
    for name, n_seeds, parts in (
            ("DR", len(dr), (dr_read_s, dr_write_s, reads["DR LZF"], dr_raw_write_s,
                             reads["DR uncompressed"], size["dr"], size["dr_lzf"],
                             size["dr_raw"])),
            ("NS", ns["velocity"].shape[0], (ns_read_s, ns_write_s, reads["NS LZF"],
                                             ns_raw_write_s, reads["NS uncompressed"],
                                             size["ns"], size["ns_lzf"], size["ns_raw"]))):
        what = "seeds" if name == "DR" else "trajectories"
        print(f"[timing] {card}: {name} store ({n_seeds} {what}) through {h5py.__name__}: phase {18 if name == 'DR' else 20}'s LZF file read "
              f"{parts[0]:.3f} s; written again LZF {parts[1]:.3f} s, read {parts[2]:.3f} s; "
              f"uncompressed written {parts[3]:.3f} s, read {parts[4]:.3f} s; sizes: phase's "
              f"{parts[5]} bytes, LZF again {parts[6]} bytes, uncompressed {parts[7]} bytes "
              f"({parts[6] / parts[7]:.3f} of it)", flush=True)
    phase_done(card, "23c", t_sub)

    # ---- 23d. fused steps from the LZF store and from the uncompressed copy --------------
    t_sub = time.perf_counter()
    spectral.set_dft_precision("default")
    tree = default_init_tree(CC, MODES, WIDTH, T0, seed=23)
    losses, data, launches = {}, {}, {}
    for name, d in (("LZF", run_dir / "dr_data"), ("uncompressed", out / "dr_raw")):
        ds = load_dr_baseline(str(d) + "/", train_subsample=9, initial_step=T0, rollout_test=1,
                              device=dev)
        theta, spec = fs.fast_state_from_tree(tree, MODES, dev)
        opt = fs.init_opt(theta)
        step, _ = fs.build_fast_baseline_step(MODES, T0, spec, 1e-3, 10_000)
        data[name] = ds.train.data
        grid2t = ds.train.grid.permute(2, 0, 1).contiguous()
        idx = torch.as_tensor(ds.train.window_index()[:B], dtype=torch.long, device=dev)
        fk.reset_launch_counts()
        got = []
        for _ in range(LZF_STEPS):
            theta, opt, loss, _ = step(theta, opt, data[name], grid2t, idx)
            got.append(loss)
        torch.cuda.synchronize()
        launches[name] = dict(fk.LAUNCHES)
        losses[name] = [v.item() for v in got]
    same = bool(torch.equal(data["LZF"], data["uncompressed"]))
    check(same and losses["LZF"] == losses["uncompressed"]
          and all(math.isfinite(v) for v in losses["LZF"]),
          f"[lzf] {LZF_STEPS} fused DR flagship steps from the LZF store and from its "
          f"uncompressed copy: the same store on the card ({same}), the same losses bit for bit "
          f"({', '.join(f'{v!r}' for v in losses['LZF'])})")
    check(all(launches[n][k] > 0 for n in launches for k in fk.KERNEL_NAMES),
          "[lzf] the steps from each store launched every FNO kernel: "
          + json.dumps(launches["LZF"]))
    phase_done(card, "23d", t_sub)
    phase_done(card, "phase 23", t_phase)


# ---- phase 24: the JAX package's checkpoints without orbax --------------------------------
# 24a: the C zstd decoder on the frames of tests/_torch_orbax_fixture.py (zstandard's, levels
# 1, 3, 19, with and without a checksum, one content over 128 KiB), CKPT_ZSTD_REPS passes
# for its MB/s.  24c: the DR flagship (batch B, 128^2, width WIDTH, modes MODES) on
# CKPT_TRAJ trajectories of phase 18's DR store, one epoch and two resumes of each step.
CKPT_ZSTD_REPS, CKPT_TRAJ = 20, 2
TOL_CKPT_FORWARD = 1e-4  # the fixture's forward on the card against JAX's, `highest`


def tree_digests(tree) -> dict:
    """{dotted path: (dtype, shape, SHA-256 of the bytes)} of every array leaf of
    a checkpoint tree, as ``save_checkpoint`` stores it (empty leaves left out)."""
    import hashlib

    import numpy as np
    import torch

    from sciml_pde_torch.utils.orbax_tree import flatten

    out = {}
    for path, leaf in flatten(tree).items():
        if leaf is None or isinstance(leaf, (tuple, list, dict)):
            continue
        a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        out[".".join(path)] = (a.dtype.str, a.shape, hashlib.sha256(a.tobytes()).hexdigest())
    return out


def _leaves_by_name(tree) -> dict:
    """{dotted path: CPU tensor} of a restored checkpoint's array leaves."""
    from sciml_pde_torch.utils.orbax_tree import flatten

    return {".".join(p): v for p, v in flatten(tree).items()
            if v is not None and not isinstance(v, (tuple, list, dict))}


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def checkpoint_path(dev, card: str, run_dir: Path, root: Path) -> None:
    """Phase 24: zstd frames, the JAX package's embedded checkpoint, the flagship's
    checkpoints through both steps' trainers (bit for bit, resumed twice), and the
    checkpoint's bytes and seconds at the flagship and at the DR VideoMAE's width."""
    import hashlib
    import importlib.util
    import shutil

    import numpy as np
    import torch

    from sciml_pde_torch.io import zstd
    from sciml_pde_torch.models.fno import FNO2d
    from sciml_pde_torch.ops import _build, spectral
    from sciml_pde_torch.train import fno_train
    from sciml_pde_torch.utils.checkpoint import restore_checkpoint
    from sciml_pde_torch.utils.orbax_tree import read_tree, write_tree
    from sciml_pde_torch.utils.weights import flax_to_state_dict

    t_phase = t_sub = time.perf_counter()
    out = run_dir / "ckpt"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    spec = importlib.util.spec_from_file_location("_torch_orbax_fixture",
                                                  root / "tests" / "_torch_orbax_fixture.py")
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)

    # ---- 24a. the C zstd decoder against zstandard's frames ---------------------------
    lib = _build.host_library_path(zstd.SOURCE)
    zstd.library()
    contents = fx.zstd_contents()
    ok = True
    for name, level, checksum, digest, frame in fx.ZSTD_FRAMES:
        got = zstd.decompress(frame)
        ok &= got == contents[name] and hashlib.sha256(got).hexdigest() == digest
    n_out = sum(len(contents[n]) for n, *_ in fx.ZSTD_FRAMES)
    t0 = time.perf_counter()
    for _ in range(CKPT_ZSTD_REPS):
        for *_, frame in fx.ZSTD_FRAMES:
            zstd.decompress_array(frame)
    rate = CKPT_ZSTD_REPS * n_out / (time.perf_counter() - t0) / 1e6
    check(ok and any(len(c) > 128 << 10 for c in contents.values()),
          f"[ckpt] the C zstd decoder ({lib.name}, built from io/csrc/zstd.c) on "
          f"{len(fx.ZSTD_FRAMES)} zstandard frames (levels 1, 3, 19, with and without a "
          "checksum, one content over 128 KiB): the same bytes")
    print(f"[timing] {card}: zstd decoder (C, host) {rate:.1f} MB/s of output over the "
          f"{len(fx.ZSTD_FRAMES)} frames ({n_out} bytes, {CKPT_ZSTD_REPS} passes)", flush=True)
    t_sub = phase_done(card, "24a", t_sub)

    # ---- 24b. the JAX package's embedded checkpoint ------------------------------------
    tree = restore_checkpoint(fx.write_checkpoint(out / "fixture_ckpt"))
    got = {k: fx.leaf_digest(k, v.numpy()) for k, v in _leaves_by_name(tree).items()}
    model = FNO2d(**fx.MODEL)
    model.load_state_dict(flax_to_state_dict(tree["params"]))
    x, grid = fx.fixture_input()
    prev = spectral.get_dft_precision()
    spectral.set_dft_precision("highest")
    try:
        with torch.no_grad():
            y = model.to(dev)(torch.as_tensor(x, device=dev), torch.as_tensor(grid, device=dev))
    finally:
        spectral.set_dft_precision(prev)
    err, rel = rel_err(y.cpu(), torch.as_tensor(fx.output()))
    check(got == fx.LEAVES, f"[ckpt] the JAX package's orbax checkpoint of "
          f"tests/_torch_orbax_fixture.py (a width-8 DR FNO, the production optimizer's "
          f"state, meta): {len(got)} leaves bit for bit against their recorded hashes")
    check(bool(torch.isfinite(y).all()) and rel <= TOL_CKPT_FORWARD,
          f"[ckpt] its parameters' forward on the card against JAX's stored output under "
          f"`highest`: {rel:.2e} of the largest magnitude (bound {TOL_CKPT_FORWARD})")
    t_sub = phase_done(card, "24b", t_sub)

    # ---- 24c. the flagship's checkpoint through both steps' trainers --------------------
    saved = []
    writer = fno_train.save_checkpoint

    def recording_save(path, params, opt_state, epoch, loss):
        t0 = time.perf_counter()
        writer(path, params, opt_state, epoch, loss)
        saved.append((Path(path), time.perf_counter() - t0, tree_digests(
            {"params": params, "opt_state": opt_state,
             "meta": {"epoch": np.asarray(int(epoch)), "loss": np.asarray(float(loss))}})))

    kw = dict(base_path=str(run_dir / "dr_data") + "/", train_subsample=CKPT_TRAJ,
              initial_step=T0, modes=MODES, width=WIDTH, batch_size=B, log_every=0,
              seed=0, if_aux=False, device=dev)
    sizes = {}
    fno_train.save_checkpoint = recording_save
    try:
        for step in ("production", "fused"):
            saved.clear()
            d = out / step
            res = fno_train.run_training(run_dir=str(d), model_name="ck", epochs=1,
                                         fast_step=step == "fused", **kw)
            path, write_s, want = saved[-1]
            t0 = time.perf_counter()
            back = restore_checkpoint(path)
            read_s = time.perf_counter() - t0
            got = tree_digests(back)
            final = tree_digests({"params": res.params})
            check(got == want and all(got[k] == v for k, v in final.items()),
                  f"[ckpt] {step} step, one epoch through run_training: the checkpoint "
                  f"read back against the trainer's best state as it wrote it, {len(got)} "
                  "leaves (params, optax's moments and counts, meta) bit for bit, and its "
                  "params against the trained tree")
            hist = []
            for r in (1, 2):
                shutil.copytree(d, out / f"{step}_resume{r}")
                hist.append(fno_train.run_training(
                    run_dir=str(out / f"{step}_resume{r}"), model_name="ck", epochs=2,
                    continue_training=True, fast_step=step == "fused", **kw).history)
            check(hist[0] == hist[1] and [h["epoch"] for h in hist[0]] == [0, 1]
                  and all(math.isfinite(h["val_loss"]) for h in hist[0]),
                  f"[ckpt] {step} step resumed twice from copies of that directory "
                  "(continue_training): the same losses bit for bit, "
                  + ", ".join(f"{h['train_loss']:.6g}/{h['val_loss']:.6g}" for h in hist[0]))
            sizes[f"DR flagship, {step} step"] = (dir_bytes(path), write_s, read_s, len(got))
    finally:
        fno_train.save_checkpoint = writer
    t_sub = phase_done(card, "24c", t_sub)

    # ---- 24d. bytes and seconds: the flagship, the DR VideoMAE at the reference width ---
    vmae = (run_dir / "study").resolve() / "dt" / "vmae_dr_basic_ds2_baseline_ckpt"
    t0 = time.perf_counter()
    big = read_tree(vmae)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_tree(out / "vmae_copy_ckpt", big)
    write_s = time.perf_counter() - t0
    copy = _leaves_by_name(read_tree(out / "vmae_copy_ckpt"))
    leaves = _leaves_by_name(big)
    same = copy.keys() == leaves.keys() and all(
        copy[k].dtype == v.dtype and torch.equal(copy[k], v) for k, v in leaves.items())
    check(same, f"[ckpt] phase 22's DR VideoMAE checkpoint (the reference's width) read, "
          "written again and read back: every leaf bit for bit")
    sizes["DR VideoMAE, reference width (phase 22)"] = (dir_bytes(vmae), write_s, read_s,
                                                        len(leaves))
    del big, copy, leaves
    for what, (n, w, r, leaves) in sizes.items():
        print(f"[timing] {card}: checkpoint of the {what}: {n} bytes, {leaves} leaves; "
              f"write {w:.3f} s ({n / w / 1e6:.1f} MB/s), read {r:.3f} s "
              f"({n / r / 1e6:.1f} MB/s), warm page cache", flush=True)
    phase_done(card, "24d", t_sub)
    phase_done(card, "phase 24 (checkpoints)", t_phase)


def timed_steps_of(build, events: list):
    """``build`` (a trainer's step builder) whose step records a pair of CUDA
    events around each call into ``events``."""
    import torch

    def wrapped(*args, **kwargs):
        step, val = build(*args, **kwargs)

        def timed(*a):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = step(*a)
            e.record()
            events.append((s, e))
            return out
        timed.xy = step.xy
        return timed, val
    return wrapped


def finite_tree(tree) -> bool:
    if isinstance(tree, dict):
        return all(finite_tree(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(finite_tree(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


def png_colours(path) -> int:
    from PIL import Image

    with Image.open(path) as im:
        return len(im.convert("RGB").getcolors(1 << 24) or ())


def study_path(dev, card: str, run_dir: Path, root: Path) -> dict:
    """Phase 22: the study drivers (ROADMAP A10) through their entry points
    on the card.  Returns each FNO kernel's launches in the fused gate run."""
    import argparse
    import contextlib
    import os
    import shutil

    import numpy as np
    import torch

    from sciml_pde_torch.experiments import (_dr_vmae, dft_precision_gate, dr_convention_eval,
                                             dr_data_audit, dr_early_window_finetune,
                                             dr_seed_figure, dr_transformer, dr_vchannel_diag,
                                             make_round_figures, ns_demo, ns_lie_toy)
    from sciml_pde_torch.experiments.ns_production import make_cfg
    from sciml_pde_torch.ops import attention as ta
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.sim.diff_react import DiffReactConfig, generate_trajectories
    from sciml_pde_torch.sim.gen_ns_incomp import generate_ns_file
    from sciml_pde_torch.train import transformer_train as ttt
    from sciml_pde_torch.utils.checkpoint import restore_params

    t_phase = t_sub = time.perf_counter()
    data, out = str(run_dir / "dr_data") + "/", (run_dir / "study").resolve()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    on_card = ["--device", dev.type]

    # ---- 22a. dr_transformer at the reference's width ------------------------------------
    events: dict[str, list] = {}
    peaks = {}
    real = {k: getattr(ttt, k) for k in ("build_transformer_baseline_step",
                                         "build_transformer_aux_step")}
    summary = {}
    ta.reset_launch_counts()
    try:
        for variant, builder in (("baseline", "build_transformer_baseline_step"),
                                 ("aux", "build_transformer_aux_step")):
            events[variant] = []
            setattr(ttt, builder, timed_steps_of(real[builder], events[variant]))
            torch.cuda.reset_peak_memory_stats()
            summary = dr_transformer.main(["--data", data, "--dataset", "basic_ds2", "--epochs",
                                           "1", "--batch-size", "4", "--precision", "bf16",
                                           "--variants", variant, "--out", str(out / "dt"),
                                           *STUDY_WIDTHS, *on_card])
            torch.cuda.synchronize()
            peaks[variant] = torch.cuda.max_memory_allocated() / 2**30
    finally:
        for k, fn in real.items():
            setattr(ttt, k, fn)
    att = {k: v for k, v in ta.LAUNCHES.items() if v}
    check(not att, "[study] dr_transformer's 640 tokens take the plain attention (JAX's shape "
          f"rule): no attention kernel launched ({json.dumps(att)})")
    keys = {"best_val", "train_seconds", "val_history", "rollout_nrmse",
            "rollout_nrmse_allsteps", "swa_rollout_nrmse"}
    for variant in ("baseline", "aux"):
        row = summary.get(f"basic_ds2_{variant}", {})
        ms = [s.elapsed_time(e) for s, e in events[variant][STUDY_WARM_STEPS:]]
        print(f"[timing] {card}: dr_transformer {variant} (encoder 1024 x 16 x 16 heads, decoder "
              f"512 x 8 x 8, bf16, batch 4{' + 12 aux windows' if variant == 'aux' else ''}, "
              f"640 tokens): {float(np.median(ms)) if ms else float('nan'):.3f} ms a step "
              f"(median of CUDA events around the trainer's {len(ms)} steps after "
              f"{STUDY_WARM_STEPS}); peak memory {peaks[variant]:.2f} GiB", flush=True)
        check(set(row) == keys and len(row["rollout_nrmse"]) == 5 and finite_tree(row)
              and all(math.isfinite(v) for v in row["val_history"]),
              f"[study] dr_transformer {variant}: JAX's summary keys, best val "
              f"{row.get('best_val', float('nan')):.5g}, rollout nRMSE "
              + ", ".join(f"{v:.5f}" for v in row.get("rollout_nrmse", []))
              + (f", SWA {', '.join(f'{v:.5f}' for v in row['swa_rollout_nrmse'])}"
                 if row.get("swa_rollout_nrmse") else "") + " finite")
    ckpt = out / "dt" / "vmae_dr_basic_ds2_baseline_ckpt"
    params, _ = restore_params(ckpt)
    width_flags = argparse.ArgumentParser()
    _dr_vmae.add_width_args(width_flags)
    widths = width_flags.parse_args(STUDY_WIDTHS)
    test = _dr_vmae.load_test(data)
    models = {where: _dr_vmae.build(widths, torch.float32, params, where)
              for where in (dev, torch.device("cpu"))}
    with torch.no_grad():
        x0 = torch.as_tensor(test[:1, :10])
        pc = models[dev](x0.to(dev)).cpu()
        pw = models[torch.device("cpu")](x0)
    err, rel = rel_err(pc, pw)
    check(bool(torch.isfinite(pc).all()) and rel <= TOL_STUDY,
          f"[study] the best baseline checkpoint in f32 at horizon 1 on the test window: the "
          f"card against the CPU max abs err {err:.3e}, rel-to-max {rel:.3e} (tol "
          f"{TOL_STUDY:.0e})")
    print(f"[time] {card}: 22a in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 22b. the three diagnostics on 22a's baseline checkpoint -------------------------------
    t_sub = time.perf_counter()
    rows = {where.type: dr_convention_eval.convention_rows(m, test, 0, STUDY_CPU_ROLLOUT, where)
            for where, m in models.items()}
    worst_rel = max(abs(a - b) / abs(b) for k in rows["cpu"]
                    for a, b in zip(rows[dev.type][k], rows["cpu"][k]))
    check(worst_rel <= TOL_STUDY,
          f"[study] convention rows in f32 at horizons 1-{STUDY_CPU_ROLLOUT}, the card against "
          f"the CPU: largest relative difference {worst_rel:.3e} (tol {TOL_STUDY:.0e}); "
          + "; ".join(f"{k} {', '.join(f'{v:.5f}' for v in r)}" for k, r in rows["cpu"].items()))
    del models
    ce = dr_convention_eval.main(["--data", data, "--ckpts", f"baseline={ckpt}", "--rollout",
                                  "5", "--out", str(out / "convention_eval.json"), *STUDY_WIDTHS,
                                  *on_card])
    row = ce.get("baseline", {})
    check(set(row) == {*dr_convention_eval.ROWS, "best_val", "published"}
          and all(len(row[k]) == 5 for k in dr_convention_eval.ROWS) and finite_tree(row),
          "[study] dr_convention_eval (bf16, horizons 1-5): JAX's rows, finite: "
          + "; ".join(f"{k} {', '.join(f'{v:.5f}' for v in row.get(k, []))}"
                      for k in dr_convention_eval.ROWS))
    vc = dr_vchannel_diag.main(["--data", data, "--ckpt", str(ckpt), "--precisions", "bf16",
                                "fp32", "--t0", "0", "20", "--out", str(out / "vchannel.json"),
                                *STUDY_WIDTHS, *on_card])
    want = {f"{p}_t0={t}" for p in ("bf16", "fp32") for t in (0, 20)}
    rkeys = {f"r{k}{s}" for k in (1, 2, 3) for s in ("", "_tgt_rms")}
    check(set(vc) == want and all(set(r) == rkeys for r in vc.values()) and finite_tree(vc),
          "[study] dr_vchannel_diag (bf16, fp32; t0 0, 20; horizons 1-3): JAX's keys, finite; "
          "per-channel nRMSE at r1 " + "; ".join(f"{k} {', '.join(f'{v:.4f}' for v in r['r1'])}"
                                                for k, r in vc.items()))
    ew = dr_early_window_finetune.main(["--data", data, "--ckpt", str(ckpt), "--n-train", "2",
                                        "--epochs", "1", "--out", str(out / "early.json"),
                                        *STUDY_WIDTHS, *on_card])
    check(set(ew) == {"before", "after", "config"}
          and all(set(ew[p]) == {"t0=0", "t0=20"} for p in ("before", "after"))
          and finite_tree({p: ew[p] for p in ("before", "after")}) and ew["before"] != ew["after"],
          "[study] dr_early_window_finetune (2 trajectories x t0 0-12, batch 4, 1 epoch): JAX's "
          f"keys, finite, the weights moved; t0=0 r1 before {ew['before']['t0=0']['r1']}, after "
          f"{ew['after']['t0=0']['r1']}")
    print(f"[time] {card}: 22b in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 22c. the DFT precision gate on the production and the fused step ----------------------
    t_sub = time.perf_counter()
    gate_launches = {}
    prev_fast, prev_prec = os.environ.get("SCIML_FAST_STEP"), spectral.get_dft_precision()
    try:
        for step_kind in ("production", "fused"):
            os.environ["SCIML_FAST_STEP"] = "1" if step_kind == "fused" else "0"
            fk.reset_launch_counts()
            gs = dft_precision_gate.main(["--data", data, "--dataset", "basic_ds2", "--epochs",
                                          "1", "--out", str(out / f"gate_{step_kind}"),
                                          *on_card])
            torch.cuda.synchronize()
            gate_launches[step_kind] = dict(fk.LAUNCHES)
            check(gs["verdict"] in ("PASS", "FAIL") and finite_tree(gs),
                  f"[study] dft_precision_gate on the {step_kind} step ({card}): verdict "
                  f"{gs['verdict']}, degradation by horizon "
                  + ", ".join(f"{v:+.4%}" for v in gs["relative_degradation_r1_5"])
                  + f" (tol {gs['tol']}), train_speedup {gs['train_speedup']:.3f}; rollout "
                  f"nRMSE highest {', '.join(f'{v:.5f}' for v in gs['highest']['rollout_nrmse'])}")
    finally:
        if prev_fast is None:
            os.environ.pop("SCIML_FAST_STEP", None)
        else:
            os.environ["SCIML_FAST_STEP"] = prev_fast
        spectral.set_dft_precision(prev_prec)
    fused = gate_launches["fused"]
    print(f"[study] gate launches: production {json.dumps(gate_launches['production'])}; fused "
          f"{json.dumps(fused)}", flush=True)
    for key in fk.KERNEL_NAMES:
        check(fused[key] > 0, f"[study] the gate's fused run launched {key} ({fused[key]}x)")
    print(f"[time] {card}: 22c in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 22d. NS: the demo, then the Lie toy from a 256^2 source ------------------------------
    t_sub = time.perf_counter()
    nd = ns_demo.main(["--folder", str(out / "ns_demo_data"), "--out", str(out / "ns_demo"),
                       *STUDY_NS_DEMO, *on_card])
    check(set(nd) == {"baseline", "aux"} and all(set(r) == {"best_val", "rollout_nrmse"}
                                                 for r in nd.values()) and finite_tree(nd),
          "[study] ns_demo (128^2, 16 frames, 1 epoch): JAX's keys, finite; rollout nRMSE "
          + "; ".join(f"{k} {', '.join(f'{v:.4f}' for v in r['rollout_nrmse'])}"
                      for k, r in nd.items()))
    src = out / "ns_lie_src.h5"
    ls = STUDY_LIE_SRC
    generate_ns_file(src, 0, make_cfg(ls["grid"], ls["frames"], ls["frame_int"], ls["n_batch"],
                                      "full", 5e-4, 0.05, "exact"), device=dev)
    lt = ns_lie_toy.main(["--src", str(src), "--folder", str(out / "ns_lie_toy_data"), "--out",
                          str(out / "ns_lie_toy"), "--stride", "4", "--epochs", "1", *on_card])
    check(set(lt) == {"baseline_toy64", "lie_toy64"} and finite_tree(lt)
          and all(len(r["rollout_nrmse"]) == 5 for r in lt.values()),
          "[study] ns_lie_toy (256^2 -> 64^2, 3 + 1 trajectories, 1 epoch): JAX's keys, finite; "
          "rollout nRMSE " + "; ".join(f"{k} {', '.join(f'{v:.4f}' for v in r['rollout_nrmse'])}"
                                       for k, r in lt.items()))
    print(f"[time] {card}: 22d in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 22e. the DR data audit, the card against the CPU -------------------------------------
    t_sub = time.perf_counter()
    audit = dr_data_audit.main(["--grid", "64", "--skip-tight", "--out",
                                str(out / "audit.json"), *on_card])
    # the report's device part, its RK4 trajectory, on the CPU (the scipy
    # references are the same host solve either way)
    cpu_rk4 = dr_data_audit.channel_rms(
        generate_trajectories([audit["seed"]], DiffReactConfig(xdim=64, ydim=64),
                              device="cpu")[0], audit["frames"])
    rel = max(abs(x - y) / abs(y) for ch in ("u_rms", "v_rms")
              for x, y in zip(audit["rk4_ours"][ch], cpu_rk4[ch]))
    check(rel <= TOL_SIM and finite_tree(audit),
          f"[study] dr_data_audit at 64^2: its RK4 RMS on the card against the CPU's within "
          f"{rel:.3e} relative (tol {TOL_SIM:.0e}); frame10_rel_l2_ours_vs_reftol "
          f"{audit['frame10_rel_l2_ours_vs_reftol']:.4e}; v RMS at frames {audit['frames']}: "
          + ", ".join(f"{v:.4f}" for v in audit["rk4_ours"]["v_rms"]))
    print("[study] dr_test_family_audit (70 seeds at 128^2 x 101 frames) runs in the CPU "
          "tests only, at a reduced config", flush=True)
    print(f"[time] {card}: 22e in {time.perf_counter() - t_sub:.1f} s", flush=True)

    # ---- 22f. figures ---------------------------------------------------------------------------
    t_sub = time.perf_counter()
    runs = out / "runs"
    (runs / "dr_parity_ds2").mkdir(parents=True)
    shutil.copy(run_dir / "dr_parity" / "summary.json", runs / "dr_parity_ds2")
    agg = dr_seed_figure.main(["--run-root", str(runs), "--presets", "2", "--out",
                               str(out / "figures")])
    with contextlib.chdir(root):
        made = make_round_figures.main(str(out / "figures"))
    pngs = [out / "figures" / "dr_seed_data_efficiency.png", *map(Path, made)]
    colours = {p.name: png_colours(p) if p.exists() else 0 for p in pngs}
    check(agg is not None and set(agg) == {"baseline", "aux"} and len(made) >= 3
          and all(c > 1 for c in colours.values()),
          "[study] dr_seed_figure and make_round_figures: PNGs written, each opens with PIL "
          "and has more than one colour: " + ", ".join(f"{k} {v} colours"
                                                      for k, v in colours.items()))
    print(f"[time] {card}: 22f in {time.perf_counter() - t_sub:.1f} s; phase 22 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return fused


def main() -> int:
    t_script = time.perf_counter()
    root = Path(__file__).resolve().parent
    if not (root / "sciml_pde_torch" / "ops" / "csrc").is_dir():
        print("FAIL: run from a checkout of the repository (sciml_pde_torch/ not found)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sciml_pde_torch.data.dr import DRBaselineDataset
    from sciml_pde_torch.data.windows import WindowedTrajectories
    from sciml_pde_torch.experiments.spectral_impl_bench import probe_native
    from sciml_pde_torch.ops import _build
    from sciml_pde_torch.ops import attention as ta
    from sciml_pde_torch.ops import fno_fused_step as ff
    from sciml_pde_torch.ops import fno_kernels as fk
    from sciml_pde_torch.ops import probe as pb
    from sciml_pde_torch.ops import spectral
    from sciml_pde_torch.ops import spectral_fused as sf
    from sciml_pde_torch.train import fast_step as fs
    from sciml_pde_torch.train.fno_train import default_init_tree, train_baseline

    card = card_line()
    # ---- 0. probe: the build and launch path, before anything is built on it --
    secs = _build.build_all(("probe",))
    pb.reset_launch_counts()
    probe_res = probe_native()
    probe_launches = pb.LAUNCHES["probe"]
    print(f"[probe] nvcc sm_90a probe.cu {secs:.2f} s; probe_native: {json.dumps(probe_res)}",
          flush=True)
    check(probe_res["native"] is True and probe_launches == 1,
          f"[probe] native kernel built, launched ({probe_launches}x) and exact")
    if not probe_res["native"]:
        print("FAIL: the native-kernel probe failed; nothing else is built", file=sys.stderr)
        return 1
    xp = torch.randn(8, 128, generator=torch.Generator().manual_seed(8)).cuda()
    yp = pb.probe(xp)
    check(bool(torch.equal(yp, pb.probe_plain(xp))), "[probe] probe(x) == 2 * x exactly")
    for shape in ((1021,), (3,), (1 << 20,)):  # a scalar tail; a grid of 1024 blocks
        xt = torch.randn(*shape, generator=torch.Generator().manual_seed(9)).cuda()
        check(bool(torch.equal(pb.probe(xt), pb.probe_plain(xt))),
              f"[probe] probe(x) == 2 * x exactly at {shape}")
    xu = torch.randn(1025, generator=torch.Generator().manual_seed(10)).cuda()[1:]
    check(xu.data_ptr() % 16 != 0 and bool(torch.equal(pb.probe(xu), pb.probe_plain(xu))),
          "[probe] probe(x) == 2 * x exactly on a pointer not 16-byte aligned")
    # the probe's device time beside torch.mul's, launched in turns in each session
    bytes_s, ops_s = 2 * xp.numel() * 4 / HBM_BPS, xp.numel() / PEAK_FLOPS["highest"]
    probe_bound = max(bytes_s, ops_s) * 1e3
    probe_dev = {what: profiler_ms(lambda: (pb.probe(xp), torch.mul(xp, 2)), key,
                                   reps=PROBE_REPS, bound_ms=probe_bound, sessions=3)
                 for what, key in (("probe", "probe_kernel"), ("mul", MUL_KEY))}
    print(f"[timing] {card}: probe at (8, 128) f32, profiler device time (median of "
          f"three sessions of {PROBE_REPS} launches, each interleaved with torch.mul): "
          f"{probe_dev['probe'] or 'not measured'} ms; torch.mul "
          f"{probe_dev['mul'] or 'not measured'} ms", flush=True)

    t = phase_done(card, "phase 0", t_script)
    # ---- 1. card -------------------------------------------------------------
    dev = torch.device("cuda", 0)
    print(f"[card] {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)
    t = phase_done(card, "phase 1", t)

    # ---- 2. build ------------------------------------------------------------
    secs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    print(f"[build] nvcc sm_90a, the other {len(_build.SOURCES) - 1} sources in parallel: "
          f"{secs:.2f} s", flush=True)
    usage = _build.ptxas_report("attention")
    for kern, regs, st, ld, _ in usage:
        print(f"[build] attention.cu {kern}: {regs} registers, {st} bytes spill stores, "
              f"{ld} bytes spill loads", flush=True)
    main_tc = [u for u in usage if u[0].endswith("tc_kernel<64>")]
    check(len(main_tc) == 3 and all(st == ld == 0 for _, _, st, ld, _ in main_tc),
          "[build] the NS path's tensor-core attention kernels (head dim 64) spill nothing")
    main_tf32 = sorted(u for u in usage if u[0].endswith("tf32_kernel<64>"))
    check([u[0] for u in main_tf32] == ["dkv_tf32_kernel<64>", "dq_tf32_kernel<64>",
                                        "fwd_tf32_kernel<64>"]
          and all(st == ld == 0 for _, _, st, ld, _ in main_tf32),
          "[build] the f32 NS path's split-TF32 forward, dQ and dK/dV kernels (head dim 64) "
          "spill nothing: " + ", ".join(f"{u[0]} {u[1]} registers" for u in main_tf32))
    wide = sorted(u for u in usage
                  if u[0].startswith(("fwd_wide_kernel<", "dq_wide_kernel<", "dkv_wide_kernel<")))
    check([u[0] for u in wide] == [f"{w}_wide_kernel<{t}>" for w in ("dkv", "dq", "fwd")
                                   for t in ("__nv_bfloat16", "float")]
          and all(st == ld == 0 for _, _, st, ld, _ in wide),
          "[build] the cluster bodies above head dim 256 (the forward, dQ and dK/dV, both "
          "types) spill nothing: " + ", ".join(f"{u[0]} {u[1]} registers" for u in wide))
    tf32w_names = [f"{w}_tf32w_kernel<{dp}>" for w in ("dkv", "dq", "fwd")
                   for dp in (160, 192, 256)]
    tf32w = sorted(u for u in usage if "_tf32w_kernel<" in u[0])
    blocks = {u[0]: ta.tf32w_max_blocks(u[0].split("_")[0], int(u[0][-4:-1])) for u in tf32w}
    check([u[0] for u in tf32w] == tf32w_names and all(st == ld == 0 for _, _, st, ld, _ in tf32w),
          "[build] the f32 forward, dQ and dK/dV of head dims 160-256 (split TF32, two "
          "warpgroups) spill nothing: " + ", ".join(f"{u[0]} {u[1]} registers, {blocks[u[0]][0]} "
                                        f"block(s) of {blocks[u[0]][1]} warps an SM"
                                        for u in tf32w)
          + " (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    wide_tc_names = [f"{w}_wide_tc_kernel<{t}>" for w in ("dkv", "dq", "fwd")
                     for t in ("__nv_bfloat16", "float")]
    wide_tc = sorted(u for u in usage if "_wide_tc_kernel<" in u[0])
    check([u[0] for u in wide_tc] == wide_tc_names
          and all(st == ld == 0 for name, _, st, ld, _ in wide_tc if "bfloat16" in name),
          "[build] the forward, dQ and dK/dV above head dim 1024 (one block's tensor-core score "
          "loop over all of d, both types; the bf16 instances spill nothing): "
          + ", ".join(f"{u[0]} {u[1]} registers, {u[2]} bytes spill stores, {u[3]} bytes spill "
                      "loads" for u in wide_tc))
    att_sass = _build.sass(_build.library_path("attention"))
    hmma = {k: sum(i.split()[0].startswith("HMMA") for i in att_sass.get(k, []))
            for k in ("dq_wide_kernel<__nv_bfloat16>", "dq_wide_kernel<float>", *tf32w_names,
                      *wide_tc_names)}
    check(all(c > 0 for c in hmma.values()),
          "[build] dq_wide_kernel, the f32 forward, dQ and dK/dV of head dims 160-256 and the "
          "forward, dQ and dK/dV above 1024 take their products on the tensor cores: HMMA "
          "instructions in their SASS " + ", ".join(f"{k} {c}" for k, c in hmma.items()))
    for kind in ta.WIDE_KINDS:
        for bf in (True, False):
            name = f"{kind}_wide_kernel<{'__nv_bfloat16' if bf else 'float'}>"
            print(f"[build] {name}: at most {ta.wide_max_clusters(kind, bf, 8)} clusters of 8 "
                  f"blocks (head dim 1024), {ta.wide_max_clusters(kind, bf, 4)} of 4 (head dim "
                  "512) at once (cudaOccupancyMaxActiveClusters)", flush=True)
    for what, (_, h_, w_, ci, co, m1, m2) in (("flagship", SF_FLAGSHIP),
                                             ("16 ranks", SF_SHAPES["16 ranks"])):
        pl = sf.plan(h_, w_, ci, co, m1, m2)
        n_cl = sf.max_clusters(h_, w_, ci, co, m1, m2)
        check(n_cl >= 1, f"[build] sf_spectrum_kernel at the {what} shape: clusters of "
              f"{pl['P']} blocks of 1024 threads and {pl['smem1']} bytes, at most {n_cl} at "
              "once (cudaOccupancyMaxActiveClusters)")
    sf_usage = _build.ptxas_report("spectral_fused")
    check(sorted(u[0] for u in sf_usage) == sorted(SF_KERNEL_KEYS)
          and all(st == ld == frame == 0 for _, _, st, ld, frame in sf_usage),
          "[build] the fused dft2 layer's two kernels spill nothing and keep no stack frame: "
          + ", ".join(f"{u[0]} {u[1]} registers, {u[2]} bytes spill stores, {u[3]} bytes spill "
                      f"loads, {u[4]} bytes stack frame" for u in sf_usage))
    fno_usage = _build.ptxas_report("fno_fwd") + _build.ptxas_report("fno_bwd")
    for kern, regs, st, ld, frame in fno_usage:
        print(f"[build] fno {kern}: {regs} registers, {st} bytes spill stores, {ld} bytes "
              f"spill loads, {frame} bytes stack frame", flush=True)
    redesigned = [u for u in fno_usage if u[0].startswith(("wdft_kernel", "reduce_rows_kernel"))]
    check(len(redesigned) >= 2 and all(st == ld == 0 for _, _, st, ld, _ in redesigned),
          "[build] wdft_kernel and reduce_rows_kernel spill nothing: "
          + ", ".join(u[0] for u in redesigned))
    heads = [u for u in fno_usage if u[0].startswith(("head_fwd_kernel", "head_bwd_kernel",
                                                      "lift_kernel"))]
    lifts = sorted(u[0] for u in heads if u[0].startswith("lift_kernel"))
    check(len(heads) == 6 and lifts == ["lift_kernel<false>", "lift_kernel<true>"]
          and all(st == ld == frame == 0 for _, _, st, ld, frame in heads),
          "[build] the head kernels (both paths) and both instances of lift_kernel spill "
          "nothing and keep no stack frame: " + ", ".join(u[0] for u in heads))
    c78 = [u for u in fno_usage if u[0].startswith(("corner_kernel", "iwdft_pw_kernel",
                                                    "wdft_kernel", "outer_partial_kernel"))]
    outers = sorted(u[0] for u in c78 if u[0].startswith("outer_partial_kernel"))
    check(len(c78) == 18 and outers == OUTER_INSTANCES
          and all(st == ld == frame == 0 for _, _, st, ld, frame in c78),
          "[build] every instance of corner_kernel, iwdft_pw_kernel, wdft_kernel and "
          "outer_partial_kernel spills nothing and keeps no stack frame: "
          + ", ".join(u[0] for u in c78))
    print_mix_wgrad_sass()
    t = phase_done(card, "phase 2", t)

    # ---- 3. kernels vs plain versions ----------------------------------------
    g = torch.Generator().manual_seed(1)
    tree = default_init_tree(CC, MODES, WIDTH, T0, seed=1)
    p = ff.pack_params(tree, MODES, MODES, dev)
    store, grid = make_store(seed=0)
    win = torch.from_numpy(store[:B, :T0]).permute(0, 1, 4, 2, 3).contiguous().to(dev)
    grid2 = torch.from_numpy(grid).permute(2, 0, 1).contiguous().to(dev)
    cot = torch.randn(B, CC, XY, XY, generator=g).to(dev)
    names = ["pred"] + [f"d{n}" for n in ff.FastFNOParams._fields]
    # autograd of the plain forward in f32: shares no code with the VJP
    spectral.set_dft_precision("highest")
    pa = ff.FastFNOParams(*(t.detach().clone().requires_grad_(True) for t in p))
    (ff.fno2d_fused_reference(win, grid2, pa, MODES, MODES, PAD) * cot).sum().backward()
    plain_outs = {}
    for prec in ("highest", "default"):
        spectral.set_dft_precision(prec)
        pk = ff.FastFNOParams(*(t.detach().clone().requires_grad_(True) for t in p))
        pred = ff.fno2d_fused_apply(win, grid2, pk, MODES, MODES, PAD)
        (pred * cot).sum().backward()
        want = ff.fno2d_fused_reference(win, grid2, p, MODES, MODES, PAD)
        want_g = ff.fno2d_fused_vjp_reference(cot, win, grid2, p, MODES, MODES, PAD)
        torch.cuda.synchronize()
        plain_outs[prec] = [want] + list(want_g)
        got_all = [pred.detach()] + [a.grad for a in pk]
        for name, got, ref in zip(names, got_all, plain_outs[prec]):
            err, rel = rel_err(got, ref)
            check(bool(torch.isfinite(got).all()) and rel <= TOL[prec],
                  f"[check {prec}] {name}: max abs err {err:.3e}, max rel-to-max err "
                  f"{rel:.3e} (tol {TOL[prec]:.0e})")
        for name, got, a in zip(names[1:], got_all[1:], pa):
            err, rel = rel_err(got, a.grad)
            check(rel <= TOL_AUTOGRAD[prec],
                  f"[check {prec}] {name} vs autograd of the f32 plain forward: max abs err "
                  f"{err:.3e}, max rel-to-max err {rel:.3e} (tol {TOL_AUTOGRAD[prec]:.0e})")
    # control: the `default` bound must tell bf16 dot inputs from f32 ones
    gaps = {n: rel_err(lo, hi)[1]
            for n, lo, hi in zip(names, plain_outs["default"], plain_outs["highest"])}
    print("[check] plain bf16-vs-f32 gap, rel-to-max: "
          + ", ".join(f"{n} {v:.3e}" for n, v in gaps.items()), flush=True)
    check(max(gaps.values()) > 2 * TOL["default"],
          f"[check] the default tolerance {TOL['default']:.0e} lies below half the largest "
          f"bf16-vs-f32 gap ({max(gaps.values()):.3e})")

    # every kernel against its plain version on the main path's own inputs
    # (the shipped `default` precision): record the first call of each
    spectral.set_dft_precision("default")
    records, (pred, sv) = record_calls(win, grid2, cot, p)
    # reduce_rows at the shape the head backward hands it
    part = torch.randn(*rr_shapes()["head backward"], generator=g).to(dev)
    records["fno_reduce_rows"] = ("reduce_rows", (part,), {})
    torch.cuda.synchronize()

    kernel_rows = check_kernels(records, "[kernel]")
    check_mix_wgrad(dev)
    check_stats(dev)
    check_wdft(dev, card, records["fno_wdft"][1][0], records["fno_wdft.adj"][1][0],
               sv.pres[0].float())
    check_reduce_rows(dev, card)
    check_head(dev, card)
    check_head_limits(dev)
    check_corner_iwdft(dev, card, records, p)
    check_outer(dev, card, records)
    check_layout_mirrors()
    check_limits(dev)
    check_c78_paths(dev)
    check_wide_fused(dev, win, grid2, cot)
    wide_fused_witness(dev, grid2)
    check_c78_fields(dev)
    c78_witness(dev)
    t = phase_done(card, "phase 3", t)

    # ---- 4. train: the main path, through the trainer -------------------------
    spectral.set_dft_precision("default")
    n_train = int(0.9 * N_TRAJ)
    ds = DRBaselineDataset(
        train=WindowedTrajectories(store[:n_train], grid, initial_step=T0, rollout=1,
                                   train=True, device=dev),
        test=WindowedTrajectories(store[n_train:], grid, initial_step=T0, rollout=1,
                                  train=False, device=dev),
    )
    run_dir = root / "runs" / "chip_smoke"
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_baseline(ds, modes=MODES, width=WIDTH, initial_step=T0, num_channels=CC,
                         batch_size=B, epochs=1, learning_rate=1e-3, seed=0,
                         run_dir=str(run_dir), model_name="DR_smoke_FNO", log_every=0,
                         fast_step=True, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    h = res.history[0]
    steps = len(ds.train.window_index()) // B
    print(f"[train] {steps} steps + val in {train_s:.3f} s: first step loss "
          f"{h['first_step_loss']:.6g}, last step loss {h['last_step_loss']:.6g}, epoch "
          f"train loss {h['train_loss']:.6g}, val loss {h['val_loss']:.6g}", flush=True)
    finite = all(map(lambda v: v == v and abs(v) != float("inf"),
                     (h["first_step_loss"], h["last_step_loss"], h["train_loss"],
                      h["val_loss"])))
    check(finite, "[train] losses finite")
    check(h["last_step_loss"] < h["first_step_loss"] and h["train_loss"] < h["first_step_loss"],
          "[train] loss falls (last step and epoch mean below the first step)")
    check((run_dir / "DR_smoke_FNO_ckpt").exists(), "[train] best-val checkpoint written")
    print(f"[train] launches: {json.dumps(launches)}", flush=True)
    for key in fk.KERNEL_NAMES:
        kernel_rows[key]["launches"] = launches[key]
        check(launches[key] > 0, f"[train] main path launched {key} ({launches[key]}x)")

    t = phase_done(card, "phase 4", t)
    # ---- 5. timing -----------------------------------------------------------
    theta, spec = fs.fast_state_from_tree(tree, MODES, dev)
    opt = fs.init_opt(theta)
    step, _ = fs.build_fast_baseline_step(MODES, T0, spec, 1e-3, 10_000)
    data, grid2t = ds.train.data, ds.train.grid.permute(2, 0, 1).contiguous()
    idx = torch.as_tensor(ds.train.window_index()[:B], dtype=torch.long, device=dev)
    n_steps = 50
    for _ in range(5):
        theta, opt, _, _ = step(theta, opt, data, grid2t, idx)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n_steps):
        theta, opt, loss, _ = step(theta, opt, data, grid2t, idx)
    e.record()
    e.synchronize()
    step_ms = s.elapsed_time(e) / n_steps
    check(bool(torch.isfinite(loss)), "[timing] loss finite")
    pf = ff.FastFNOParams(*(t.detach().clone().requires_grad_(True) for t in p))
    fwd_ms = cuda_ms(lambda: ff.fno2d_fused_apply(win, grid2, p, MODES, MODES, PAD))

    def fwd_bwd():
        (ff.fno2d_fused_apply(win, grid2, pf, MODES, MODES, PAD) * cot).sum().backward()
    fwd_bwd_ms = cuda_ms(fwd_bwd)
    print(f"[timing] {card}: fused step {step_ms:.4f} ms = {1e3 / step_ms:.2f} steps/s "
          f"(batch {B}, 128^2, width {WIDTH}, modes {MODES}, default precision)", flush=True)
    print(f"[timing] {card}: fused apply forward {fwd_ms:.4f} ms, forward+backward "
          f"{fwd_bwd_ms:.4f} ms", flush=True)
    def fno_steps():
        nonlocal theta, opt
        for _ in range(20):
            theta, opt, _, _ = step(theta, opt, data, grid2t, idx)
    device_profile(card, fno_steps, 20, "step", step_ms, tuple(set(FNO_KERNEL_KEYS.values())))
    for key in fk.KERNEL_NAMES:
        r = kernel_rows[key]
        lib = ("n/a" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms (profiler device time {fmt(r['library_device_ms'])})")
        print(f"[timing] {card}: {key}: {r['ms']:.4f} ms/launch (profiler device time "
              f"{fmt(r['device_ms'])}), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}), library {lib}, "
              f"{r['launches']} launches in the epoch", flush=True)

    t = phase_done(card, "phase 5", t)
    # ---- 4b. evaluation of phase 4's checkpoint; aux joint training ------------
    eval_aux_path(dev, card, run_dir, store, grid, ds)
    phase_done(card, "phase 4b", t)

    kernel_rows.update(transformer_path(dev, card, run_dir))
    kernel_rows.update(production_path(dev, card, run_dir, store, grid, tree, ds))

    # ---- 14. the split functions; 15. the probe, this slice's path -------------
    t = time.perf_counter()
    split_rows = split_path(dev, card, win, grid2, p, cot)
    split_c78(dev)
    t = phase_done(card, "phase 14", t)
    path_launches = probe_path(dev, card, run_dir)
    phase_done(card, "phase 15", t)
    for name, row in split_rows.items():
        row["launches"] = path_launches[name]
    kernel_rows.update(split_rows)

    # ---- 16. the FNO on NS-2D and 3D NS -----------------------------------------
    ns_launches = ns_fno_path(dev, card, run_dir)
    for key in fk.KERNEL_NAMES:
        kernel_rows[key]["ns_launches"] = ns_launches[key]
    # ---- 17. the transformer's aux joint training and the rest of ROADMAP A5 ---------
    kernel_rows.update(aux_transformer_path(dev, card, run_dir))
    # ---- 18. the data and parity pipeline (ROADMAP A6, the DR and NS-2D half of A7) --
    parity_launches = data_parity_path(dev, card, run_dir)
    for key in fk.KERNEL_NAMES:
        kernel_rows[key]["parity_launches"] = parity_launches[key]
    # ---- 19. the rest of the simulators (ROADMAP A7) and the 3D plume drivers ------
    simulators_path(dev, card, run_dir)
    # ---- 20. scaling and I/O (ROADMAP A8): streaming, rotation, the process group ----
    a8_shapes = a8_path(dev, card, run_dir)
    for key in AUXT_ROWS:
        name, where = key.split(" (")
        kernel_rows[key]["a8_launches"] = a8_shapes.get((name, *AUXT_ATT_SHAPES[where[:-1]],
                                                         "bf16"), 0)
    # ---- 21. tensor parallelism and the comparison models (ROADMAP A8b, A9) ------------
    comparisons_path(dev, card, run_dir)
    # ---- 22. the study drivers (ROADMAP A10) --------------------------------------------
    study_launches = study_path(dev, card, run_dir, root)
    for key in fk.KERNEL_NAMES:
        kernel_rows[key]["study_launches"] = study_launches[key]
    # ---- 23. the compressed HDF5 stores without h5py -------------------------------------
    lzf_store_path(dev, card, run_dir, root)
    # ---- 24. the JAX package's checkpoints without orbax ---------------------------------
    checkpoint_path(dev, card, run_dir, root)
    kernel_rows["probe"] = {
        "name": "probe", "route": "cuda", "source": "sciml_pde_torch/ops/csrc/probe.cu",
        "replaces": PROBE_SITE, "launches": probe_launches,
        "max_abs_err": rel_err(yp, pb.probe_plain(xp))[0],
        "ms": cuda_ms(lambda: pb.probe(xp)), "plain_ms": cuda_ms(lambda: pb.probe_plain(xp)),
        "bound_ms": probe_bound, "bound_by": "bytes" if bytes_s >= ops_s else "operations",
        "library_ms": cuda_ms(lambda: torch.mul(xp, 2)),
        "device_ms": probe_dev["probe"], "library_device_ms": probe_dev["mul"],
    }
    r = kernel_rows["probe"]
    print(f"[timing] {card}: probe at (8, 128) f32: {r['ms']:.4f} ms/launch (profiler device "
          f"time {fmt(r['device_ms'])}, phase 0), plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.7f} ms ({r['bound_by']}), library {r['library_ms']:.4f} ms "
          f"(torch.mul; profiler device time {fmt(r['library_device_ms'])}, phase 0), "
          f"{r['launches']} "
          "launch in probe_native", flush=True)

    print(f"[time] the whole script {time.perf_counter() - t_script:.1f} s", flush=True)
    if failures:
        print(f"FAILED {len(failures)} check(s): " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [kernel_rows[k] for k in (*fk.KERNEL_NAMES, *ta.KERNEL_NAMES,
                                                            *AUXT_ROWS, *sf.KERNEL_NAMES,
                                                            *pb.KERNEL_NAMES,
                                                            *ff.SPLIT_NAMES)]}))
    print(card)
    print("[tp] no exchange between two cards was checked: phase 21a's two ranks share one "
          "card through gloo (ROADMAP C G5)", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
