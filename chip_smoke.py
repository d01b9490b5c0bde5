"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py group_norm   # phases 1, 2 and phase 3's group norm part alone

Phases (any failure raises and the script exits non-zero):
  1. device   — the card's name and power limit; TF32 off for the fp32 checks;
  2. build    — nvcc builds the kernel library from cips_tpu_torch/csrc/ (one
                nvcc per source, all at once) and reports each kernel's
                registers, spills (none allowed) and static shared memory
                (-Xptxas -v) of the bf16 dQ, the fp32 (3xTF32) forward, dQ and
                dK/dV and the Hopper phase conv kernels (csrc/phase_conv_sm90.cu,
                and the fp32 ones, 3xTF32, csrc/phase_conv_tf32.cu), with the
                dynamic shared memory of the bf16 dQ and phase conv kernels; then
                g++ builds the native NIfTI runtime (cips_tpu_torch/runtime/), its
                compiler, build time and the zlib it links printed;
  3. kernels  — the forward kernel and the dQ and dK/dV backward kernels
                against their plain PyTorch versions at the paths' shapes,
                ragged L (1, 17, 127, 129, 1000, 2305), Lq != Lk, Dh 64 and
                128, the classifier's (2, 4, 288, 32) and (2, 4, 2304, 32), the
                causal generator's long attention (1, 1, 18432, 32)
                and scale -0.3 and 0, the forward and the backward at each in
                bf16 and fp32 (fp32 also against their 3xTF32 rounding models,
                the forward's distance printed); then each
                kernel's device time (torch.profiler; its
                eager time beside it) at the flagship's (2, 4, 2304, 32),
                the causal encoder's level-2 (2, 4, 18432, 32) and the
                classifier's level-4 (2, 4, 288, 32) shape in bf16, and the fp32 kernels (--dtype f32) at the flagship's,
                beside its three-term bound (operations, bytes, exponentials),
                its plain version's time (flagship shape only) and the fastest
                of SDPA's flash, efficient and cuDNN backends, each pinned and,
                at the flagship's shape, first held to the plain versions
                (library yardstick); then the group norm kernels
                (csrc/group_norm.cu: forward and backward, with SiLU or
                LeakyReLU) at the cells' norms (GN_SHAPES, batch 4, bf16,
                channels last as the models' activations lie), each held to
                the plain version against the fp32 plain graph (y, dx, dw, db)
                and timed (device time, forward and backward apart) beside its
                bytes bound, the kernels' time on the NCDHW copy, the plain
                version's and one PyTorch call's (F.group_norm, then the
                activation) on both layouts, with their ptxas report;
  4. serving  — cips_tpu_torch.cli.output_predict at the flagship's full width
                and the full (96, 128, 96) volume in bf16 on a synthetic NIfTI
                tree, with seeded random weights; checks outputs, metrics and
                that the forward kernel ran 6 times per generator forward; then
                the same CLI run once more with each stage of the real path
                clocked, set-up apart; the forward's time and its device time
                by kernel kind (torch.profiler);
  5. parity   — the same fp32 weights on the card (kernels) and on the CPU
                (plain versions) at a reduced crop, forward only; then the fp32
                generator forward (--dtype f32 serving) at the full volume and
                batch 2 (CUDA events) and its device time by kernel kind, the
                fp32 flash forward's share among them;
  6. training — the native prefetch pool's decode rate; then
                cips_tpu_torch.cli.train_unet at full width and volume in
                bf16, batch 2, for a few epochs with eval and a checkpoint per
                epoch; checks losses, checkpoints and that every train step
                launched 6 forward, 6 dQ and 6 dK/dV kernels; then --resume
                --streaming, which decodes through the pool (6/6/6 a step, the
                wait of each step for its batch printed), then output_predict
                serves the trained checkpoint; then that checkpoint, written as
                the reference writes one (module. names), goes through
                cli.import_torch_ckpt into a fresh experiment and is served with
                --epoch N (6, 0, 0 launches; its volumes against the trained run's);
  7. step     — the train step's time (CUDA events) and peak memory, one
                profiled step by kernel kind, and the rec loss falling over
                steps on one fixed batch; then one step with remat and d_remat
                beside one without, from the same weights on the same batch:
                losses, gradients and updated parameters compared, both peaks
                and step times printed;
  8. grads    — one fp32 train step from the same random weights on the card
                and on the CPU at the reduced crop: G and D gradients compared;
  9. causal serving — cips_tpu_torch.cli.gen_test_causal with the causal generator
                (configs/training_causal.json) at full width and the full volume
                in bf16, seeded random weights non-zero everywhere; checks its
                outputs and 7 flash forwards per generator forward; the
                generator forward's time (CUDA events), peak memory and device
                time by kernel kind at batch 2; the fp32 trio on the card against
                the CPU at the reduced crop;
 10. causal training — cips_tpu_torch.cli.train_causal in bf16, batch 2, for 2
                epochs (default packed loader, eval, a checkpoint each), every step
                launching 7 forward, 7 dQ and 7 dK/dV kernels; --resume; the
                trained checkpoint served and gen_latents on it; the train step's
                time, peak memory and profile on one fixed batch, an exact_d_fake
                step (7 forwards more), a step with remat (the trio's resnets
                recomputed: its time, peak memory and 7/7/7 launches); one fp32
                step's gradients, card vs CPU;
 11. classifier — cips_tpu_torch.cli.train_classifier (configs/training_atten.json) at full
                width and the full volume in bf16, batch 2, PET + T1 + covariates, on the same
                8 subjects with a converter CSV of both classes, for 2 epochs with eval and
                checkpoints, every step launching 4 forward, 4 dQ and 4 dK/dV kernels (level 3 at
                2,304 tokens, level 4 at 288); test_mci --best on real PET, then on the PET that
                phase 4 synthesized; the forward's and the train step's time, peak memory and
                profile; the fp32 logits and one fp32 step's gradients, card vs CPU;
 12. BMGAN    — cips_tpu_torch.cli.train_bmgan at the default widths and the full volume in
                bf16, batch 2, for 2 epochs with eval and checkpoints (no attention: no kernel of
                this port), --resume, gen_test_bmgan on the trained checkpoint; the train step's
                time, peak memory and profile; one fp32 step's G, E and D gradients, card vs CPU,
                at (64, 64, 64);
 13. phase conv — every variant of the phase-structured packed conv kernels
                (csrc/phase_conv.cu, csrc/phase_conv_sm90.cu,
                csrc/phase_conv_tf32.cu: the Pallas phase_conv and its three TPU
                probes) against its plain version at the probes' shapes, at
                ragged shapes, at pc 256, batch 2 and a volume under one tile,
                in bf16 and fp32; bf16 dot and the fp32 (3xTF32) product
                variants also against their rounding models (the distance
                printed); the kernel against the flagship generator's
                own level-0 conv on that conv's input; each variant's device
                time (torch.profiler; its eager time beside it) beside its
                bound, its plain version's time and its one-call library
                counterpart's device time, with the cuDNN yardsticks, at two
                shapes (PHASE_TIMED; pc 256 is checked, not timed); the fp32 kernels that the `stages` probe runs (full,
                one_tap, shift, copy) the same way at the probe shape and the TPU
                probe's own (1, 8, 16, 8, 128), TF32 off, their bound at the
                3xTF32 rate with the FMA figure beside it; then the slice's main
                paths: each subcommand of
                `cips_tpu_torch.scripts.probe_phase_conv`, its launches counted;
 14. tool-chain — the offline tool-chain's CLIs at ADNI's sizes on a synthetic raw tree (4
                subjects: T1 (170, 256, 256) at 1.2 x 1.0 x 1.0 mm, AV45 PET (96, 160, 160) at
                1.5 mm; 2 with oblique headers and a true motion, 2 on identity headers): every
                `cli.preprocess` subcommand (reg in ncc, and mi on one pair; downsample with N4
                to 1.5 mm and (96, 128, 96)), each motion recovered, the packed store loaded, a
                registration 4x coarser on the card against the CPU; `cli.postprocess suvr
                --conform` into 256^3 on phase 4's real and synthesized PET against the CPU,
                suvr-error, analyse, summary; `cli.metrics` on phase 4's tree at (192, 224,
                192), one tree and two, against the CPU; each subcommand's wall time and each
                registration's. No kernel of this port is on this path;
 15. data parallel — cips_tpu_torch.cli.train_unet under torchrun (python -m
                torch.distributed.run; the rank side is this script's --dp-rank
                mode) at full width and volume in bf16, global batch 2, one epoch
                of 4 steps with eval and a checkpoint: 1 rank over NCCL, then one
                rank a card over NCCL (a machine with one card: 2 ranks sharing it
                over gloo); each rank's replicas identical, 6/6/6 flash launches a
                step, the all-reduced bytes a step equal to the gradient bytes, one
                writer of meta.json; step time a rank (CUDA events), peak memory a
                rank, the speed-up where there are 2 cards or more; the checkpoint
                resumed at 1 rank; the dry run (cips_tpu_torch.parallel.dryrun) of
                two fp32 flagship steps at the reduced crop at W ranks held to one
                process on the same global batch;
 16. space parallel — train_unet under torchrun at --n_space 2 (the mesh's space
                axis: each rank a depth slab of every volume), full width and
                volume, bf16, global batch 2, one epoch of 4 steps with eval and a
                checkpoint: 2 ranks sharing the one card over gloo (4 cards or more:
                data 2 x space 2 over NCCL); replicas identical, 6/6/6 flash launches
                a step on each rank at Lq 1152 against Lk 2304, one writer, the first
                two steps' losses against phase 15's 1-rank steps; step time a rank, peak
                memory a rank, bytes exchanged a step by kind; the checkpoint resumed
                at 1 rank; the flash kernels at (2, 4, 1152, 32) and (2, 4, 576, 32)
                against Lk 2304 in bf16 and fp32 held to their plain versions, timed
                beside SDPA and their bound; the fp32 step at full width and
                (40, 64, 32), whose coarsest level's 5 planes part 2 / 3, at space 2
                against one process: losses, replicas, G and D each alone
                (cips_tpu_torch/scripts/probe_space_kink.py); then uneven slabs: the
                flagship's dry run at (88, 128, 96), space 2, bf16 (the coarsest
                level's 11 planes part 5 / 6: 6/6/6 flash launches at Lq 960 and
                1152 against Lk 2112), the kernels at those shapes held to their
                plain versions;
 17. causal space — the causal trio's dry run (CIPS_DRYRUN_TASK=causal, the bundled
                config, the full volume, bf16, 2 steps) at --n_space 2: 2 ranks sharing
                the card over gloo (4 cards or more: data 2 x space 2 over NCCL);
                replicas identical, 7/7/7 flash launches a step on each rank at Lq 9216
                against Lk 18432, DDP's bytes the gradients', the bytes exchanged a step
                by kind beside the prediction, the first step's losses against a 1-rank
                step on the same batch and noise; the flash kernels at (1, 4, 9216, 32)
                and (1, 2, 9216, 32) against Lk 18432 in bf16 and fp32 held to their
                plain versions, timed beside SDPA and their bound; the fp32 trio at full
                width and the reduced crop at space 2 against one process: losses,
                replicas, the trio and D each alone (probe_space_kink --task causal);
 18. summary  — a JSON line of kernels, the card line, and the result line.

Every path from phase 4 on that a CLI or a dry run drives on the card counts its
group norm calls (`norm_path`, `rank_norms`): the kernels forward (and backward
where it trains), no call of the plain version, and in each train step as many
forward launches as norm modules called and as many backward launches as autograd
recorded (a forward pre-hook counts the calls); the kernels line gives each path's
counts.

Imports nothing of JAX or of the JAX package. Exits non-zero without CUDA.
"""

from __future__ import annotations

import ast
import contextlib
import csv
import functools
import io
import itertools
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

FLAGSHIP_K = 5  # AV45 covariates: ABETA, Age, Sex, APOE4, PTEDUCAT
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12
# ex2 results per clock per SM on the special-function units, and fp32 FMA lanes
# per SM (CUDA C Programming Guide, arithmetic instruction throughput, compute
# capability 9.0); times the SM count and the card's maximum SM clock from nvidia-smi.
EX2_PER_CLOCK_PER_SM = 16
FP32_LANES_PER_SM = 128  # 2 operations a lane a clock (an FMA)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
SERVING_BATCH = 2
N_SUBJECTS = 8
STAGED_RUNS = 1  # serving runs after the main path's, each stage clocked
SETUP = ("build model", "restore checkpoint")
CROP = (96, 128, 96)
PARITY_CROP = (32, 64, 32)
TRAIN_BATCH = 2
TRAIN_EPOCHS = 3  # 4 steps each over 8 subjects: step 10's loss record falls inside
N_EVAL = 2  # subjects of the per-epoch eval
STEPS_TIMED = 14  # train steps clocked after 2 warm-up steps, on one fixed batch
REMAT_STEPS_TIMED = 3  # remat and plain flagship steps (phase 7), each after 1 warm-up, one batch
POOL_THREADS = 2  # the native prefetch pool of --streaming (StreamingLoader's default)
# The causal generator (configs/training_causal.json) at full width and the full volume. A
# generator forward launches 7 flash forwards: the encoder's level 2 (24x32x24 = 18,432 tokens)
# has 2 transformers whose attn1 and attn2 both attend to their own tokens (the encoder gets no
# context), at 4 heads of 32; the PET decoder's level 0 has the mid block's and 2 more
# transformers' attn1, at 2 heads of 32. Their cross-attentions to the covariate row (Lk = 1)
# take the plain path. A train step: 7 forward, 7 dQ, 7 dK/dV; exact_d_fake 7 forwards more.
CAUSAL_FLASH = 7
CAUSAL_ENCODER_FLASH = 4
CAUSAL_PARTS = ("encoder", "t1_decoder", "pet_decoder")
CAUSAL_TRAIN_BATCH = 2
CAUSAL_EPOCHS = 2  # 4 steps each over 8 subjects, an eval of N_EVAL and a checkpoint each
CAUSAL_STEPS_TIMED = 6  # after 2 warm-up steps, on one fixed batch
# The MCI classifier (configs/training_atten.json) at full width and the full volume, PET + T1 +
# covariates: its encoder downsamples at every level, so level 3 attends at 12x16x12 = 2,304 tokens
# and level 4 at 6x8x6 = 288, each in 2 transformers whose attn1 (4 heads of 32) is a flash
# forward; their cross-attentions to the covariate row (Lk = 1) take the plain path. A forward
# launches 4 flash forwards, a train step 4/4/4.
CLASSIFIER_FLASH = 4
CLASSIFIER_ATTN = (2, 4, 288, 32)
CLASSIFIER_BATCH = 2
CLASSIFIER_EPOCHS = 2  # 4 steps each over 8 subjects, an eval of N_EVAL (both classes) and a checkpoint each
CLASSIFIER_STEPS_TIMED = 6  # after 2 warm-up steps, on one fixed batch
# BMGAN at its default widths and the full volume; no attention, so no kernel of this port. Its
# discriminator (num_layers_d 4) needs 48 voxels an axis and its generator (a stride-2 stem, 4
# stride-2 levels, then 5 x2 transposed convs) a multiple of 32: the fp32 gradients are compared
# at BMGAN_PARITY_CROP, the smallest such volume.
BMGAN_BATCH = 2
BMGAN_EPOCHS = 2
BMGAN_STEPS_TIMED = 4  # after 2 warm-up steps, on one fixed batch
BMGAN_PARITY_CROP = (64, 64, 64)
# The offline tool-chain (phase 14) at ADNI's sizes: a T1 (z, y, x) (170, 256, 256) at 1.2 x 1.0 x
# 1.0 mm and the AV45 "uniform resolution" PET (96, 160, 160) at 1.5 mm. Subjects 0-1 carry oblique
# scanner headers and a true rigid motion (the physical path); subjects 2-3 identity headers with
# their PET on the T1's grid, moved by a small rigid motion (the voxel path). A head-sized phantom
# (tests/test_registration_geometry.py's, 3x larger), a bias field on the T1, noise inside the head.
TOOLCHAIN_T1 = (170, 256, 256)
TOOLCHAIN_T1_MM = (1.0, 1.0, 1.2)  # x, y, z
TOOLCHAIN_PET = (96, 160, 160)
TOOLCHAIN_PET_MM = (1.5, 1.5, 1.5)
# Subject 1's motion is one that 100 Adam steps a level (the defaults) do not reach at 1/4 size, for
# the JAX package's registration and the port's alike (tests/test_torch_port_registration_physical.py).
TOOLCHAIN_MOTION = (((6.0, -3.0, 4.0), (5.0, -3.0, 2.0)),  # degrees about x, y, z; mm: the physical path
                    ((-6.0, -3.0, 4.0), (-5.0, -3.0, 2.0)),
                    ((3.0, -2.0, 2.0), (2.0, -2.0, 1.5)),  # the voxel path: PET on the T1 grid
                    ((-2.5, 2.0, -3.0), (-2.5, 1.0, 2.0)))
TOOLCHAIN_MIN_CORR = 0.93  # tests/test_registration_geometry.py's recovery limit
TOOLCHAIN_REDUCED = 4  # the card-vs-CPU registration: every grid 4x coarser
TOOLCHAIN_LR = 0.05  # register_rigid_physical's default; its params are held within one last-level step, lr / 3
TOL_TOOLCHAIN_REL = 1e-5  # SUVRs and metric JSONs, card vs CPU (a std relative to its mean)
SEG_SHAPE = (256, 256, 256)  # FastSurfer's conformed space
# Phase conv shapes, packed (B, Z, Y, X, 8C): the TPU probes' level-0 shape (C = 16), their
# 32-channel case, and the flagship's own level 0 at batch 2.
PHASE_SHAPES = ((8, 48, 64, 48, 128), (8, 48, 64, 48, 256), (2, 48, 64, 48, 128))
# Timed at two of them: the 256-channel shape is checked only (PERF.md keeps its earlier times),
# which pays for the streamed resume, the import and the remat steps of phases 6-7 and 10.
PHASE_TIMED = (PHASE_SHAPES[0], PHASE_SHAPES[2])
PHASE_CHECKS = ((PHASE_SHAPES[0], torch.bfloat16), (PHASE_SHAPES[1], torch.bfloat16),
                ((2, 8, 16, 8, 128), torch.float32), ((1, 5, 7, 9, 128), torch.bfloat16),
                ((1, 5, 7, 9, 128), torch.float32),  # ragged on every axis
                # the TMA + wgmma kernels' edges: ragged at pc 256, batch 2 ragged, fewer cells than a tile
                ((1, 5, 7, 9, 256), torch.bfloat16), ((2, 3, 9, 17, 128), torch.bfloat16),
                ((1, 1, 2, 3, 128), torch.bfloat16), ((1, 5, 7, 9, 256), torch.float32),
                ((2, 3, 9, 17, 128), torch.float32), ((1, 1, 2, 3, 128), torch.float32))
PHASE_VARIANTS = ("full", "noshift", "one_tap", "dot", "shift", "copy", "select")
# The fp32 kernels that the `stages` probe (scripts/debug_pallas_stages.py, fp32) runs, timed at
# the probe shape and at the TPU probe's own (1, 8, 16, 8, 128).
PHASE_F32_VARIANTS = ("full", "one_tap", "shift", "copy")
PHASE_F32_SHAPES = ((8, 48, 64, 48, 128), (1, 8, 16, 8, 128))
PHASE_EXACT = ("shift", "copy", "select")  # no sums: the kernel must equal the plain version
# the kernels of csrc/phase_conv_sm90.cu (bf16 TMA + wgmma; copy, any dtype, by bulk copies)
PHASE_SM90 = (("dot", 128), ("dot", 256), ("noshift", 128), ("full", 128), ("full", 256), ("one_tap", 128),
              ("one_tap", 256), ("copy", 128))
# the fp32 product variants of csrc/phase_conv_tf32.cu, each at N tiles of 128, 64 and 32 channels
PHASE_TF32 = ("full", "noshift", "one_tap", "dot")
PHASE_TF32_TILES = (128, 64, 32)
DESIGNS = {  # each kernel's design, for the kernels line
    "fwd": "TMA ring + wgmma (sm_90a): two warpgroups on even and odd key tiles, exp2, merged in shared memory",
    "dq": "TMA ring + wgmma (sm_90a): two warpgroups on even and odd key tiles, exp2, dS as register A, K read "
          "transposed by wgmma, merged in shared memory",
    "dkv": "TMA ring + wgmma (sm_90a): two warpgroups on even and odd q tiles, exp2, merged in shared memory",
    "full": "TMA halo boxes at three x shifts + wgmma, y/z shifts as descriptor offsets per phase group; "
            "persistent, TMA-store epilogue",
    "noshift": "TMA halo boxes + wgmma, shifts as descriptor offsets; persistent, TMA-store epilogue",
    "dot": "TMA stream + wgmma on the summed weights (one GEMM); persistent, TMA-store epilogue",
    "one_tap": "a TMA halo box per phase group at its x shift + wgmma on a resident Wp[0,0,0] slab, y/z shifts "
               "as descriptor offsets; persistent, TMA-store epilogue",
    "shift": "gather, 16 bytes a thread", "select": "elementwise, 16 bytes a thread",
    "copy": "1-D bulk copies (cp.async.bulk) through a ring of shared-memory stages; persistent, one thread a CTA",
}
TF32_CONV = ("3xTF32 on wgmma m64nNk8 (sm_90a), A split in registers from a TMA halo box read at each cell's "
             "shifted row (the next stage's under the products), B from a split K-major copy of W made by a prep "
             "kernel, through a TMA ring; a 32-channel chunk of one tap summed in the tensor cores, then added by "
             "fp32 adds; two consumer warpgroups on one z plane each, 128 channels (64 or 32 when the grid would "
             "leave SMs idle), the producer warpgroup's registers handed to them (setmaxnreg); persistent; stores "
             "from the accumulators")
DESIGNS_F32 = {  # the fp32 kernels' designs (flash, phase conv), beside the bf16 ones in the kernels line
    "fwd": "TMA ring + 3xTF32 on mma.sync m16n8k8 (sm_90a): 32 q rows a CTA, two groups of 2 warps on even "
           "and odd key tiles, exp2, P as register A straight from the score accumulators, S summed over 4 "
           "k-steps at most and P V over one key tile in the tensor cores, then added by fp32 adds, merged in "
           "shared memory; three CTAs an SM at Dh 32",
    "dq": "TMA ring + 3xTF32 on mma.sync m16n8k8 (sm_90a): two groups of 4 warps on even and odd key tiles, "
          "exp2, dS as register A straight from the accumulators, sums over keys added a tile at a time by "
          "fp32 adds, merged in shared memory",
    "dkv": "TMA ring + 3xTF32 on mma.sync m16n8k8 (sm_90a): two groups of 4 warps on even and odd q tiles, "
           "S^T and dP^T so that P^T and dS^T are register A operands, exp2, sums over q rows added a tile at "
           "a time by fp32 adds, merged in shared memory; at Dh 128 two CTAs a key block, one a column half",
    **{variant: TF32_CONV for variant in PHASE_TF32},
    # shift, select and copy: one kernel for both dtypes
    **{variant: DESIGNS[variant] for variant in ("shift", "select", "copy")},
}
PHASE_ROWS = (  # TPU kernel, its line, the probe entry's subcommand that runs it, the variants that port it
    ("phase_conv", "cips_tpu/ops/pallas/phase_conv.py:50", "phase", ("full",)),
    ("probe_pallas_dot", "scripts/probe_pallas_dot.py:34", "dot", ("dot", "select")),
    ("probe_pallas_bisect", "scripts/probe_pallas_bisect.py:30", "bisect", ("noshift", "shift", "full")),
    ("debug_pallas_stages", "scripts/debug_pallas_stages.py:22", "stages", ("one_tap", "shift", "copy", "full")),
)

# Kernel output limits, relative to max|out| of the plain version (about 0.16
# at L 4608, larger at shorter L, for unit-normal inputs). bf16 rounds P before
# P.V and the output, 2^-9 relative each; the worst measured is about 0.4 %.
# fp32 takes both products as 3xTF32 (split into tf32 parts, three tensor-core
# passes): its rounding model, flash_attention_tf32x3_reference, stays within
# 2.0e-6 of max|out| and 9.6e-7 in lse of the plain version on the CPU
# (tests/test_torch_port_flash.py); the kernel's distance to the model is printed.
TOL_BF16_OUT_REL = 1e-2
TOL_F32_OUT_REL = 1e-5
TOL_LSE = 1e-4  # fp32 scores and sums in both dtypes, absolute
TRAIN_ATTN = (2, 4, 2304, 32)  # the flagship's attention at training batch 2
# The causal generator's encoder level 2 (configs/training_causal.json: 128
# channels in 4 heads of 32 at 24x32x24 tokens), batch 2; checked at one head.
CAUSAL_ATTN = (2, 4, 18432, 32)
CAUSAL_CHECK = (1, 1, 18432, 32)
# Backward kernel limits, relative to each output's max|grad|, against the plain
# backward computed in fp32 from the same (rounded) inputs. bf16 rounds dS and P
# before their products and the grads at the end (2^-9 relative each), and each
# grad sums L such terms; the worst measured is 5.5e-3 (dQ), so 2e-2 leaves
# about 3.6x. fp32 takes every product of both kernels as 3xTF32 (split into tf32
# parts, three tensor-core passes): its rounding model,
# flash_attention_bwd_tf32x3_reference, stays within 2.2e-6 of the plain backward
# on the CPU (tests/test_torch_port_flash_bwd.py), the kernels within 5.8e-6 at
# every case below (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md); their distance to
# the model is printed beside.
TOL_BF16_GRAD_REL = 2e-2
TOL_F32_GRAD_REL = 1e-5
# Card vs CPU, full model in fp32: different conv/matmul algorithms and
# summation orders; the JAX package's full-model gate calibrates f32 noise
# at about 1e-3 relative (tests/test_halo_full_model.py).
TOL_MODEL_REL = 1e-3
TOL_METRIC = 1e-3
# One fp32 train step, card vs CPU: each gradient tensor within this share of
# its max|grad| (the forward's full-model limit; measured worst 2e-5); a tensor
# whose max|grad| is under 1e-3 of its network's largest (a conv bias ahead of
# a norm: exactly 0) must stay under that on both sides.
TOL_GRAD_MODEL_REL = 1e-3
TOL_STEP_METRIC_REL = 1e-3  # the step's losses, card vs CPU
# The causal step's gradients are held to an fp64 CPU step: within TOL_GRAD_MODEL_REL, or,
# for a tensor whose fp32 CPU gradient is itself far from fp64 (ill-conditioned: the
# discriminator's, `compare_grads_f64`), within this many times the CPU's distance: two fp32
# implementations round differently (the card's conv_0 2.7x the CPU's on an NVIDIA H100 80GB HBM3, 700 W).
FP32_NOISE = 4
# BMGAN's fp32 step from random weights, each network's whole gradient against the fp64 step,
# relative in the 2-norm, a limit per network about 2.5-4x the card's reading. On an NVIDIA H100
# 80GB HBM3 at 700 W the card reads 2.1e-2 (G), 5.0e-4 (E) and 2.5e-3 (D) under every cuDNN
# algorithm choice and without cuDNN, the CPU 1.4e-2, 4.0e-4 and 4.7e-4, while the card's
# fp64 step is within 4e-7 of the CPU's tensor by tensor
# (cips_tpu_torch/scripts/probe_bmgan_grads.py; PERF.md §6). G's coarse instance norms (8 voxels
# at its deepest level at (64, 64, 64)) amplify its own rounding. D's own arithmetic is as
# close on both (3e-6 on one fixed input): its distance is the fake's rounding (G's forward,
# 5.8e-5 from fp64 on the card, 3.2e-5 on the CPU) amplified through near-uniform patch
# logits. Each network's own fp32 arithmetic is held to the CPU's at TOL_MODEL_REL (G's
# forward) and TOL_GRAD_MODEL_REL (D's step on one input); a wrong function moves either by O(1).
TOL_BMGAN_F32_GRAD_NORM = {"g": 5e-2, "e": 2e-3, "d": 1e-2}
EVENT_TIMED: list = []  # calls that device_ms timed by CUDA events, the profiler having seen none of their work
# The group norm kernels at the cells' norms, batch 4, bf16: (label, (N, C, *S), groups,
# activation). The flagship's AttenUNet (16 groups) at levels 0-2, the causal encoder at its
# full and half volume (16 groups), the decoders (32 groups), the discriminators' InstanceNorm
# with LeakyReLU, the two deepest at odd sizes (no 16-byte path).
GN_SHAPES = (
    ("flagship level 0", (4, 16, 96, 128, 96), 16, "silu"),
    ("flagship level 1", (4, 32, 48, 64, 48), 16, "silu"),
    ("flagship level 2", (4, 64, 24, 32, 24), 16, "silu"),
    ("causal encoder level 0", (4, 64, 96, 128, 96), 16, "silu"),
    ("causal encoder level 1", (4, 128, 48, 64, 48), 16, "silu"),
    ("PET decoder level 2", (4, 32, 96, 128, 96), 32, "silu"),
    ("decoders level 1", (4, 64, 48, 64, 48), 32, "silu"),
    ("D norm_1", (4, 128, 24, 32, 24), 128, "leaky_relu"),
    ("causal D penultimate", (4, 256, 23, 31, 23), 256, "leaky_relu"),
    ("flagship D penultimate", (4, 512, 11, 15, 11), 512, "leaky_relu"),
)
GN_BYTES = {"fwd": 4, "bwd": 6}  # bf16 bytes an element: x read, y written; x and dy read, dx written
# Phase conv product variants against their plain version in fp32 from the same
# inputs, relative to max|out|: bf16 rounds the fp32 sum to bf16 once at the end
# (2^-9 relative) and both sum 8 taps of pc products in other orders; the worst
# measured on an H100 is 3.4e-3. fp32 takes every product as 3xTF32 (split into
# tf32 parts, three tensor-core passes) and sums a 32-channel chunk of one tap
# in the tensor cores before an fp32 add: its rounding model,
# phase_conv_tf32x3_reference, stays within 7.2e-7 of max|out| of the plain
# version on the CPU (tests/test_torch_port_phase_conv.py holds it to 3e-6); the
# kernel's distance to the model is printed. The same bf16 limit holds the kernel to the flagship's cuDNN
# conv, which also rounds an fp32 sum to bf16.
TOL_PHASE_BF16_REL = 1e-2
TOL_PHASE_F32_REL = 1e-5
# The fp32 library yardsticks against the fp32 kernel before they are timed: cuDNN may take
# a Winograd or FFT algorithm in fp32, whose rounding differs by more than summation order;
# the check only ties each yardstick to the function.
TOL_PHASE_LIBRARY_F32_REL = 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, traces: int = 3, floor: float = 0.0) -> float:
    """Device time of one call of ``fn``: every kernel and copy it launches, from a
    torch.profiler trace of ``iters`` calls after 5 warm-up calls, each kernel's
    mean duration times its launches a call. The host's own work per call
    (argument checks, tensor maps, ctypes, autograd) is not in it, so a kernel of
    tens of microseconds is not timed by its host.

    CUPTI drops device records now and then. Some of them (on an H100, 10-14 of
    200 in every phase 11 trace): each kernel's mean over the records kept still
    times it, where their sum over ``iters`` would read low; this is printed.
    All of them: the trace is taken again, up to ``traces`` times, and if every
    one is empty the call is timed by CUDA events instead, printed as such and
    counted in EVENT_TIMED. A trace that reads under ``floor`` (the call's bound,
    the least time the card could take) lost the records of a whole kernel and is
    taken again the same way."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for trace in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        records = device_records(prof, f"device_ms of {fn!r}")
        if records:
            ms = kernel_ms_per_call(records, iters, fn)
            if ms >= floor:
                return ms
            print(f"device_ms: trace {trace} of {traces} of {fn!r} reads {ms:.4f} ms, under the bound {floor:.5f} ms")
            continue
        print(f"device_ms: trace {trace} of {traces} of {fn!r} holds no device time")
    EVENT_TIMED.append(repr(fn))
    ms = cuda_ms(fn, iters)
    print(f"device_ms: {fn!r} timed by CUDA events instead: {ms:.4f} ms")
    return ms


def device_records(prof, label) -> list:
    """A trace's device records (key_averages) without user annotations: a
    record_function range (Adam's Optimizer.step) can come back as a device
    record that spans the kernels it holds, which would count them twice. Prints
    each annotation it drops, with its device time."""
    records = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    for e in records:
        if e.is_user_annotation:
            print(f"{label}: dropped a user annotation from the device records: {e.key} x{e.count}, "
                  f"{e.self_device_time_total / 1e3:.3f} ms")
    return [e for e in records if not e.is_user_annotation]


def kernel_ms_per_call(records, iters: int, label) -> float:
    """Device ms a call from a trace's device records (key_averages) over ``iters``
    calls: a kernel recorded about n x iters times runs n times a call at its mean
    duration, and so does one recorded at least iters / 10 times (once a call, most
    of its records lost: late in a call of this script the profiler kept as few as
    a third of them, on an NVIDIA H100 80GB HBM3 at 700 W); one recorded fewer times
    (once a trace) is spread over the calls."""
    total, lost = 0.0, 0
    for e in records:
        n = round(e.count / iters) or int(e.count >= iters / 10)
        total += e.self_device_time_total * (n / e.count if n else 1 / iters)
        lost += max(n * iters - e.count, 0)
    if lost:
        print(f"device_ms: the trace of {label!r} lost {lost} device records of {iters} calls; timed by the "
              f"mean of those kept")
    return total / 1e3


@functools.cache
def sm_clocks_per_s() -> float:
    """SMs x the card's maximum SM clock (nvidia-smi), in SM clocks a second."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def ex2_per_s() -> float:
    """The card's exponential rate: EX2_PER_CLOCK_PER_SM x SMs x max SM clock."""
    return EX2_PER_CLOCK_PER_SM * sm_clocks_per_s()


def fp32_flops_per_s() -> float:
    """The card's fp32 rate outside the tensor cores: FP32_LANES_PER_SM x 2 x SMs x max SM clock."""
    return FP32_LANES_PER_SM * 2 * sm_clocks_per_s()


def fma_ms(flops: float) -> float:
    """``flops`` at the FMA rate (fp32_flops_per_s): the fp32 operations term of
    the bound before the fp32 kernels took 3xTF32, printed beside it."""
    return flops / fp32_flops_per_s() * 1e3


def bound_ms(flops: float, nbytes: float, exps: float = 0.0, dtype=torch.bfloat16) -> tuple:
    """Least time of a function on the card: its operations at the bf16
    tensor-core peak (fp32: three passes at the TF32 peak, H100_BF16_FLOPS / 2,
    the least time for products of fp32 grade: 3xTF32, as the fp32 flash
    backward and SDPA's fp32 backend compute them), its bytes (each input read
    once, each output written once) at the memory rate, or its exponentials on
    the special-function units, whichever is longest; (ms, what bounds it)."""
    ops = 3 * flops / (H100_BF16_FLOPS / 2) if dtype == torch.float32 else flops / H100_BF16_FLOPS
    terms = {"operations": ops * 1e3, "bytes": nbytes / H100_BYTES_PER_S * 1e3}
    if exps:
        terms["exponentials"] = exps / ex2_per_s() * 1e3
    by = max(terms, key=terms.get)
    return terms[by], by


def kernel_checks(fa) -> float:
    """Kernel vs the plain version in fp32 on the same inputs (the fp32 kernel's
    distance to its 3xTF32 rounding model printed beside); returns the worst bf16
    error at the serving shape."""
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    bf16, f32 = torch.bfloat16, torch.float32
    edges = [  # (q shape, Lk or None for Lk = Lq[, scale]): every tile edge, at each Dh
        ((1, 1, 1, 32), None), ((1, 2, 17, 32), None), ((1, 2, 127, 64), None), ((1, 2, 129, 128), None),
        ((1, 1, 2305, 32), None), ((1, 2, 100, 32), 300), ((1, 2, 300, 128), 77), (CAUSAL_CHECK, None),
        # any scale, as JAX's kernel takes: the wrapper maps these onto a positive one
        ((1, 2, 200, 32), 300, -0.3), ((1, 2, 200, 64), 150, 0.0),
    ]
    cases = [  # (q shape, Lk or None for Lk = Lq, dtype[, scale])
        ((1, 4, 2304, 32), None, bf16), ((1, 4, 2304, 32), None, f32),
        ((4, 4, 2304, 32), None, bf16), ((4, 4, 2304, 32), None, f32),
        ((SERVING_BATCH, 4, 2304, 32), None, bf16),
        ((1, 2, 1000, 32), None, bf16), ((1, 2, 1000, 32), None, f32),
        ((1, 2, 4608, 64), None, bf16), ((1, 2, 4608, 64), None, f32),
        # the classifier's two attention levels at training batch 2
        (CLASSIFIER_ATTN, None, bf16), (CLASSIFIER_ATTN, None, f32), ((CLASSIFIER_BATCH, 4, 2304, 32), None, f32),
        *((shape, lk, bf16, *scale) for shape, lk, *scale in edges),
        # every edge in fp32 too: the fp32 kernel is tiled as the bf16 one is
        *((shape, lk, f32, *scale) for shape, lk, *scale in edges),
    ]
    for shape, lk, dtype, *scales in cases:
        kshape = shape if lk is None else (*shape[:2], lk, shape[3])
        q = torch.randn(shape, device="cuda", generator=g).to(dtype)
        k, v = (torch.randn(kshape, device="cuda", generator=g).to(dtype) for _ in range(2))
        scale = scales[0] if scales else shape[-1] ** -0.5
        out, lse = fa.flash_attention_forward(q, k, v, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q.float(), k.float(), v.float(), scale)
        err = (out.float() - ref_out).abs().max().item()
        rel = err / ref_out.abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = TOL_BF16_OUT_REL if dtype == torch.bfloat16 else TOL_F32_OUT_REL
        model = ""
        if dtype == torch.float32:  # the 3xTF32 kernel against its rounding model too
            m_out, m_lse = fa.flash_attention_tf32x3_reference(q, k, v, scale)
            model = (f"; to the 3xTF32 model: out {((out - m_out).abs().max() / ref_out.abs().max()).item():.3e} of "
                     f"max|out|, lse {(lse - m_lse).abs().max().item():.3e} (the model "
                     f"{((m_out - ref_out).abs().max() / ref_out.abs().max()).item():.3e}, lse "
                     f"{(m_lse - ref_lse).abs().max().item():.3e})")
            del m_out, m_lse
        print(f"kernel {shape} Lk {kshape[2]} {str(dtype)[6:]} scale {scale:.4g}: out max abs err {err:.3e}, / max|out| = "
              f"{rel:.3e} (tol {tol:g}), lse max abs err {lse_err:.3e} (tol {TOL_LSE:g}){model}")
        check(torch.isfinite(out).all().item() and rel <= tol and lse_err <= TOL_LSE,
              f"flash kernel disagrees with its plain version at {shape} {dtype}")
        if shape == (SERVING_BATCH, 4, 2304, 32):
            worst = err
    return worst


def sdpa_yardstick(q, k, v, dout, scale: float, iters: int, want=None, floors=(0.0, 0.0)) -> tuple:
    """SDPA's forward and backward (dq, dk and dv in one call) under each of the
    flash, efficient and cuDNN backends, pinned, by device time; a backend that
    refuses the shape or dtype is skipped and printed, and none accepting it raises.
    ``want`` (out, dq, dk, dv) of the plain versions in fp32, if given: each
    backend's results must agree with it within the kernels' own limits before
    it is timed. ``floors``: the forward's and the backward's bounds (`device_ms`).
    Returns ((fwd ms, backend), (bwd ms, backend)) of the fastest."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    f32 = q.dtype == torch.float32
    fwd, bwd = {}, {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
                out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
                if want is not None:
                    got = (out, *torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True))
                    errs = [((a.float() - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want)]
                    tols = [TOL_F32_OUT_REL if f32 else TOL_BF16_OUT_REL] + 3 * [TOL_F32_GRAD_REL if f32 else
                                                                                  TOL_BF16_GRAD_REL]
                    print(f"SDPA {name} {tuple(q.shape)} {str(q.dtype)[6:]} against the plain versions in fp32, "
                          f"of max|out| and max|grad|: out {errs[0]:.3e}, dq {errs[1]:.3e}, dk {errs[2]:.3e}, "
                          f"dv {errs[3]:.3e} (tol {tols[0]:g}, {tols[1]:g})")
                    check(all(e <= t for e, t in zip(errs, tols)),
                          f"SDPA {name} computes another function at {tuple(q.shape)} {q.dtype}")
                fwd[name] = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), iters,
                                      floor=floors[0])
                bwd[name] = device_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dout, retain_graph=True),
                                      iters, floor=floors[1])
        except RuntimeError as err:
            print(f"SDPA {name} refuses {tuple(q.shape)}: {str(err).splitlines()[0][:200]}")
    check(bool(fwd), f"no SDPA backend accepts {tuple(q.shape)} {q.dtype}")
    print(f"SDPA {tuple(q.shape)} {str(q.dtype)[6:]} (pinned backends): " + "; ".join(
        f"{name} fwd {fwd[name]:.4f} ms, bwd {bwd[name]:.4f} ms" for name in fwd))
    best_f, best_b = min(fwd, key=fwd.get), min(bwd, key=bwd.get)
    return (fwd[best_f], best_f), (bwd[best_b], best_b)


def flash_timing(fa, shape, plain: bool, dtype=torch.bfloat16, lk=None) -> dict:
    """Each flash kernel's device time (``ms``) and its time launched eagerly
    from Python (``eager_ms``, CUDA events over the calls after 20 warm-up, the
    host's work per call included) beside its three-term bound, its plain
    version's time and the fastest pinned SDPA call's device time, SDPA first
    held to the plain versions (both when ``plain``); {"fwd" | "dq" | "dkv": row}.
    fp32 runs the fp32 kernels, which ``--dtype f32`` sends every attention to.
    ``lk``: the keys' length (Lq unless given; a space rank's queries attend to
    the whole volume's keys)."""
    b, h, l, d = shape
    lk = l if lk is None else lk
    iters = 200 if l <= 4096 else 50
    q, k, v, out, lse, dout, delta, scale = bwd_inputs(fa, shape, dtype, seed=1, lk=lk)
    want = None
    if plain:
        f32 = [t.float() for t in (q, k, v, dout)]
        want = (fa.flash_attention_reference(*f32[:3], scale)[0], fa.flash_attention_bwd_dq_reference(
            *f32, lse, delta, scale), *fa.flash_attention_bwd_dkv_reference(*f32, lse, delta, scale))
    pairs = b * h * l * lk
    size = q.element_size()
    rows_q, rows_k = b * h * l * d * size, b * h * lk * d * size  # one tensor of q's, of k's shape
    kernels = {
        # 4 B H Lq Lk Dh operations; q, k, v, out and lse; one exponential per score
        "fwd": (lambda: fa.flash_attention_forward(q, k, v, scale),
                lambda: fa.flash_attention_reference(q, k, v, scale),
                4.0 * pairs * d, 2 * rows_q + 2 * rows_k + b * h * l * 4),
        # dQ 6 B H Lq Lk Dh operations, dK/dV 8; each reads q, k, v, dO and lse, delta (fp32)
        # and writes its grads; each recomputes one exponential per score
        "dq": (lambda: fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale),
               lambda: fa.flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta, scale),
               6.0 * pairs * d, 3 * rows_q + 2 * rows_k + 2 * b * h * l * 4),
        "dkv": (lambda: fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale),
                lambda: fa.flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta, scale),
                8.0 * pairs * d, 2 * rows_q + 4 * rows_k + 2 * b * h * l * 4),
    }
    bounds = {kind: bound_ms(flops, nbytes, float(pairs), dtype) for kind, (_, _, flops, nbytes) in kernels.items()}
    library_fwd, library_bwd = sdpa_yardstick(q, k, v, dout, scale, iters, want, floors=(
        bounds["fwd"][0], max(bounds["dq"][0], bounds["dkv"][0])))
    del want
    rows = {}
    for kind, (kernel, reference, flops, nbytes) in kernels.items():
        bound, bound_by = bounds[kind]
        library_ms, library = library_fwd if kind == "fwd" else library_bwd
        ms = device_ms(kernel, 200, floor=bound)
        eager_ms = cuda_ms(kernel, 200, warmup=20)
        plain_ms = cuda_ms(reference, 20) if plain else None
        yardstick = "SDPA" if kind == "fwd" else "SDPA backward (dq, dk, dv)"
        # fp32: the operations at the FMA rate, the fp32 bound before 3xTF32, printed only
        fma = f", at the FMA rate {fma_ms(flops):.5f} ms ({fma_ms(flops) / ms:.1%})" if dtype == torch.float32 else ""
        print(f"flash {kind} {shape}{'' if lk == l else f' Lk {lk}'} {str(dtype)[6:]}: kernel {ms:.4f} ms on the device ({eager_ms:.4f} ms a call "
              f"eagerly), plain {'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}, {yardstick} {library.lower()} "
              f"{library_ms:.4f} ms on the device ({ms / library_ms:.2f}x), bound {bound:.5f} ms ({bound_by}); "
              f"{bound / ms:.1%} of bound{fma}")
        rows[kind] = {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "library": f"SDPA {library.lower()}", "bound_ms": bound, "bound_by": bound_by}
    return rows


FLASH_COUNTS = ("flash.fwd.launches", "flash.dq.launches", "flash.dkv.launches")


def counts() -> tuple:
    """(forward, dQ, dK/dV) launch counts."""
    from cips_tpu_torch import profiling

    return tuple(profiling.COUNTERS[k] for k in FLASH_COUNTS)


# The group norm's counters: kernel calls forward and backward, and calls of the plain version,
# which no bf16 or fp32 norm on the card may take.
NORM_COUNTS = ("group_norm.fwd.launches", "group_norm.bwd.launches", "group_norm.plain.calls")
NORM_PATHS: dict = {}  # {path: its run's group norm launches}, for the kernels line


def norm_counts() -> tuple:
    """(forward, backward, plain) group norm counts."""
    from cips_tpu_torch import profiling

    return tuple(profiling.COUNTERS[k] for k in NORM_COUNTS)


def set_counts(values, norms=(0, 0, 0)) -> None:
    """Sets the flash (forward, dQ, dK/dV) and the group norm (forward, backward, plain) counts."""
    from cips_tpu_torch import profiling

    for key, value in zip(FLASH_COUNTS + NORM_COUNTS, (*values, *norms)):  # assigned: a Counter's update() adds
        profiling.COUNTERS[key] = value


@contextlib.contextmanager
def uncounted():
    """Launches inside the block (checks, timing) leave the counts as they were."""
    saved, saved_norms = counts(), norm_counts()
    try:
        yield
    finally:
        set_counts(saved, saved_norms)


@contextlib.contextmanager
def norm_calls():
    """Counts the norm modules' calls inside the block (`blocks.GroupNorm`, and
    `InstanceNorm` on it), by a forward pre-hook on every module: yields
    [calls, calls that autograd records], the second being those whose backward
    runs in the step."""
    from torch.nn.modules.module import register_module_forward_pre_hook
    from cips_tpu_torch.models.blocks import GroupNorm

    seen = [0, 0]

    def hook(module, args):
        if isinstance(module, GroupNorm):
            seen[0] += 1
            seen[1] += torch.is_grad_enabled() and (args[0].requires_grad
                                                    or any(p.requires_grad for p in module.parameters()))

    handle = register_module_forward_pre_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def norm_step(seen: list, before: tuple) -> dict:
    """One step's norm calls (`norm_calls`) beside the group norm counters' growth since ``before``."""
    grown = [a - b for a, b in zip(norm_counts(), before)]
    return {"calls": seen[0], "recorded": seen[1], "fwd": grown[0], "bwd": grown[1], "plain": grown[2]}


def check_norm_steps(steps: list, label: str) -> list:
    """Every step ran each of its norm calls through the kernels: the forward
    launches equal its norm calls (at least one), the backward launches the calls
    that autograd recorded, and the plain version ran on nothing. Returns the
    distinct (calls, forward, backward) a step."""
    check(bool(steps), f"{label}: no train step recorded its norms")
    for i, st in enumerate(steps):
        check(st["calls"] > 0 and st["fwd"] == st["calls"] and st["bwd"] == st["recorded"] and st["plain"] == 0,
              f"{label} step {i}: {st['calls']} norm calls ({st['recorded']} recorded by autograd) but group norm "
              f"launches {st['fwd']} forward / {st['bwd']} backward and {st['plain']} plain-version calls")
    return sorted({(st["calls"], st["fwd"], st["bwd"]) for st in steps})


def norm_path(label: str, backward: bool, steps: Optional[list] = None, counted: Optional[tuple] = None) -> dict:
    """The group norm counts of the path that ran since `set_counts` zeroed them
    (or ``counted``, a rank's): kernels forward (and backward where the path
    trains, none where it does not), and no plain-version call; with each train
    step's (`check_norm_steps`). Recorded in NORM_PATHS under ``label``."""
    fwd, bwd, plain = counted if counted is not None else norm_counts()
    check(fwd > 0 and (bwd > 0) == backward and plain == 0,
          f"{label}: group norm launches {fwd} forward / {bwd} backward and {plain} plain-version calls")
    entry = {"fwd": fwd, "bwd": bwd, "plain": plain}
    if steps is not None:
        entry["per_step"] = check_norm_steps(steps, label)
    print(f"{label}: group norm launches {fwd} forward / {bwd} backward, no plain-version call"
          + (f"; per step (calls, forward, backward) {entry['per_step']}" if steps is not None else ""))
    NORM_PATHS[label] = entry
    return entry


def rank_norms(record: dict, label: str) -> dict:
    """`norm_path` for a training rank's record (`dp_rank_main`, `recorded_dryrun_rank`)."""
    steps = record.get("norm_steps") or [st["norms"] for st in record["steps"]]
    return norm_path(label, True, steps, tuple(record["norms"]))


@contextlib.contextmanager
def step_launches(record: list, task, norms: Optional[list] = None):
    """Each train step that a train CLI runs inside the block appends its own
    (forward, dQ, dK/dV) launches to ``record``, and its norms (`norm_step`) to
    ``norms`` when given: wraps the step that ``task.make_train_step`` returns
    (``task``: `unet_synthesis`, `causal_task` or `classifier_task`)."""
    make_train_step = task.make_train_step

    def counted_make(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def counted(*step_args):
            before, norms_before = counts(), norm_counts()
            with norm_calls() as seen:
                out = step(*step_args)
            record.append(tuple(a - b for a, b in zip(counts(), before)))
            if norms is not None:
                norms.append(norm_step(seen, norms_before))
            return out

        return counted

    task.make_train_step = counted_make
    try:
        yield record
    finally:
        task.make_train_step = make_train_step


def bwd_inputs(fa, shape, dtype, seed: int, lk=None, scale=None) -> tuple:
    """q, k, v, out, lse from the forward kernel; dO; delta; the scale (1/sqrt(Dh) unless
    given). k and v have ``lk`` rows (Lq unless given)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    kshape = shape if lk is None else (*shape[:2], lk, shape[3])
    q, dout = (torch.randn(shape, device="cuda", generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn(kshape, device="cuda", generator=g).to(dtype) for _ in range(2))
    scale = shape[-1] ** -0.5 if scale is None else scale
    out, lse = fa.flash_attention_forward(q, k, v, scale)
    delta = (dout.float() * out.float()).sum(-1)
    return q, k, v, out, lse, dout, delta, scale


def bwd_kernel_checks(fa) -> dict:
    """dQ and dK/dV kernels against the plain backward computed in fp32 on the same
    inputs; errors relative to each output's max|grad|. Returns the worst absolute
    errors {"dq": x, "dkv": y} at the training shape in bf16."""
    worst = {}
    edges = [
        ((1, 1, 1, 32),), ((1, 2, 17, 32),), ((1, 2, 129, 128),), ((1, 1, 2305, 32),), (CAUSAL_CHECK,),
        # the kernels' key-side edges (fewer keys than a tile, Lq != Lk both ways, ragged, at
        # Dh 128 too, one q row), then a negative and a zero scale, mapped by the wrapper
        ((1, 2, 100, 32), 40), ((1, 2, 130, 64), 77), ((1, 2, 77, 64), 130), ((1, 1, 129, 128), 191),
        ((1, 2, 1, 128), 130), ((1, 2, 200, 32), 300, -0.3), ((1, 2, 200, 64), 150, 0.0),
    ]
    cases = [
        (TRAIN_ATTN, torch.bfloat16), (TRAIN_ATTN, torch.float32), ((4, 4, 2304, 32), torch.bfloat16),
        (CLASSIFIER_ATTN, torch.bfloat16), (CLASSIFIER_ATTN, torch.float32),  # the classifier's level 4
        ((1, 2, 1000, 32), torch.bfloat16), ((1, 2, 1000, 32), torch.float32),
        ((1, 2, 4608, 64), torch.bfloat16), ((1, 2, 4608, 64), torch.float32),
        *((shape, torch.bfloat16, *extra) for shape, *extra in edges),
        ((1, 2, 200, 64), torch.float32, 150, -0.3),
        # every edge in fp32 too: the fp32 kernels are tiled as the bf16 ones are
        *((shape, torch.float32, *extra) for shape, *extra in edges),
    ]
    for i, (shape, dtype, *extra) in enumerate(cases):
        q, k, v, out, lse, dout, delta, scale = bwd_inputs(fa, shape, dtype, 10 + i, *extra)
        got = (fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale),
               *fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale))
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, dout)]
        want = (fa.flash_attention_bwd_dq_reference(*f32, lse, delta, scale),
                *fa.flash_attention_bwd_dkv_reference(*f32, lse, delta, scale))
        tol = TOL_BF16_GRAD_REL if dtype == torch.bfloat16 else TOL_F32_GRAD_REL
        errs = []
        # At Lk = 1 or scale 0 the softmax is constant and dQ = dK = 0 exactly; both sides hold
        # only fp32 rounding noise of dP - delta there (about 1e-8), so they are held to the
        # largest max|grad| of the three (dV's).
        largest = max(b.abs().max().item() for b in want)
        constant = k.shape[2] == 1 or scale == 0
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = (a.float() - b).abs().max().item()
            rel = err / (largest if constant and name != "dv" else b.abs().max().item())
            errs.append(f"{name} {err:.3e} abs, {rel:.3e} of max|grad| {b.abs().max().item():.3e}")
            check(a.dtype == dtype and torch.isfinite(a).all().item() and rel <= tol,
                  f"{name} kernel disagrees with its plain version at {shape} {dtype}: {rel:.3e} > {tol:g}")
            if shape == TRAIN_ATTN and dtype == torch.bfloat16:
                key = "dq" if name == "dq" else "dkv"
                worst[key] = max(worst.get(key, 0.0), err)
        if dtype == torch.float32:  # the 3xTF32 kernels against their rounding model too
            model = fa.flash_attention_bwd_tf32x3_reference(q, k, v, dout, lse, delta, scale)
            errs.append("to the 3xTF32 model " + ", ".join(
                f"{name} {(a - m).abs().max().item():.3e} (the model {((m - b).abs().max() / b.abs().max()).item():.3e}"
                f" of max|grad|)" for name, a, m, b in zip(("dq", "dk", "dv"), got, model, want)))
            del model
        print(f"bwd kernels {shape} Lk {k.shape[2]} scale {scale:.4g} {str(dtype)[6:]} (tol {tol:g} of max|grad|): "
              + "; ".join(errs))
    return worst


def group_norm_report(report: str) -> None:
    """The group norm kernels' registers and spills (none allowed) from nvcc's
    -Xptxas -v report, the most over each kernel's instances (dtype, vector width,
    activation)."""
    worst = {}
    for name, body in re.findall(r"Compiling entry function '(\S+)' for 'sm_90a'(.*?)(?=Compiling entry|\Z)",
                                 report, flags=re.S):
        kernel = re.search(r"group_norm_((?:cl_)?(?:moments_partial|apply|bwd_partial|bwd_dx)|moments_group|bwd_channel)",
                           name)
        if kernel is None:
            continue
        regs = int(re.search(r"Used (\d+) registers", body).group(1))
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        check(spills is None or spills.groups() == ("0", "0"), f"ptxas reports spills in {name}")
        count, most = worst.get(kernel.group(1), (0, 0))
        worst[kernel.group(1)] = (count + 1, max(most, regs))
    for kernel, (count, regs) in worst.items():
        print(f"ptxas group_norm_{kernel}: {count} instances, at most {regs} registers, no spills")
    if "nvcc done" in report:
        check(sum(c for c, _ in worst.values()) == 62, f"the build report names {worst} group norm kernels, not 62")


def group_norm_phase(card: str) -> dict:
    """The group norm kernels at GN_SHAPES, channels last as the models' activations
    lie: held to the plain version against the fp32 plain graph (y within 2^-7 of
    max|y| of the plain version's y and no farther from the graph than 1.01x its
    distance; dx, dw, db no farther; relative in the 2-norm; a LeakyReLU takes the
    branch of the bf16 forward), then each pass's device time beside its bytes
    bound, the same kernels' on the NCDHW copy ("rows"), the plain version's and
    the library's (F.group_norm, then the activation) on both layouts ("library",
    "library_rows"); {label: row}."""
    import torch.nn.functional as F
    from cips_tpu_torch.ops import group_norm as gn

    library_act = {"silu": F.silu, "leaky_relu": lambda t: F.leaky_relu(t, 0.2)}
    rows = {}
    for label, shape, groups, act in GN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(len(rows))
        cl = torch.channels_last_3d
        x = (torch.randn(shape, device="cuda", generator=g) * 1.5 + 0.3).to(torch.bfloat16)
        x = x.contiguous(memory_format=cl).requires_grad_(True)
        dy = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16).contiguous(memory_format=cl)
        check(gn.takes_channels_last(x), f"group norm {label}: the channels-last kernels refuse {tuple(shape)}")
        rows_x, rows_dy = x.detach().contiguous().requires_grad_(True), dy.contiguous()
        w = (torch.randn(shape[1], device="cuda", generator=g) * 0.5 + 1.0).requires_grad_(True)
        b = (torch.randn(shape[1], device="cuda", generator=g) * 0.5).requires_grad_(True)
        fns = {"kernel": lambda t: gn.group_norm(t, w, b, groups, 1e-6, act),
               "plain": lambda t: gn.group_norm_reference(t, w, b, groups, 1e-6, act),
               "library": lambda t: library_act[act](F.group_norm(t, groups, w.to(t.dtype), b.to(t.dtype), 1e-6))}
        grads, outs = {}, {}
        for name in ("kernel", "plain"):
            outs[name] = fns[name](x)
            grads[name] = torch.autograd.grad(outs[name], (x, w, b), dy)
            outs[name] = outs[name].detach()
        # the fp32 graph; its LeakyReLU takes the bf16 forward's branch, as where rounding moves z
        # across 0 both bf16 paths share the other slope's error
        with torch.no_grad():
            branch = gn.group_norm_reference(x, w, b, groups, 1e-6) > 0
        x32 = x.detach().float().requires_grad_(True)
        z32 = gn.group_norm_reference(x32, w, b, groups, 1e-6)
        y32 = torch.where(branch, z32, z32 * gn.LEAKY_SLOPE) if act == "leaky_relu" else gn.activate(z32, act)
        want = torch.autograd.grad(y32, (x32, w, b), dy.float())
        errs, y_errs = {}, {}
        for name, got in grads.items():
            errs[name] = [((a.double() - r.double()).norm() / r.double().norm()).item() for a, r in zip(got, want)]
            y_errs[name] = ((outs[name].double() - y32.double()).norm() / y32.double().norm()).item()
        y_gap = (outs["kernel"].float() - outs["plain"].float()).abs().max().item()
        y_scale = outs["plain"].float().abs().max().item()
        del grads, want, x32, z32, y32, outs
        check(y_gap <= 2.0**-7 * y_scale and y_errs["kernel"] <= 1.01 * y_errs["plain"],
              f"group norm {label}: the kernels' y lies {y_gap} from the plain version's (max |y| {y_scale}) and "
              f"{y_errs['kernel']} from the fp32 graph, the plain version's {y_errs['plain']}")
        check(all(k <= p + 1e-7 for k, p in zip(errs["kernel"], errs["plain"])),
              f"group norm {label}: the kernels' (dx, dw, db) {errs['kernel']} farther from the fp32 graph than the "
              f"plain version's {errs['plain']}")
        bound = {k: x.numel() * v / H100_BYTES_PER_S * 1e3 for k, v in GN_BYTES.items()}
        row = {"shape": shape, "groups": groups, "act": act, "bound_ms": bound,
               "rel_err": {"kernel": errs["kernel"], "plain": errs["plain"]},
               "y_err": {"max_gap": y_gap, "max_abs": y_scale, "kernel": y_errs["kernel"], "plain": y_errs["plain"]}}
        for name, fn, xi, dyi in [(name, fn, x, dy) for name, fn in fns.items()] + [
                ("kernel_rows", fns["kernel"], rows_x, rows_dy), ("library_rows", fns["library"], rows_x, rows_dy)]:
            with torch.no_grad():
                fwd = device_ms(lambda: fn(xi), 20, floor=bound["fwd"])
            y = fn(xi)
            bwd = device_ms(lambda: torch.autograd.grad(y, (xi, w, b), dyi, retain_graph=True), 20,
                            floor=bound["bwd"])
            row[name] = {"fwd_ms": fwd, "bwd_ms": bwd}
            del y
        k = row["kernel"]
        # the library at its faster layout, each pass apart
        best = {p: min(row["library"][p], row["library_rows"][p]) for p in ("fwd_ms", "bwd_ms")}
        row["library_best"] = best
        print(f"group norm {label} {tuple(shape)} G {groups} {act}: kernel fwd {k['fwd_ms']:.4f} / bwd "
              f"{k['bwd_ms']:.4f} ms ({100 * bound['fwd'] / k['fwd_ms']:.1f} / "
              f"{100 * bound['bwd'] / k['bwd_ms']:.1f} % of the bytes bound {bound['fwd']:.4f} / "
              f"{bound['bwd']:.4f}); rows {row['kernel_rows']['fwd_ms']:.4f} / {row['kernel_rows']['bwd_ms']:.4f}; "
              f"plain {row['plain']['fwd_ms']:.4f} / {row['plain']['bwd_ms']:.4f}; library channels last "
              f"{row['library']['fwd_ms']:.4f} / {row['library']['bwd_ms']:.4f}, rows "
              f"{row['library_rows']['fwd_ms']:.4f} / {row['library_rows']['bwd_ms']:.4f} (kernel "
              f"{k['fwd_ms'] / best['fwd_ms']:.2f}x / {k['bwd_ms'] / best['bwd_ms']:.2f}x of the faster); y gap "
              f"{y_gap:.3e} of max {y_scale:.3e}, rel err y kernel {y_errs['kernel']:.2e}, plain "
              f"{y_errs['plain']:.2e}; rel err (dx, dw, db) kernel "
              f"{', '.join(f'{e:.2e}' for e in errs['kernel'])}, plain {', '.join(f'{e:.2e}' for e in errs['plain'])}"
              f"; {card}")
        rows[label] = row
        del x, dy, rows_x, rows_dy
        torch.cuda.empty_cache()
    return rows


def group_norm_main() -> int:
    """Phases 1 and 2, then phase 3's group norm part; one JSON line of its rows."""
    from cips_tpu_torch.ops import cuda_library

    phase("1 device")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase("2 build")
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        cuda_library.build(verbose=True)
    group_norm_report(report.getvalue())
    phase("3 group norm")
    rows = group_norm_phase(card)
    print(json.dumps({"group_norm": rows, "event_timed": len(EVENT_TIMED)}))
    print(card)
    return 0


def sm90_kernel_report(report: str, fa, pc) -> None:
    """One line for each Hopper kernel that has no other report here (the bf16 dQ
    and the fp32 (3xTF32) forward, dQ and dK/dV kernels at each Dh, every kernel of
    csrc/phase_conv_sm90.cu and of csrc/phase_conv_tf32.cu: the fp32 phase conv at
    each variant and N tile, and its weight split) from nvcc's -Xptxas -v report
    (registers, spills, static shared memory), then the dynamic shared memory that
    the bf16 dQ's and the phase conv kernels' launchers ask for."""
    found = 0
    for name, body in re.findall(r"Compiling entry function '(\S+)' for 'sm_90a'(.*?)(?=Compiling entry|\Z)",
                                 report, flags=re.S):
        kernel = re.search(r"(flash_bwd_dq_bf16_kernel|flash_fwd_tf32x3_kernel|flash_bwd_dq_tf32x3_kernel|"
                           r"flash_bwd_dkv_tf32x3_kernel|"
                           r"phase_conv_sm90_cu\w*?"
                           r"(?:dot_kernel|noshift_kernel|full_kernel|one_tap_kernel|copy_kernel)|"
                           r"phase_conv_tf32_cu\w*?(?:tf32x3_kernel|split_weights_kernel))"
                           r"(?:ILi(\d+)E(?:Li(\d+)E)?)?", name)
        if kernel is None:
            continue
        regs = re.search(r"Used (\d+) registers", body)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        static = re.search(r"(\d+) bytes smem", body)
        label = re.sub(r"^phase_conv_(?:sm90|tf32)_cu\w*?(?=dot|noshift|full|one_tap|copy|tf32x3|split)", "",
                       kernel.group(1)) + (f"<{','.join(filter(None, kernel.group(2, 3)))}>" if kernel.group(2) else "")
        print(f"ptxas {label}: {regs.group(1) if regs else '?'} registers, spill stores / loads "
              f"{' / '.join(spills.groups()) if spills else '?'} bytes, static shared memory "
              f"{static.group(1) if static else 0} bytes")
        check(spills is None or spills.groups() == ("0", "0"), f"ptxas reports spills in {label}")
        found += 1
    if "nvcc done" in report:  # else the library was up to date and nothing was compiled
        want = 19 + len(PHASE_TF32) * len(PHASE_TF32_TILES) + 1
        check(found == want, f"the build report names {found} of the {want} kernels above (bf16 dQ, fp32 forward, "
                             f"dQ and dK/dV at 3 Dh each, dot at 2 pc, noshift, full, one_tap at 2 pc, copy; fp32 "
                             f"phase conv at 4 variants x 3 N tiles, its weight split)")
    for dh in fa.HEAD_DIMS:
        print(f"dynamic shared memory: bf16 dQ at Dh {dh}: {fa.dq_kernel_smem(dh)} bytes (a block may have 232,448)")
    for variant, width in PHASE_SM90:
        label = "copy (any dtype, any pc)" if variant == "copy" else f"bf16 {variant} at pc {width}"
        print(f"dynamic shared memory: {label}: {pc.kernel_smem(variant, width)} bytes (a block may have 232,448)")
    for variant in PHASE_TF32:
        print(f"dynamic shared memory: fp32 {variant} (any pc) at N tiles of "
              + ", ".join(f"{bn}: {pc.kernel_smem_f32(variant, bn)}" for bn in PHASE_TF32_TILES) + " bytes")


def phase_source(variant: str, dtype=torch.bfloat16) -> str:
    """The CUDA source of a phase conv variant's kernel in ``dtype`` (copy, shift and
    select: one kernel for both dtypes)."""
    if dtype == torch.float32 and variant in PHASE_TF32:
        return "cips_tpu_torch/csrc/phase_conv_tf32.cu"
    sm90 = {v for v, _ in PHASE_SM90}
    return "cips_tpu_torch/csrc/" + ("phase_conv_sm90.cu" if variant in sm90 else "phase_conv.cu")


def phase_inputs(shape, dtype, seed: int) -> tuple:
    """x, the original k3 kernel w (3, 3, 3, C, C), and each product variant's weights
    in x's dtype: full takes pack_conv_kernel_phase(w) (the real conv, 27/64 dense);
    noshift, one_tap and dot take dense random weights, as the TPU probes did."""
    from cips_tpu_torch.ops.s2d import pack_conv_kernel_phase

    g = torch.Generator(device="cuda").manual_seed(seed)
    p = shape[-1]
    x = torch.randn(shape, device="cuda", generator=g).to(dtype)
    w = torch.randn((3, 3, 3, p // 8, p // 8), device="cuda", generator=g) * 0.1
    weights = {"full": pack_conv_kernel_phase(w.to(dtype)), "dot": (torch.randn((8, p, p), device="cuda",
                                                                                 generator=g) * 0.1).to(dtype)}
    for variant in ("noshift", "one_tap"):
        weights[variant] = (torch.randn((2, 2, 2, p, p), device="cuda", generator=g) * 0.1).to(dtype)
    return x, w, weights


def phase_variant(pc, variant: str, x: torch.Tensor, weights: dict) -> tuple:
    """(kernel, plain) callables of one variant on x; the plain one takes the
    dtype to compute in (fp32 for the checks of the product variants)."""
    if variant == "select":
        return (lambda: pc.lane_select(x)), (lambda dtype: pc.lane_select_reference(x.to(dtype)))
    wp = weights.get(variant)
    return ((lambda: pc.phase_conv_stage(x, wp, variant)),
            (lambda dtype: pc.phase_conv_stage_reference(x.to(dtype), None if wp is None else wp.to(dtype), variant)))


def phase_conv_checks(pc) -> dict:
    """Every variant against its plain version on the card: the product variants
    against the plain version in fp32 from the same inputs (relative to max|out|),
    shift, copy and select exactly. Returns each variant's max abs error at the
    probe shape, bf16."""
    worst = {}
    for i, (shape, dtype) in enumerate(PHASE_CHECKS):
        x, _, weights = phase_inputs(shape, dtype, seed=20 + i)
        errs = []
        for variant in PHASE_VARIANTS:
            kernel, plain = phase_variant(pc, variant, x, weights)
            got = kernel()
            torch.cuda.synchronize()
            exact = variant in PHASE_EXACT
            want = plain(dtype if exact else torch.float32)
            err = (got.float() - want.float()).abs().max().item()
            rel = err / want.abs().max().item()
            tol = 0.0 if exact else TOL_PHASE_BF16_REL if dtype == torch.bfloat16 else TOL_PHASE_F32_REL
            errs.append(f"{variant} {err:.3e} ({rel:.3e})")
            check(got.dtype == dtype and got.shape == x.shape and torch.isfinite(got).all().item() and rel <= tol,
                  f"phase conv {variant} disagrees with its plain version at {shape} {dtype}: {rel:.3e} > {tol:g}")
            if variant == "dot" and dtype == torch.bfloat16:  # the kernel's own rounding of sum_k W[k]
                model = pc.dot_rounded_reference(x, weights["dot"]).float()
                errs.append(f"dot vs its rounding model {(got.float() - model).abs().max().item():.3e}, the model "
                            f"{((model - want.float()).abs().max() / want.abs().max()).item():.3e} of max|out|")
            if variant in PHASE_TF32 and dtype == torch.float32:  # 3xTF32, chunked sums
                model = pc.phase_conv_tf32x3_reference(x, weights[variant], variant)
                to_model = (got - model).abs().max().item() / want.abs().max().item()
                errs.append(f"{variant} vs its 3xTF32 model {to_model:.3e} of max|out|")
            if shape == PHASE_SHAPES[0] and dtype == torch.bfloat16:
                worst[variant] = err
        print(f"phase conv kernels {shape} {str(dtype)[6:]}: max abs err (/ max|out|) " + ", ".join(errs))
    return worst


def phase_conv_flagship(cfg: dict, state: dict) -> float:
    """The kernel against the flagship generator's own level-0 conv: full width,
    the full volume, batch 2, bf16, seeded random weights; returns the max abs error."""
    from cips_tpu_torch.training import unet_synthesis

    generator, _, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.bfloat16, device="cuda")
    generator.load_state_dict(state)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand((SERVING_BATCH, *CROP, 1), device="cuda", generator=g)
    ctx = torch.rand((SERVING_BATCH, 1, FLAGSHIP_K), device="cuda", generator=g)
    got, want = level0_tie(generator, x, ctx)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    print(f"phase conv vs the flagship's level-0 conv (down_blocks[0].resnets[0].conv1, cuDNN, NCDHW) on its "
          f"own input: packed {tuple(got.shape)} bf16, max abs err {err:.3e} = {rel:.3e} of max|out| "
          f"(tol {TOL_PHASE_BF16_REL:g})")
    check(got.shape == (SERVING_BATCH, *(n // 2 for n in CROP), 128) and rel <= TOL_PHASE_BF16_REL,
          "the phase conv disagrees with the flagship's level-0 conv")
    return err


def phase_conv_timing(pc, shape, dtype=torch.bfloat16, variants=PHASE_VARIANTS) -> dict:
    """Each variant's device time (``ms``, torch.profiler over 200 calls: CUPTI drops
    about 10 records a trace, which a shorter trace cannot spare) and eager time
    (``eager_ms``, CUDA events over 200 launches after 20 warm-up) beside its bound, its plain version's time and, where one PyTorch call computes
    the same function, that call's device and eager times; the two cuDNN yardsticks
    of the conv at this shape. In ``dtype`` (fp32: TF32 off, as phase 1 sets it;
    the bound's operations at the 3xTF32 rate, the FMA figure printed beside)."""
    import torch.nn.functional as F

    from cips_tpu_torch.scripts.probe_phase_conv import yardsticks

    x, w, weights = phase_inputs(shape, dtype, seed=30)
    name = str(dtype)[6:]
    b, z, y, xd, p = shape
    cells, c = b * z * y * xd, p // 8
    xc = x.permute(0, 4, 1, 2, 3)  # channels-last view for cuDNN
    convs = yardsticks(x, w)
    sticks = {label: (device_ms(fn, 200), cuda_ms(fn, 200, warmup=20)) for label, fn in convs.items()}
    print(f"phase conv yardsticks {shape} {name}, device (eager) ms: F.conv3d dense k3 over the packed layout "
          f"{sticks['dense k3 packed'][0]:.4f} ({sticks['dense k3 packed'][1]:.4f}); F.conv3d at the unpacked "
          f"{(b, c, 2 * z, 2 * y, 2 * xd)} {sticks['unpacked'][0]:.4f} ({sticks['unpacked'][1]:.4f})")

    def k2_conv(wk2):  # one conv over x padded by 1; its first (Z, Y, X) outputs are the variant's
        wk2 = wk2.contiguous(memory_format=torch.channels_last_3d)
        return lambda: F.conv3d(xc, wk2, padding=1)[:, :, :z, :y, :xd]

    one_tap = torch.zeros((p, p, 2, 2, 2), device="cuda", dtype=x.dtype)
    for q in range(8):  # group q of x'[cell] is x[cell - q]: offset 1 - q of the k2 window
        one_tap[:, q * c:(q + 1) * c, 1 - (q >> 2), 1 - ((q >> 1) & 1), 1 - (q & 1)] = \
            weights["one_tap"][0, 0, 0, q * c:(q + 1) * c].T
    library = {"full": convs["dense k3 packed"],
               "noshift": k2_conv(weights["noshift"].permute(4, 3, 0, 1, 2)), "one_tap": k2_conv(one_tap),
               "dot": lambda: torch.einsum("bzyxi,kio->bzyxo", x, weights["dot"]), "copy": x.clone}
    channels_first = ("full", "noshift", "one_tap")  # the cuDNN calls return (B, pc, Z, Y, X) views
    io_bytes = 2.0 * cells * p * x.element_size()  # x read once, out written once
    # The functions' own operations. dot is sum_k x . W[k] = x . (sum_k W[k]): one
    # product per cell plus the sum of W, which is what the bf16 kernel runs. full
    # also gets the count that its kernel issues (8 dense taps), as dense_bound_ms.
    ops = {"full": 2.0 * 27 * c * c * 8 * cells, "noshift": 2.0 * 8 * cells * p * p,
           "dot": 2.0 * cells * p * p + 8.0 * p * p, "one_tap": 2.0 * cells * p * p}
    tol = TOL_PHASE_BF16_REL if dtype == torch.bfloat16 else TOL_PHASE_LIBRARY_F32_REL
    rows = {}
    for variant in variants:
        kernel, plain = phase_variant(pc, variant, x, weights)
        weight = weights.get(variant)
        bound, bound_by = bound_ms(ops.get(variant, 0.0),
                                   io_bytes + (0 if weight is None else weight.numel() * weight.element_size()), dtype=dtype)
        ms = device_ms(kernel, 200)
        eager_ms = cuda_ms(kernel, 200, warmup=20)
        plain_ms = cuda_ms(lambda: plain(x.dtype), 5, warmup=1)
        library_ms = library_eager_ms = None
        if variant in library:
            lib_out, out = library[variant](), kernel()
            if variant in channels_first:
                lib_out = lib_out.permute(0, 2, 3, 4, 1)
            rel = ((lib_out.float() - out.float()).abs().max() / out.float().abs().max()).item()
            check(lib_out.shape == out.shape and rel <= tol,
                  f"the library call of {variant} computes another function: {rel:.3e}")
            library_ms = device_ms(library[variant], 200)
            library_eager_ms = cuda_ms(library[variant], 200, warmup=20)
        rows[variant] = {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": bound_by, "library_ms": library_ms, "library_eager_ms": library_eager_ms,
                         "unpacked_conv3d_ms": sticks["unpacked"][0]}
        dense = ""
        if variant == "full":
            rows[variant]["dense_bound_ms"], _ = bound_ms(2.0 * 8 * cells * p * p,
                                                          io_bytes + weight.numel() * weight.element_size(), dtype=dtype)
            dense = (f", dense-count bound {rows[variant]['dense_bound_ms']:.5f} ms "
                     f"({rows[variant]['dense_bound_ms'] / ms:.1%})")
        if dtype == torch.float32 and variant in ops:  # the products at the FMA rate, printed only
            dense += f", at the FMA rate {fma_ms(ops[variant]):.5f} ms ({fma_ms(ops[variant]) / ms:.1%})"
        lib = "none" if library_ms is None else \
            f"{library_ms:.4f} ms on the device ({library_eager_ms:.4f} eagerly; kernel {ms / library_ms:.2f}x)"
        print(f"phase conv {variant} {shape} {name}: kernel {ms:.4f} ms on the device ({eager_ms:.4f} ms a call "
              f"eagerly), plain {plain_ms:.4f} ms, library {lib}, bound {bound:.5f} ms ({bound_by}{dense}); "
              f"{bound / ms:.1%} of bound")
    return rows


def phase_conv_entry() -> dict:
    """The slice's main paths: each subcommand of the probe entry, through its
    `main`, with the launch counts set to 0 just before it and read just after;
    every variant of the row must have launched. Returns {row: {variant: launches}}."""
    from cips_tpu_torch.scripts import probe_phase_conv
    from cips_tpu_torch import profiling

    runs = {}
    for name, _, command, variants in PHASE_ROWS:
        profiling.reset("phase_conv.launches.")
        t0 = time.perf_counter()
        probe_phase_conv.main([command])
        torch.cuda.synchronize()
        launched = {v: profiling.COUNTERS[f"phase_conv.launches.{v}"] for v in variants}
        print(f"entry `probe_phase_conv {command}` in {time.perf_counter() - t0:.1f} s: launches {launched}")
        check(all(n > 0 for n in launched.values()), f"`probe_phase_conv {command}` did not launch every kernel "
                                                     f"of {name}: {launched}")
        runs[name] = launched
    return runs


def level0_tie(model: torch.nn.Module, x: torch.Tensor, ctx) -> tuple:
    """(phase_conv(space_to_depth(h), w), space_to_depth(conv3d(h, w, padding 1))), no
    bias, for the input h and weight w of the generator's first level-0 k3 conv
    (`down_blocks[0].resnets[0].conv1`, 16 -> 16 in the flagship), h taken by a hook
    in one forward of ``model``. The hook sits on the `Conv` wrapper, which calls
    F.conv3d with `conv.weight` itself rather than the inner nn.Conv3d."""
    import torch.nn.functional as F

    from cips_tpu_torch.ops.phase_conv import phase_conv
    from cips_tpu_torch.ops.s2d import space_to_depth

    conv = model.down_blocks[0].resnets[0].conv1
    seen = {}
    handle = conv.register_forward_pre_hook(lambda module, args: seen.setdefault("h", args[0]))
    try:
        with torch.inference_mode():
            model(x, ctx)
            h = seen["h"]
            w = conv.conv.weight.to(h.dtype)
            want = space_to_depth(F.conv3d(h, w, padding=1).permute(0, 2, 3, 4, 1).contiguous())
            got = phase_conv(space_to_depth(h.permute(0, 2, 3, 4, 1).contiguous()), w.permute(2, 3, 4, 1, 0))
    finally:
        handle.remove()
    return got, want


def random_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Every parameter drawn from a seeded numpy generator, the zero-initialised
    output convs included (else the output is identically 0): LeCun-scaled
    kernels, small biases, norm scales near 1."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in model.state_dict().items():
        if name.endswith("weight") and p.ndim >= 2:
            std = 1.0 / np.sqrt(p[0].numel())
            arr = rng.standard_normal(p.shape) * std
        elif name.endswith("weight"):
            arr = 1.0 + 0.1 * rng.standard_normal(p.shape)
        else:
            arr = 0.1 * rng.standard_normal(p.shape)
        state[name] = torch.from_numpy(arr.astype(np.float32))
    return state


def write_tree(root: str, seed: int, shape=(100, 132, 100)) -> dict:
    """Synthetic subjects: a smooth head-like blob plus noise, slightly larger than
    the crop so pad/crop runs; a manifest with AV45 covariates and their stats."""
    from cips_tpu_torch.data import nifti

    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*(np.linspace(-1, 1, s) for s in shape), indexing="ij")
    rows = []
    for i in range(N_SUBJECTS):
        subj, t1_date, pet_date = f"sub{i:03d}", "2015-01-01", "2015-01-20"
        radius = 0.7 + 0.05 * i
        blob = np.clip(1.0 - (zz**2 + yy**2 + xx**2) / radius**2, 0.0, None)
        for kind, date in (("t1", t1_date), ("pet", pet_date)):
            vol = blob * (1.0 + 0.2 * rng.standard_normal(shape)) + 0.02 * rng.random(shape)
            nifti.write(os.path.join(root, kind, subj, date, "img.nii.gz"), vol.astype(np.float32))
        rows.append({"Subject": subj, "T1_date": t1_date, "PET_date": pet_date, "ABETA": 600 + 200 * i,
                     "Age": 70 + i, "Sex": "Female" if i % 2 else "Male", "APOE4": i % 3, "PTEDUCAT": 12 + i})
    with open(os.path.join(root, "test.csv"), "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    stats = {"ABETA": [200, 1700], "Age": [55, 95], "PTEDUCAT": [6, 20]}
    with open(os.path.join(root, "stats.json"), "w", encoding="utf-8") as f:
        json.dump(stats, f)
    return {"csv": os.path.join(root, "test.csv"), "stats": os.path.join(root, "stats.json"),
            "t1": os.path.join(root, "t1"), "pet": os.path.join(root, "pet")}


KERNEL_KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("flash attention forward (this port)", ("flash_fwd",)),
    ("flash attention backward (this port)", ("flash_bwd",)),
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "xmma", "implicit_gemm", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "sm90")),
    ("optimizer (Adam, foreach)", ("multi_tensor",)),
    ("reductions", ("reduce",)),
    ("elementwise, copies, casts", ("elementwise", "copy", "vectorized", "cat", "index")),
)


def profile_window(fn, label: str) -> dict:
    """Device time by kernel over one warm call of ``fn``, grouped by kind, and
    the device's busy share of that call (a second profiled window, so the
    profiler's start-up is outside it); returns {kind: device ms}."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key) for e in device_records(prof, f"profile {label}")
            if e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    check(busy > 0, f"profile {label}: the profiler saw no device time")
    print(f"profile {label}: kernel time {busy:.3f} ms in {wall_ms:.3f} ms wall (profiler on); "
          f"device busy {busy / wall_ms:.1%}; {sum(r[1] for r in rows)} kernel launches")
    kinds = {}
    for ms, count, name in rows:
        kind = next((k for k, keys in KERNEL_KINDS if any(key in name for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}: {ms:9.3f} ms {ms / busy:6.1%}  {kind}")
    for ms, count, name in rows[:12]:
        print(f"profile {label}: {ms:9.3f} ms {ms / busy:6.1%} x{count:<4d} {name[:110]}")
    return kinds


def f32_forward(cfg: dict, state: dict, card: str) -> float:
    """The fp32 generator forward (what `output_predict --dtype f32` runs) at the full
    volume and batch 2: CUDA events over 3 calls after 1, the 6 fp32 flash forwards it
    launches checked, and one profiled call by kernel kind with the flash forward's
    share of the device time. TF32 is off (phase 1). Returns the forward's ms."""
    from cips_tpu_torch.ops import flash_attention as fa
    from cips_tpu_torch.training import unet_synthesis

    generator, _, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.float32, device="cuda")
    generator.load_state_dict(state)
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.rand((SERVING_BATCH, *CROP, 1), device="cuda", generator=g)
    ctx = torch.rand((SERVING_BATCH, 1, FLAGSHIP_K), device="cuda", generator=g)

    def forward():
        with torch.inference_mode():
            return generator(x, ctx)

    with uncounted():
        before = counts()[0]
        out = forward()
        launched = counts()[0] - before
        check(launched == 6 and out.dtype == torch.float32 and torch.isfinite(out).all().item(),
              f"the fp32 generator forward launched {launched} flash forwards (6 expected) or gave a bad output")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(forward, 3, warmup=1)
        print(f"fp32 serving: generator forward {ms:.3f} ms at batch {SERVING_BATCH} fp32, full volume {CROP}, "
              f"TF32 off = {SERVING_BATCH / ms * 1e3:.3f} vol/s (forward only, CUDA events over 3 after 1), peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; 6 fp32 flash forwards a call; {card}")
        kinds = profile_window(forward, "fp32 forward")
    flash = kinds.get(KERNEL_KINDS[0][0], 0.0)
    print(f"fp32 serving: the fp32 flash forward {flash:.3f} ms of {sum(kinds.values()):.3f} ms of kernels in the "
          f"profiled call ({flash / sum(kinds.values()):.2%})")
    del generator, out
    return ms


def subset_manifest(src: str, dst: str, n: int) -> str:
    """The first ``n`` rows of a manifest CSV, written to ``dst``."""
    with open(src, newline="", encoding="utf-8") as f:
        rows = list(itertools.islice(csv.reader(f), n + 1))
    with open(dst, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows(rows)
    return dst


def synthetic_batch(shape, batch: int, device: str, seed: int) -> dict:
    """{"t1", "pet", "info"}: PET a noisy affine function of T1, K covariates."""
    rng = np.random.default_rng(seed)
    t1 = rng.random((batch, *shape, 1), dtype=np.float32)
    pet = np.clip(t1 * 0.8 + 0.1 * rng.random((batch, *shape, 1), dtype=np.float32), 0, 1)
    info = rng.random((batch, 1, FLAGSHIP_K), dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in (("t1", t1), ("pet", pet), ("info", info))}


def compare_grads(label: str, got: dict, want: dict) -> float:
    """Card gradients against CPU gradients of one network, tensor by tensor
    (limits at TOL_GRAD_MODEL_REL); returns the worst error relative to a
    tensor's max|grad| among the tensors held to that."""
    tiny = 1e-3 * max(w.abs().max().item() for w in want.values())
    worst, worst_name, noise = 0.0, "", 0
    for name, w in want.items():
        g = got[name]
        scale = w.abs().max().item()
        check(torch.isfinite(g).all().item(), f"{label} {name}: non-finite gradient on the card")
        if scale < tiny:
            noise += 1
            check(g.abs().max().item() < tiny, f"{label} {name}: a zero gradient on the CPU is not on the card")
            continue
        rel = (g - w).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, name
    print(f"grads {label}: {len(want)} tensors, worst {worst:.3e} of max|grad| ({worst_name}); "
          f"{noise} tensors of rounding noise only (under {tiny:.3e}); tol {TOL_GRAD_MODEL_REL:g}")
    check(worst <= TOL_GRAD_MODEL_REL, f"{label} gradients disagree between card and CPU: {worst:.3e}")
    return worst


def compare_grads_f64(label: str, card: dict, cpu: dict, ref: dict) -> None:
    """Card and CPU fp32 gradients of one network against the CPU's fp64 step (fp64
    activations and norm statistics from the same fp32 weights; the losses, the
    plain attention's scores and LPIPS's unit normalisation stay fp32), tensor by tensor,
    relative to each max|grad|: within TOL_GRAD_MODEL_REL, or within FP32_NOISE
    times the CPU fp32 step's own distance where that is larger. The second limit
    is the discriminator's: with random weights its patch logits are nearly
    uniform, so the gradient reaching each instance norm is nearly constant over
    its voxels and the norm's backward leaves a small difference of fp32 sums (the
    CPU's fp32 step: 9.2e-3 of max|grad| at conv_penultimate, 8.9e-4 at conv_0;
    with two-pass norm statistics, or fp64 ones in the reference, the same). A tensor whose fp64 max|grad| is under
    1e-3 of its network's largest (exactly 0: a conv bias ahead of a norm) must
    stay under that on the card."""
    tiny = 1e-3 * max(w.abs().max().item() for w in ref.values())
    worst, worst_name, floors = 0.0, "", []
    for name, w in ref.items():
        g, c, w = card[name], cpu[name], w.float()
        check(torch.isfinite(g).all().item(), f"{label} {name}: non-finite gradient on the card")
        scale = w.abs().max().item()
        if scale < tiny:
            check(g.abs().max().item() < tiny, f"{label} {name}: a zero gradient in fp64 is not on the card")
            continue
        rel, cpu_rel = ((g - w).abs().max().item() / scale), ((c - w).abs().max().item() / scale)
        tol = max(TOL_GRAD_MODEL_REL, FP32_NOISE * cpu_rel)
        if tol > TOL_GRAD_MODEL_REL:
            floors.append((rel, f"{name} card {rel:.3e}, CPU fp32 {cpu_rel:.3e}"))
        check(rel <= tol, f"{label} {name}: card {rel:.3e} of max|grad| from fp64 > {tol:.3e}")
        if rel > worst:
            worst, worst_name = rel, name
    print(f"grads {label}: {len(ref)} tensors against fp64, card worst {worst:.3e} of max|grad| ({worst_name}); "
          f"tol {TOL_GRAD_MODEL_REL:g}, or {FP32_NOISE}x the CPU fp32 step's own distance where that is larger: "
          f"{len(floors)} tensors" + "".join(f"; {text}" for _, text in sorted(floors, reverse=True)[:8]))


@contextlib.contextmanager
def stage_clock(times: dict):
    """Host-clock time of each stage of the real serving path: wraps the
    functions that output_predict and predict_dataset call, each call ended
    by a synchronize; ``times[stage]`` collects one entry (ms) per call."""
    from cips_tpu_torch.data import nifti
    from cips_tpu_torch.data.dataset import PairedVolumeDataset
    from cips_tpu_torch.inference import predict
    from cips_tpu_torch.training import unet_synthesis
    from cips_tpu_torch.training.common import CheckpointManager

    def timed(stage, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times.setdefault(stage, []).append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    make_predict_fn = unet_synthesis.make_predict_fn
    patches = [
        (unet_synthesis, "build_models", timed(SETUP[0], unet_synthesis.build_models)),
        (CheckpointManager, "restore", timed(SETUP[1], CheckpointManager.restore)),
        (PairedVolumeDataset, "__getitem__", timed("decode + pad/crop, per subject", PairedVolumeDataset.__getitem__)),
        (unet_synthesis, "make_predict_fn",
         lambda *a, **kw: timed(f"generator forward, per batch of {SERVING_BATCH}", make_predict_fn(*a, **kw))),
        (predict, "get_mask", timed("brain mask, per volume", predict.get_mask)),
        *((predict, name, timed("metrics (3 calls per volume)", getattr(predict, name)))
          for name in ("mae", "ms_ssim", "psnr")),
        (nifti, "write", timed("NIfTI gz write (2 per volume)", nifti.write)),
    ]
    saved = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
    try:
        for owner, name, fn in patches:
            setattr(owner, name, fn)
        yield times
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@contextlib.contextmanager
def cpu_noise():
    """The causal task draws its noise on the CPU from the generator it is given and
    moves it to the device: a card run and a CPU run from one seed see the same eps."""
    from cips_tpu_torch.training import causal_task

    sample_noise = causal_task.sample_noise
    causal_task.sample_noise = lambda shape, dtype, device, generator: \
        torch.randn(shape, generator=generator).to(device, dtype)
    try:
        yield
    finally:
        causal_task.sample_noise = sample_noise


def causal_models(cfg: dict, states: dict, dtype, device: str, remat: bool = False) -> tuple:
    """The causal trio, D and the perceptual net (seed 0) with ``states`` loaded."""
    from cips_tpu_torch.training import causal_task

    models = causal_task.build_models(cfg, FLAGSHIP_K, dtype=dtype, device=device, remat=remat)
    for name, model in zip(CAUSAL_PARTS + ("discriminator",), models):
        model.load_state_dict(states[name])
    return models


def check_causal_outputs(out_dir: str, n: int) -> None:
    """``n`` rec.nii.gz of the full volume, min-max renormalised and self-masked, and no ori.nii.gz."""
    from cips_tpu_torch.data import nifti

    recs = [os.path.join(dp, f) for dp, _, fs in os.walk(out_dir) for f in fs if f == "rec.nii.gz"]
    oris = [f for _, _, fs in os.walk(out_dir) for f in fs if f == "ori.nii.gz"]
    check(len(recs) == n and not oris, f"expected {n} rec.nii.gz and no ori.nii.gz, found {len(recs)}, {len(oris)}")
    for path in recs:
        rec = nifti.read_array(path)
        check(rec.shape == CROP and np.isfinite(rec).all() and rec.min() >= 0 and 0 < rec.max() <= 1,
              f"{path}: bad causal output")


def causal_serving(fa, cfg: dict, states: dict, tree: dict, args: list, tmp: str, card: str) -> tuple:
    """Phase 9: gen_test_causal over the 8 subjects at the full volume, bf16, batch 2 (the
    path's run, its launches counted); the bf16 generator forward timed at batch 2 with its
    peak memory and profile; the fp32 trio on the card against the CPU at PARITY_CROP.
    Returns ((forward, dQ, dK/dV) launches of the path's run, forward ms)."""
    from cips_tpu_torch.cli import gen_test_causal
    from cips_tpu_torch.training import causal_task
    from cips_tpu_torch.training.common import CheckpointManager

    exp_dir = os.path.join(tmp, "causal_exp")
    CheckpointManager(os.path.join(exp_dir, "conditional", "AV45", "ckpt")).save({**states, "epoch": 0}, epoch=0)
    out_dir = os.path.join(tmp, "causal_gen")
    forwards = -(-N_SUBJECTS // SERVING_BATCH)
    set_counts((0, 0, 0))
    t0 = time.perf_counter()
    results = gen_test_causal.main(args + ["--exp_dir", exp_dir, "--eval_info_csv", tree["csv"], "--dtype", "bf16",
                                           "--batch_size", str(SERVING_BATCH), "--output_dir", out_dir])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = counts()  # the causal serving path's run
    norm_path("causal serving", backward=False)
    print(f"causal serving: gen_test_causal, {N_SUBJECTS} volumes in {elapsed:.3f} s = {N_SUBJECTS / elapsed:.3f} "
          f"vol/s end to end (set-up, the first forward and the NIfTI writes included); batch {SERVING_BATCH}, "
          f"bf16; launches (forward, dQ, dK/dV) {launched} over {forwards} generator forwards; metrics "
          f"{results.summary()}; {card}")
    check(launched == (CAUSAL_FLASH * forwards, 0, 0), f"expected {(CAUSAL_FLASH * forwards, 0, 0)}, got {launched}")
    check(all(np.isfinite(v) for v in results.summary().values()), "non-finite causal metrics")
    check_causal_outputs(out_dir, N_SUBJECTS)

    with uncounted():
        enc, _, pet_dec, _, _ = causal_models(cfg, states, torch.bfloat16, "cuda")
        generate = causal_task.make_generate_fn(enc, pet_dec)
        batch = synthetic_batch(CROP, SERVING_BATCH, "cuda", seed=7)
        g = torch.Generator("cuda").manual_seed(0)
        before = counts()[0]
        out = generate(batch, g)
        per_forward = counts()[0] - before
        check(per_forward == CAUSAL_FLASH and out.shape == (SERVING_BATCH, *CROP, 1)
              and torch.isfinite(out).all().item() and out.float().std().item() > 0,
              f"the causal generator forward launched {per_forward} flash forwards or gave a bad output")
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = cuda_ms(lambda: generate(batch, g), 5, warmup=2)
        print(f"causal serving: generator forward (encoder + PET decoder) {fwd_ms:.3f} ms at batch {SERVING_BATCH} "
              f"bf16, full volume {CROP} = {SERVING_BATCH / fwd_ms * 1e3:.3f} vol/s (forward only, CUDA events over 5 "
              f"after 2), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {per_forward} flash "
              f"forwards a forward; {card}")
        kinds = profile_window(lambda: generate(batch, g), "causal forward")
        flash = kinds.get(KERNEL_KINDS[0][0], 0.0)
        print(f"causal serving: the flash forward {flash:.3f} ms of {sum(kinds.values()):.3f} ms of kernels "
              f"({flash / sum(kinds.values()):.2%})")
        del enc, pet_dec, generate, out

        rng = np.random.default_rng(2)
        x = torch.from_numpy(rng.random((1, *PARITY_CROP, 1), dtype=np.float32))
        info = torch.from_numpy(rng.random((1, 1, FLAGSHIP_K), dtype=np.float32))
        outs = {}
        for dev in ("cuda", "cpu"):
            enc, t1_dec, pet_dec, _, _ = causal_models(cfg, states, torch.float32, dev)
            before = counts()[0]
            with torch.inference_mode():
                latent = enc(x.to(dev))
                z_mu, z_sigma = causal_task.split_latent(latent)
                z = z_mu + torch.randn(z_sigma.shape, generator=torch.Generator().manual_seed(4)).to(dev) * z_sigma
                outs[dev] = [t.cpu() for t in (latent, t1_dec(z), pet_dec(z, info.to(dev)))]
            check(counts()[0] - before == (CAUSAL_FLASH if dev == "cuda" else 0), f"{dev}: fp32 trio launches")
        errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(outs["cuda"], outs["cpu"])]
        print(f"causal parity: fp32 trio {PARITY_CROP} card vs CPU, max abs err / max|out|: encoder {errs[0]:.3e}, "
              f"T1 decoder {errs[1]:.3e}, PET decoder {errs[2]:.3e} (tol {TOL_MODEL_REL:g})")
        check(all(e <= TOL_MODEL_REL for e in errs) and all(torch.isfinite(t).all().item() for t in outs["cuda"]),
              "the causal trio's card and CPU forwards disagree")
    return launched, fwd_ms


def runtime_build() -> None:
    """Phase 2: the native NIfTI runtime built from its source in the checkout (g++, at first use
    elsewhere; forced here so that its build time is this run's); the compiler, the build time
    and the zlib the library links."""
    from cips_tpu_torch.runtime import native

    t0 = time.perf_counter()
    native.build(force=True)
    seconds = time.perf_counter() - t0
    compiler = subprocess.run([native.CXX, "--version"], capture_output=True, text=True, check=False).stdout
    ldd = subprocess.run(["ldd", native.LIBRARY], capture_output=True, text=True, check=False).stdout
    libz = [line.strip() for line in ldd.splitlines() if "libz." in line]
    print(f"runtime: {native.LIBRARY} built by {compiler.splitlines()[0]} in {seconds:.3f} s "
          f"({' '.join(native.CXX_FLAGS)}, no -march=native), compiled against zlib.h, linked {libz}")
    check(len(libz) == 1, f"the runtime does not link the system zlib: {ldd}")


def pool_rate(tree: dict, csv_path: str) -> float:
    """Phase 6: the native pool's decode rate in volumes a second (two gzipped volumes a sample,
    normalised at CROP, POOL_THREADS threads), every subject of the tree decoded once, nothing
    consuming but the drain itself."""
    from cips_tpu_torch.data.dataset import PairedVolumeDataset
    from cips_tpu_torch.runtime import native

    ds = PairedVolumeDataset(csv_path, pet_dir=tree["pet"], t1_dir=tree["t1"], crop_size=CROP)
    pool = native.NativePrefetcher([p[0] for p in ds.paths], [p[1] for p in ds.paths], CROP, n_threads=POOL_THREADS,
                                   capacity=len(ds))
    t0 = time.perf_counter()
    pool.submit(range(len(ds)))
    got = [pool.next()[0] for _ in ds.paths]
    elapsed = time.perf_counter() - t0
    pool.close()
    check(sorted(got) == list(range(len(ds))), f"the pool returned {got}")
    return 2 * len(ds) / elapsed


@contextlib.contextmanager
def recorded_loaders(made: list):
    """The (train, eval) loaders each trainer builds inside the block (`cli.common.make_loaders`)."""
    from cips_tpu_torch.cli import common

    make_loaders = common.make_loaders

    def recording(*args, **kwargs):
        made.append(make_loaders(*args, **kwargs))
        return made[-1]

    common.make_loaders = recording
    try:
        yield made
    finally:
        common.make_loaders = make_loaders


def import_phase(fa, base: str, trained_pred: str, serve, serve_args: list, tmp: str) -> dict:
    """After phase 6: the trained checkpoint written as the reference writes one (DDP's
    ``module.`` names), imported by `cli.import_torch_ckpt` into a fresh experiment directory
    and served by output_predict --epoch N; its weights and served volumes against the trained
    run's (``trained_pred``). Returns the launches of the serving run."""
    from cips_tpu_torch.cli import import_torch_ckpt
    from cips_tpu_torch.data import nifti
    from cips_tpu_torch.training.common import CheckpointManager

    manager = CheckpointManager(os.path.join(base, "ckpt"))
    epoch = manager.latest_epoch()
    payload = manager.restore(epoch=epoch)
    reference = os.path.join(tmp, "reference_epoch.ckpt")
    torch.save({"unet": {f"module.{k}": v for k, v in payload["unet"].items()},
                "discriminator": {f"module.{k}": v for k, v in payload["discriminator"].items()},
                "epoch": epoch, "eval_loss": 0.5}, reference)
    imported_exp = os.path.join(tmp, "imported_exp")
    t0 = time.perf_counter()
    ckpt_dir = import_torch_ckpt.main(["--torch_ckpt", reference, "--exp_dir", imported_exp, "--use_condition",
                                       "--crop_size", *map(str, CROP)])
    import_s = time.perf_counter() - t0
    restored = CheckpointManager(ckpt_dir).restore(epoch=epoch)
    check(all(torch.equal(restored["unet"][k], v) for k, v in payload["unet"].items()) and
          all(torch.equal(restored["discriminator"][k], v) for k, v in payload["discriminator"].items()),
          "the imported weights differ from the trained ones")
    out_dir = os.path.join(tmp, "pred_imported")
    with uncounted():
        set_counts((0, 0, 0))
        results, _ = serve(serve_args + ["--exp_dir", imported_exp, "--epoch", str(epoch)], out_dir)
        launched = counts()
        norm_path("serving the imported checkpoint", backward=False)
    check(launched == (6, 0, 0), f"serving the imported checkpoint: launches {launched}")
    pairs = []
    for dp, _, fs in os.walk(trained_pred):
        for f in fs:
            if f == "rec.nii.gz":
                rel = os.path.relpath(os.path.join(dp, f), trained_pred)
                pairs.append((nifti.read_array(os.path.join(dp, f)), nifti.read_array(os.path.join(out_dir, rel))))
    check(len(pairs) == N_EVAL, f"expected {N_EVAL} served pairs, found {len(pairs)}")
    diffs = [float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)) for a, b in pairs]
    exact = all(np.array_equal(a, b) for a, b in pairs)
    print(f"import: the trained epoch {epoch} written with module. names, imported in {import_s:.3f} s, served with "
          f"--epoch {epoch}: launches {launched}; volumes {'bit for bit equal to' if exact else 'within'} the trained "
          f"run's (max |diff| / max |vol| {max(diffs):.3e}, tol {TOL_BF16_OUT_REL:g}); metrics {results.summary()}")
    check(max(diffs) <= TOL_BF16_OUT_REL, f"the imported checkpoint serves other volumes: {diffs}")
    return {"launches": launched, "exact": exact}


def remat_flagship_steps(cfg: dict, g_state: dict, batch: dict, card: str) -> None:
    """Phase 7: one bf16 flagship step at batch 2 with remat (G's blocks) and d_remat (D and
    LPIPS in the G step) beside the same step without them, from the same weights (G's
    ``g_state``, D's seeded init) on the same
    batch: the losses within TOL_BF16_OUT_REL, G's and D's gradients within TOL_BF16_GRAD_REL
    of each network's max|grad|, the updated parameters within two Adam steps (2 lr); each
    variant's peak memory and step time (CUDA events over REMAT_STEPS_TIMED steps after one)."""
    from cips_tpu_torch.training import unet_synthesis

    runs = {}
    for remat in (False, True):
        train_cfg = dict(cfg["training"], d_remat=remat)
        g, d, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.bfloat16, device="cuda", remat=remat)
        g.load_state_dict(g_state)  # every weight drawn: a zero output conv would stop G's gradients
        gan = unet_synthesis.init_state(g, d, train_cfg)
        step_fn = unet_synthesis.make_train_step(train_cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first = {k: float(v) for k, v in step_fn(gan, batch).items()}
        grads = {f"{net}.{k}": p.grad.float().clone() for net, m in (("g", g), ("d", d))
                 for k, p in m.named_parameters() if p.grad is not None}
        params = {f"{net}.{k}": p.detach().float().clone() for net, m in (("g", g), ("d", d))
                  for k, p in m.named_parameters()}
        ms = cuda_ms(lambda: step_fn(gan, batch), REMAT_STEPS_TIMED, warmup=0)
        runs[remat] = (first, grads, params, ms, torch.cuda.max_memory_allocated() / 2**30)
        del g, d, gan
    (m0, g0, p0, ms0, peak0), (m1, g1, p1, ms1, peak1) = runs[False], runs[True]
    loss_rel = max(abs(m1[k] - v) / max(abs(v), 1e-12) for k, v in m0.items())
    grad_rel = max(max((g1[k] - g0[k]).abs().max().item() for k in g0 if k.startswith(net)) /
                   max(g0[k].abs().max().item() for k in g0 if k.startswith(net)) for net in ("g.", "d."))
    lr = max(cfg["training"].get("base_lr", 5e-4), cfg["training"].get("disc_lr", 1e-4))
    param_abs = max((p1[k] - p0[k]).abs().max().item() for k in p0)
    exact = all(torch.equal(p1[k], p0[k]) for k in p0)
    print(f"remat step: with remat and d_remat {ms1:.3f} ms, peak {peak1:.2f} GiB; without {ms0:.3f} ms, peak "
          f"{peak0:.2f} GiB (CUDA events over {REMAT_STEPS_TIMED} steps after the compared one, batch {TRAIN_BATCH}, "
          f"bf16); losses within {loss_rel:.3e} (tol {TOL_BF16_OUT_REL:g}), gradients {grad_rel:.3e} of max|grad| "
          f"(tol {TOL_BF16_GRAD_REL:g}), updated parameters {param_abs:.3e} apart ({'bit for bit' if exact else 'tol'} "
          f"{2 * lr:g}); {card}")
    check(loss_rel <= TOL_BF16_OUT_REL and grad_rel <= TOL_BF16_GRAD_REL and param_abs <= 2 * lr,
          "the remat step disagrees with the plain step")


def remat_causal_step(fa, cfg: dict, states: dict, batch: dict) -> tuple:
    """Phase 10: one causal train step at batch 2, bf16, with remat (the trio's resnets; the
    attentions outside, so 7/7/7 launches as without): (ms over 2 steps after one, peak GiB,
    the first step's launches)."""
    from cips_tpu_torch.training import causal_task

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = causal_task.init_state(*causal_models(cfg, states, torch.bfloat16, "cuda", remat=True), cfg["training"])
    step_fn = causal_task.make_train_step(cfg["training"])
    g = torch.Generator("cuda").manual_seed(1)
    before = counts()
    metrics = step_fn(state, batch, g)
    launched = tuple(a - b for a, b in zip(counts(), before))
    check(all(np.isfinite(float(v)) for v in metrics.values()), "non-finite causal remat metrics")
    ms = cuda_ms(lambda: step_fn(state, batch, g), 2, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    return ms, peak, launched


def causal_training(fa, cfg: dict, states: dict, tree: dict, eval_csv: str, args: list, tmp: str,
                    card: str) -> tuple:
    """Phase 10: train_causal at the full volume, bf16, batch 2 (the path's run: every step
    7/7/7 flash launches), --resume, the trained checkpoint served and gen_latents on it;
    the train step timed on one fixed batch, its peak memory and profile, an exact_d_fake
    step; one fp32 step's gradients on the card against the CPU's at PARITY_CROP.
    Returns ((forward, dQ, dK/dV) launches of the path's run, step ms)."""
    from cips_tpu_torch.cli import gen_latents, gen_test_causal, train_causal
    from cips_tpu_torch.training import causal_task
    from cips_tpu_torch.training.common import CheckpointManager

    exp_dir = os.path.join(tmp, "causal_train")
    train_args = args + ["--exp_dir", exp_dir, "--training_info_csv", tree["csv"], "--eval_info_csv", eval_csv,
                         "--dtype", "bf16", "--batch_size", str(CAUSAL_TRAIN_BATCH), "--save_every", "1"]
    steps_per_epoch = N_SUBJECTS // CAUSAL_TRAIN_BATCH
    per_step, norm_steps = [], []
    set_counts((0, 0, 0))
    t0 = time.perf_counter()
    with step_launches(per_step, causal_task, norm_steps):
        trained = train_causal.main(train_args + ["--epochs", str(CAUSAL_EPOCHS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()  # the causal training path's run
    norm_path("causal training", True, norm_steps)
    steps = trained.step
    n = CAUSAL_FLASH
    expected = (n * (steps + CAUSAL_EPOCHS * N_EVAL), n * steps, n * steps)  # eval: one trio forward a subject
    print(f"causal training: train_causal, {steps} steps and {CAUSAL_EPOCHS} evals of {N_EVAL} subjects in "
          f"{wall:.3f} s ({steps / wall:.3f} steps/s end to end: packing, eval and checkpoints included); launches "
          f"{launched}; per step {sorted(set(per_step))}; {card}")
    check(steps == CAUSAL_EPOCHS * steps_per_epoch, f"expected {CAUSAL_EPOCHS * steps_per_epoch} steps, got {steps}")
    check(len(per_step) == steps and set(per_step) == {(n, n, n)},
          f"every causal train step must launch {n} forward, {n} dQ and {n} dK/dV kernels: {per_step}")
    check(launched == expected, f"expected {expected} launches, got {launched}")
    check(os.path.exists(os.path.join(exp_dir, "packed_train", "volumes.npy")), "the default loader packed nothing")
    base = os.path.join(exp_dir, "conditional", "AV45")
    records = [json.loads(line) for line in open(os.path.join(base, "log", "metrics.jsonl"), encoding="utf-8")]
    with open(os.path.join(base, "ckpt", "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    print(f"causal training: metric records {records}; meta.json {meta}")
    check([r["prefix"] for r in records].count("eval") == CAUSAL_EPOCHS and all(
        np.isfinite(v) for r in records for k, v in r.items() if k != "prefix"), "bad causal metric records")
    check(meta["last_epoch"] == CAUSAL_EPOCHS - 1 and np.isfinite(meta["best_metric"]), f"bad meta.json {meta}")
    del trained

    with uncounted():
        set_counts((0, 0, 0))
        resumed = train_causal.main(train_args + ["--epochs", str(CAUSAL_EPOCHS + 1), "--resume"])
        resume_counts = counts()
        norm_path("causal training --resume", backward=True)
        want = (n * (steps_per_epoch + N_EVAL), n * steps_per_epoch, n * steps_per_epoch)
        print(f"causal training: --resume ran epoch {CAUSAL_EPOCHS} to step {resumed.step}; launches {resume_counts}")
        check(resumed.step == steps + steps_per_epoch and resume_counts == want,
              f"causal resume: step {resumed.step}, launches {resume_counts}, expected {want}")
        check(CheckpointManager(os.path.join(base, "ckpt")).latest_epoch() == CAUSAL_EPOCHS, "resume saved no epoch")
        del resumed

        set_counts((0, 0, 0))
        out_dir = os.path.join(tmp, "causal_gen_trained")
        results = gen_test_causal.main(args + ["--exp_dir", exp_dir, "--eval_info_csv", eval_csv, "--dtype", "bf16",
                                               "--batch_size", str(SERVING_BATCH), "--output_dir", out_dir])
        check(counts() == (n * -(-N_EVAL // SERVING_BATCH), 0, 0), f"serving the trained trio: {counts()}")
        norm_path("causal serving the trained trio", backward=False)
        check_causal_outputs(out_dir, N_EVAL)
        print(f"causal training: the trained checkpoint served {N_EVAL} subjects, metrics {results.summary()}")

        set_counts((0, 0, 0))
        lat_dir = os.path.join(tmp, "latents")
        written = gen_latents.main(args + ["--exp_dir", exp_dir, "--eval_info_csv", eval_csv, "--dtype", "bf16",
                                           "--out_dir", lat_dir])
        latents = [np.load(os.path.join(dp, f)) for dp, _, fs in os.walk(lat_dir) for f in fs if f == "latent.npy"]
        latent_shape = (*(c // 4 for c in CROP), 6)
        norm_path("gen_latents", backward=False)
        print(f"causal training: gen_latents wrote {written} latents {[a.shape for a in latents]}; launches "
              f"{counts()}")
        check(written == len(latents) == N_EVAL and all(a.shape == latent_shape and np.isfinite(a).all()
                                                         for a in latents), "bad latents")
        check(counts() == (CAUSAL_ENCODER_FLASH * N_EVAL, 0, 0), f"gen_latents launches {counts()}")

        step_fn = causal_task.make_train_step(cfg["training"])
        batch = synthetic_batch(CROP, CAUSAL_TRAIN_BATCH, "cuda", seed=8)
        state = causal_task.init_state(*causal_models(cfg, states, torch.bfloat16, "cuda"), cfg["training"])
        g = torch.Generator("cuda").manual_seed(1)
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        step_fn(state, batch, g)
        check(tuple(a - b for a, b in zip(counts(), before)) == (n, n, n), "the causal step's launches")
        step_fn(state, batch, g)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        timed = [step_fn(state, batch, g) for _ in range(CAUSAL_STEPS_TIMED)]
        end.record()
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(end) / CAUSAL_STEPS_TIMED
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"causal train step: {step_ms:.3f} ms at batch {CAUSAL_TRAIN_BATCH} bf16 = {1e3 / step_ms:.3f} "
              f"steps/s = {CAUSAL_TRAIN_BATCH * 1e3 / step_ms:.3f} vol/s (CUDA events over {CAUSAL_STEPS_TIMED} "
              f"steps after 2 warm-up, one fixed batch, no data loading; perceptual weight "
              f"{cfg['training']['perceptual_weight']}); peak memory {peak:.2f} GiB of 80, no remat; last metrics "
              f"{ {k: round(float(v), 6) for k, v in timed[-1].items()} }; {card}")
        check(all(np.isfinite(float(v)) for m in timed for v in m.values()), "non-finite causal train-step metrics")
        profile_window(lambda: step_fn(state, batch, g), "causal train step")
        before = counts()
        causal_task.make_train_step(cfg["training"], exact_d_fake=True)(state, batch, g)
        exact = tuple(a - b for a, b in zip(counts(), before))
        print(f"causal train step: with exact_d_fake, launches {exact}")
        check(exact == (2 * n, n, n), f"an exact_d_fake step launched {exact}, expected {(2 * n, n, n)}")
        del state, timed
        remat_ms, remat_peak, remat_launches = remat_causal_step(fa, cfg, states, batch)
        print(f"causal train step with remat (the trio's resnets recomputed, attention outside): {remat_ms:.3f} ms, "
              f"peak memory {remat_peak:.2f} GiB of 80 beside {peak:.2f} GiB without; launches {remat_launches}; "
              f"batch {CAUSAL_TRAIN_BATCH} bf16; {card}")
        check(remat_launches == (n, n, n), f"the causal remat step launched {remat_launches}, expected {(n, n, n)}")

        got = {}
        small = synthetic_batch(PARITY_CROP, 1, "cpu", seed=9)
        with cpu_noise():
            for run, (dev, dtype) in (("cuda", ("cuda", torch.float32)), ("cpu", ("cpu", torch.float32)),
                                      ("cpu f64", ("cpu", torch.float64))):
                state = causal_task.init_state(*causal_models(cfg, states, dtype, dev), cfg["training"])
                before = counts()
                metrics = step_fn(state, {k: v.to(dev) for k, v in small.items()}, torch.Generator().manual_seed(3))
                grown = tuple(a - b for a, b in zip(counts(), before))
                check(grown == ((n, n, n) if dev == "cuda" else (0, 0, 0)), f"{run} causal step launches {grown}")
                got[run] = ({k: float(v) for k, v in metrics.items()},
                            {**{f"{part}.{k}": p.grad.cpu() for part in CAUSAL_PARTS
                                for k, p in state.gen[part].named_parameters()},
                             **{f"discriminator.{k}": p.grad.cpu() for k, p in state.d.named_parameters()}})
                del state
    print(f"causal grads: step metrics card {got['cuda'][0]} vs CPU {got['cpu'][0]}")
    for key, want in got["cpu"][0].items():
        rel = abs(got["cuda"][0][key] - want) / max(abs(want), 1e-12)
        check(rel <= TOL_STEP_METRIC_REL, f"causal train-step {key} card vs CPU: {rel:.3e} > {TOL_STEP_METRIC_REL:g}")
    for part in CAUSAL_PARTS + ("discriminator",):
        keys = [k for k in got["cpu f64"][1] if k.startswith(part + ".")]
        compare_grads_f64(f"causal {part}", *({k: got[run][1][k] for k in keys} for run in ("cuda", "cpu", "cpu f64")))
    return launched, step_ms


def write_converters(path: str) -> str:
    """The MCI converter CSV of the synthetic subjects: odd ones convert (in
    2030, after every scan, so none is dropped), even ones do not."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["Subject", "MCI_converter", "Converter_date"])
        w.writerows([f"sub{i:03d}", i % 2, "2030-01-01" if i % 2 else ""] for i in range(N_SUBJECTS))
    return path


def classifier_batch(shape, batch: int, device: str, seed: int) -> dict:
    """{"imgs": (B, *shape, 2) PET and T1, "info": (B, 1, K), "labels": both classes}."""
    rng = np.random.default_rng(seed)
    return {"imgs": torch.from_numpy(rng.random((batch, *shape, 2), dtype=np.float32)).to(device),
            "info": torch.from_numpy(rng.random((batch, 1, FLAGSHIP_K), dtype=np.float32)).to(device),
            "labels": torch.arange(batch, device=device) % 2}


def classifier_phase(fa, tree: dict, eval_csv: str, fake_pet_dir: str, tmp: str, card: str) -> dict:
    """Phase 11: train_classifier at full width and the full volume, bf16, batch 2, PET + T1 +
    covariates, for CLASSIFIER_EPOCHS epochs with eval and checkpoints (the path's run: every step
    4/4/4 flash launches); test_mci --best on real PET, then on the PET that the flagship's serving
    phase synthesized (synthesize, then classify), each run's launches counted from 0; the forward's
    and the train step's time, peak memory and profile; the fp32 forward and one fp32 step's
    gradients on the card against the CPU at PARITY_CROP. Returns the paths' launches and times."""
    from cips_tpu_torch.cli import test_mci, train_classifier
    from cips_tpu_torch.cli.common import load_config
    from cips_tpu_torch.training import classifier_task

    n = CLASSIFIER_FLASH
    exp_dir = os.path.join(tmp, "cls_exp")
    args = ["--PET_dir", tree["pet"], "--T1_dir", tree["t1"], "--min_and_max", tree["stats"], "--crop_size",
            *map(str, CROP), "--device", "cuda", "--dtype", "bf16", "--batch_size", str(CLASSIFIER_BATCH),
            "--converter_csv", write_converters(os.path.join(tmp, "mci_converters.csv")), "--use_T1",
            "--use_tabular_info"]
    per_step, norm_steps = [], []
    set_counts((0, 0, 0))
    t0 = time.perf_counter()
    with step_launches(per_step, classifier_task, norm_steps):
        trained = train_classifier.main(args + ["--exp_dir", exp_dir, "--training_info_csv", tree["csv"],
                                                "--eval_info_csv", eval_csv, "--epochs", str(CLASSIFIER_EPOCHS),
                                                "--save_every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()  # the classifier's training path
    norm_path("classifier training", True, norm_steps)
    steps = trained.step
    evals = CLASSIFIER_EPOCHS * -(-N_EVAL // CLASSIFIER_BATCH)  # eval forwards
    expected = (n * (steps + evals), n * steps, n * steps)
    print(f"classifier training: train_classifier, {steps} steps and {CLASSIFIER_EPOCHS} evals of {N_EVAL} "
          f"sessions in {wall:.3f} s ({steps / wall:.3f} steps/s end to end: packing, eval and checkpoints "
          f"included); launches {launched}; per step {sorted(set(per_step))}; {card}")
    check(steps == CLASSIFIER_EPOCHS * (N_SUBJECTS // CLASSIFIER_BATCH), f"classifier steps {steps}")
    check(len(per_step) == steps and set(per_step) == {(n, n, n)},
          f"every classifier train step must launch {n} forward, {n} dQ and {n} dK/dV kernels: {per_step}")
    check(launched == expected, f"expected {expected} classifier launches, got {launched}")
    run = os.path.join(exp_dir, "pet_t1_tab")
    records = [json.loads(line) for line in open(os.path.join(run, "log", "metrics.jsonl"), encoding="utf-8")]
    with open(os.path.join(run, "ckpt", "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    print(f"classifier training: metric records {records}; meta.json {meta}")
    check([r["prefix"] for r in records] == ["training", "eval"] * CLASSIFIER_EPOCHS, "classifier metric records")
    check(all(np.isfinite(r[k]) for r in records if r["prefix"] == "eval" for k in ("auc", "f1", "accuracy")),
          "non-finite classifier eval metrics")
    check(meta["last_epoch"] == CLASSIFIER_EPOCHS - 1 and np.isfinite(meta["best_metric"]), f"bad meta.json {meta}")
    del trained

    tested = {}
    for name, extra in (("real", []), ("synthesized", ["--test_fake_pet", "--fake_pet_dir", fake_pet_dir])):
        set_counts((0, 0, 0))
        t0 = time.perf_counter()
        m = test_mci.main(args + ["--exp_dir", run, "--eval_info_csv", tree["csv"], "--best", *extra])
        torch.cuda.synchronize()
        tested[name] = counts()  # the test path on real, then synthesized PET
        norm_path(f"classifier test ({name} PET)", backward=False)
        print(f"classifier test ({name} PET): test_mci --best over {N_SUBJECTS} sessions in "
              f"{time.perf_counter() - t0:.3f} s, metrics {m}; launches {tested[name]}")
        check(tested[name] == (n * N_SUBJECTS, 0, 0), f"test_mci on {name} PET launched {tested[name]}")
        check(all(np.isfinite(m[k]) for k in ("accuracy", "precision", "recall", "f1", "auc")),
              f"test_mci on {name} PET: {m}")

    cfg = load_config(None, "training_atten.json")

    def build(shape, dtype, device):
        return classifier_task.build_model(cfg, in_channels=2, input_shape=shape, n_covariates=FLAGSHIP_K,
                                           dtype=dtype, device=device, seed=5)

    with uncounted():
        model = build(CROP, torch.bfloat16, "cuda")
        batch = classifier_batch(CROP, CLASSIFIER_BATCH, "cuda", seed=11)
        predict = classifier_task.make_predict_fn(model, use_tabular=True)
        before = counts()[0]
        logits = predict(batch)
        check(counts()[0] - before == n and logits.shape == (CLASSIFIER_BATCH, 2)
              and torch.isfinite(logits).all().item(), "the classifier forward's launches or logits")
        torch.cuda.reset_peak_memory_stats()
        fwd_ms = cuda_ms(lambda: predict(batch), 5, warmup=2)
        print(f"classifier: forward {fwd_ms:.3f} ms at batch {CLASSIFIER_BATCH} bf16, full volume {CROP}, PET + T1 + "
              f"{FLAGSHIP_K} covariates (CUDA events over 5 after 2), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {n} flash forwards a forward; {card}")
        kinds = profile_window(lambda: predict(batch), "classifier forward")
        print(f"classifier: the flash forward {kinds.get(KERNEL_KINDS[0][0], 0.0):.3f} ms of "
              f"{sum(kinds.values()):.3f} ms of kernels")
        state = classifier_task.init_state(model, cfg["training"]["base_lr"])
        step_fn = classifier_task.make_train_step(use_tabular=True)
        torch.cuda.reset_peak_memory_stats()
        before = counts()
        step_fn(state, batch)
        check(tuple(a - b for a, b in zip(counts(), before)) == (n, n, n), "the classifier step's launches")
        timed = []
        step_ms = cuda_ms(lambda: timed.append(step_fn(state, batch)), CLASSIFIER_STEPS_TIMED, warmup=1)
        timed = timed[1:]
        print(f"classifier train step: {step_ms:.3f} ms at batch {CLASSIFIER_BATCH} bf16 = {1e3 / step_ms:.3f} steps/s "
              f"(CUDA events over {CLASSIFIER_STEPS_TIMED} after 2 warm-up, one fixed batch, dropout on); peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of 80, no remat; last loss "
              f"{float(timed[-1]['ce_loss']):.6f}; {card}")
        check(all(np.isfinite(float(m["ce_loss"])) for m in timed), "non-finite classifier losses")
        kinds = profile_window(lambda: step_fn(state, batch), "classifier train step")
        flash = sum(ms for kind, ms in kinds.items() if kind in (KERNEL_KINDS[0][0], KERNEL_KINDS[1][0]))
        print(f"classifier train step: flash forward and backward {flash:.3f} ms of {sum(kinds.values()):.3f} ms "
              f"of kernels ({flash / sum(kinds.values()):.2%})")
        del model, state, timed

        weights = random_state_dict(build(PARITY_CROP, torch.float32, "cpu"), seed=30)
        small = classifier_batch(PARITY_CROP, CLASSIFIER_BATCH, "cpu", seed=12)
        got = {}
        for run_name, (dev, dtype) in (("cuda", ("cuda", torch.float32)), ("cpu", ("cpu", torch.float32)),
                                       ("cpu f64", ("cpu", torch.float64))):
            model = build(PARITY_CROP, dtype, dev)
            model.load_state_dict(weights)
            on_dev = {k: v.to(dev) for k, v in small.items()}
            before = counts()
            logits = classifier_task.make_predict_fn(model, use_tabular=True)(on_dev).cpu()
            state = classifier_task.init_state(model)
            metrics = classifier_task.make_train_step(use_tabular=True, dropout=False)(state, on_dev)
            grown = tuple(a - b for a, b in zip(counts(), before))
            check(grown == ((2 * n, n, n) if dev == "cuda" else (0, 0, 0)), f"{run_name} classifier launches {grown}")
            got[run_name] = (logits, float(metrics["ce_loss"]),
                             {k: p.grad.cpu() for k, p in state.model.named_parameters()})
            del model, state
    rel = ((got["cuda"][0] - got["cpu"][0]).abs().max() / got["cpu"][0].abs().max()).item()
    loss_rel = abs(got["cuda"][1] - got["cpu"][1]) / abs(got["cpu"][1])
    print(f"classifier parity: fp32 logits {PARITY_CROP} card vs CPU {rel:.3e} of max|out| (tol {TOL_MODEL_REL:g}); "
          f"loss card {got['cuda'][1]:.6f} vs CPU {got['cpu'][1]:.6f} ({loss_rel:.3e}, tol {TOL_STEP_METRIC_REL:g})")
    check(rel <= TOL_MODEL_REL and loss_rel <= TOL_STEP_METRIC_REL, "the classifier's card and CPU runs disagree")
    compare_grads_f64("classifier", *(got[run][2] for run in ("cuda", "cpu", "cpu f64")))
    return {"training": launched, "test": tested, "forward_ms": fwd_ms, "step_ms": step_ms}


@contextlib.contextmanager
def cpu_latents():
    """BMGAN draws its latent on the CPU from the generator it is given and moves it to the
    device: a card run and a CPU run from one seed see the same z."""
    from cips_tpu_torch.training import bmgan_task

    sample_latent = bmgan_task.sample_latent
    bmgan_task.sample_latent = lambda shape, dtype, device, generator: \
        torch.randn(shape, generator=generator).to(device, dtype)
    try:
        yield
    finally:
        bmgan_task.sample_latent = sample_latent


def bmgan_phase(fa, tree: dict, eval_csv: str, tmp: str, card: str) -> dict:
    """Phase 12: train_bmgan at the default widths and the full volume, bf16, batch 2, for
    BMGAN_EPOCHS epochs with eval and checkpoints (no attention: no kernel of this port
    launches), --resume for one more epoch, gen_test_bmgan on the trained checkpoint; the train
    step's time, peak memory and profile on one fixed batch; one fp32 step's gradients on the
    card against the CPU's at BMGAN_PARITY_CROP. Returns the times."""
    from cips_tpu_torch.cli import gen_test_bmgan, train_bmgan
    from cips_tpu_torch.data import nifti
    from cips_tpu_torch.losses import lsgan_discriminator_loss
    from cips_tpu_torch.models import bmgan
    from cips_tpu_torch.training import bmgan_task
    from cips_tpu_torch.training.common import CheckpointManager

    exp_dir = os.path.join(tmp, "bmgan_exp")
    args = ["--PET_dir", tree["pet"], "--T1_dir", tree["t1"], "--crop_size", *map(str, CROP), "--device", "cuda",
            "--dtype", "bf16", "--batch_size", str(BMGAN_BATCH), "--exp_dir", exp_dir]
    train_args = args + ["--training_info_csv", tree["csv"], "--eval_info_csv", eval_csv, "--save_every", "1"]
    steps_per_epoch = N_SUBJECTS // BMGAN_BATCH
    set_counts((0, 0, 0))
    t0 = time.perf_counter()
    trained = train_bmgan.main(train_args + ["--epochs", str(BMGAN_EPOCHS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    norm_path("bmgan training", backward=True)
    steps = trained.step
    print(f"bmgan training: train_bmgan, {steps} steps and {BMGAN_EPOCHS} evals of {N_EVAL} subjects in {wall:.3f} s "
          f"({steps / wall:.3f} steps/s end to end: packing, eval and checkpoints of "
          f"{sum(p.numel() for p in trained.g.parameters()) / 1e6:.1f}M generator parameters included); batch "
          f"{BMGAN_BATCH}, bf16; launches {counts()} (no attention); {card}")
    check(steps == BMGAN_EPOCHS * steps_per_epoch and counts() == (0, 0, 0), f"bmgan steps {steps}, {counts()}")
    records = [json.loads(line) for line in open(os.path.join(exp_dir, "log", "metrics.jsonl"), encoding="utf-8")]
    with open(os.path.join(exp_dir, "ckpt", "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    print(f"bmgan training: metric records {records}; meta.json {meta}")
    check([r["prefix"] for r in records].count("eval") == BMGAN_EPOCHS and all(
        np.isfinite(v) for r in records for k, v in r.items() if k != "prefix"), "bad bmgan metric records")
    check(meta["last_epoch"] == BMGAN_EPOCHS - 1 and np.isfinite(meta["best_metric"]), f"bad meta.json {meta}")
    del trained

    resumed = train_bmgan.main(train_args + ["--epochs", str(BMGAN_EPOCHS + 1), "--resume"])
    print(f"bmgan training: --resume ran epoch {BMGAN_EPOCHS} to step {resumed.step}")
    check(resumed.step == (BMGAN_EPOCHS + 1) * steps_per_epoch, f"bmgan resume: step {resumed.step}")
    check(CheckpointManager(os.path.join(exp_dir, "ckpt")).latest_epoch() == BMGAN_EPOCHS, "resume saved no epoch")
    del resumed

    out_dir = os.path.join(tmp, "bmgan_gen")
    t0 = time.perf_counter()
    results = gen_test_bmgan.main(args + ["--eval_info_csv", eval_csv, "--best", "--output_dir", out_dir])
    torch.cuda.synchronize()
    recs = [os.path.join(dp, f) for dp, _, fs in os.walk(out_dir) for f in fs if f == "rec.nii.gz"]
    print(f"bmgan serving: gen_test_bmgan on the trained checkpoint, {len(recs)} volumes in "
          f"{time.perf_counter() - t0:.3f} s, metrics {results.summary()}")
    check(len(recs) == N_EVAL and all(np.isfinite(v) for v in results.summary().values()), "bad bmgan generation")
    for path in recs:
        rec = nifti.read_array(path)
        check(rec.shape == CROP and np.isfinite(rec).all() and np.abs(rec).max() <= 1 and rec.std() > 0,
              f"{path}: bad bmgan output")

    models = bmgan_task.build_models(dtype=torch.bfloat16, device="cuda", seed=3)
    state = bmgan_task.init_state(*models)
    step_fn = bmgan_task.make_train_step()
    batch = synthetic_batch(CROP, BMGAN_BATCH, "cuda", seed=13)
    g = torch.Generator("cuda").manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    timed = []
    step_ms = cuda_ms(lambda: timed.append(step_fn(state, batch, g)), BMGAN_STEPS_TIMED, warmup=2)
    timed = timed[2:]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"bmgan train step: {step_ms:.3f} ms at batch {BMGAN_BATCH} bf16 = {1e3 / step_ms:.3f} steps/s = "
          f"{BMGAN_BATCH * 1e3 / step_ms:.3f} vol/s (CUDA events over {BMGAN_STEPS_TIMED} steps after 2 warm-up, one "
          f"fixed batch, G + E + D steps, LPIPS alex at weight 8); peak memory {peak:.2f} GiB of 80, no remat; last "
          f"metrics { {k: round(float(v), 6) for k, v in timed[-1].items()} }; {card}")
    check(all(np.isfinite(float(v)) for m in timed for v in m.values()), "non-finite bmgan train-step metrics")
    profile_window(lambda: step_fn(state, batch, g), "bmgan train step")
    del models, state, timed, batch

    # One step from the same weights, batch and latent in four runs. The fp32 step is too coarse
    # to pin the function (TOL_BMGAN_F32_GRAD_NORM), so the card's fp64 step is held to the CPU's
    # fp64 step tensor by tensor at TOL_GRAD_MODEL_REL, each network's fp32 gradient on the card
    # to the CPU's fp64 one in the 2-norm at its TOL_BMGAN_F32_GRAD_NORM, and, before the fp32
    # steps, G's forward and D's gradients on one fixed input ([t1; pet]) card against CPU.
    built = bmgan_task.build_models(dtype=torch.float32, input_shape=BMGAN_PARITY_CROP, device="cpu", seed=4)
    weights = [random_state_dict(model, seed=40 + i) for i, model in enumerate(built[:3])] + [built[3].state_dict()]
    del built
    small = synthetic_batch(BMGAN_PARITY_CROP, 1, "cpu", seed=14)
    got, alone = {}, {}
    with cpu_latents():
        for run_name, dev, dtype in (("card", "cuda", torch.float32), ("card f64", "cuda", torch.float64),
                                     ("cpu", "cpu", torch.float32), ("cpu f64", "cpu", torch.float64)):
            models = bmgan_task.build_models(dtype=dtype, input_shape=BMGAN_PARITY_CROP, device=dev)
            for model, state_dict in zip(models, weights):
                model.load_state_dict(state_dict)
            if dtype == torch.float32:
                with torch.no_grad():
                    z = bmgan_task.sample_latent((1, bmgan.LATENT_DIM), dtype, dev, torch.Generator().manual_seed(5))
                    fake = models[0](small["t1"].to(dev), z).cpu()
                logits_fake, logits_real = models[2](torch.cat([small["t1"], small["pet"]]).to(dev)).chunk(2, dim=0)
                lsgan_discriminator_loss(logits_fake, logits_real).backward()
                alone[run_name] = (fake, {k: p.grad.cpu() for k, p in models[2].named_parameters()})
                models[2].zero_grad(set_to_none=True)
            state = bmgan_task.init_state(*models)
            t0 = time.perf_counter()
            metrics = step_fn(state, {k: v.to(dev) for k, v in small.items()}, torch.Generator().manual_seed(5))
            got[run_name] = ({k: float(v) for k, v in metrics.items()},
                             {f"{part}.{k}": p.grad.cpu() for part in ("g", "e", "d")
                              for k, p in getattr(state, part).named_parameters()})
            print(f"bmgan grads: {run_name} step at {BMGAN_PARITY_CROP} in {time.perf_counter() - t0:.1f} s, "
                  f"metrics {got[run_name][0]}")
            del models, state
    for card_run, cpu_run in (("card", "cpu"), ("card f64", "cpu f64")):
        for key, want in got[cpu_run][0].items():
            rel = abs(got[card_run][0][key] - want) / max(abs(want), 1e-12)
            check(rel <= TOL_STEP_METRIC_REL, f"bmgan {card_run} step {key} vs CPU: {rel:.3e} > {TOL_STEP_METRIC_REL:g}")
    fake_card, fake_cpu = alone["card"][0], alone["cpu"][0]
    rel = (fake_card - fake_cpu).abs().max().item() / fake_cpu.abs().max().item()
    print(f"bmgan generator fp32 forward, card vs CPU: {rel:.3e} of max|out| (tol {TOL_MODEL_REL:g})")
    check(rel <= TOL_MODEL_REL, f"bmgan generator fp32 forward disagrees between card and CPU: {rel:.3e}")
    compare_grads("bmgan discriminator fp32 on [t1; pet], card vs CPU", alone["card"][1], alone["cpu"][1])
    ref = got["cpu f64"][1]
    for part, label in (("g", "generator"), ("e", "encoder"), ("d", "discriminator")):
        keys = [k for k in ref if k.startswith(part + ".")]
        compare_grads(f"bmgan {label} fp64, card vs CPU", *({k: got[run][1][k] for k in keys}
                                                           for run in ("card f64", "cpu f64")))
        want = torch.cat([ref[k].double().flatten() for k in keys])
        dist = {run: ((torch.cat([got[run][1][k].double().flatten() for k in keys]) - want).norm() / want.norm()).item()
                for run in ("card", "cpu")}
        print(f"grads bmgan {label} fp32: the whole gradient's 2-norm distance to the CPU's fp64 step: card "
              f"{dist['card']:.3e}, CPU {dist['cpu']:.3e} (tol {TOL_BMGAN_F32_GRAD_NORM[part]:g})")
        check(dist["card"] <= TOL_BMGAN_F32_GRAD_NORM[part],
              f"bmgan {label}: the card's fp32 gradient is {dist['card']:.3e} from fp64")
    return {"step_ms": step_ms, "peak_gib": peak}


def head_phantom(zyx_mm: torch.Tensor) -> torch.Tensor:
    """tests/test_registration_geometry.py's brain-like phantom (an ellipsoid shell, its interior and
    three blobs) made 3x larger, a head of about 130 x 170 x 145 mm; ``zyx_mm`` is (..., 3) in mm."""
    z, y, x = (zyx_mm[..., i] / 3.0 for i in range(3))
    r2 = (z / 22.0) ** 2 + (y / 28.0) ** 2 + (x / 24.0) ** 2
    val = 0.6 * torch.exp(-torch.clamp_min(r2 - 0.75, 0.0) / 0.05)
    for (cz, cy, cx), s, a in (((0.0, 8.0, -6.0), 7.0, 0.9), ((5.0, -10.0, 4.0), 5.0, 0.7),
                               ((-8.0, 2.0, 9.0), 4.0, 1.0)):
        val = val + a * torch.exp(-((z - cz) ** 2 + (y - cy) ** 2 + (x - cx) ** 2) / (2 * s * s))
    return (val + 0.8 * torch.exp(-((r2 - 0.75) ** 2) / 0.02)).float()


def rot_xyz(degrees) -> np.ndarray:
    """Rotation about x, then y, then z (degrees), in NIfTI's xyz order."""
    rx, ry, rz = np.deg2rad(degrees)
    mx = np.array([[1, 0, 0], [0, np.cos(rx), -np.sin(rx)], [0, np.sin(rx), np.cos(rx)]])
    my = np.array([[np.cos(ry), 0, np.sin(ry)], [0, 1, 0], [-np.sin(ry), 0, np.cos(ry)]])
    mz = np.array([[np.cos(rz), -np.sin(rz), 0], [np.sin(rz), np.cos(rz), 0], [0, 0, 1]])
    return mz @ my @ mx


def centered_affine(shape_zyx, spacing_xyz, degrees=(0.0, 0.0, 0.0), shift_mm=(0.0, 0.0, 0.0)) -> np.ndarray:
    """A voxel -> mm NIfTI affine whose center voxel lands at ``shift_mm``."""
    a = np.eye(4)
    a[:3, :3] = rot_xyz(degrees) @ np.diag(spacing_xyz)
    a[:3, 3] = np.asarray(shift_mm) - a[:3, :3] @ ((np.asarray(shape_zyx[::-1], np.float64) - 1) / 2)
    return a


def sample_head(shape_zyx, affine_xyz, device, motion=np.eye(4)) -> torch.Tensor:
    """The phantom at every voxel of a (z, y, x) grid: voxel -> mm by ``affine_xyz``, then ``motion``."""
    m = torch.tensor(motion @ affine_xyz, dtype=torch.float64, device=device)
    zz, yy, xx = torch.meshgrid(*(torch.arange(s, dtype=torch.float64, device=device) for s in shape_zyx),
                                indexing="ij")
    xyz = xx[..., None] * m[:3, 0] + yy[..., None] * m[:3, 1] + zz[..., None] * m[:3, 2] + m[:3, 3]
    return head_phantom(xyz.flip(-1))


def toolchain_case(i: int, device, scale: int = 1, seed: int = 0) -> dict:
    """Subject ``i`` of the raw tree, every grid ``scale`` times coarser: T1 and PET (numpy, (z, y, x)),
    their true affines and the ones written in their headers, and the true motion."""
    g = torch.Generator(device=device).manual_seed(seed + i)
    t1_shape = tuple(s // scale for s in TOOLCHAIN_T1)
    degrees, mm = TOOLCHAIN_MOTION[i]
    motion = np.eye(4)
    motion[:3, :3], motion[:3, 3] = rot_xyz(degrees), mm
    if i < 2:  # oblique scanner headers, PET on its own grid with its field of view shifted: the physical path
        t1_aff = centered_affine(t1_shape, [s * scale for s in TOOLCHAIN_T1_MM], (2.0, -1.5, 1.0))
        pet_shape = tuple(s // scale for s in TOOLCHAIN_PET)
        pet_aff = centered_affine(pet_shape, [s * scale for s in TOOLCHAIN_PET_MM], (-1.0, 2.0, -2.5), (3.0, -4.0, 2.0))
        headers = (t1_aff, pet_aff)
    else:  # identity headers, the PET on the T1's (isotropic) grid: the voxel path
        t1_aff = centered_affine(t1_shape, (float(scale),) * 3)
        pet_shape, pet_aff = t1_shape, t1_aff
        headers = (np.eye(4), np.eye(4))

    def noisy(vol):
        inside = vol > 0.05
        return torch.where(inside, vol + 0.01 * torch.randn(vol.shape, generator=g, device=device), 0.0)

    t1 = sample_head(t1_shape, t1_aff, device)
    zz, yy, xx = torch.meshgrid(*(torch.linspace(-1, 1, s, device=device) for s in t1_shape), indexing="ij")
    t1 = noisy(t1 * torch.exp(0.25 * (0.8 * xx + 0.5 * yy - 0.4 * zz)))  # the bias field N4 exists for
    pet = noisy(sample_head(pet_shape, pet_aff, device, motion))
    return {"t1": t1.cpu().numpy(), "pet": pet.cpu().numpy(), "t1_aff": t1_aff, "pet_aff": pet_aff,
            "headers": headers, "motion": (degrees, mm)}


def write_raw_tree(root: str) -> dict:
    """{root}/{t1,pet}/adni{i}/{date}/img.nii (uncompressed) for the 4 subjects, and an ADNIMERGE-style CSV
    (covariates and diagnoses of these subjects and of write_tree's)."""
    from cips_tpu_torch.data import nifti

    cases = []
    for i in range(len(TOOLCHAIN_MOTION)):
        case = toolchain_case(i, "cuda")
        for kind, date, header in (("t1", "2015-01-01", case["headers"][0]), ("pet", "2015-01-20", case["headers"][1])):
            spacing = np.sqrt((header[:3, :3] ** 2).sum(axis=0)) if i < 2 else (1.0,) * 3
            nifti.write(os.path.join(root, kind, f"adni{i}", date, "img.nii"),
                        nifti.NiftiImage(data=case[kind], affine=header, spacing=tuple(map(float, spacing))))
        cases.append(case)
    rows = ["PTID,EXAMDATE,ABETA,Age,Sex,APOE4,PTEDUCAT,DX,PTGENDER,AGE"]
    for i, subj in enumerate([f"adni{i}" for i in range(len(cases))] + [f"sub{i:03d}" for i in range(N_SUBJECTS)]):
        sex = "Female" if i % 2 else "Male"
        rows.append(f"{subj},2014-12-15,{600 + 90 * i},{70 + i},{sex},{i % 3},{12 + i % 8},{('CN', 'MCI')[i % 2]},"
                    f"{sex},{70 + i}")
        rows.append(f"{subj},2016-06-01,{'<200' if i % 3 == 0 else 700},{71 + i},{sex},{i % 3},{12 + i % 8},"
                    f"{('MCI', 'AD', 'CN')[i % 3]},{sex},{71 + i}")
    with open(os.path.join(root, "adnimerge.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    return {"t1": os.path.join(root, "t1"), "pet": os.path.join(root, "pet"),
            "adnimerge": os.path.join(root, "adnimerge.csv"), "cases": cases}


def masked_corr(a: np.ndarray, b: np.ndarray, mask: np.ndarray) -> float:
    a, b = a[mask].astype(np.float64), b[mask].astype(np.float64)
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum() + 1e-9))


def write_seg_tree(root: str, pred_dir: str) -> str:
    """A FastSurfer-style aseg in conformed space (256^3, uint8) for every session of ``pred_dir``:
    cortex (3, 42) over the middle of the conformed PET, cerebellum (8, 47) below it. One file,
    linked into every session."""
    from cips_tpu_torch.data import nifti

    seg = np.zeros(SEG_SHAPE, np.uint8)
    seg[80:176, 80:176, 80:128] = 3
    seg[80:176, 80:176, 128:176] = 42
    seg[176:208, 90:170, 80:128] = 8
    seg[176:208, 90:170, 128:176] = 47
    first = None
    for subject in sorted(os.listdir(pred_dir)):
        for date in sorted(os.listdir(os.path.join(pred_dir, subject))):
            path = os.path.join(root, subject, date, "aseg.nii.gz")
            if first is None:
                nifti.write(path, seg)
                first = path
            else:
                os.makedirs(os.path.dirname(path))
                os.symlink(first, path)
    return root


def rescaled_tree(pred_dir: str, root: str) -> str:
    """{root}/{subject}/{date}/rec.nii.gz: each synthesized PET of ``pred_dir`` mapped linearly onto its
    real PET's range (min to max). A generator with random weights gives a PET whose reference region
    may average at or under 0; its SUVR would then be the ROI mean over compute_suvr's 1e-12 floor."""
    from cips_tpu_torch.data import nifti

    for subject in sorted(os.listdir(pred_dir)):
        for date in sorted(os.listdir(os.path.join(pred_dir, subject))):
            rec, ori = (nifti.read_array(os.path.join(pred_dir, subject, date, n)).astype(np.float64)
                        for n in ("rec.nii.gz", "ori.nii.gz"))
            rec = ori.min() + (rec - rec.min()) / (rec.max() - rec.min()) * (ori.max() - ori.min())
            nifti.write(os.path.join(root, subject, date, "rec.nii.gz"), rec.astype(np.float32))
    return root


def link_tree(src: str, dst: str, name: str) -> str:
    """{dst}/{subject}/{date}/{name} linked to the same file of ``src`` (a one-file-a-session tree)."""
    for subject in sorted(os.listdir(src)):
        for date in sorted(os.listdir(os.path.join(src, subject))):
            os.makedirs(os.path.join(dst, subject, date))
            os.symlink(os.path.join(src, subject, date, name), os.path.join(dst, subject, date, name))
    return dst


def suvr_rows(path: str) -> dict:
    with open(path, newline="", encoding="utf-8") as f:
        return {(r["Subject"], r["date"]): float(r["suvr"]) for r in csv.DictReader(f)}


def close_json(got: dict, want: dict, label: str) -> float:
    """The metric tool's JSON against another run's: each value within TOL_TOOLCHAIN_REL of its mean's
    magnitude (a std's error is its values' error); returns the largest such distance."""
    check(list(got) == list(want) and got["count"] == want["count"] > 0, f"{label}: {got} vs {want}")
    worst = max(abs(got[k] - want[k]) / abs(want[k.replace("_std", "_mean")]) for k in want)
    check(worst <= TOL_TOOLCHAIN_REL, f"{label}: {got} vs {want}, {worst:.3e} > {TOL_TOOLCHAIN_REL:g}")
    return worst


@contextlib.contextmanager
def registration_clock(records: list):
    """Each registration the `reg` subcommand runs: (which, seconds, result), the card synchronised."""
    from cips_tpu_torch.data import preprocess

    saved = {name: getattr(preprocess, name) for name in ("register_rigid", "register_rigid_physical")}

    def timed(name):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = saved[name](*args, **kwargs)
            torch.cuda.synchronize()
            records.append((name, time.perf_counter() - t0, result))
            return result
        return wrapper

    try:
        for name in saved:
            setattr(preprocess, name, timed(name))
        yield records
    finally:
        for name, fn in saved.items():
            setattr(preprocess, name, fn)


def toolchain_phase(pred_dir: str, tree_csv: str, tmp: str, card: str) -> dict:
    """The offline tool-chain through its CLIs on the card, each held to its CPU run where it computes
    on the device. Returns each subcommand's wall time (s)."""
    from cips_tpu_torch.cli import metrics as metrics_cli
    from cips_tpu_torch.cli import postprocess, preprocess
    from cips_tpu_torch.data import nifti
    from cips_tpu_torch.data.dataset import PackedDataset
    from cips_tpu_torch.eval.pair_metrics import METRIC_SHAPE
    from cips_tpu_torch.ops.registration import apply_transform, register_rigid_physical

    times = {}
    t0 = time.perf_counter()
    raw = write_raw_tree(os.path.join(tmp, "raw"))
    times["raw tree (phantoms on the device, .nii writes)"] = time.perf_counter() - t0
    work = os.path.join(tmp, "work")
    def run(label, main, argv):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = main(argv)
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - start
        text = out.getvalue()
        print(f"toolchain {label}: {times[label]:.3f} s; " + " | ".join(text.strip().splitlines()[-3:]), flush=True)
        return result, text

    w = functools.partial(os.path.join, work)
    trees = ["--PET_dir", raw["pet"], "--T1_dir", raw["t1"]]
    _, text = run("preprocess pair", preprocess.main, ["pair"] + trees + ["--out_dir", w("pairs")])
    check(text.startswith("4 pairs"), f"pair: {text}")
    _, text = run("preprocess audit", preprocess.main, ["audit"] + trees)
    check("0 unpaired" in text, f"audit: {text}")
    _, text = run("preprocess merge-csf", preprocess.main, ["merge-csf", "--manifest", w("pairs", "pair_all.csv"),
                                                            "--adnimerge_csv", raw["adnimerge"],
                                                            "--out_csv", w("pairs", "pair_all_csf.csv")])
    check(text.startswith("4/4 rows"), f"merge-csf: {text}")
    run("preprocess stats", preprocess.main, ["stats", "--manifest", w("pairs", "pair_all_csf.csv"),
                                              "--out_json", w("stats.json")])
    registrations = []
    with registration_clock(registrations):
        run("preprocess reg (ncc, 4 pairs)", preprocess.main, ["reg"] + trees + ["--out_dir", w("reg")])
        os.makedirs(os.path.join(tmp, "raw", "pet_mi"))
        os.symlink(os.path.join(raw["pet"], "adni0"), os.path.join(tmp, "raw", "pet_mi", "adni0"))
        run("preprocess reg --metric mi (1 pair)", preprocess.main,
            ["reg", "--PET_dir", os.path.join(tmp, "raw", "pet_mi"), "--T1_dir", raw["t1"], "--out_dir", w("reg_mi"),
             "--metric", "mi"])
    run("preprocess downsample (N4, 1.5 mm, crop (96, 128, 96))", preprocess.main,
        ["downsample", "--T1_dir", raw["t1"], "--out_dir", w("ds")])
    _, text = run("preprocess mask", preprocess.main, ["mask", "--PET_dir", w("reg"), "--T1_dir", raw["t1"],
                                                      "--out_dir", w("masked")])
    check(text.startswith("masked 4 PET"), f"mask: {text}")
    _, text = run("preprocess simple-csv", preprocess.main, ["simple-csv", "--image_dir", raw["t1"],
                                                             "--out_dir", w("simple")])
    check(text.startswith("4 sessions"), f"simple-csv: {text}")
    run("preprocess pack", preprocess.main, ["pack", "--manifest", w("pairs", "pair_all_csf.csv"), "--PET_dir", w("masked"),
                                             "--T1_dir", w("ds"), "--out_dir", w("packed"), "--with_covariates",
                                             "--min_and_max", w("stats.json")])

    # each motion recovered: the warped PET's masked correlation with the T1 above the header-only one and 0.93
    check(len(registrations) == 5, f"expected 5 registrations, got {len(registrations)}")
    for (name, seconds, result), (i, metric) in zip(registrations, [(i, "ncc") for i in range(4)] + [(0, "mi")]):
        case = raw["cases"][i]
        out = nifti.read_array(w("reg_mi" if metric == "mi" else "reg", f"adni{i}", "2015-01-20", "pet_reg.nii.gz"))
        mask = case["t1"] > 0.2
        if i < 2:
            pet, t1 = (torch.from_numpy(case[k]).cuda() for k in ("pet", "t1"))
            header = register_rigid_physical(pet, t1, *case["headers"][::-1], pyramid=(2,), iters_per_level=0)
            base_vol = apply_transform(pet, header.matrix, out_shape=case["t1"].shape).cpu().numpy()
        else:
            base_vol = case["pet"]
        base, corr = masked_corr(base_vol, case["t1"], mask), masked_corr(out, case["t1"], mask)
        print(f"toolchain registration adni{i} ({metric}, {name}): {seconds:.3f} s, loss {result.loss:.5f}, "
              f"params {[round(float(p), 5) for p in result.params]} (true motion {case['motion']}), masked "
              f"correlation {corr:.5f} (header only {base:.5f}); {card}")
        check(corr > base + 0.01 and corr > TOOLCHAIN_MIN_CORR,
              f"adni{i} {metric}: the motion was not recovered ({corr:.5f}, header only {base:.5f})")
    ds = [nifti.read_array(w("ds", f"adni{i}", "2015-01-01", "t1_ds.nii.gz")) for i in range(4)]
    check(all(v.shape == CROP and np.isfinite(v).all() and v.max() > 0 for v in ds), "bad downsampled T1s")
    packed = PackedDataset(w("packed"))
    check(len(packed) == 4 and packed.volumes.shape == (4, 2, *CROP) and np.isfinite(packed.volumes).all(),
          f"the packed store: {len(packed)} pairs, {packed.volumes.shape}")

    # the registration on the card against the CPU, every grid TOOLCHAIN_REDUCED times coarser
    small = toolchain_case(0, "cpu", TOOLCHAIN_REDUCED)
    regs = {}
    for d in ("cuda", "cpu"):
        args = [torch.from_numpy(small["pet"]).to(d), torch.from_numpy(small["t1"]).to(d), *small["headers"][::-1]]
        torch.cuda.synchronize()
        start = time.perf_counter()
        regs[d] = (register_rigid_physical(*args, pyramid=(2,), iters_per_level=0), register_rigid_physical(*args))
        torch.cuda.synchronize()
        times[f"reduced registration {small['t1'].shape} on {d}"] = time.perf_counter() - start
    header_err = float((regs["cuda"][0].matrix.cpu() - regs["cpu"][0].matrix).abs().max()
                       / regs["cpu"][0].matrix.abs().max())
    param_err = float((regs["cuda"][1].params.cpu() - regs["cpu"][1].params).abs().max())
    print(f"toolchain registration {small['t1'].shape} <- {small['pet'].shape}, card vs CPU: header-only pull-back "
          f"{header_err:.3e} of max (tol {TOL_TOOLCHAIN_REL:g}), params {param_err:.3e} apart (tol one Adam step, "
          f"{TOOLCHAIN_LR / 3:g}); losses {regs["cuda"][1].loss:.6f} / {regs['cpu'][1].loss:.6f}")
    check(header_err <= TOL_TOOLCHAIN_REL and param_err <= TOOLCHAIN_LR / 3, "card and CPU registrations disagree")

    # post-processing: SUVR in conformed space on real and synthesized PET (phase 4's, mapped onto the
    # real PET's range so that its reference region averages above 0), card and CPU
    seg_dir = write_seg_tree(os.path.join(tmp, "seg"), pred_dir)
    pet_dirs = {"ori.nii.gz": pred_dir, "rec.nii.gz": rescaled_tree(pred_dir, os.path.join(tmp, "syn_tree"))}
    suvr = {}
    for d in ("cuda", "cpu"):
        for name, pet_dir in pet_dirs.items():
            out_csv = w(f"suvr_{name[:3]}_{d}.csv")
            run(f"postprocess suvr --conform {name} on {d}", postprocess.main,
                ["suvr", "--pet_dir", pet_dir, "--seg_dir", seg_dir, "--pet_name", name, "--conform",
                 "--out_csv", out_csv, "--device", d])
            suvr[d, name] = suvr_rows(out_csv)
    for name in pet_dirs:
        got, want = suvr["cuda", name], suvr["cpu", name]
        check(len(want) == N_SUBJECTS and got.keys() == want.keys(), f"SUVR sessions {list(got)} vs {list(want)}")
        rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
        print(f"toolchain SUVR {name}, card vs CPU: {rel:.3e} relative at most (tol {TOL_TOOLCHAIN_REL:g}); "
              f"{[round(v, 5) for v in got.values()]}")
        check(all(np.isfinite(v) and v > 0 for v in got.values()) and rel <= TOL_TOOLCHAIN_REL, "SUVR card vs CPU")
    run("postprocess suvr-error", postprocess.main, ["suvr-error", "--gt_csv", w("suvr_ori_cuda.csv"),
                                                     "--synth_csv", w("suvr_rec_cuda.csv")])
    fig = w("suvr_groups.jpg")
    _, text = run("postprocess analyse", postprocess.main, ["analyse", "--suvr_csv", w("suvr_rec_cuda.csv"),
                                                            "--dx_csv", raw["adnimerge"], "--out_fig", fig])
    kept = sum(ast.literal_eval(text.rsplit(" -> ", 1)[0]).values())
    want_kept = sum(v <= 2.0 for v in suvr["cuda", "rec.nii.gz"].values())  # analyse's default --max_suvr
    print(f"toolchain analyse: {kept} of {N_SUBJECTS} synthesized sessions grouped (SUVR <= 2: {want_kept}); "
          f"figure {'written' if os.path.exists(fig) else 'not written (no matplotlib)'}")
    check(kept == want_kept > 0, f"analyse grouped {kept} sessions, {want_kept} have SUVR <= 2")
    run("postprocess summary", postprocess.main, ["summary", "--manifest", tree_csv, "--adnimerge_csv", raw["adnimerge"]])

    # the folder metric tool at the metric shape, one tree and two
    one, _ = run("metrics one tree on cuda", metrics_cli.main, ["--root", pred_dir])
    one_cpu, _ = run("metrics one tree on cpu", metrics_cli.main, ["--root", pred_dir, "--device", "cpu"])
    sys_dir = link_tree(pred_dir, os.path.join(tmp, "sys_tree"), "rec.nii.gz")
    real_dir = link_tree(pred_dir, os.path.join(tmp, "real_tree"), "ori.nii.gz")
    two, _ = run("metrics two trees on cuda", metrics_cli.main, ["--root", sys_dir, "--real_root", real_dir])
    # the two-tree run pairs the same volumes, so it is held to the same CPU run
    errs = [close_json(one, one_cpu, "metrics one tree"), close_json(two, one_cpu, "metrics two trees")]
    print(f"toolchain metrics {METRIC_SHAPE}: {one}; card vs CPU {errs[0]:.3e}, two trees vs CPU {errs[1]:.3e} "
          f"of the mean at most (tol {TOL_TOOLCHAIN_REL:g})")
    for label, seconds in times.items():
        print(f"toolchain time: {seconds:9.3f} s  {label}; {card}")
    print(f"toolchain: {sum(times.values()):.1f} s in all; {card}")
    return times


DP_STEPS = 4  # one epoch of 8 subjects at global batch 2
DP_EPOCH_TIMEOUT = 600  # seconds a torchrun run may take, start-up included
DP_CROP = PARITY_CROP  # the fp32 comparison of W ranks with one process (the dry run)


def dp_rank_main(out_pattern: str, argv: list) -> int:
    """One rank of phases 15 and 16, under torchrun: joins the process group, runs
    cips_tpu_torch.cli.train_unet.main(argv) with each train step's flash launches
    and their (kernel, Lq, Lk), time (CUDA events), all-reduced bytes, bytes
    exchanged over the space group by kind and metrics recorded, then writes what
    it saw to ``out_pattern.format(rank=...)``: those records, its peak memory
    (`device_memory_report`), its checkpoint-metadata writes, its trained networks'
    gradient bytes and their largest difference from rank 0's, all-reduced."""
    from cips_tpu_torch.cli import train_unet
    from cips_tpu_torch.ops import flash_attention as fa
    from cips_tpu_torch.parallel import mesh as pm
    from cips_tpu_torch.parallel import spatial
    from cips_tpu_torch.parallel.dryrun import max_rank_difference
    from cips_tpu_torch import profiling
    from cips_tpu_torch.training import unet_synthesis
    from cips_tpu_torch.training.profiling import device_memory_report
    from cips_tpu_torch.training.common import CheckpointManager

    mesh = pm.make_mesh("cuda")  # the world's group; train_unet's own mesh adds any space groups
    steps, meta_writes, launched = [], [], []
    make_train_step, write_meta, launch = unet_synthesis.make_train_step, CheckpointManager._write_meta, fa._launch

    def recorded_launch(name, q, k, *pointers, scale):
        launched.append((name, q.shape[2], k.shape[2]))
        return launch(name, q, k, *pointers, scale=scale)

    def recorded_make(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def recorded(*step_args):
            space = step_args[0].space  # the GANState's space group, None without one
            profiling.reset("ddp.reduced_bytes")
            profiling.reset("space.exchanged.")
            before, first, norms_before = counts(), len(launched), norm_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            with norm_calls() as seen:
                out = step(*step_args)
            end.record()
            end.synchronize()
            steps.append({"launches": [a - b for a, b in zip(counts(), before)], "ms": start.elapsed_time(end),
                          "norms": norm_step(seen, norms_before),
                          "reduced_bytes": profiling.COUNTERS["ddp.reduced_bytes"],
                          "space_bytes": spatial.exchanged() if space is not None else {},
                          "flash_shapes": sorted(set(launched[first:])),
                          "metrics": {k: float(v) for k, v in out.items()}})
            return out

        return recorded

    def recorded_meta(self, meta):
        meta_writes.append(dict(meta))
        write_meta(self, meta)

    unet_synthesis.make_train_step, CheckpointManager._write_meta, fa._launch = recorded_make, recorded_meta, \
        recorded_launch
    try:
        set_counts((0, 0, 0))
        torch.cuda.reset_peak_memory_stats()
        state = train_unet.main(argv)
        torch.cuda.synchronize()
        params = {f"{net}.{k}": v.float() for net, m in (("g", state.g), ("d", state.d))
                  for k, v in m.state_dict().items()}
        record = {
            "rank": mesh.rank, "world": mesh.world_size, "device": str(mesh.device), "steps": steps,
            "launches": list(counts()), "norms": list(norm_counts()), "meta_writes": len(meta_writes),
            "grad_bytes": sum(p.numel() * p.element_size() for m in (state.g, state.d) for p in m.parameters()),
            "max_rank_diff": max_rank_difference(mesh, params) if mesh.distributed else 0.0,
            "memory": device_memory_report()[mesh.device.index],
        }
        with open(out_pattern.format(rank=mesh.rank), "w", encoding="utf-8") as f:
            json.dump(record, f)
    finally:
        unet_synthesis.make_train_step, CheckpointManager._write_meta, fa._launch = make_train_step, write_meta, launch
        mesh.close()
    return 0


def dp_run(n: int, backend: str, args: list, out_dir: str) -> list:
    """train_unet under torchrun at ``n`` ranks (over ``backend``, which
    `parallel.mesh.backend_for` picks), each rank in `dp_rank_main`; returns the
    ranks' records, in rank order."""
    os.makedirs(out_dir, exist_ok=True)
    pattern = os.path.join(out_dir, "rank{rank}.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n),
           os.path.abspath(__file__), "--dp-rank", pattern, *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DP_EPOCH_TIMEOUT,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    wall = time.perf_counter() - t0
    print(f"data parallel: torchrun {n} rank(s) over {backend} in {wall:.1f} s (start-up included), exit "
          f"{proc.returncode}")
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-8000:])
    check(proc.returncode == 0, f"torchrun at {n} ranks over {backend} failed")
    print("\n".join(f"data parallel | {line}" for line in proc.stdout.strip().splitlines()[-4:]))
    return [json.load(open(pattern.format(rank=r), encoding="utf-8")) for r in range(n)]


def data_parallel_phase(fa, tree: dict, eval_csv: str, packed: tuple, tmp: str, card: str) -> dict:
    """Phase 15: cips_tpu_torch.cli.train_unet under torchrun. One rank a card
    over NCCL (the world is torch.cuda.device_count() ranks); on a machine with one
    card, 2 ranks share it over gloo as well, so that a cross-rank reduction runs
    the card's kernels. The multi-rank run is checked (identical replicas, 6/6/6
    flash launches a step on each rank, the all-reduced bytes a step equal to G's
    and D's gradient bytes, one writer of meta.json), its checkpoint resumed at 1
    rank, and the dry run (`cips_tpu_torch.parallel.dryrun`) holds two fp32 steps
    at the reduced crop at W ranks to one process on the same global batch."""
    from cips_tpu_torch.cli import train_unet
    from cips_tpu_torch.training.common import CheckpointManager

    cards = torch.cuda.device_count()
    multi = (cards, "nccl") if cards >= 2 else (2, "gloo")
    print(f"data parallel: {cards} card(s); runs: 1 rank over nccl, then {multi[0]} ranks over {multi[1]}"
          + ("" if cards >= 2 else " sharing the one card (no scaling figure: the ranks share one card)"))

    def args(exp: str) -> list:
        return ["--PET_dir", tree["pet"], "--T1_dir", tree["t1"], "--min_and_max", tree["stats"], "--use_condition",
                "--crop_size", *map(str, CROP), "--device", "cuda", "--exp_dir", exp,
                "--training_info_csv", tree["csv"], "--eval_info_csv", eval_csv, "--packed_dir", packed[0],
                "--eval_packed_dir", packed[1], "--dtype", "bf16", "--batch_size", str(TRAIN_BATCH),
                "--save_every", "1", "--epochs", "1"]

    records = {}
    for n, backend in ((1, "nccl"), multi):
        exp = os.path.join(tmp, f"dp_{n}_{backend}")
        recs = dp_run(n, backend, args(exp), os.path.join(tmp, f"dp_{n}_{backend}_records"))
        for r in recs:
            ms = [s["ms"] for s in r["steps"]]
            print(f"data parallel: {n} rank(s) {backend}, rank {r['rank']} on {r['device']}: step ms "
                  f"{[round(x, 3) for x in ms]} (mean of steps 2-{len(ms)} {np.mean(ms[1:]):.3f}), all-reduced bytes "
                  f"a step {[s['reduced_bytes'] for s in r['steps']]}, launches a step "
                  f"{sorted({tuple(s['launches']) for s in r['steps']})}, peak memory "
                  f"{r['memory']['peak_bytes_in_use'] / 2**30:.2f} GiB, meta.json writes {r['meta_writes']}, "
                  f"max difference from rank 0 {r['max_rank_diff']}; {card}")
            check(len(r["steps"]) == DP_STEPS and all(s["launches"] == [6, 6, 6] for s in r["steps"]),
                  f"rank {r['rank']} of {n}: every step must launch 6 forward, 6 dQ and 6 dK/dV kernels")
            rank_norms(r, f"data parallel {n} rank(s) {backend}, rank {r['rank']}")
            check(r["max_rank_diff"] == 0.0, f"rank {r['rank']} of {n} differs from rank 0 by {r['max_rank_diff']}")
            check(r["meta_writes"] == (1 if r["rank"] == 0 else 0), f"rank {r['rank']} wrote meta.json "
                  f"{r['meta_writes']} times")
            if n > 1:
                check(all(s["reduced_bytes"] == r["grad_bytes"] for s in r["steps"]),
                      f"all-reduced bytes a step {[s['reduced_bytes'] for s in r['steps']]}, gradients "
                      f"{r['grad_bytes']}")
        records[n] = recs
        check(os.path.exists(os.path.join(exp, "conditional", "AV45", "ckpt", "meta.json")), "no meta.json")
    n = multi[0]
    step_ms = {k: float(np.mean([np.mean([s["ms"] for s in r["steps"]][1:]) for r in v])) for k, v in records.items()}
    peak = max(r["memory"]["peak_bytes_in_use"] for r in records[n]) / 2**30
    line = (f"data parallel: step {step_ms[n]:.3f} ms a rank at {n} ranks over {multi[1]} (1 rank: {step_ms[1]:.3f} "
            f"ms), global batch {TRAIN_BATCH}; all-reduced {records[n][0]['steps'][0]['reduced_bytes']} bytes a step; "
            f"peak {peak:.2f} GiB a rank")
    if cards >= 2:
        line += f"; speed-up over 1 rank {step_ms[1] / step_ms[n]:.3f}x at the same global batch"
    else:
        line += "; no scaling figure (the ranks shared one card)"
    print(f"{line}; {card}")

    exp = os.path.join(tmp, f"dp_{n}_{multi[1]}")
    with uncounted():
        resumed = train_unet.main(args(exp)[:-2] + ["--epochs", "2", "--resume"])
    check(resumed.step == 2 * DP_STEPS and CheckpointManager(
        os.path.join(exp, "conditional", "AV45", "ckpt")).latest_epoch() == 1,
          f"the {n}-rank checkpoint resumed at 1 rank to step {resumed.step}")
    print(f"data parallel: the {n}-rank checkpoint resumed at 1 rank, step {resumed.step}")
    del resumed

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cips_tpu_torch.parallel.dryrun", str(n), "--steps", "2",
                           "--crop", *map(str, DP_CROP), "--dtype", "f32", "--n_space", "1"],
                          capture_output=True, text=True, timeout=DP_EPOCH_TIMEOUT,
                          env={**os.environ, "CIPS_DRYRUN_FULL": "1", "OMP_NUM_THREADS": "1"})
    if proc.returncode != 0:
        print(proc.stdout[-4000:])
        print(proc.stderr[-8000:])
    check(proc.returncode == 0, "the dry run failed")
    payload = json.loads([line for line in proc.stdout.splitlines() if line.startswith("{")][-1])
    print(f"data parallel: dry run at {n} ranks over {multi[1]} in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(payload)}")
    verdict = payload["one_process"]
    print(f"data parallel: dry run, flagship config fp32 at {DP_CROP} (cuDNN off), {n} ranks vs one process: the "
          f"first step's gradients {verdict['grads_max_rel']:.3e} of each tensor's max|grad| (limit 1e-4), its "
          f"parameters {verdict['max_rel']:.3e} of max|value| (limit 1e-5; {verdict['noise_elements']} elements moved "
          f"by Adam on rounding noise, {verdict['max_noise_lr']:.3f} lr at most); after step 2 {verdict['last_max_rel']:.3e} "
          f"of max|value|, {verdict['last_max_lr']:.3f} lr at most (limit 4); all-reduced "
          f"{payload['reduced_bytes_per_step']} bytes a step = gradient bytes {payload['grad_bytes']}; replicas apart "
          f"by {payload['max_rank_diff']}; {card}")
    return {"ranks": n, "backend": multi[1], "step_ms": step_ms, "peak_gib": peak,
            "launches_per_rank": [r["launches"] for r in records[n]],
            "reduced_bytes": records[n][0]["steps"][0]["reduced_bytes"], "dryrun": payload,
            "one_rank_metrics": [s["metrics"] for s in records[1][0]["steps"]]}


SPACE_LK = 2304  # the flagship's attention level (12 x 16 x 12 tokens): a space rank's queries attend to all of it
SPACE_ATTN = ((TRAIN_BATCH, 4, SPACE_LK // 2, 32), (TRAIN_BATCH, 4, SPACE_LK // 4, 32))  # n_space 2 and 4
# Phase 16's first two train steps at n_space 2 against phase 15's 1-rank steps on the same batches from
# the same weights (the same stores and seed), bf16: each loss within this share of the 1-rank one. The
# first step's losses differ only by the means' rounding (measured 0): the trainers' zero-initialised
# output convs make G's fake and D's logits 0 in the first forward, so they check the rows and the slabs'
# means. The second step's follow one Adam step, which moves each weight by about lr whatever its
# gradient's size, so they part by the elements whose gradients' signs differ between two summation
# orders (measured 6.6e-4 at most on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md). Later steps
# compound that (1.8e-3 and 7.4e-3 there) and are printed, not held.
TOL_SPACE_LOSS_REL = 1e-2
SPACE_LOSS_STEPS = 2  # the steps held to TOL_SPACE_LOSS_REL
SPACE_LOSSES = ("g_loss", "rec_loss", "adv_loss", "d_loss")
# Uneven slabs: the flagship's dry run at a depth of 88, whose coarsest level (11 x 16 x 12 = 2,112
# tokens) parts 5 / 6 over 2 ranks, so the flash kernels run at Lq 960 and 1,152 against Lk 2,112 (no
# multiple of 128); at (40, 64, 32) the coarsest level's 5 planes part 2 / 3.
SPACE_UNEVEN_CROP = (88, 128, 96)
SPACE_UNEVEN_LK = 2112
SPACE_UNEVEN_ATTN = ((1, 4, 960, 32), (1, 4, 1152, 32))
SPACE_KINK_UNEVEN_CROP = (40, 64, 32)
# Phase 17: the causal trio at space 2, batch 1 a data group: the latent's 24 planes part 12 / 12, so
# every flash kernel runs at Lq 9,216 against Lk 18,432; the encoder's 4 sites at 4 heads, the PET
# decoder's 3 at 2.
CAUSAL_SPACE_LK = 18432
CAUSAL_SPACE_ATTN = ((1, 4, 9216, 32), (1, 2, 9216, 32))
CAUSAL_SPACE_STEPS = 2
# PERF.md's prediction of the bytes rank 0 exchanges a step by kind at data 1 x space 2 (scaled from
# the CPU's count at (16, 32, 24) in fp32), printed beside the measured ones
CAUSAL_SPACE_PREDICTED = {"halo": 64.7e6, "norm": 40640, "kv": 51904512, "volume": 4.7e6, "mean": 88}


def recorded_dryrun_rank(mesh, task: str, full: bool, crop, dtype_name: str, steps: int) -> dict:
    """One rank of `cips_tpu_torch.parallel.dryrun` (`dryrun_rank`, what the dry
    run's entry point runs in each rank) with each train step's flash launches,
    every launch's (kernel, Lq, Lk) and the rank's peak memory recorded; started
    by `dryrun.start` (spawn re-imports this file to find it)."""
    from cips_tpu_torch.ops import flash_attention as fa
    from cips_tpu_torch.parallel import dryrun
    from cips_tpu_torch.training import causal_task, unet_synthesis

    launched, per_step, norm_steps, launch = [], [], [], fa._launch

    def recorded_launch(name, q, k, *pointers, scale):
        launched.append((name, q.shape[2], k.shape[2]))
        return launch(name, q, k, *pointers, scale=scale)

    fa._launch = recorded_launch
    try:
        set_counts((0, 0, 0))
        torch.cuda.reset_peak_memory_stats(mesh.device)
        with step_launches(per_step, causal_task if task == "causal" else unet_synthesis, norm_steps):
            payload = dryrun.dryrun_rank(mesh, task, full, crop, dtype_name, steps)
        return {"rank": mesh.rank, "device": str(mesh.device), "payload": payload, "steps": per_step,
                "norm_steps": norm_steps, "launches": list(counts()), "norms": list(norm_counts()), "flash_shapes": sorted(set(launched)),
                "peak_bytes": torch.cuda.max_memory_allocated(mesh.device)}
    finally:
        fa._launch = launch


def recorded_dryrun(task: str, crop, dtype_name: str, steps: int, n: int, n_space: int) -> list:
    """The dry run's ranks (`recorded_dryrun_rank`) at ``n`` ranks, space ``n_space``, on the card(s):
    each rank's record, in rank order (rank 0's holds the payload)."""
    from cips_tpu_torch.parallel import dryrun

    return dryrun.start(recorded_dryrun_rank, n, task, True, tuple(crop), dtype_name, steps, device="cuda",
                        n_space=n_space, timeout=DP_EPOCH_TIMEOUT).join()


def space_kernel_checks(fa, shapes=SPACE_ATTN, lk: int = SPACE_LK) -> None:
    """The forward, dQ and dK/dV kernels at a space rank's ``shapes`` (its queries
    against all ``lk`` keys) in bf16 and fp32, against their plain versions in fp32
    on the same inputs, within the limits of phase 3."""
    for i, (shape, dtype) in enumerate(itertools.product(shapes, (torch.bfloat16, torch.float32))):
        q, k, v, out, lse, dout, delta, scale = bwd_inputs(fa, shape, dtype, 40 + i, lk=lk)
        got = (fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale),
               *fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale))
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, dout)]
        ref_out, ref_lse = fa.flash_attention_reference(*f32[:3], scale)
        want = (fa.flash_attention_bwd_dq_reference(*f32, lse, delta, scale),
                *fa.flash_attention_bwd_dkv_reference(*f32, lse, delta, scale))
        bf16 = dtype == torch.bfloat16
        tol_out, tol_grad = (TOL_BF16_OUT_REL, TOL_BF16_GRAD_REL) if bf16 else (TOL_F32_OUT_REL, TOL_F32_GRAD_REL)
        rel_out = ((out.float() - ref_out).abs().max() / ref_out.abs().max()).item()
        lse_err = (lse - ref_lse).abs().max().item()
        rels = [((a.float() - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want)]
        print(f"space kernels {shape} Lk {lk} {str(dtype)[6:]}: out {rel_out:.3e} of max|out| (tol {tol_out:g}), "
              f"lse {lse_err:.3e} (tol {TOL_LSE:g}); dq {rels[0]:.3e}, dk {rels[1]:.3e}, dv {rels[2]:.3e} of "
              f"max|grad| (tol {tol_grad:g})")
        check(rel_out <= tol_out and lse_err <= TOL_LSE and all(r <= tol_grad for r in rels)
              and all(torch.isfinite(t).all().item() for t in (out, *got)),
              f"flash kernels disagree with their plain versions at {shape} Lk {lk} {dtype}")
        del q, k, v, out, lse, dout, delta, got, f32, ref_out, want


def kink_start(task: str, crop) -> tuple:
    """Start `probe_space_kink --task TASK --check --crop CROP` in its own session (so that
    `kink_stop` can end its spawned ranks with it), its output into temporary files (a pipe that
    nobody reads would stall it): the fp32 step at full width, data 1 x space 2, against one process
    (no TF32, no cuDNN). Returns what `kink_check` and `kink_stop` take."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-m", "cips_tpu_torch.scripts.probe_space_kink", "--task", task,
                             "--check", "--crop", *map(str, crop)], stdout=out, stderr=err, text=True,
                            env={**os.environ, "OMP_NUM_THREADS": "1"}, start_new_session=True)
    return proc, task, tuple(crop), time.perf_counter(), out, err


def kink_stop(started: tuple) -> None:
    """End a probe that `kink_start` started and its ranks, if it still runs."""
    proc = started[0]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def kink_check(started: tuple, label: str, card: str) -> dict:
    """Wait for a probe of `kink_start`: the losses, the replicas, and G and D each alone within
    dryrun.TOL_GRADS, which the probe asserts; prints the whole step's gradients beside one
    process's own jump when G's synthesis moves by a relative eps. Returns the probe's payload."""
    proc, task, crop, t0, out, err = started
    try:
        proc.wait(timeout=DP_EPOCH_TIMEOUT)
    finally:
        kink_stop(started)
    for f in (out, err):
        f.seek(0)
    stdout, stderr = out.read(), err.read()
    out.close()
    err.close()
    if proc.returncode != 0:
        print(stdout[-4000:])
        print(stderr[-8000:])
    check(proc.returncode == 0, f"the fp32 {task} space check at {crop} failed")
    payload = json.loads([line for line in stdout.splitlines() if line.startswith("{")][-1])
    fmt = lambda row: f"{row[0]:.3e} of {row[1]}'s max|grad| (2-norm {row[2]:.3e})"  # noqa: E731
    parts = payload["parts"]
    adversarial = parts["G's adversarial term"]
    print(f"{label}: fp32 at {crop}, full width, data 1 x space 2 vs one process, in "
          f"{time.perf_counter() - t0:.1f} s: losses within {payload['metrics_rel']:.3e}, replicas apart by "
          f"{payload['max_rank_diff']}; G alone {fmt(parts['G alone'])}, D alone {fmt(parts['D alone'])} (limit "
          f"1e-4); G's adversarial term {fmt(adversarial)}; "
          f"the whole step: G {fmt(payload['step']['generator'])}, D {fmt(payload['step']['discriminator'])}; "
          f"one process's own G adversarial gradient with G's synthesis x (1 + eps N(0, 1)): "
          + "; ".join(f"eps {eps} {fmt(row)}" for eps, row in payload["jumps"].items())
          + f"; bytes exchanged {payload['space_bytes']}; {card}")
    return payload


def space_parallel_phase(fa, tree: dict, eval_csv: str, packed: tuple, tmp: str, card: str,
                         one_rank_metrics: list) -> dict:
    """Phase 16: cips_tpu_torch.cli.train_unet under torchrun at --n_space 2 (one
    card: 2 ranks sharing it over gloo; 2-3 cards: 2 over NCCL; 4 or more: data 2 x
    space 2 over NCCL), flagship, bf16, full volume, global batch 2, one epoch of 4
    steps with eval and a checkpoint. Checked: identical replicas, 6/6/6 flash
    launches a step on each rank, all at Lq 1152 / Lk 2304, DDP's bytes, one writer,
    the first two steps' losses against phase 15's 1-rank steps on the same batches; the
    checkpoint resumed at 1 rank; the flash kernels at a space rank's shapes held to
    their plain versions and timed beside SDPA and their bound; the fp32 step at a
    reduced crop against one process (`kink_check`); uneven slabs (`space_uneven_case`)."""
    from cips_tpu_torch.cli import train_unet
    from cips_tpu_torch.training.common import CheckpointManager

    cards = torch.cuda.device_count()
    n, backend = (4, "nccl") if cards >= 4 else (2, "nccl" if cards >= 2 else "gloo")
    layout = f"data {n // 2} x space 2"
    print(f"space parallel: {cards} card(s); train_unet --n_space 2 at {n} ranks ({layout}) over {backend}"
          + (" sharing the one card: the step time measures the mechanism's cost through gloo and the host, "
             "not a speed-up" if cards == 1 else ""))

    def args(exp: str, *extra) -> list:
        return ["--PET_dir", tree["pet"], "--T1_dir", tree["t1"], "--min_and_max", tree["stats"], "--use_condition",
                "--crop_size", *map(str, CROP), "--device", "cuda", "--exp_dir", exp,
                "--training_info_csv", tree["csv"], "--eval_info_csv", eval_csv, "--packed_dir", packed[0],
                "--eval_packed_dir", packed[1], "--dtype", "bf16", "--batch_size", str(TRAIN_BATCH),
                "--save_every", "1", *extra]

    exp = os.path.join(tmp, f"space_{n}")
    recs = dp_run(n, backend, args(exp, "--epochs", "1", "--n_space", "2"), os.path.join(tmp, f"space_{n}_records"))
    kernels = {"cips_flash_attention_fwd", "cips_flash_attention_bwd_dq", "cips_flash_attention_bwd_dkv"}
    for r in recs:
        ms = [s["ms"] for s in r["steps"]]
        print(f"space parallel: rank {r['rank']} of {n} on {r['device']}: step ms {[round(x, 3) for x in ms]} (mean "
              f"of steps 2-{len(ms)} {np.mean(ms[1:]):.3f}); bytes exchanged over the space group a step "
              f"{r['steps'][-1]['space_bytes']}; DDP all-reduced {r['steps'][-1]['reduced_bytes']}; launches a step "
              f"{sorted({tuple(s['launches']) for s in r['steps']})} at (kernel, Lq, Lk) "
              f"{sorted({tuple(x) for s in r['steps'] for x in s['flash_shapes']})}; peak memory "
              f"{r['memory']['peak_bytes_in_use'] / 2**30:.2f} GiB; meta.json writes {r['meta_writes']}; max "
              f"difference from rank 0 {r['max_rank_diff']}; {card}")
        check(len(r["steps"]) == DP_STEPS and all(s["launches"] == [6, 6, 6] for s in r["steps"]),
              f"rank {r['rank']} of {n}: every step must launch 6 forward, 6 dQ and 6 dK/dV kernels")
        rank_norms(r, f"space parallel, rank {r['rank']} of {n}")
        check(all({tuple(x) for x in s["flash_shapes"]} == {(k, SPACE_LK // 2, SPACE_LK) for k in kernels}
                  for s in r["steps"]), f"rank {r['rank']}: the train steps' flash kernels must run at Lq "
              f"{SPACE_LK // 2}, Lk {SPACE_LK}")
        check(r["max_rank_diff"] == 0.0, f"rank {r['rank']} of {n} differs from rank 0 by {r['max_rank_diff']}")
        check(r["meta_writes"] == (1 if r["rank"] == 0 else 0), f"rank {r['rank']} wrote meta.json "
              f"{r['meta_writes']} times")
        check(all(s["reduced_bytes"] == r["grad_bytes"] for s in r["steps"]), "DDP's bytes are not the gradients'")
        check(all(s["space_bytes"][kind] > 0 for s in r["steps"] for kind in ("halo", "norm", "kv", "mean"))
              and all(s["space_bytes"]["volume"] == 0 for s in r["steps"]),
              f"rank {r['rank']}: the space exchanges a step {r['steps'][0]['space_bytes']}")
    check(os.path.exists(os.path.join(exp, "conditional", "AV45", "ckpt", "meta.json")), "no meta.json")
    # each space group's ranks hold their data group's losses; the mean over all ranks is the global batch's
    for i, want in enumerate(one_rank_metrics):
        got = {k: float(np.mean([r["steps"][i]["metrics"][k] for r in recs])) for k in SPACE_LOSSES}
        rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in SPACE_LOSSES}
        print(f"space parallel: step {i + 1}'s losses at {layout} {got} vs phase 15's 1-rank step "
              f"{ {k: want[k] for k in SPACE_LOSSES} }: relative differences "
              f"{ {k: f'{v:.3e}' for k, v in rel.items()} }"
              + (f" (limit {TOL_SPACE_LOSS_REL:g})" if i < SPACE_LOSS_STEPS else " (not held: Adam's noise compounds)"))
        check(i >= SPACE_LOSS_STEPS or all(v <= TOL_SPACE_LOSS_REL for v in rel.values()),
              f"the sharded step {i + 1}'s losses part from the 1-rank step's")
    step_ms = float(np.mean([np.mean([s["ms"] for s in r["steps"]][1:]) for r in recs]))
    peak = max(r["memory"]["peak_bytes_in_use"] for r in recs) / 2**30
    exchanged = recs[0]["steps"][-1]["space_bytes"]
    print(f"space parallel: step {step_ms:.3f} ms a rank at {layout} over {backend}, global batch {TRAIN_BATCH}; peak "
          f"{peak:.2f} GiB a rank; bytes exchanged a step by rank 0 {exchanged} (total {sum(exchanged.values())}); "
          f"DDP {recs[0]['steps'][-1]['reduced_bytes']}"
          + ("; one card: the mechanism's cost through gloo, not a speed-up" if cards == 1 else "") + f"; {card}")

    with uncounted():
        resumed = train_unet.main(args(exp, "--epochs", "2", "--resume"))
    check(resumed.step == 2 * DP_STEPS and CheckpointManager(
        os.path.join(exp, "conditional", "AV45", "ckpt")).latest_epoch() == 1,
          f"the {layout} checkpoint resumed at 1 rank to step {resumed.step}")
    print(f"space parallel: the {layout} checkpoint resumed at 1 rank, step {resumed.step}")
    del resumed

    with uncounted():
        t0 = time.perf_counter()
        space_kernel_checks(fa)
        timing = {"x".join(map(str, SPACE_ATTN[0])) + f" Lk {SPACE_LK}": flash_timing(fa, SPACE_ATTN[0], True,
                                                                                        lk=SPACE_LK),
                  "x".join(map(str, SPACE_ATTN[1])) + f" Lk {SPACE_LK}": flash_timing(fa, SPACE_ATTN[1], True,
                                                                                        lk=SPACE_LK),
                  "x".join(map(str, SPACE_ATTN[0])) + f" Lk {SPACE_LK} f32": flash_timing(
                      fa, SPACE_ATTN[0], True, torch.float32, lk=SPACE_LK)}
        print(f"space parallel: kernel checks and timing at a space rank's shapes in {time.perf_counter() - t0:.1f} s")

    # The fp32 checks of this phase and the next, and the uneven case, side by side (each is a few
    # host-bound processes; none is timed): the flagship at a reduced crop whose coarsest level parts
    # unevenly (5 planes: 2 / 3) and the causal trio at DP_CROP, full width, data 1 x space 2 against one
    # process (no TF32, no cuDNN): the losses, the replicas, and G and D each alone within
    # dryrun.TOL_GRADS; the whole step's gradients are printed beside the one-process step's own jump
    # when G's synthesis moves by a relative eps: a LeakyReLU of D within rounding of its kink parts any
    # two summation orders (the flagship's at (32, 64, 32) by 1e-2; probe_space_kink's docstring)
    probes = [kink_start("flagship", SPACE_KINK_UNEVEN_CROP), kink_start("causal", DP_CROP)]
    try:
        uneven = space_uneven_case(fa, card)
        payload = kink_check(probes[0], "space parallel", card)
        causal_fp32 = kink_check(probes[1], "causal space", card)
    finally:
        for probe in probes:
            kink_stop(probe)
    return {"ranks": n, "layout": layout, "backend": backend, "step_ms": step_ms, "peak_gib": peak,
            "exchanged": exchanged, "launches_per_rank": [r["launches"] for r in recs], "timing": timing,
            "fp32": payload, "uneven": uneven, "causal_fp32": causal_fp32}


def space_uneven_case(fa, card: str) -> dict:
    """Phase 16's uneven slabs: the flagship's dry run at SPACE_UNEVEN_CROP, space 2 (2 ranks), bf16,
    full width, 1 step (finite losses and identical replicas, which the dry run asserts; 6/6/6 flash
    launches on each rank, at Lq 960 on rank 0 and 1,152 on rank 1 against Lk 2,112); the flash kernels
    at those shapes against their plain versions. Returns each rank's launches."""
    kernels = ("cips_flash_attention_fwd", "cips_flash_attention_bwd_dq", "cips_flash_attention_bwd_dkv")
    t0 = time.perf_counter()
    recs = recorded_dryrun("flagship", SPACE_UNEVEN_CROP, "bf16", 1, 2, 2)
    for r, shape in zip(recs, SPACE_UNEVEN_ATTN):
        print(f"space parallel (uneven): rank {r['rank']} on {r['device']} at {SPACE_UNEVEN_CROP}: launches a step "
              f"{r['steps']} at (kernel, Lq, Lk) {r['flash_shapes']}; peak {r['peak_bytes'] / 2**30:.2f} GiB")
        check(r["steps"] == [(6, 6, 6)], f"rank {r['rank']}: the uneven step must launch 6/6/6 flash kernels")
        rank_norms(r, f"space parallel (uneven), rank {r['rank']}")
        check({tuple(x) for x in r["flash_shapes"]} == {(k, shape[2], SPACE_UNEVEN_LK) for k in kernels},
              f"rank {r['rank']}: the uneven step's flash kernels must run at Lq {shape[2]}, Lk {SPACE_UNEVEN_LK}")
    payload = recs[0]["payload"]
    print(f"space parallel (uneven): the flagship's dry run at {SPACE_UNEVEN_CROP}, data 1 x space 2, bf16 in "
          f"{time.perf_counter() - t0:.1f} s: metrics {payload['metrics']}, bytes exchanged by rank 0 "
          f"{payload['space_bytes_per_step']}, step {payload['step_ms']} ms, replicas apart by "
          f"{payload['max_rank_diff']}; {card}")
    check(all(np.isfinite(v) for m in payload["metrics"] for v in m.values()), "non-finite uneven metrics")
    with uncounted():
        space_kernel_checks(fa, SPACE_UNEVEN_ATTN, SPACE_UNEVEN_LK)
    return {"launches_per_rank": [r["launches"] for r in recs]}


def causal_space_phase(fa, card: str, fp32: dict) -> dict:
    """Phase 17: the causal trio's dry run at --n_space 2 (2 ranks sharing the card over gloo; 2-3
    cards: 2 over NCCL; 4 or more: data 2 x space 2 over NCCL), the bundled config, the full volume,
    bf16, CAUSAL_SPACE_STEPS steps. Checked: identical replicas and DDP's bytes (the dry run asserts
    both), 7/7/7 flash launches a step on each rank, all at Lq 9,216 / Lk 18,432, every kind of
    exchange, the first step's losses against a 1-rank step on the same batch and noise; the flash
    kernels at CAUSAL_SPACE_ATTN against their plain versions, timed beside SDPA and their bound.
    ``fp32``: the fp32 trio at DP_CROP, space 2, against one process part by part (`probe_space_kink
    --task causal --check`), which phase 16 ran beside its own."""
    from cips_tpu_torch.parallel import dryrun

    cards = torch.cuda.device_count()
    n, backend = (4, "nccl") if cards >= 4 else (2, "nccl" if cards >= 2 else "gloo")
    layout = f"data {n // 2} x space 2"
    print(f"causal space: {cards} card(s); CIPS_DRYRUN_TASK=causal CIPS_DRYRUN_FULL=1 parallel.dryrun {n} "
          f"--n_space 2 ({layout}) over {backend}" + (" sharing the one card: the step time measures the "
                                                      "mechanism's cost through gloo, not a speed-up"
                                                      if cards == 1 else ""))
    t0 = time.perf_counter()
    recs = recorded_dryrun("causal", CROP, "bf16", CAUSAL_SPACE_STEPS, n, 2)
    kernels = {"cips_flash_attention_fwd", "cips_flash_attention_bwd_dq", "cips_flash_attention_bwd_dkv"}
    payload = recs[0]["payload"]
    for r in recs:
        print(f"causal space: rank {r['rank']} of {n} on {r['device']}: launches a step {r['steps']} at (kernel, Lq, "
              f"Lk) {r['flash_shapes']}; peak memory {r['peak_bytes'] / 2**30:.2f} GiB; {card}")
        check(r["steps"] == [(CAUSAL_FLASH,) * 3] * CAUSAL_SPACE_STEPS,
              f"rank {r['rank']}: every causal step must launch {CAUSAL_FLASH} forward, dQ and dK/dV kernels")
        rank_norms(r, f"causal space, rank {r['rank']} of {n}")
        check({tuple(x) for x in r["flash_shapes"]} == {(k, CAUSAL_SPACE_LK // 2, CAUSAL_SPACE_LK) for k in kernels},
              f"rank {r['rank']}: the causal flash kernels must run at Lq {CAUSAL_SPACE_LK // 2}, Lk {CAUSAL_SPACE_LK}")
    check(all(b == payload["grad_bytes"] for b in payload["reduced_bytes_per_step"]),
          "DDP's bytes are not the gradients'")
    exchanged = payload["space_bytes_per_step"]
    check(all(step[kind] > 0 for step in exchanged for kind in CAUSAL_SPACE_PREDICTED),
          f"the causal space exchanges a step {exchanged}")
    step_ms = payload["step_ms"]
    peak = max(r["peak_bytes"] for r in recs) / 2**30
    print(f"causal space: {layout} over {backend}, batch 1 a data group, in {time.perf_counter() - t0:.1f} s: step ms "
          f"{[round(x, 3) for x in step_ms]} (rank 0, CUDA events); peak {peak:.2f} GiB a rank; bytes exchanged a "
          f"step by rank 0 {exchanged[-1]} (total {sum(exchanged[-1].values())}) against the prediction "
          f"{CAUSAL_SPACE_PREDICTED}; DDP {payload['reduced_bytes_per_step']} = gradients {payload['grad_bytes']}; "
          f"replicas apart by {payload['max_rank_diff']}; {card}")
    with uncounted():
        one = dryrun.run_steps(None, "causal", dryrun._config("causal", True), CROP, torch.bfloat16, 1,
                               payload["global_batch"], torch.device("cuda"))
    want = one["metrics"][0]
    got = payload["metrics"][0]  # the global batch's
    rel = {k: abs(got[k] - v) / max(abs(v), 1e-30) for k, v in want.items()}
    print(f"causal space: step 1's losses at {layout} {got} vs a 1-rank step on the same batch and noise {want}: "
          f"relative differences { {k: f'{v:.3e}' for k, v in rel.items()} } (limit {TOL_SPACE_LOSS_REL:g}); "
          f"the 1-rank step {one['step_ms'][0]:.3f} ms")
    check(all(v <= TOL_SPACE_LOSS_REL for v in rel.values()), "the sharded causal step's losses part from 1 rank's")
    del one

    with uncounted():
        t0 = time.perf_counter()
        space_kernel_checks(fa, CAUSAL_SPACE_ATTN, CAUSAL_SPACE_LK)
        timing = {"x".join(map(str, shape)) + f" Lk {CAUSAL_SPACE_LK}": flash_timing(fa, shape, True,
                                                                                     lk=CAUSAL_SPACE_LK)
                  for shape in CAUSAL_SPACE_ATTN}
        timing["x".join(map(str, CAUSAL_SPACE_ATTN[0])) + f" Lk {CAUSAL_SPACE_LK} f32"] = flash_timing(
            fa, CAUSAL_SPACE_ATTN[0], True, torch.float32, lk=CAUSAL_SPACE_LK)
        print(f"causal space: kernel checks and timing at a causal space rank's shapes in "
              f"{time.perf_counter() - t0:.1f} s")

    return {"ranks": n, "layout": layout, "backend": backend, "step_ms": step_ms, "peak_gib": peak,
            "exchanged": exchanged[-1], "launches_per_rank": [r["launches"] for r in recs], "timing": timing,
            "fp32": fp32}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 1
    from cips_tpu_torch.cli import output_predict, train_unet
    from cips_tpu_torch.cli.common import load_config
    from cips_tpu_torch.data import nifti
    from cips_tpu_torch.ops import cuda_library
    from cips_tpu_torch.ops import flash_attention as fa
    from cips_tpu_torch.ops import phase_conv as pc
    from cips_tpu_torch.ops.masking import get_mask
    from cips_tpu_torch.ops.metrics import mae, ms_ssim, psnr
    from cips_tpu_torch.training import causal_task, unet_synthesis
    from cips_tpu_torch.training.common import CheckpointManager

    started = time.perf_counter()
    phase("1 device")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off for cuDNN convolutions and matmuls: fp32 checks run in full fp32")

    phase("2 build")
    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        cuda_library.build(verbose=True)
    print(report.getvalue(), end="")
    print(f"kernel library built in {time.perf_counter() - t0:.1f} s")
    sm90_kernel_report(report.getvalue(), fa, pc)
    group_norm_report(report.getvalue())
    runtime_build()

    phase("3 kernels")
    with uncounted():
        fwd_err = kernel_checks(fa)
        bwd_err = bwd_kernel_checks(fa)
        flash_at = {"x".join(map(str, TRAIN_ATTN)): flash_timing(fa, TRAIN_ATTN, plain=True),
                    "x".join(map(str, CAUSAL_ATTN)): flash_timing(fa, CAUSAL_ATTN, plain=False),
                    "x".join(map(str, CLASSIFIER_ATTN)): flash_timing(fa, CLASSIFIER_ATTN, plain=True),
                    # the fp32 kernels, on the train and serving paths under --dtype f32
                    "x".join(map(str, TRAIN_ATTN)) + " f32": flash_timing(fa, TRAIN_ATTN, plain=True,
                                                                          dtype=torch.float32)}
        group_norm_rows = group_norm_phase(card)

    cfg = load_config(None, "training.json")
    train_cfg = cfg["training"]
    with tempfile.TemporaryDirectory() as tmp:
        phase("4 serving")
        tree = write_tree(os.path.join(tmp, "data"), seed=0)
        exp_dir = os.path.join(tmp, "exp")
        generator, discriminator, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.float32, device="cpu")
        state = random_state_dict(generator, seed=0)
        d_state = random_state_dict(discriminator, seed=1)
        ckpt_dir = os.path.join(exp_dir, "conditional", "AV45", "ckpt")
        CheckpointManager(ckpt_dir).save({"unet": state, "discriminator": {}, "epoch": 0}, epoch=0)
        data_args = [
            "--PET_dir", tree["pet"], "--T1_dir", tree["t1"], "--min_and_max", tree["stats"], "--use_condition",
            "--crop_size", *map(str, CROP), "--device", "cuda",
        ]
        forwards = -(-N_SUBJECTS // SERVING_BATCH)
        serve_args = data_args + ["--exp_dir", exp_dir, "--eval_info_csv", tree["csv"], "--dtype", "bf16",
                                  "--batch_size", str(SERVING_BATCH)]

        def serve(args, out_dir: str):
            t0 = time.perf_counter()
            results = output_predict.main(args + ["--output_dir", out_dir])
            torch.cuda.synchronize()
            return results, time.perf_counter() - t0

        def check_served(results, pred_dir: str, n: int) -> list:
            summary = results.summary()
            check(all(np.isfinite(v) for v in summary.values()), f"non-finite metrics {summary}")
            recs = [os.path.join(dp, f) for dp, _, fs in os.walk(pred_dir) for f in fs if f == "rec.nii.gz"]
            check(len(recs) == n, f"expected {n} rec.nii.gz, found {len(recs)}")
            for path in recs:
                rec = nifti.read_array(path)
                check(rec.shape == CROP and np.isfinite(rec).all() and np.abs(rec).max() > 0, f"{path}: bad output")
            return recs

        pred_dir = os.path.join(tmp, "pred")
        set_counts((0, 0, 0))
        results, elapsed = serve(serve_args, pred_dir)  # the serving path's run
        serving_counts = counts()
        norm_path("serving", backward=False)
        summary = results.summary()
        print(f"serving: launches (forward, dQ, dK/dV) {serving_counts} over {forwards} generator forwards; "
              f"metrics {summary}")
        check(serving_counts == (6 * forwards, 0, 0), f"expected {(6 * forwards, 0, 0)} launches, got {serving_counts}")
        recs = check_served(results, pred_dir, N_SUBJECTS)
        print(f"serving run 1: {N_SUBJECTS} volumes in {elapsed:.3f} s = {N_SUBJECTS / elapsed:.3f} vol/s "
              f"end to end, set-up and the process's first forward included; batch {SERVING_BATCH}, bf16, {card}")

        with uncounted():
            # The same CLI run again, each stage clocked; set-up (model build and
            # checkpoint restore) is reported apart from the per-volume work.
            for run in range(2, 2 + STAGED_RUNS):
                times = {}
                with stage_clock(times):
                    results, elapsed = serve(serve_args, os.path.join(tmp, f"pred{run}"))
                again = results.summary()
                check(all(np.isclose(again[k], summary[k], rtol=1e-4, atol=0) for k in summary),
                      f"a repeated serving run gave other metrics: {again}")
                setup = sum(sum(times[name]) for name in SETUP) / 1e3
                steady = elapsed - setup
                print(f"serving run {run}: {N_SUBJECTS} volumes in {elapsed:.3f} s = {N_SUBJECTS / elapsed:.3f} "
                      f"vol/s end to end; set-up {setup:.3f} s; without set-up {steady:.3f} s = "
                      f"{N_SUBJECTS / steady:.3f} vol/s; {card}")
                for name, ms in sorted(times.items(), key=lambda kv: -sum(kv[1])):
                    print(f"serving run {run} stage: {sum(ms):10.3f} ms total, {len(ms):3d} calls, "
                          f"{sum(ms) / len(ms):9.3f} ms mean, first {ms[0]:9.3f}  {name}")
                print(f"serving run {run} stage: {elapsed * 1e3 - sum(map(sum, times.values())):10.3f} ms total"
                      f"  rest (stacking, host to device, device to host, loop)")

            generator_bf16, _, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.bfloat16, device="cuda")
            generator_bf16.load_state_dict(state)
            x = torch.rand((SERVING_BATCH, *CROP, 1), device="cuda")
            ctx = torch.rand((SERVING_BATCH, 1, FLAGSHIP_K), device="cuda")

            def forward():
                with torch.inference_mode():
                    generator_bf16(x, ctx)

            torch.cuda.reset_peak_memory_stats()
            fwd_ms = cuda_ms(forward, 5, warmup=2)
            print(f"serving: generator forward {fwd_ms:.3f} ms at batch {SERVING_BATCH} bf16 "
                  f"= {SERVING_BATCH / fwd_ms * 1e3:.2f} vol/s (forward only), "
                  f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {card}")
            profile_window(forward, "forward")
            del generator_bf16

        phase("5 parity (card vs CPU, fp32 forward)")
        models = {}
        for dev in ("cuda", "cpu"):
            models[dev], _, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.float32, device=dev)
            models[dev].load_state_dict(state)
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.random((1, *PARITY_CROP, 1), dtype=np.float32))
        ctx = torch.from_numpy(rng.random((1, 1, FLAGSHIP_K), dtype=np.float32))
        before = counts()
        with uncounted(), torch.inference_mode():
            out_gpu = models["cuda"](x.cuda(), ctx.cuda()).cpu()
            out_cpu = models["cpu"](x, ctx)
            check(counts()[0] - before[0] == 6, "card forward did not run the kernel 6 times")
        rel = ((out_gpu - out_cpu).abs().max() / out_cpu.abs().max()).item()
        del models
        print(f"parity: fp32 generator {PARITY_CROP} card vs CPU max abs err / max |out| = {rel:.3e} "
              f"(tol {TOL_MODEL_REL:g})")
        check(torch.isfinite(out_gpu).all().item() and rel <= TOL_MODEL_REL, "card and CPU forwards disagree")
        real = torch.from_numpy(nifti.read_array(recs[0]).astype(np.float32))
        metrics = {}
        for dev in ("cuda", "cpu"):
            r = real.to(dev)
            fake = (r * 0.9 + 0.05 * torch.sin(r * 7.0)) * get_mask(r).float()
            metrics[dev] = [mae(fake, r).item(), ms_ssim(fake, r, kernel_size=5, sigma=0.5).item(),
                            psnr(fake, r).item()]
        diff = max(abs(a - b) for a, b in zip(metrics["cuda"], metrics["cpu"]))
        print(f"parity: mask + MAE/MS-SSIM/PSNR card {metrics['cuda']} vs CPU {metrics['cpu']}, "
              f"max diff {diff:.3e} (tol {TOL_METRIC:g})")
        check(diff <= TOL_METRIC, "card and CPU metrics disagree")
        f32_forward(cfg, state, card)

        phase("6 training")
        train_exp = os.path.join(tmp, "train_exp")
        eval_csv = subset_manifest(tree["csv"], os.path.join(tmp, "eval.csv"), N_EVAL)
        rate = pool_rate(tree, tree["csv"])
        print(f"streaming: the native pool decodes {rate:.2f} volumes/s ({POOL_THREADS} threads, {N_SUBJECTS} pairs of "
              f"gzipped {CROP} volumes, normalised, nothing else running) = {rate / 2 / TRAIN_BATCH:.2f} batches of "
              f"{TRAIN_BATCH} a second; {card}")
        train_args = data_args + [
            "--exp_dir", train_exp, "--training_info_csv", tree["csv"], "--eval_info_csv", eval_csv,
            "--dtype", "bf16", "--batch_size", str(TRAIN_BATCH), "--save_every", "1",
        ]
        steps_per_epoch = N_SUBJECTS // TRAIN_BATCH
        per_step, norm_steps = [], []
        set_counts((0, 0, 0))
        t0 = time.perf_counter()
        with step_launches(per_step, unet_synthesis, norm_steps):
            trained = train_unet.main(train_args + ["--epochs", str(TRAIN_EPOCHS)])
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_counts = counts()  # the training path's run
        norm_path("training", True, norm_steps)
        steps = trained.step
        expected = (6 * (steps + TRAIN_EPOCHS * N_EVAL), 6 * steps, 6 * steps)  # eval: one forward per subject
        print(f"training: {steps} steps and {TRAIN_EPOCHS} evals of {N_EVAL} subjects in {train_wall:.3f} s "
              f"({steps / train_wall:.3f} steps/s end to end: decode, eval, NIfTI dumps and checkpoints "
              f"included); launches (forward, dQ, dK/dV) {train_counts}; per step {sorted(set(per_step))}; {card}")
        check(steps == TRAIN_EPOCHS * steps_per_epoch, f"expected {TRAIN_EPOCHS * steps_per_epoch} steps, got {steps}")
        check(len(per_step) == steps and set(per_step) == {(6, 6, 6)},
              f"every train step must launch 6 forward, 6 dQ and 6 dK/dV kernels: {per_step}")
        check(train_counts == expected, f"expected {expected} launches, got {train_counts}")
        base = os.path.join(train_exp, "conditional", "AV45")
        records = [json.loads(line) for line in open(os.path.join(base, "log", "metrics.jsonl"), encoding="utf-8")]
        print(f"training: metric records {records}")
        check([r["prefix"] for r in records].count("training") == steps // 10, "missing loss records")
        check(all(np.isfinite(v) for r in records for k, v in r.items() if k != "prefix"), "non-finite losses")
        with open(os.path.join(base, "ckpt", "meta.json"), encoding="utf-8") as f:
            meta = json.load(f)
        print(f"training: meta.json {meta}")
        check(meta["last_epoch"] == TRAIN_EPOCHS - 1 and np.isfinite(meta["best_metric"]), f"bad meta.json {meta}")
        for e in range(TRAIN_EPOCHS):
            check(os.path.exists(os.path.join(base, "ckpt", f"epoch_{e}")), f"no checkpoint of epoch {e}")
            check(nifti.read_array(os.path.join(base, "visual", f"epoch{e}_rec.nii.gz")).shape == CROP,
                  f"no eval dump of epoch {e}")
        del trained

        # the resume decodes through the native pool (--streaming) instead of the packed store
        resume_steps, made = [], []
        with uncounted(), step_launches(resume_steps, unet_synthesis), recorded_loaders(made):
            set_counts((0, 0, 0))
            t0 = time.perf_counter()
            resumed = train_unet.main(train_args + ["--epochs", str(TRAIN_EPOCHS + 1), "--resume", "--streaming"])
            torch.cuda.synchronize()
            resume_wall = time.perf_counter() - t0
            resume_counts = counts()
            norm_path("training --resume --streaming", backward=True)
        expected = (6 * (steps_per_epoch + N_EVAL), 6 * steps_per_epoch, 6 * steps_per_epoch)
        (stream_train, stream_eval), = made
        waits = [round(w * 1e3, 3) for w in stream_train.waits]
        print(f"training: --resume --streaming ran epoch {TRAIN_EPOCHS} to step {resumed.step} in {resume_wall:.3f} s; "
              f"launches {resume_counts}, per step {resume_steps}; the pool decoded {stream_train.decoded} training "
              f"and {stream_eval.decoded} eval samples; each step waited {waits} ms for its batch (the first: the "
              f"pool's start); {card}")
        check(type(stream_train).__name__ == "StreamingLoader"
              and stream_train.decoded == steps_per_epoch * TRAIN_BATCH, f"the resume did not stream its {steps_per_epoch * TRAIN_BATCH} samples through the pool")
        check(resumed.step == steps + steps_per_epoch and resume_counts == expected
              and resume_steps == [(6, 6, 6)] * steps_per_epoch,
              f"resume: step {resumed.step}, launches {resume_counts} ({resume_steps}), expected {expected}")
        check(CheckpointManager(os.path.join(base, "ckpt")).latest_epoch() == TRAIN_EPOCHS, "resume saved no epoch")
        del resumed

        with uncounted():
            set_counts((0, 0, 0))
            trained_pred = os.path.join(tmp, "pred_trained")
            results, _ = serve(data_args + ["--exp_dir", train_exp, "--eval_info_csv", eval_csv, "--dtype", "bf16",
                                            "--batch_size", str(SERVING_BATCH)], trained_pred)
            check(counts() == (6, 0, 0), f"serving the trained checkpoint: launches {counts()}")
            norm_path("serving the trained checkpoint", backward=False)
        check_served(results, trained_pred, N_EVAL)
        print(f"training: the trained checkpoint served {N_EVAL} subjects, metrics {results.summary()}")
        imported = import_phase(fa, base, trained_pred, serve, data_args + [
            "--eval_info_csv", eval_csv, "--dtype", "bf16", "--batch_size", str(SERVING_BATCH)], tmp)

        phase("7 train step")
        step_fn = unet_synthesis.make_train_step(train_cfg)
        batch = synthetic_batch(CROP, TRAIN_BATCH, "cuda", seed=3)
        with uncounted():
            g_bf16, d_bf16, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.bfloat16, device="cuda")
            gan = unet_synthesis.init_state(g_bf16, d_bf16, train_cfg)
            torch.cuda.reset_peak_memory_stats()
            recs_loss = [step_fn(gan, batch)["rec_loss"] for _ in range(2)]  # warm-up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            timed = [step_fn(gan, batch) for _ in range(STEPS_TIMED)]
            end.record()
            torch.cuda.synchronize()
            step_ms = start.elapsed_time(end) / STEPS_TIMED
            peak = torch.cuda.max_memory_allocated() / 2**30
            losses = [float(r) for r in recs_loss + [m["rec_loss"] for m in timed]]
            print(f"train step: {step_ms:.3f} ms at batch {TRAIN_BATCH} bf16 = {1e3 / step_ms:.3f} steps/s "
                  f"= {TRAIN_BATCH * 1e3 / step_ms:.3f} vol/s (CUDA events over {STEPS_TIMED} steps after 2 "
                  f"warm-up, one fixed batch, no data loading); peak memory {peak:.2f} GiB of 80, no remat; {card}")
            print(f"train step: rec loss over {len(losses)} steps on one batch: {[round(v, 6) for v in losses]}; "
                  f"last metrics {({k: float(v) for k, v in timed[-1].items()})}")
            check(all(np.isfinite(float(v)) for m in timed for v in m.values()), "non-finite train-step metrics")
            check(losses[-1] < losses[0], "the rec loss did not fall on a fixed batch")
            profile_window(lambda: step_fn(gan, batch), "train step")
            del gan, g_bf16, d_bf16, timed
            remat_flagship_steps(cfg, state, batch, card)

        phase("8 grads (card vs CPU, fp32 train step)")
        got = {}
        small = synthetic_batch(PARITY_CROP, 1, "cpu", seed=4)
        for dev in ("cuda", "cpu"):
            g32, d32, _ = unet_synthesis.build_models(cfg, FLAGSHIP_K, dtype=torch.float32, device=dev)
            g32.load_state_dict(state)
            d32.load_state_dict(d_state)
            gan = unet_synthesis.init_state(g32, d32, train_cfg)
            before = counts()
            with uncounted():
                step_metrics = step_fn(gan, {k: v.to(dev) for k, v in small.items()})
                launched = tuple(a - b for a, b in zip(counts(), before))
            check(launched == ((6, 6, 6) if dev == "cuda" else (0, 0, 0)), f"{dev} step launches {launched}")
            got[dev] = ({k: float(v) for k, v in step_metrics.items()},
                        {n: p.grad.cpu() for n, p in g32.named_parameters()},
                        {n: p.grad.cpu() for n, p in d32.named_parameters()})
        print(f"grads: step metrics card {got['cuda'][0]} vs CPU {got['cpu'][0]}")
        for key, want in got["cpu"][0].items():
            rel = abs(got["cuda"][0][key] - want) / max(abs(want), 1e-12)
            check(rel <= TOL_STEP_METRIC_REL, f"train-step {key} card vs CPU: {rel:.3e} > {TOL_STEP_METRIC_REL:g}")
        compare_grads("generator", got["cuda"][1], got["cpu"][1])
        compare_grads("discriminator", got["cuda"][2], got["cpu"][2])

        phase("9 causal serving")
        causal_cfg = load_config(None, "training_causal.json")
        causal_args = ["--PET_dir", tree["pet"], "--T1_dir", tree["t1"], "--min_and_max", tree["stats"],
                       "--crop_size", *map(str, CROP), "--device", "cuda"]
        built = causal_task.build_models(causal_cfg, FLAGSHIP_K, dtype=torch.float32, device="cpu")
        causal_states = {name: random_state_dict(model, seed=10 + i)
                         for i, (name, model) in enumerate(zip(CAUSAL_PARTS + ("discriminator",), built))}
        del built
        causal_serving_counts, causal_fwd_ms = causal_serving(fa, causal_cfg, causal_states, tree, causal_args, tmp,
                                                              card)

        phase("10 causal training")
        causal_train_counts, causal_step_ms = causal_training(fa, causal_cfg, causal_states, tree, eval_csv,
                                                              causal_args, tmp, card)
        print(f"causal: generator forward {causal_fwd_ms:.3f} ms, train step {causal_step_ms:.3f} ms, at batch "
              f"{SERVING_BATCH} and {CAUSAL_TRAIN_BATCH}, bf16, full volume; {card}")

        phase("11 classifier")
        classifier = classifier_phase(fa, tree, eval_csv, pred_dir, tmp, card)

        phase("12 BMGAN")
        bmgan_run = bmgan_phase(fa, tree, eval_csv, tmp, card)
        print(f"classifier: forward {classifier['forward_ms']:.3f} ms, train step {classifier['step_ms']:.3f} ms; "
              f"BMGAN: train step {bmgan_run['step_ms']:.3f} ms, peak {bmgan_run['peak_gib']:.2f} GiB; batch 2, bf16, "
              f"full volume; {card}")

        phase("13 phase conv")
        with uncounted():
            t0 = time.perf_counter()
            phase_err = phase_conv_checks(pc)
            phase_err["full"] = max(phase_err["full"], phase_conv_flagship(cfg, state))
            phase_timing = {shape: phase_conv_timing(pc, shape) for shape in PHASE_TIMED}
            phase_timing_f32 = {shape: phase_conv_timing(pc, shape, torch.float32, PHASE_F32_VARIANTS)
                                for shape in PHASE_F32_SHAPES}
            print(f"phase conv checks and timing in {time.perf_counter() - t0:.1f} s")
            entry_launches = phase_conv_entry()

        phase("14 tool-chain")
        t0 = time.perf_counter()
        with uncounted():
            set_counts((0, 0, 0))
            toolchain_phase(pred_dir, tree["csv"], tmp, card)
            check(counts() == (0, 0, 0), f"the tool-chain launched flash kernels: {counts()}")
        print(f"tool-chain phase in {time.perf_counter() - t0:.1f} s (no kernel of this port on its path); {card}")

        phase("15 data parallel")
        t0 = time.perf_counter()
        packed = tuple(os.path.join(train_exp, f"packed_{tag}") for tag in ("train", "eval"))
        data_parallel = data_parallel_phase(fa, tree, eval_csv, packed, tmp, card)
        print(f"data parallel phase in {time.perf_counter() - t0:.1f} s; {card}")

        phase("16 space parallel")
        t0 = time.perf_counter()
        space = space_parallel_phase(fa, tree, eval_csv, packed, tmp, card, data_parallel["one_rank_metrics"])
        flash_at.update(space["timing"])
        print(f"space parallel phase in {time.perf_counter() - t0:.1f} s; {card}")

        phase("17 causal space")
        t0 = time.perf_counter()
        causal_space = causal_space_phase(fa, card, space["causal_fp32"])
        flash_at.update(causal_space["timing"])
        print(f"causal space phase in {time.perf_counter() - t0:.1f} s; {card}")

    phase("18 summary")
    kernels = []
    for name, kind, replaces, launches, err in (
        ("flash_attention_fwd", "fwd", "cips_tpu/ops/pallas/flash_attention.py:44", train_counts[0], fwd_err),
        ("flash_attention_bwd_dq", "dq", "cips_tpu/ops/pallas/flash_attention.py:123", train_counts[1],
         bwd_err["dq"]),
        ("flash_attention_bwd_dkv", "dkv", "cips_tpu/ops/pallas/flash_attention.py:164", train_counts[2],
         bwd_err["dkv"]),
    ):
        source = "cips_tpu_torch/csrc/" + ("flash_attention_fwd.cu" if kind == "fwd" else "flash_attention_bwd.cu")
        i = ("fwd", "dq", "dkv").index(kind)
        kernels.append({"name": name, "route": "cuda", "source": source, "design": DESIGNS[kind],
                        "design_f32": DESIGNS_F32[kind],
                        "replaces": replaces, "launches": launches, "max_abs_err": err,
                        # phase 6's --resume --streaming (the native pool; 6/6/6 a step) and the imported
                        # reference-style checkpoint served by output_predict --epoch N (6, 0, 0)
                        "launches_streamed_resume": resume_counts[i],
                        "launches_imported_serving": imported["launches"][i],
                        # the causal generator's paths (phases 9 and 10), each counted from 0
                        "launches_causal_serving": causal_serving_counts[i],
                        "launches_causal_training": causal_train_counts[i],
                        # the classifier's paths (phase 11): train_classifier, test_mci on real and synthesized PET
                        "launches_classifier_training": classifier["training"][i],
                        "launches_classifier_test": {k: v[i] for k, v in classifier["test"].items()},
                        # phase 15: train_unet under torchrun, each rank's launches
                        "launches_data_parallel": {"ranks": data_parallel["ranks"],
                                                   "backend": data_parallel["backend"],
                                                   "per_rank": [r[i] for r in data_parallel["launches_per_rank"]]},
                        # phase 16: train_unet --n_space 2 under torchrun, each rank's launches (Lq 1152, Lk 2304
                        # in the train steps; the eval forwards take whole volumes)
                        "launches_space_parallel": {"ranks": space["ranks"], "layout": space["layout"],
                                                    "backend": space["backend"],
                                                    "per_rank": [r[i] for r in space["launches_per_rank"]]},
                        # phase 16's uneven slabs: the flagship's dry run at (88, 128, 96), space 2, one step
                        # (Lq 960 and 1152, Lk 2112)
                        "launches_space_uneven": [r[i] for r in space["uneven"]["launches_per_rank"]],
                        # phase 17: the causal trio's dry run at space 2, each rank's launches (Lq 9216, Lk 18432)
                        "launches_causal_space": {"ranks": causal_space["ranks"], "layout": causal_space["layout"],
                                                  "backend": causal_space["backend"],
                                                  "per_rank": [r[i] for r in causal_space["launches_per_rank"]]},
                        **flash_at["x".join(map(str, TRAIN_ATTN))][kind],
                        "at": {label: {k: round(t, 6) if isinstance(t, float) else t for k, t in rows[kind].items()}
                               for label, rows in flash_at.items()}})
    probe = PHASE_SHAPES[0]
    for name, replaces, _, variants in PHASE_ROWS:
        head = phase_timing[probe][variants[0]]  # the row's first variant at the probe shape
        kernels.append({
            "name": name, "route": "cuda", "source": phase_source(variants[0]), "design": DESIGNS[variants[0]],
            "replaces": replaces,
            "launches": sum(entry_launches[name].values()), "max_abs_err": max(phase_err[v] for v in variants),
            **{k: head[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "library_eager_ms", "dense_bound_ms") if k in head},
            "variants": {v: {"source": phase_source(v), "design": DESIGNS[v],
                             "source_f32": phase_source(v, torch.float32), "design_f32": DESIGNS_F32[v],
                             "launches": entry_launches[name][v],
                             "max_abs_err": phase_err[v],
                             "at": {"x".join(map(str, shape)): {k: round(t, 6) if isinstance(t, float) else t
                                                               for k, t in phase_timing[shape][v].items()}
                                    for shape in PHASE_TIMED},
                             # the fp32 kernel (source_f32), TF32 off
                             **({"at_f32": {"x".join(map(str, shape)): {
                                 k: round(t, 6) if isinstance(t, float) else t
                                 for k, t in phase_timing_f32[shape][v].items()} for shape in PHASE_F32_SHAPES}}
                                if v in PHASE_F32_VARIANTS else {})}
                         for v in variants},
        })
    kernels.append({"name": "group_norm", "route": "cuda", "source": "cips_tpu_torch/csrc/group_norm.cu",
                    "replaces": None, "at": group_norm_rows, "launches": NORM_PATHS})
    print(f"calls timed by CUDA events for want of device records: {len(EVENT_TIMED)} {EVENT_TIMED}")
    print(f"chip_smoke: phases 1-18 in {time.perf_counter() - started:.1f} s")
    print(json.dumps({"kernels": kernels, "event_timed": len(EVENT_TIMED)}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--dp-rank":  # a rank of phase 15, started by torchrun
        sys.exit(dp_rank_main(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:] == ["group_norm"]:
        sys.exit(group_norm_main())
    sys.exit(main())
