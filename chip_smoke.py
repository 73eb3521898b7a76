#!/usr/bin/env python3
"""Drive the anap3_tpu_torch main path once on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
printing its own lines and failing the run (exit code 1, no result line)
when it fails:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the cold build of the SG, FV and Newton-Krylov (nk)
   kernels from ``csrc/`` (one ``nvcc`` per family, started together);
   ptxas must report no spill and no stack frame in either instantiation
   of the nk family's ``schur_kernel`` (operator bands resident in shared
   memory, and streamed), and no
   spill and no stack frame in any instantiation of the SG stage kernel
   and of the FV BiCGSTAB and pressure kernels, and their registers must
   leave 3 blocks an SM to the BiCGSTAB kernel in float32 and 4 (float32)
   and 3 (float64) to the pressure kernel;
2. SG kernels: every kernel wrapper (step, tau step, chunk of 64 steps with
   metrics_every=16 and warmup 10) against its plain PyTorch version on the
   same CUDA tensors, at N = 20, 48, 96, 128, 192, 320, 400 (the stage
   kernel's geometry branches: 16-, 32- and 48-wide tiles, whole bands and
   rings, and at N=400 a non-portable cluster of nine blocks),
   float32 and float64, smoothed and singular lids; tolerances: relative
   max error <= 1e-11 in float64 and <= 1e-4 in float32, done/conv_iter
   equal; kernel and plain ms/step at N = 48, 96, 128; at N=128 float32 the
   times of the last stage, dt_kernel, tail_kernel (a sampled step's
   quadratures and finish) and control_kernel (an unsampled step's
   finish), each beside its plain version and bound, the stage's library
   yardstick (its 12 products as torch.matmul) and a torch.profiler idle
   share and kernel shares of a one-lane chunk;
2b. FV kernels: a 32-iteration chunk from rest and one step from the flow
   it reaches, kernel against plain, at 20x20, ny=12 x nx=16 and 128x128,
   float32 and float64 (float64 with n_refine 0 and 1), TVD and upwind;
   tolerances: relative max error <= 1e-10 in float64, <= 1e-4 in float32
   (step and chunk), flags equal; the same kernel chunk run twice must
   agree bit for bit; the chunk's launches must be 2 an iteration, one of
   each FV kernel (fv_bicgstab: the assembly and the BiCGSTAB solve;
   fv_pressure: the pressure stage and control; each one cooperative
   launch); kernel and plain ms per SIMPLE iteration at N=128; at N=128
   float32 each kernel on the main path's inputs (fv_bicgstab's assembly
   and u*, v* against plain_momentum; fv_pressure against
   plain_pressure_stage on the kernel's own momentum solution: rhs_p, p'
   after the gauge, the new state, the metrics from its partials and the
   metrics its control wrote), its time beside its plain version and
   bound, the time of each launch without its folded phase (the solve
   alone, the pressure stage without control), and a torch.profiler idle
   share of one N=128 float32
   chunk; wherever the pressure solve is refined, one step with perturbed
   eigenvalue inverses, so that the refinement moves the state by far more
   than the bound; then, at N=128 in float32 and float64, a chunk whose
   tolerance is met mid-chunk: flags, NaN rows and the frozen state as the
   plain chunk's;
3. SG N=128 Re=1000 float32 (the BASELINE timesteps/s cell): SGSolver
   .solve(max_iter=50_000) with chunk 5000; steps/s net of the first chunk;
4. FSG N=96 Re=1000 tol=1e-6 float32 (the flagship): FSGSolver.solve() with
   max_iterations=400_000; iterations within 20% of the JAX record
   (176,389), Ghia u-centerline max error <= 0.027, L2 errors against the
   stored FV truth;
2c. the SG smoothing loop (sg_smooth_run, the VMG/FMG smoother) with 2 and
   30 steps against its plain version at N = 48, 96, 192, float32 and
   float64, smoothed and singular lids, forced by a tau that is random
   inside the velocity boundary ring and zero on it (the same bounds as
   phase 2); the x6 chunk (quadratures every step) at N=96 against its
   plain version; ms per step of the loop, of as many sg_step_run calls
   and of the plain loop, at N=96 and N=192 float32;
5. FV N=128 Re=100 tol=1e-6 float32 with the numerics of
   conf/solver/fv.yaml and chunk 1000, through FVSolver.solve(): converged,
   iterations within 20% of the JAX record (11,497), L2 against
   data/validation/fv/Re100 <= 0.003 for u and v, Ghia u-centerline max
   error <= 0.008;
6. FV N=128 Re=1000, the same against 11,570 iterations, L2 <= 0.004 and
   Ghia <= 0.008;
7. VMG [192, 96] Re=1000 float32, the full-width path: 2,000 V-cycles from
   rest at tolerance 0 through VMGSolver.solve(); cycles/s net of the first
   chunk, fine-step equivalents/s and a torch.profiler idle share of one
   50-cycle chunk; the state must be finite;
8. VMG N=48 Re=100 tol=1e-6 float32 (ladder [48, 24]): converged, V-cycles
   within 10% of the JAX package's count and final kinetic energy within
   1e-4 relative of its value (JAX_VMG48, from
   scripts/jax_vmg_reference.py);
9. FMG N=96 Re=100 tol=1e-6 float32 (conf/solver/spectral/fmg.yaml: ladder
   [24, 48, 96], coarse factor 10) with matmul_algorithm=x6, so that its
   N=24 level runs the x6 chunk route: the same checks against JAX_FMG96,
   and the Ghia Re=100 u-centerline max error within 0.005 of the JAX
   value.

2d. SG lane kernels (sg_lanes_chunk_run, the sweep lanes): B = 3 lanes
   with Re, corner_smoothing, CFL and beta_squared varying, at N = 20
   (quadratures every step: the tiled lane kernel's cadence), 40 and 96
   (every 16th: the aligned lane kernel's), float32 and float64, smoothed
   and singular lids, and B = 8 in float32, against lanes_plain on the same
   CUDA tensors (the bounds of phase 2, flags equal); every lane against a
   one-lane sg_chunk_run of its own, bit for bit; a lane driven to NaN by a
   huge CFL flagged diverged and frozen while the others keep their bits; a
   tolerance met by one lane mid-chunk; ms per step of the N=128 B=8 and
   N=20 B=8 lane chunks beside 8 one-lane chunks and beside plain;
2e. FV lane kernels (fv_lanes_chunk_run): B = 3 lanes with Re, alpha_uv,
   alpha_p and the lid speed varying, at 20x20, ny=12 x nx=16 and 128x128,
   float32 and float64, TVD and upwind, against lanes_plain (the bounds of
   phase 2b), every lane against a one-lane fv_chunk_run bit for bit, a NaN
   lane isolated, 2 launches a float32 iteration whatever B; ms per
   iteration at 128x128 for B = 1, 3 and 8;
10. fsg sweep N=40: one round of the corner-smoothing optimization
   (conf/experiment/optimization/corner_smoothing.yaml at N=40: FSG
   Re=1000 tol 1e-6 float32, ladder [20, 40]) as 8 lanes, corner_smoothing
   0.03 to 0.10, through parallel.batched.run_batched; each lane's levels,
   iterations, FV-truth L2 (the optimization's objective), the shared wall
   and the aggregate lane-steps/s; lanes 0 and 7 again as one-lane
   FSGSolver.solve(): the same levels, iterations and bits (the sweep and
   the solver share one prolongation routine);
11. sg sweep N=128: 8 lanes (Re 100, 400, 1000, 3200 x corner_smoothing
   0.15, 0.10), 5,000 steps from rest at tolerance 0 in chunks of 1,000;
   aggregate lane-steps/s net of the first chunk; the Re=1000 / 0.15 lane
   bit-equal to a one-lane SGSolver run;
12. fv sweep N=128: 3 lanes, Re 100, 400, 1000, tol 1e-6 float32: the
   Re=100 and Re=1000 lanes take the iterations phases 5 and 6 took; L2
   against the stored truths within 0.003, 0.004 and 0.004;
2f. the Newton Schur kernel (nk_schur, csrc/nk_schur.cu: the Schur
   BiCGSTAB of the Stokes preconditioner, one cooperative launch that stops
   on the device) against its plain version (the masked loop) on the card,
   with the plain loop on the CPU as the yardstick of rounding, on the
   Schur systems of the Newton matvec at N = 12, 20, 96, 128 (ni = N - 1;
   the kernel's operator bands resident in shared memory) and 256 (streamed;
   budgets 8 and 16 only), dt 0.05, 1 and 3e3, the sharp lid at Re=1000 and
   the smoothed one at Re=250: at budgets 8 and 16 (no solve stops early)
   k equal and dp
   within NK_B8_TOL relative or NK_SPREAD x the CPU loop's distance; at
   the default 40, k within 2, a converged solve's true residual within
   NK_RES_TOL (the kernel's and the plain loop's), and for the unconverged
   ones, over each system and NK_PERTURB perturbations of its right-hand
   side, the kernel's residuals against the plain loop's (NK_UNCONV_GM,
   NK_UNCONV_MED); the breakdown codes -10 and -11 and the exit on ||s||
   on operators of the kernel's form; at N = 96, 128 and 256 the kernel's
   and the plain loop's ms a solve at budget 40, iterations, us an
   iteration and bound;
4b. fsg N=96 polished (after phase 4): the flagship again with
   newton_polish=true: the march must take phase 4's iterations, then the
   float64 Newton polish on the card must converge in <= 12 PTC steps to
   steady_residual_rms <= 1e-9; the polish wall and the Ghia u error
   before and after;
A. cli fsg N=96 (after 4b): the flagship through the port's CLI,
   ``anap3_tpu_torch.main.main(["solver=gpu/fsg", "N=96", "Re=1000",
   "plots=false", ...])`` in process with a temporary tracking store: the
   ladder and iterations of phase 4; the run read back through the port's
   tracking.search_runs converged, and the Ghia u-centerline max error of
   its stored solution.vts <= 0.027;
B. cli optimization N=40: one round of the corner-smoothing optimization
   through the CLI (``-m +experiment/optimization=corner_smoothing
   solver=gpu/fsg N=40 hydra.sweeper.params.N=40 optuna.n_trials=8
   plots=false``): the 8 trials run as one batch of 8 FSG lanes
   (parallel.batched.run_batched, the SG lane kernels), the store holds 8
   child runs and the parent's optuna_trials.json with 8 trials and a
   finite best_objective; lanes 0 and 7 again as FSGSolver.solve()
   (uncounted): the same levels, iterations and bits;
13. newton N=128 cold: NewtonSolver.solve() on the sharp lid
   (corner_treatment=singular) at Re=1000 from rest with the Newton knobs
   of conf/solver/spectral/newton.yaml on the Legendre grid of the stored
   exact states, tolerance 1e-6: converged within its 50 PTC steps, the
   first five steps' ||F||_rms within NEWTON_LEAD_TOL of the JAX package's
   (JAX_NEWTON_COLD_LEAD, from scripts/jax_newton_reference.py), u and v
   within NEWTON_COLD_STATE_TOL of the stored exact state; steps, wall,
   seconds a step, GMRES vectors a step, ||F||_rms, psi_min and the
   distance from data/steady/sharp_Re1000_N128.npz. The step count after
   the first five steps is chaotic under rounding, so the same solve runs
   again from x0 + 1e-15 noise of NEWTON_SEEDS (uncounted) and the median
   of the five counts must lie within PLAIN_COLD_STEPS, the plain Schur
   loop's 10th-90th percentile band (scripts/newton_sensitivity.py), every
   solve converged; then the unprofiled wall of one PTC step from rest
   (its graph capture included), and over 20 GMRES vectors of a captured
   matvec the unprofiled wall a vector and, by
   torch.profiler, the device activities a vector, the idle share and the
   leading device operations;
14. newton N=128 warm: from sharp_Re1000_N128.npz at tolerance 1e-8: at
   most 1 step, psi_min within 2e-4 of Botella & Peyret's -0.1189366 and
   |omega_center| within 2e-3 of 2.067753; the stored state meets 1e-8
   (0 steps, as in JAX), so the phase then takes one PTC step from it
   (tolerance 0, newton_max_steps=1), which must keep ||F||_rms below
   1e-8;
14b. newton N=256 warm: from sharp_Re5000_N256.npz (Re=5000) with phase
   14's knobs at tolerance 1e-6: 0 PTC steps; then one PTC step from it
   (tolerance 0, newton_max_steps=1), which must keep ||F||_rms below 1e-8
   (the Schur kernel streams its operator bands at N=256); its wall and the
   kernel's launches;
15. newton prelude N=128: 200 prelude steps in float64 on the sharp lid
   through the SG step kernel against the plain prelude, relative error
   <= 1e-11;
16. sg resume N=128 float32 (chunk kernel, chunks of 1,000) and 17. fv
   resume N=128 float32 (FV chunk kernels, chunks of 100): three chunks in
   one solve against two chunks with checkpoints and a new solver resumed
   for the third; iterations and every field bit-equal.

Phases 18-20 are the distributed paths at world size 1, each in its own
one-rank NCCL process group (NCCL refuses two ranks on one card):

18. sg N=128 x-sharded (parallel/spatial.py, Re=1000, sg.yaml numerics; no
   kernel of the port): 200 float64 steps of the sharded chunk runner from
   rest against the plain sg_step chunk on the same CUDA tensors, relative
   max error <= 1e-11 and flags equal; a float32 64-step chunk from the
   flow after 500 steps against the kernel chunk, <= 1e-4 in u, v, p with
   done and conv_iter equal; 2,000 float32 steps from rest: ms a step
   beside the kernel chunk's, finite, kinetic energy from the final fields
   within 1e-4 relative of the kernel path's after the same steps, and a
   torch.profiler idle share and device activities a step of a 20-step
   chunk beside its unprofiled wall;
19. sg sweep N=128 over a mesh: phase 11's 8 lanes through
   run_batched(mesh=...), every lane bit-equal to phase 11's, with its
   iterations, through sg_lanes_aligned;
20. scaling probe: measure_scaling at one rank and N=127, its keys.

Then dryrun_multigpu over every card prints its line (one card: a one-rank
NCCL world; its 2-process sweep is not measured).

Phases 3 to 20, A and B are the main paths: before each, the launch counters of
every kernel family are zeroed, and after it every kernel the path runs
must have launched and no plain version run. On the Newton paths (4b, 13,
14, 14b) every GMRES vector replays one CUDA graph of the matvec, and the nk
counter counts the Schur kernel's launches in each replay. Every torch.profiler idle
share is printed beside the unprofiled wall of the same work
(utils/profiling.py). The line before the last is the
kernels' JSON summary (launches summed over the main paths; bound_ms the
least time the card could take for the timed work, from the shapes and the
card's published peaks); the last line is the result object.

``python3 chip_smoke.py --newton`` runs phases 1, 2f, 4 (whose march the
polished flagship repeats), 4b, 13, 14, 14b and 15 alone, with the same
checks.

``python3 chip_smoke.py --flagship-vmg`` instead runs the converged VMG
[192, 96] Re=1000 tol=1e-6 float32 solve (the JAX record: 47,685 cycles,
L2 0.0995 / 0.0758) and prints its cycles, wall, cycles/s, L2 against the
stored FV truth and Ghia u-centerline error.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from anap3_tpu_torch import main as cli  # noqa: E402
from anap3_tpu_torch.models import fv as fvm  # noqa: E402
from anap3_tpu_torch.models import spectral_sg as core  # noqa: E402
from anap3_tpu_torch.models.params import (FVParameters,  # noqa: E402
                                           SpectralParameters)
from anap3_tpu_torch.models.runner import control_step  # noqa: E402
from anap3_tpu_torch.models import runner as TR  # noqa: E402
from anap3_tpu_torch.models import spectral_vmg as vmg  # noqa: E402
from anap3_tpu_torch.models import steady  # noqa: E402
from anap3_tpu_torch.models.spectral import (FSGSolver, SGSolver,  # noqa: E402
                                             make_fused_paths)
from anap3_tpu_torch.ops import fv_kernels as fvk  # noqa: E402
from anap3_tpu_torch.ops import fv_lane_kernels as fvl  # noqa: E402
from anap3_tpu_torch.ops import nk_kernels as nkk  # noqa: E402
from anap3_tpu_torch.ops import sg_kernels as sgk  # noqa: E402
from anap3_tpu_torch.ops import sg_lane_kernels as sgl  # noqa: E402
from anap3_tpu_torch.ops._build import build_all, build_info  # noqa: E402
from anap3_tpu_torch.parallel import batched as TB  # noqa: E402
from anap3_tpu_torch.parallel import spatial as SP  # noqa: E402
from anap3_tpu_torch.parallel import sweep as TS  # noqa: E402
from anap3_tpu_torch.parallel.dryrun import dryrun_multigpu  # noqa: E402
from anap3_tpu_torch.parallel.scaling import measure_scaling  # noqa: E402
from anap3_tpu_torch.parallel.sweep import stack_states  # noqa: E402
from anap3_tpu_torch.plotting.data_loading import (  # noqa: E402
    load_fields_from_vts, restructure_fields)
from anap3_tpu_torch.utils import tracking as TT  # noqa: E402
from anap3_tpu_torch.utils.profiling import (  # noqa: E402
    NoDeviceActivity, device_breakdown, profile_chunk, trace_device)

JAX_FSG_ITERATIONS = 176_389  # JAX record for the flagship FSG config
GHIA_MAX_ERR = 0.027
# anap3_tpu on the CPU in float32 (scripts/jax_vmg_reference.py): V-cycles
# (FMG: iterations summed over its levels), final kinetic energy, Ghia
# Re=100 u-centerline max error
JAX_VMG48 = (1678, 0.03288045898079872, 0.0023671919441865426)
JAX_FMG96 = (5891, 0.032877251505851746, 0.0023731883057019794)
# anap3_tpu on the CPU (scripts/jax_newton_reference.py): the Newton
# N=128 Re=1000 sharp-lid solves on the Legendre grid, cold from rest at
# tol 1e-6 and warm from data/steady/sharp_Re1000_N128.npz at tol 1e-8:
# PTC steps, final ||F||_rms, psi_min, omega_center, final energy
JAX_NEWTON_COLD = (34, 4.2142219471090654e-07, -0.11890890593900696,
                   -2.067688188077706, 0.04451810886955563)
JAX_NEWTON_WARM = (0, 1.985123821584891e-11, -0.11890905476651023,
                   -2.067697427482559, 0.04451815348715139)
# ||F||_rms after each of the cold solve's first five PTC steps (the same
# script, --only cold --steps 5), held within NEWTON_LEAD_TOL relative
# (readings: 2.3e-3 at the fifth, 1e-4 before; H100)
JAX_NEWTON_COLD_LEAD = (4.625593550163377, 0.31459195795248635,
                        0.2028347218225133, 0.359472804584428,
                        9.088424637804438)
NEWTON_LEAD_TOL = 1e-2
# Past the first five steps the GMRES(60) solves stop converging and the
# step count turns chaotic under rounding: x0 + 1e-15 noise moves it
# between 25 and 49 (the plain Schur loop, 20 runs). So it is held as a
# distribution: the median of the cold solves from x0 and from x0 + 1e-15
# noise of NEWTON_SEEDS within PLAIN_COLD_STEPS, the 10th-90th percentile
# band of the plain loop's steps from x0 and from the noise of seeds 1-19
# (scripts/newton_sensitivity.py --seeds 19, H100), which the median of
# five of the plain loop's own runs leaves about 2% of the time; JAX's 34
# is printed beside it
NEWTON_SEEDS = (1, 2, 3, 4)
PLAIN_COLD_STEPS = (29.7, 45.1)
# the converged cold state's velocities against the stored exact state
# (||F||_rms <= 1e-6; readings 1.5e-5 and 6.9e-7, H100)
NEWTON_COLD_STATE_TOL = 1e-4
# Botella & Peyret N=160 Re=1000, psi_min and omega_center with the bounds
# of test_re1000_fixture_matches_botella in the JAX package's
# tests/test_steady.py
BOTELLA_RE1000 = (-0.1189366, 2e-4, 2.067753, 2e-3)
STEADY_RE1000 = ROOT / "data/steady/sharp_Re1000_N128.npz"
# the stored N=256 Re=5000 sharp-lid state (||F||_rms <= 1e-9), warm start
# of the Newton phase whose Schur kernel streams its operator bands
STEADY_RE5000_N256 = ROOT / "data/steady/sharp_Re5000_N256.npz"
# the flagship FSG march of phase 4 (iterations, Ghia u error), which the
# polished flagship repeats
FSG_MARCH = {}
# the JAX record of the converged VMG [192, 96] Re=1000 tol 1e-6 f32 solve
# (STATUS.md, solver study r3): cycles, L2 u and v
JAX_VMG192 = (47_685, 0.0995, 0.0758)
# every pallas_call site the SG kernels stand in for: the aligned and
# tiled chunks, the tiled step with tau, the x6 step and chunk, and the
# aligned tau step (the VMG smoother)
_SG_SITES = ("anap3_tpu/ops/pallas_tiled.py:545, pallas_tiled.py:721, "
             "pallas_aligned.py:647, pallas_aligned.py:934, "
             "pallas_step.py:168, pallas_chunk.py:176")
REPLACES = {  # TPU kernels each CUDA kernel stands in for (pallas_call site)
    "sg_stage": _SG_SITES,
    "sg_diag": _SG_SITES,
    "sg_control": _SG_SITES,
    # the body _make_iterate of make_pallas_fv_step / _chunk_runner: the
    # assembly and the solve, then the pressure stage with the chunk's
    # state machine (and the step's metrics vector)
    "fv_bicgstab": "anap3_tpu/ops/pallas_fv.py:415",
    "fv_pressure": "anap3_tpu/ops/pallas_fv.py:415, pallas_fv.py:515",
    # the sweep lanes: the kernels above with a lane axis, looped by the
    # lane entries of csrc/sg_host.cu and csrc/fv_host.cu
    "sg_lanes_tiled": "anap3_tpu/ops/pallas_lanes.py:364",
    "sg_lanes_aligned": "anap3_tpu/ops/pallas_lanes_aligned.py:612",
    "fv_lanes": "anap3_tpu/ops/pallas_fv_lanes.py:524",
    # no pallas_call: jax.scipy.sparse.linalg.bicgstab inside the jitted
    # matvec_fused (steady.py:251), which XLA compiles
    "nk_schur": "anap3_tpu/models/steady.py:173",
}
SOURCES = {"sg_lanes_tiled": "anap3_tpu_torch/csrc/sg_host.cu",
           "sg_lanes_aligned": "anap3_tpu_torch/csrc/sg_host.cu",
           "fv_lanes": "anap3_tpu_torch/csrc/fv_host.cu"}
# sweep lanes: (Re, corner_smoothing, CFL, beta_squared); singular lanes
# take the first three (Re <= 1000 from rest at N=20)
SG_LANES = [(100.0, 0.15, 1.5, 5.0), (400.0, 0.10, 1.2, 4.0),
            (1000.0, 0.05, 1.0, 6.0), (3200.0, 0.20, 1.5, 5.0),
            (100.0, 0.08, 1.3, 5.5), (400.0, 0.12, 1.5, 4.5),
            (1000.0, 0.15, 1.1, 5.0), (200.0, 0.03, 1.4, 6.0)]
# (Re, alpha_uv, alpha_p, lid_velocity)
FV_LANES = [(100.0, 0.4, 0.2, 1.0), (400.0, 0.6, 0.3, 1.0),
            (1000.0, 0.5, 0.25, 1.5)]
# one-lane FV N=128 iterations of phases 5 and 6, by Re (the fv sweep
# repeats them)
FV_B1_ITERATIONS = {}
FV_K = 16  # conf/solver/fv.yaml fv_inner_iters
# (JAX record of iterations, STATUS.md:190-199; L2 bound against the
# stored N=128 FV truth)
FV_TARGETS = {100.0: (11_497, 0.003), 1000.0: (11_570, 0.004)}
FV_GHIA_MAX_ERR = 0.008
# the Schur kernel against the masked plain loop (phase 2f), float64. The
# yardstick of rounding is a second plain implementation: the same loop on
# the CPU in one thread (``cpu_loop``; the operators are built in one host
# BLAS thread too, utils/host_blas); the kernel differs from the card's
# plain loop only in sum order too. Budgets 8 and 16 (no solve stops early:
# the fewest iterations a solve here takes at 40 is 21): k equal and dp
# within NK_B8_TOL relative, or, where the CPU loop is itself further from
# the card's (the iterations amplify the products' rounding), within
# NK_SPREAD times that distance.
NK_EARLY = (8, 16)
# the orders of phase 2f: through N=128 the kernel keeps its operator bands
# in shared memory, at N=256 it streams them (budgets 8 and 16 only)
NK_N = (12, 20, 96, 128, 256)
NK_STREAMED = (256,)
NK_B8_TOL = 1e-12
NK_SPREAD = 10.0
# budget 40: a solve that converges meets the 1e-8 test on its recursive
# residual; its true residual ||S dp - b|| / ||b|| drifts from that by
# rounding. Two converged solutions differ by up to cond(S) times the test,
# so converged solves are held to their residuals (the kernel's and the
# plain loop's), not to each other
NK_RES_TOL = 1.5e-8
# budget 40, a solve that runs out its budget unconverged: its residual is
# a chaotic function of the rounding, so the kernel and the card's plain
# loop each solve the system and NK_PERTURB seeded perturbations of its
# right-hand side (1e-15 relative, element by element); the geometric mean
# of the kernel's residual over the plain loop's on the same right-hand
# side, over all these solves, within NK_UNCONV_GM, and on each system the
# median of the kernel's residuals within NK_UNCONV_MED times the plain
# loop's median
NK_PERTURB = 8
NK_UNCONV_GM = 1.5
NK_UNCONV_MED = 10.0
FV_F64_TOL = 1e-10
# float32, step and chunk: the kernels sum in another order than torch, and
# over 32 iterations from rest those roundings grow to ~1e-6 relative
# (H100); the BiCGSTAB guard, which could flip on rounding near
# convergence, stays active in that transient. 1e-4 leaves a 100x margin.
FV_F32_TOL = 1e-4
# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W):
# FLOP/s by dtype, the highest rate the card offers for it (float32 outside
# the tensor cores; float64 on its FP64 tensor cores, twice its vector
# rate), and HBM bytes/s
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
PEAK_BYTES = 3.35e12


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def rel_err(a, b) -> float:
    a = a.detach().double()
    b = b.detach().double()
    fin = torch.isfinite(b)
    check(bool(torch.equal(fin, torch.isfinite(a))), "NaN positions differ")
    if not bool(fin.any()):
        return 0.0
    scale = float(b[fin].abs().max())
    return float((a[fin] - b[fin]).abs().max()) / max(scale, 1e-300)


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound(flops, nbytes, dtype):
    """(ms, what bounds it): the least time the card could take for work
    that does ``flops`` operations in ``dtype`` and must move ``nbytes``
    (each input read once, each output written once)."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sg_work(nf, dtype):
    """(operations, bytes) of the SG kernels' timed launch groups at order
    nf - 1, one lane, counted from the shapes: a product of (m x k) by
    (k x n) is 2mkn operations; elementwise work is left out (it only
    lowers the bound).

    - sg_stage, one RK stage: the 8 full-grid products of the residuals
      (Dx, Dxx from the left and DyT, DyyT from the right on u and v) and
      the two pressure-gradient chains Gx p IyT, Ix p GyT; it reads the
      stage and base states, 8 operators and the BCs, writes a state;
    - dt (dt_kernel): reads u and v;
    - tail (tail_kernel, a sampled step's tail): omega = Dx v - u DyT, then
      Dx omega and omega DyT; reads u, v, Dx, DyT, W2d and the stage's 9
      partial columns, writes the row;
    - sg_control (control_kernel, an unsampled step's tail): reads the 9
      partial columns of every stage block, writes the row and the next
      dt (the state stays where the last stage wrote it);
    - sg_diag, the counter's two kernels once each: dt and tail.
    """
    ni, e = nf - 2, torch.finfo(dtype).bits // 8
    full, inner = nf * nf, ni * ni
    cols = e * (sgk.stage_geometry(nf, dtype).nparts * 9 + 7)
    work = {
        "sg_stage": (16 * nf ** 3 + 4 * nf * ni * ni + 4 * nf * nf * ni,
                     e * (12 * full + 3 * inner + 4 * nf * ni)),
        "dt": (0, e * 2 * full),
        "tail": (8 * nf ** 3, e * 5 * full + cols),
        "sg_control": (0, cols),
    }
    work["sg_diag"] = tuple(a + b for a, b in zip(work["dt"], work["tail"]))
    return work


def sg_bounds(nf, dtype):
    return {k: bound(f, b, dtype) for k, (f, b) in sg_work(nf, dtype).items()}


def steps_bound(nf, dtype, n_steps, n_quad):
    """Bound of ``n_steps`` RK4 steps (four stages each) with ``n_quad``
    quadrature passes, the input state, forcing and operators read once
    and the output state written once: a chunk, a step, or the smoothing
    loop."""
    ni, e = nf - 2, torch.finfo(dtype).bits // 8
    work = sg_work(nf, dtype)
    flops = 4 * n_steps * work["sg_stage"][0] + n_quad * work["tail"][0]
    return bound(flops, e * (13 * nf * nf + 3 * ni * ni + 4 * nf * ni), dtype)


def params(n, dtype, corner="smoothing", **kw):
    # the shipped conf/solver/spectral/sg.yaml numerics
    base = dict(Re=1000.0, nx=n, ny=n, basis_type="chebyshev", CFL=1.5,
                beta_squared=5.0, corner_treatment=corner,
                corner_smoothing=0.15, dtype=dtype, device="cuda",
                chunk_size=5000, convergence_metric="auto")
    base.update(kw)
    return SpectralParameters(**base)


def ptxas_kernels(report):
    """(kernel, type letter, registers, stack frame, spill stores) of every
    entry function in a ptxas -v report, the kernel by its template name
    (f: float, d: double)."""
    return [(k, t, int(r), int(f), int(sp)) for k, t, f, sp, r in re.findall(
        r"Function properties for \S*?\d+([A-Za-z_]+_kernel)I([fd])\S*\n"
        r"\s*(\d+) bytes stack frame, (\d+) bytes spill stores[^\n]*\n"
        r"[^\n]*Used (\d+) registers", report)]


def blocks_per_sm(regs, threads=256):
    """Blocks of ``threads`` threads an H100 SM holds at ``regs`` registers
    a thread (64K registers an SM, allocated in 8s a thread; 2,048 threads
    an SM), shared memory aside."""
    return min(65536 // (threads * (-(-regs // 8) * 8)), 2048 // threads)


def kernel_build_check(report, name, min_blocks=None):
    """ptxas's report of kernel ``name`` (every instantiation): its
    registers, the largest stack frame and spill stores, both of which
    must be 0, and, by type letter in ``min_blocks``, the blocks an SM its
    registers must leave."""
    blocks = [k for k in ptxas_kernels(report) if k[0] == name]
    check(blocks, f"ptxas reported no {name}")
    frame = max(k[3] for k in blocks)
    spill = max(k[4] for k in blocks)
    regs = ", ".join(f"{t} {r} ({blocks_per_sm(r)} blocks an SM)"
                     for _, t, r, _, _ in blocks)
    print(f"[device] {name}: {len(blocks)} instantiations, registers "
          f"({regs}), largest stack frame {frame} bytes, spill stores "
          f"{spill} bytes", flush=True)
    check(frame == 0 and spill == 0, f"{name} spills or has a stack frame")
    for _, t, r, _, _ in blocks:
        want = (min_blocks or {}).get(t, 1)
        check(blocks_per_sm(r) >= want, f"{name}<{t}>: {r} registers leave "
              f"{blocks_per_sm(r)} blocks an SM, fewer than {want}")


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.time()
    build_all()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"card {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"kernel builds {time.time() - t0:.1f}s wall", flush=True)
    for family in ("sg", "fv", "nk"):
        info = build_info(family)
        check(info.get("path"), f"the {family} kernel library did not load")
        # this process's build, or the report the cached build left
        log = Path(info["path"]).parent / "build.log"
        report = info.get("ptxas") or (log.read_text() if log.exists()
                                        else "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
        spills = [int(b) for b in
                  re.findall(r"(\d+) bytes spill stores", report)]
        stacks = [int(b) for b in
                  re.findall(r"(\d+) bytes stack frame", report)]
        print(f"[device] {family} kernels: nvcc {info['build_seconds']:.1f}s "
              f"(cached={info.get('cached')}); ptxas: {len(regs)} kernels, "
              f"max {max(regs, default=0)} registers, {sum(spills)} bytes of "
              f"spill stores, largest stack frame {max(stacks, default=0)} "
              f"bytes (report: {Path(info['path']).parent / 'build.log'})",
              flush=True)
        if family == "fv":
            print("[device] fv registers (f, d): " + ", ".join(
                f"{k}<{t}> {r}" for k, t, r, _, _ in ptxas_kernels(report)),
                flush=True)
        if family == "sg":
            kernel_build_check(report, "stage_kernel")
        elif family == "nk":
            # every instantiation: the resident (Lb1) and streamed (Lb0)
            frames = re.findall(
                r"Function properties for \S*schur_kernelIL(b[01])\S*\n\s*"
                r"(\d+) bytes stack frame, (\d+) bytes spill stores[^\n]*\n"
                r"[^\n]*Used (\d+) registers", report)
            check(len(frames) == 2, f"ptxas reported {len(frames)} "
                  f"instantiations of schur_kernel, not 2")
            for inst, frame, spill, regs in frames:
                print(f"[device] schur_kernel<{'resident' if inst == 'b1' else 'streamed'}>:"
                      f" registers {regs}, stack frame {frame} bytes, spill "
                      f"stores {spill} bytes", flush=True)
                check((frame, spill) == ("0", "0"),
                      f"schur_kernel<{inst}> spills or has a stack frame")
        else:
            kernel_build_check(report, "bicg_kernel", {"f": 3})
            kernel_build_check(report, "pressure_kernel", {"f": 4, "d": 3})
    return card


def random_state(ops, rng):
    nf = ops.nf
    u = 0.05 * rng.standard_normal((nf, nf))
    v = 0.05 * rng.standard_normal((nf, nf))
    p = 0.05 * rng.standard_normal((nf - 2, nf - 2))
    st = core.state_from_numpy((u, v, p), ops.device, ops.dtype)
    uu, vv = core.enforce_bc(ops, st.u, st.v)
    return core.SpectralState(uu.contiguous(), vv.contiguous(), st.p)


def phase_kernels(summary):
    rng = np.random.default_rng(0)
    chunk, m_every, warmup = 64, 16, 10
    for n in (20, 48, 96, 128, 192, 320, 400):
        for dt_name in ("float32", "float64"):
            tol = 1e-4 if dt_name == "float32" else 1e-11
            for corner in ("smoothing", "singular"):
                ops, _ = core.build_spectral_ops(params(n, dt_name, corner))
                st = random_state(ops, rng)
                step = sgk.make_sg_step(ops)
                s_k, m_k = step(st)
                torch.cuda.synchronize()  # a fault shows where it happened
                s_p, m_p = sgk.step_plain(ops, st)
                e_state = max(rel_err(a, b) for a, b in zip(s_k, s_p))
                e_met = max(rel_err(m_k[k], m_p[k]) for k in m_p)
                nf = ops.nf
                tau = tuple(
                    torch.as_tensor(0.01 * rng.standard_normal(shape),
                                    dtype=ops.dtype, device=ops.device)
                    for shape in ((nf, nf), (nf, nf), (nf - 2, nf - 2)))
                s_kt, m_kt = sgk.make_sg_step(ops, with_tau=True)(st, tau)
                s_pt, m_pt = sgk.step_plain(ops, st, tau)
                e_tau = max([rel_err(a, b) for a, b in zip(s_kt, s_pt)]
                            + [rel_err(m_kt[k], m_pt[k]) for k in m_pt])
                # the chunk from rest: the cold-start transient
                st0 = core.initial_state(ops)
                ref = torch.tensor(float("inf"), dtype=ops.dtype,
                                   device=ops.device)
                run_k = sgk.make_sg_chunk_runner(ops, chunk, 1e-30, warmup,
                                                 "rel_iter", m_every)
                out_k = run_k(st0, 0, ref)
                out_p = sgk.chunk_plain(ops, st0, 0, ref, chunk, 1e-30,
                                        warmup, False, m_every)
                e_chunk = max(rel_err(a, b) for a, b in zip(out_k[0], out_p[0]))
                e_rows = max(rel_err(out_k[4][:, c], out_p[4][:, c])
                             for c in range(7))  # per column
                flags_k = [int(out_k[i]) for i in (1, 2, 3)]
                flags_p = [int(out_p[i]) for i in (1, 2, 3)]
                worst = max(e_state, e_met, e_tau, e_chunk, e_rows)
                print(f"[kernels] N={n} {dt_name} {corner}: step state "
                      f"{e_state:.2e} metrics {e_met:.2e} tau {e_tau:.2e} "
                      f"chunk state {e_chunk:.2e} rows {e_rows:.2e} "
                      f"flags {flags_k} (tol {tol:.0e})", flush=True)
                check(worst <= tol, f"N={n} {dt_name} {corner}: relative "
                      f"error {worst:.3e} > {tol:.0e}")
                check(flags_k == flags_p, f"flags differ: {flags_k} vs "
                      f"{flags_p}")
                if corner == "smoothing" and n in (48, 96, 128):
                    t_k = cuda_ms(lambda: run_k(st0, 0, ref), 3) / chunk
                    t_p = cuda_ms(lambda: sgk.chunk_plain(
                        ops, st0, 0, ref, chunk, 1e-30, warmup, False,
                        m_every), 1) / chunk
                    # quadratures at i = 0 and every m_every-th step
                    b_ms, b_by = steps_bound(ops.nf, ops.dtype, chunk,
                                             chunk // m_every)
                    print(f"[kernels] N={n} {dt_name}: chunk ms/step kernel "
                          f"{t_k:.4f} plain {t_p:.4f} bound "
                          f"{b_ms / chunk:.5f} ({b_by})", flush=True)
                if n == 128 and dt_name == "float32" and corner == "smoothing":
                    # absolute errors on the main path's inputs: one step
                    # from the flow 64 steps after rest, and that chunk
                    s_k, m_k = step(out_p[0])
                    s_p, m_p = sgk.step_plain(ops, out_p[0])
                    summary["sg_stage"]["max_abs_err"] = max(
                        float((a.double() - b.double()).abs().max())
                        for a, b in zip(s_k, s_p))
                    summary["sg_diag"]["max_abs_err"] = max(
                        abs(float(m_k[k]) - float(m_p[k]))
                        for k in ("energy", "enstrophy", "palinstrophy"))
                    summary["sg_control"]["max_abs_err"] = float(
                        (out_k[4].double() - out_p[4].double()).abs().max())
                    print(f"[kernels] N=128 float32 developed flow: abs err "
                          + ", ".join(f"{k} {summary[k]['max_abs_err']:.3e}"
                                      for k in sgk.KERNELS), flush=True)
                    time_kernels(ops, st0, summary)


def time_kernels(ops, st0, summary):
    """Per-kernel time (bench entry of the library, CUDA events) beside
    its plain PyTorch counterpart and its bound, at N=128 float32: the
    last stage, dt_kernel, tail_kernel (a sampled step's tail),
    control_kernel (an unsampled step's), and sg_diag as one dt and one
    tail launch."""
    run = sgk.make_sg_chunk_runner(ops, 16, 1e-30, 10, "rel_iter", 16)
    st = run(st0, 0, float("inf"))[0]  # a developing flow, not rest
    ws = sgk.chunk_workspace(ops, st, 16, float("inf"))
    for a, b in (("au", st.u), ("av", st.v), ("ap", st.p), ("bu", st.u),
                 ("bv", st.v), ("bp", st.p)):
        ws[a].copy_(b)
    reps = 200
    # the partials every tail reads, from this state
    sgk.bench_kernel(ops, ws, "sg_stage", 1)
    ms = {name: cuda_ms(lambda: sgk.bench_kernel(ops, ws, name, reps),
                        1) / reps for name in sgk.BENCH_GROUPS}
    ms["sg_diag"] = cuda_ms(lambda: (sgk.bench_kernel(ops, ws, "dt", reps),
                                     sgk.bench_kernel(ops, ws, "tail", reps)),
                            1) / reps
    u, v, p = st
    dt = core.adaptive_dt(ops, u, v)

    def plain_stage():
        R_u, R_v, R_p = core.residuals(ops, u, v, p)
        core.enforce_bc(ops, u + dt * R_u, v + dt * R_v)
        return p + dt * R_p

    def plain_dt():
        return (core.adaptive_dt(ops, u, v), (u * u).sum(), (v * v).sum())

    done = torch.zeros((), dtype=torch.bool, device=ops.device)
    conv = torch.full((), -1, dtype=torch.int32, device=ops.device)
    ref = torch.tensor(float("inf"), dtype=ops.dtype, device=ops.device)

    def plain_control():
        row = torch.stack([torch.linalg.norm(u - v), torch.linalg.norm(u),
                           torch.linalg.norm(v), torch.linalg.norm(p),
                           dt, dt, dt])
        control_step(row, 100, done, conv, done, ref, 1e-30, 10, False)
        return plain_dt()

    def plain_tail():
        core.conserved_quantities(ops, u, v)
        return plain_control()

    plain = {"sg_stage": plain_stage, "dt": plain_dt, "tail": plain_tail,
             "sg_control": plain_control,
             "sg_diag": lambda: (plain_dt(), plain_tail())}
    bounds = sg_bounds(ops.nf, ops.dtype)
    rows = {}
    for name, fn in plain.items():
        b_ms, b_by = bounds[name]
        rows[name] = dict(ms=ms[name], plain_ms=cuda_ms(fn, 50),
                          bound_ms=b_ms, bound_by=b_by)
    for name in sgk.KERNELS:
        summary[name].update(rows[name], library_ms=None)
    summary["sg_diag"]["parts"] = {"dt_kernel": rows["dt"],
                                   "tail_kernel": rows["tail"]}
    summary["sg_stage"]["library_ms"] = stage_library_ms(ops, st)
    print(f"[kernels] sg_stage library yardstick (12 products as "
          f"torch.matmul, TF32 off): {summary['sg_stage']['library_ms']:.4f}"
          f" ms", flush=True)
    profile_chunk(lambda: run(st, 16, float("inf")),
                  "profile SG N=128 float32 one lane, 16-step chunk")
    for name, what in (("sg_stage", "sg_stage (last stage)"),
                       ("dt", "dt_kernel"), ("tail", "tail_kernel"),
                       ("sg_control", "control_kernel"),
                       ("sg_diag", "sg_diag (dt + tail)")):
        r = rows[name]
        print(f"[kernels] {what} at N=128 float32: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.3g} ms "
              f"({r['bound_by']})", flush=True)


def stage_library_ms(ops, st):
    """torch.matmul doing the stage's 12 products on stacked operands in
    the working dtype, TF32 off: [Dx, Dxx, Dx, Dxx] @ [u, u, v, v],
    [u, u, v, v] @ [DyT, DyyT, DyT, DyyT], and ([Gx, Ix] @ p) @ [IyT, GyT].
    A yardstick only; the port never calls it."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    u, v, p = st
    left = torch.stack([ops.Dx, ops.Dxx, ops.Dx, ops.Dxx])
    fields = torch.stack([u, u, v, v])
    right = torch.stack([ops.DyT, ops.DyyT, ops.DyT, ops.DyyT])
    grads = torch.stack([ops.Gx, ops.Ix])
    interp = torch.stack([ops.IyT, ops.GyT])

    def products():
        return (torch.matmul(left, fields), torch.matmul(fields, right),
                torch.matmul(torch.matmul(grads, p), interp))

    return cuda_ms(products, 50)


def ring_zero_tau(ops, rng, scale=0.01):
    """A FAS forcing as a V-cycle makes it: random inside the velocity
    boundary ring, zero on it (the pressure forcing everywhere)."""
    nf = ops.nf
    ring = ops.interior.to(ops.dtype)
    return tuple(
        torch.as_tensor(scale * rng.standard_normal(shape), dtype=ops.dtype,
                        device=ops.device) * m
        for shape, m in (((nf, nf), ring), ((nf, nf), ring),
                         ((nf - 2, nf - 2), 1.0)))


def phase_smoother():
    """Phase 2c: the smoothing loop and the x6 chunk against their plain
    versions, and the loop's time per step."""
    rng = np.random.default_rng(2)
    # N=24 is the coarse level of the VMG N=48 and FMG ladders
    for n in (24, 48, 96, 192):
        for dt_name in ("float32", "float64"):
            tol = 1e-4 if dt_name == "float32" else 1e-11
            for corner in ("smoothing", "singular"):
                ops, _ = core.build_spectral_ops(params(n, dt_name, corner))
                smooth = sgk.make_sg_smoother(ops)
                st = core.initial_state(ops)
                tau = ring_zero_tau(ops, rng)
                errs = []
                for n_steps in (2, 30):
                    s_k, m_k = smooth(st, tau, n_steps)
                    torch.cuda.synchronize()  # a fault shows where it happened
                    s_p, m_p = sgk.smooth_plain(ops, st, tau, n_steps)
                    errs.append(max([rel_err(a, b) for a, b in zip(s_k, s_p)]
                                    + [rel_err(m_k[k], m_p[k]) for k in m_p]))
                print(f"[smoother] N={n} {dt_name} {corner}: 2 steps "
                      f"{errs[0]:.2e}, 30 steps {errs[1]:.2e} (tol {tol:.0e})",
                      flush=True)
                check(max(errs) <= tol, f"smoother N={n} {dt_name} {corner}: "
                      f"relative error {max(errs):.3e} > {tol:.0e}")
    # the x6 route: the chunk kernel with quadratures every step, at N=24
    # (FMG's coarsest stage, where the main path runs it) and at N=96
    for n in (24, 96):
        ops, _ = core.build_spectral_ops(params(n, "float32"))
        _, factory = make_fused_paths(ops, "x6")
        st0 = core.initial_state(ops)
        out_k = factory(64, 1e-30, "rel_iter")(st0, 0, float("inf"))
        out_p = sgk.chunk_plain(ops, st0, 0, float("inf"), 64, 1e-30, 10,
                                False, 1)
        err = max([rel_err(a, b) for a, b in zip(out_k[0], out_p[0])]
                  + [rel_err(out_k[4][:, c], out_p[4][:, c])
                     for c in range(7)])
        flags_k = [int(out_k[i]) for i in (1, 2, 3)]
        flags_p = [int(out_p[i]) for i in (1, 2, 3)]
        print(f"[smoother] x6 chunk N={n} float32, 64 steps, metrics every "
              f"step: relative error {err:.2e}, flags {flags_k} (plain "
              f"{flags_p})", flush=True)
        check(err <= 1e-4 and flags_k == flags_p,
              f"x6 chunk N={n} differs from plain")
    t_x6 = cuda_ms(lambda: factory(64, 1e-30, "rel_iter")(
        st0, 0, float("inf")), 3) / 64
    t_x6p = cuda_ms(lambda: sgk.chunk_plain(
        ops, st0, 0, float("inf"), 64, 1e-30, 10, False, 1), 1) / 64
    step = sgk.make_sg_step(ops)
    t_st = cuda_ms(lambda: step(st0), 20)
    t_stp = cuda_ms(lambda: sgk.step_plain(ops, st0), 5)
    b_chunk = steps_bound(ops.nf, ops.dtype, 64, 64)[0] / 64
    b_step, b_by = steps_bound(ops.nf, ops.dtype, 1, 1)
    print(f"[smoother] x6 route N=96 float32: chunk {t_x6:.4f} ms/step "
          f"(plain {t_x6p:.4f}, bound {b_chunk:.5f}), step {t_st:.4f} ms "
          f"(plain {t_stp:.4f}, bound {b_step:.5f}; {b_by})", flush=True)
    for n in (96, 192):
        ops, _ = core.build_spectral_ops(params(n, "float32"))
        smooth = sgk.make_sg_smoother(ops)
        step = sgk.make_sg_step(ops, with_tau=True)
        st = core.initial_state(ops)
        tau = ring_zero_tau(ops, rng)

        def steps():
            s = st
            for _ in range(30):
                s, _ = step(s, tau)
            return s

        t_loop = cuda_ms(lambda: smooth(st, tau, 30), 10) / 30
        t_steps = cuda_ms(steps, 3) / 30
        t_plain = cuda_ms(lambda: sgk.smooth_plain(ops, st, tau, 30), 1) / 30
        b_ms, b_by = steps_bound(ops.nf, ops.dtype, 30, 1)
        print(f"[smoother] N={n} float32, 30 forced steps: loop "
              f"{t_loop:.4f} ms/step, sg_step_run calls {t_steps:.4f}, plain "
              f"{t_plain:.4f}; bound {b_ms / 30:.5f} ms/step ({b_by})",
              flush=True)


def lane_ops(n, dtype, lanes, corner="smoothing"):
    """The CUDA operators of sweep lanes of (Re, corner_smoothing, CFL,
    beta_squared) at order n."""
    return [core.build_spectral_ops(params(
        n, dtype, corner, Re=Re, corner_smoothing=cs, CFL=cfl,
        beta_squared=beta))[0] for Re, cs, cfl, beta in lanes]


def lane_of(states, b):
    return type(states)(*(t[b] for t in states))


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bool(torch.equal(
        torch.where(nan, 0, a), torch.where(nan, 0, b)))


def max_abs(outs_k, outs_p) -> float:
    return max(float((a.double() - b.double()).abs().nan_to_num(0).max())
               for a, b in zip(outs_k, outs_p))


def check_lanes(what, run_k, run_plain, run_one, states, err_tol):
    """A lane chunk (``run_k(states)`` -> (states, carry, rows)) against
    its plain version on the same tensors (relative error per field and
    per row column, flags equal), and every lane against a one-lane kernel
    chunk of its own (``run_one(b, lane_state)`` -> the B=1 chunk tuple),
    bit for bit. Returns the kernel output, the plain output, the worst
    relative error and the largest absolute error of the states (the rows'
    quadratures reach 1e10 and more; their error is printed)."""
    out_k = run_k(states)
    torch.cuda.synchronize()  # a fault shows where it happened
    out_p = run_plain(states)
    err = max([rel_err(a, b) for a, b in zip(out_k[0], out_p[0])]
              + [rel_err(out_k[2][..., c], out_p[2][..., c])
                 for c in range(7)])
    flags_k, flags_p = out_k[1].flags.tolist(), out_p[1].flags.tolist()
    bitwise = True
    for b in range(len(flags_k)):
        one = run_one(b, lane_of(states, b))
        bitwise &= all(same_bits(a[b], c) for a, c in zip(out_k[0], one[0]))
        bitwise &= same_bits(out_k[2][:, b], one[4])
        bitwise &= flags_k[b] == [int(one[i]) for i in (1, 2, 3)]
    abs_err = max_abs(out_k[0], out_p[0])
    print(f"[lanes] {what}: relative error {err:.2e} (tol {err_tol:.0e}), "
          f"abs state {abs_err:.3e} rows {max_abs([out_k[2]], [out_p[2]]):.3e}"
          f", flags {flags_k}, every lane bitwise its one-lane chunk: "
          f"{bitwise}", flush=True)
    check(err <= err_tol, f"lanes {what}: relative error {err:.3e} > "
          f"{err_tol:.0e}")
    check(flags_k == flags_p, f"lanes {what}: flags {flags_k} vs plain "
          f"{flags_p}")
    check(bitwise, f"lanes {what}: a lane differs from its one-lane chunk")
    return out_k, out_p, err, abs_err


def sg_lane_check(ops_list, chunk, tol, what, err_tol, states=None):
    o0, B = ops_list[0], len(ops_list)
    m = sgl.lane_metrics_every(o0.nf - 1)
    if states is None:
        states = stack_states([core.initial_state(o) for o in ops_list])
    carry = TR.fresh_carry(B, o0.dtype, o0.device)
    return check_lanes(
        what, lambda st: sgl.make_lane_chunk_runner(ops_list, chunk, tol)(
            st, 0),
        lambda st: sgl.lanes_plain(ops_list, st, 0, carry, chunk, tol, 10,
                                   False, m),
        lambda b, st: sgk.make_sg_chunk_runner(
            ops_list[b], chunk, tol, 10, "rel_iter", m)(st, 0, float("inf")),
        states, err_tol)


def sampled_steps(start, chunk, m):
    return sum(1 for i in range(chunk) if i == 0 or (start + i) % m == 0)


def phase_sg_lanes(summary):
    """Phase 2d: the SG lane kernels against lanes_plain and one-lane
    chunks; NaN isolation; a mid-chunk tolerance; timings."""
    t0 = time.time()
    for n in (20, 40, 96):
        for dt_name in ("float32", "float64"):
            err_tol = 1e-4 if dt_name == "float32" else 1e-11
            for corner in ("smoothing", "singular"):
                sizes = (3, 8) if (dt_name, corner) == ("float32",
                                                        "smoothing") else (3,)
                for B in sizes:
                    ops_list = lane_ops(n, dt_name, SG_LANES[:B], corner)
                    sg_lane_check(ops_list, 40, 1e-30,
                                  f"SG N={n} {dt_name} {corner} B={B}",
                                  err_tol)
    # a lane driven to NaN: flagged diverged, frozen, the others untouched
    for dt_name in ("float32", "float64"):
        lanes = SG_LANES[:2] + [(400.0, 0.15, 1e4, 5.0)]
        ops_list = lane_ops(40, dt_name, lanes)
        st = stack_states([core.initial_state(o) for o in ops_list])
        run = sgl.make_lane_chunk_runner(ops_list, 48, 1e-30)
        out = run(st, 0)
        again = run(out[0], 48, out[1])
        f = out[1].flags.tolist()
        frozen = (all(same_bits(a[2], b[2]) for a, b in zip(again[0], out[0]))
                  and bool(torch.isnan(again[2][:, 2]).all())
                  and again[1].flags[2].tolist() == f[2])
        isolated = True
        for b in range(2):
            one = sgk.make_sg_chunk_runner(ops_list[b], 48, 1e-30, 10,
                                           "rel_iter", 16)(
                lane_of(st, b), 0, float("inf"))
            isolated &= all(same_bits(a[b], c) for a, c in zip(out[0], one[0]))
        print(f"[lanes] SG N=40 {dt_name} NaN lane (CFL 1e4): flags {f}, "
              f"frozen over the next chunk {frozen}, other lanes bitwise "
              f"their one-lane chunks {isolated}", flush=True)
        check(f[2][0] == 1 and f[2][2] == 0 and f[2][1] > 0
              and bool(torch.isnan(out[2][f[2][1]:, 2]).all()),
              f"SG NaN lane not flagged diverged: {f[2]}")
        check(frozen and isolated and f[:2] == [[0, -1, 0]] * 2,
              "SG NaN lane not isolated")
    # a tolerance that lane 0 meets mid-chunk, before step 25, and lane 1
    # (its iterate change stays about twice lane 0's) not before: flags,
    # NaN rows and the frozen state as plain
    for dt_name in ("float32", "float64"):
        err_tol = 1e-4 if dt_name == "float32" else 1e-11
        lanes = [(100.0, 0.15, 1.5, 5.0), (1000.0, 0.15, 0.3, 5.0),
                 (400.0, 0.10, 1.2, 4.0)]
        ops_list = lane_ops(40, dt_name, lanes)
        st = stack_states([core.initial_state(o) for o in ops_list])
        carry = TR.fresh_carry(3, ops_list[0].dtype, ops_list[0].device)
        probe = sgl.lanes_plain(ops_list, st, 0, carry, 40, 1e-30, 10, False,
                                16)[2][:, :, 0].double().cpu().numpy()
        tol = float(probe[10:25, 1].min()) * 0.99
        check(float(probe[10:25, 0].min()) < tol, "no mid-chunk crossing")
        out_k, out_p, _, _ = sg_lane_check(
            ops_list, 40, tol, f"SG N=40 {dt_name} tol {tol:.4e} mid-chunk",
            err_tol)
        conv = out_p[1].flags[0].tolist()
        check(conv[0] == 1 and conv[2] == 1 and 10 < conv[1] <= 25,
              f"lane 0 did not converge mid-chunk: {conv}")
        check(torch.equal(torch.isnan(out_k[2]), torch.isnan(out_p[2])),
              "mid-chunk NaN rows differ")
    # the main paths' shapes, float32: N=128 B=8 (sg sweep: the aligned
    # cadence) and N=20 B=8 (the fsg sweep's coarse level: every step)
    for key, n in (("sg_lanes_aligned", 128), ("sg_lanes_tiled", 20)):
        ops_list = lane_ops(n, "float32", SG_LANES)
        o0 = ops_list[0]
        m = sgl.lane_metrics_every(n)
        out_k, _, _, abs_err = sg_lane_check(
            ops_list, 16, 1e-30, f"SG N={n} float32 B=8 (main path)", 1e-4)
        summary[key]["max_abs_err"] = abs_err
        st = out_k[0]  # a developing flow, not rest
        chunk = 200
        run = sgl.make_lane_chunk_runner(ops_list, chunk, 1e-30)
        ones = [sgk.make_sg_chunk_runner(o, chunk, 1e-30, 10, "rel_iter", m)
                for o in ops_list]
        t_lane = cuda_ms(lambda: run(st, 16), 3) / chunk
        t_ones = cuda_ms(lambda: [r(lane_of(st, b), 16, float("inf"))
                                  for b, r in enumerate(ones)], 2) / chunk
        carry = TR.fresh_carry(8, o0.dtype, o0.device)
        t_plain = cuda_ms(lambda: sgl.lanes_plain(
            ops_list, st, 16, carry, 4, 1e-30, 10, False, m), 1) / 4
        b_ms, b_by = steps_bound(o0.nf, o0.dtype, chunk,
                                 sampled_steps(16, chunk, m))
        bound_step = 8 * b_ms / chunk
        summary[key].update(ms=t_lane, plain_ms=t_plain, bound_ms=bound_step,
                            bound_by=b_by, library_ms=None)
        profile_chunk(lambda: run(st, 16),
                      f"lanes profile SG N={n} float32 B=8 {chunk}-step chunk")
        print(f"[lanes] SG N={n} float32 B=8, quadratures every {m}: lane "
              f"chunk {t_lane:.4f} ms/step ({8 / t_lane * 1e3:.1f} "
              f"lane-steps/s), 8 one-lane chunks {t_ones:.4f} ms/step "
              f"({t_ones / t_lane:.2f}x), plain {t_plain:.4f} ms/step, "
              f"bound {bound_step:.5f} ms/step ({b_by})", flush=True)
    print(f"[lanes] phase 2d: {time.time() - t0:.1f}s", flush=True)


def fv_lane_setup(ny, nx, dt_name, scheme, lanes):
    ps = [fv_params(ny, nx, dt_name, scheme, Re=Re, alpha_uv=a, alpha_p=ap,
                    lid_velocity=U) for Re, a, ap, U in lanes]
    return ps, [fv_ops(p) for p in ps]


def fv_lane_check(ps, ops_list, chunk, tol, what, err_tol, states=None):
    o0, B = ops_list[0], len(ops_list)
    if states is None:
        states = stack_states([fvm.initial_state(o) for o in ops_list])
    S_list = [fvk.statics(p, o) for p, o in zip(ps, ops_list)]
    carry = TR.fresh_carry(B, o0.dtype, o0.device)
    return check_lanes(
        what, lambda st: fvl.make_fv_lane_runner(ps, ops_list, chunk, tol, 10,
                                                 FV_K)(st, 0),
        lambda st: fvl.lanes_plain(S_list, st, 0, carry, chunk, tol, 10,
                                   FV_K),
        lambda b, st: fvk.make_fv_chunk_runner(
            ps[b], ops_list[b], chunk, tol, 10, FV_K)(st, 0, float("inf")),
        states, err_tol)


def phase_fv_lanes(summary):
    """Phase 2e: the FV lane kernels against lanes_plain and one-lane
    chunks; NaN isolation; timings at 128x128."""
    t0 = time.time()
    for ny, nx in ((20, 20), (12, 16), (128, 128)):
        for dt_name in ("float32", "float64"):
            err_tol = FV_F32_TOL if dt_name == "float32" else FV_F64_TOL
            for scheme in ("TVD", "Upwind"):
                ps, ops_list = fv_lane_setup(ny, nx, dt_name, scheme,
                                             FV_LANES)
                _, _, _, abs_err = fv_lane_check(
                    ps, ops_list, 20, 1e-30,
                    f"FV {ny}x{nx} {dt_name} {scheme} B=3", err_tol)
                if (nx, dt_name, scheme) == (128, "float32", "TVD"):
                    summary["fv_lanes"]["max_abs_err"] = abs_err
    ps, ops_list = fv_lane_setup(20, 20, "float32", "TVD", FV_LANES)
    states = [fvm.initial_state(o) for o in ops_list]
    u = states[1].u.clone()
    u[5, 7] = float("nan")
    states[1] = fvm.FVState(u, *states[1][1:])
    st = stack_states(states)
    run = fvl.make_fv_lane_runner(ps, ops_list, 16, 1e-30, 10, FV_K)
    out = run(st, 0)
    again = run(out[0], 16, out[1])
    f = out[1].flags.tolist()
    frozen = (all(same_bits(a[1], b[1]) for a, b in zip(again[0], out[0]))
              and bool(torch.isnan(again[2][:, 1]).all()))
    isolated = True
    for b in (0, 2):
        one = fvk.make_fv_chunk_runner(ps[b], ops_list[b], 16, 1e-30, 10,
                                       FV_K)(states[b], 0, float("inf"))
        isolated &= all(same_bits(a[b], c) for a, c in zip(out[0], one[0]))
    print(f"[lanes] FV 20x20 float32 NaN lane: flags {f}, frozen over the "
          f"next chunk {frozen}, other lanes bitwise their one-lane chunks "
          f"{isolated}", flush=True)
    check(f == [[0, -1, 0], [1, 1, 0], [0, -1, 0]] and frozen and isolated,
          "FV NaN lane not isolated")
    # the residual criterion, each lane with its own normalization: a
    # tolerance that one lane meets mid-chunk, flags and normalizations as
    # plain
    ps, ops_list = fv_lane_setup(20, 20, "float32", "TVD", FV_LANES)
    st = stack_states([fvm.initial_state(o) for o in ops_list])
    S_list = [fvk.statics(p, o) for p, o in zip(ps, ops_list)]
    carry = TR.fresh_carry(3, torch.float32, ops_list[0].device)
    cont = fvl.lanes_plain(S_list, st, 0, carry, 24, 1e-30, 10, FV_K,
                           True)[2][:, :, 3].double().cpu().numpy()
    crit = cont[10:] / cont[10]
    tol = float(crit[:, 0].min()) * (1 + 1e-3)
    run = fvl.make_fv_lane_runner(ps, ops_list, 24, tol, 10, FV_K,
                                  "residual")
    out_k, out_p = run(st, 0), fvl.lanes_plain(S_list, st, 0, carry, 24, tol,
                                               10, FV_K, True)
    err = max(rel_err(a, b) for a, b in zip(
        list(out_k[0]) + [out_k[1].ref_norm],
        list(out_p[0]) + [out_p[1].ref_norm]))
    fk, fp = out_k[1].flags.tolist(), out_p[1].flags.tolist()
    print(f"[lanes] FV 20x20 float32 residual criterion, tol {tol:.4e}: "
          f"flags {fk} (plain {fp}), relative error of states and "
          f"normalizations {err:.2e}", flush=True)
    check(fk == fp and fk[0][2] == 1 and err <= FV_F32_TOL,
          f"FV residual lanes differ from plain: {fk} vs {fp}, {err:.3e}")
    # ms per SIMPLE iteration at 128x128 float32 for B = 1, 3 and 8
    lanes8 = [FV_LANES[k % 3] for k in range(8)]
    ps, ops_list = fv_lane_setup(128, 128, "float32", "TVD", lanes8)
    chunk = 100
    st8 = stack_states([fvm.initial_state(o) for o in ops_list])
    fvl.reset_counts()
    fvl.make_fv_lane_runner(ps, ops_list, 2, 1e-30, 10, FV_K)(st8, 0)
    per_iter = fvl.LAUNCHES["fv_lanes"] / 2
    print(f"[lanes] FV 128x128 float32 B=8: {per_iter:g} launches an "
          "iteration", flush=True)
    check(per_iter == 2, f"FV B=8: {per_iter} launches an iteration")
    one = fvk.make_fv_chunk_runner(ps[0], ops_list[0], chunk, 1e-30, 10,
                                   FV_K)
    t1 = cuda_ms(lambda: one(lane_of(st8, 0), 0, float("inf")), 2) / chunk
    times = {}
    for B in (3, 8):
        st = type(st8)(*(t[:B].contiguous() for t in st8))
        run = fvl.make_fv_lane_runner(ps[:B], ops_list[:B], chunk, 1e-30, 10,
                                      FV_K)
        times[B] = cuda_ms(lambda: run(st, 0), 2) / chunk
    st3 = type(st8)(*(t[:3].contiguous() for t in st8))
    S3 = [fvk.statics(p, o) for p, o in zip(ps[:3], ops_list[:3])]
    carry = TR.fresh_carry(3, torch.float32, ops_list[0].device)
    t_plain = cuda_ms(lambda: fvl.lanes_plain(S3, st3, 0, carry, 2, 1e-30,
                                              10, FV_K), 1) / 2
    work = fv_work(ops_list[0]).values()
    b_ms, b_by = bound(3 * sum(w[0] for w in work),
                       3 * sum(w[1] for w in work), torch.float32)
    summary["fv_lanes"].update(ms=times[3], plain_ms=t_plain, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None)
    run3 = fvl.make_fv_lane_runner(ps[:3], ops_list[:3], chunk, 1e-30, 10,
                                   FV_K)
    profile_chunk(lambda: run3(st3, 0), "lanes profile FV 128x128 float32 "
                  f"B=3 {chunk}-iteration chunk")
    print(f"[lanes] FV 128x128 float32, ms per SIMPLE iteration: B=1 "
          f"{t1:.4f}, B=3 {times[3]:.4f} ({times[3] / t1:.2f}x B=1), B=8 "
          f"{times[8]:.4f} ({times[8] / t1:.2f}x B=1); B=3 plain "
          f"{t_plain:.4f}, bound {b_ms:.5f} ({b_by})", flush=True)
    print(f"[lanes] phase 2e: {time.time() - t0:.1f}s", flush=True)


def fv_params(ny, nx, dtype, scheme="TVD", **kw):
    # the shipped conf/solver/fv.yaml numerics
    base = dict(Re=100.0, nx=nx, ny=ny, convection_scheme=scheme,
                limiter="MUSCL", alpha_uv=0.4, alpha_p=0.2,
                linear_solver_tol=1e-9, rhie_chow="compact",
                corner_treatment="none", fv_inner_iters=FV_K, dtype=dtype,
                device="cuda", chunk_size=1000, convergence_metric="auto")
    base.update(kw)
    return FVParameters(**base)


def fv_cases():
    """(ny, nx, dtype, n_refine, scheme) of phase 2b. float64 runs with its
    default n_refine = 0 and again with one refinement step, float32's
    default, so that the refinement residual and the accumulating product
    are held at the float64 bound too: in float32 their correction is of the
    order of the solve's rounding, far below the float32 bound."""
    for ny, nx in ((20, 20), (12, 16), (128, 128)):
        for dt_name in ("float32", "float64"):
            for n_refine in (None,) if dt_name == "float32" else (None, 1):
                for scheme in ("TVD", "Upwind"):
                    yield ny, nx, dt_name, n_refine, scheme


def fv_ops(p, n_refine=None):
    ops, _ = fvm.build_fv_ops(p)
    if n_refine is not None:
        ops = dataclasses.replace(ops, n_refine=n_refine)
    return ops


def phase_fv_kernels(summary):
    chunk = 32
    inf = float("inf")
    for ny, nx, dt_name, n_refine, scheme in fv_cases():
        tol = FV_F32_TOL if dt_name == "float32" else FV_F64_TOL
        p = fv_params(ny, nx, dt_name, scheme)
        ops = fv_ops(p, n_refine)
        case = f"{ny}x{nx} {dt_name} {scheme} n_refine={ops.n_refine}"
        S = fvk.statics(p, ops)
        st0 = fvm.initial_state(ops)
        run_k = fvk.make_fv_chunk_runner(p, ops, chunk, 1e-30, 10, FV_K)
        fvk.reset_counts()
        out_k = run_k(st0, 0, inf)
        torch.cuda.synchronize()  # a fault shows where it happened
        per_iter = {k: v / chunk for k, v in fvk.LAUNCHES.items()}
        check(all(n == 1 for n in per_iter.values()), f"FV {case}: "
              f"launches an iteration {per_iter}")
        out_p = fvk.chunk_plain(S, st0, 0, inf, chunk, 1e-30, 10, FV_K)
        e_chunk = max(rel_err(a, b) for a, b in zip(out_k[0], out_p[0]))
        e_rows = max(rel_err(out_k[4][:, c], out_p[4][:, c])
                     for c in range(7))  # per column
        flags_k = [int(out_k[i]) for i in (1, 2, 3)]
        flags_p = [int(out_p[i]) for i in (1, 2, 3)]
        again = run_k(st0, 0, inf)
        bitwise = (all(torch.equal(a, b) for a, b in zip(out_k[0], again[0]))
                   and torch.equal(out_k[4], again[4]))
        # one step from the flow the chunk reached
        flow = out_p[0]
        s_k, m_k = fvk.make_fv_step(p, ops, FV_K)(flow)
        s_p, m_p = fvk.step_plain(S, flow, FV_K)
        e_step = max(rel_err(a, b) for a, b in zip(s_k, s_p))
        e_met = max(rel_err(m_k[k], m_p[k]) for k in m_p)
        worst = max(e_chunk, e_rows, e_step, e_met)
        print(f"[fv kernels] {case}: step state {e_step:.2e} metrics "
              f"{e_met:.2e} chunk state {e_chunk:.2e} rows {e_rows:.2e} "
              f"flags {flags_k} bitwise repeat {bitwise} (tol {tol:.0e}); "
              f"launches an iteration {sum(per_iter.values()):g} "
              f"({', '.join(f'{k} {n:g}' for k, n in per_iter.items())})",
              flush=True)
        check(worst <= tol, f"FV {case}: relative error {worst:.3e} > "
              f"{tol:.0e}")
        check(flags_k == flags_p, f"FV flags differ: {flags_k} vs {flags_p}")
        check(bitwise, f"FV {case}: two runs of one kernel chunk differ")
        if ops.n_refine and scheme == "TVD":
            refinement_check(S, ops, flow, tol, case)
        if nx == 128 and scheme == "TVD" and n_refine is None:
            t_k = cuda_ms(lambda: run_k(st0, 0, inf), 3) / chunk
            t_p = cuda_ms(lambda: fvk.chunk_plain(
                S, st0, 0, inf, chunk, 1e-30, 10, FV_K), 1) / chunk
            work = fv_work(ops).values()
            b_ms, b_by = bound(sum(w[0] for w in work),
                               sum(w[1] for w in work), ops.dtype)
            print(f"[fv kernels] N=128 {dt_name}: ms per SIMPLE iteration, "
                  f"kernel chunk {t_k:.4f} plain {t_p:.4f} bound {b_ms:.5f} "
                  f"({b_by})", flush=True)
            if dt_name == "float32":
                fv_kernel_checks(p, ops, flow, summary)
                profile_fv_chunk(p, ops, flow)


def perturbed_solve(S, seed=0, size=0.5):
    """The statics ``S`` with the eigenvalue inverses of the pressure solve
    scaled by 1 + size * u, u uniform in [-1, 1]. The first solve then
    misses by up to ``size`` and the refinement step moves the state by
    4e-3 to 2e-2 relative (20x20 to 128x128). With the exact inverses it
    moves it by the solve's rounding (~1e-16 in float64, ~3e-8 in float32),
    which no bound can tell from a wrong refinement residual or a wrong
    accumulating product."""
    rng = np.random.default_rng(seed)
    inv = S["inv_lam"]
    scale = torch.as_tensor(1 + size * rng.uniform(-1, 1, tuple(inv.shape)),
                            dtype=inv.dtype, device=inv.device)
    return dict(S, inv_lam=(inv * scale).contiguous())


def refinement_check(S, ops, flow, tol, case):
    """One kernel step against the plain step with a perturbed pressure
    solve (``perturbed_solve``) and ``ops.n_refine`` refinement steps."""
    S2 = perturbed_solve(S)
    s_k, m_k = fvk._step_kernel(S2, ops, flow, FV_K)
    s_p, m_p = fvk.step_plain(S2, flow, FV_K)
    s_0, _ = fvk.step_plain(dict(S2, n_refine=0), flow, FV_K)
    err = max([rel_err(a, b) for a, b in zip(s_k, s_p)]
              + [rel_err(m_k[k], m_p[k]) for k in m_p])
    moved = max(rel_err(a, b) for a, b in zip(s_0, s_p))
    print(f"[fv kernels] {case} perturbed solve: step {err:.2e} (the "
          f"refinement moves the state by {moved:.2e}; tol {tol:.0e})",
          flush=True)
    check(moved > 10 * tol, f"FV {case}: the perturbed solve leaves the "
          f"refinement too small to check ({moved:.2e})")
    check(err <= tol, f"FV {case} perturbed solve: relative error "
          f"{err:.3e} > {tol:.0e}")


def phase_fv_flags():
    """The chunk's state machine at N=128, float32 and float64: a tolerance
    met mid-chunk, between two successive rel_iter values of a plain probe
    chunk from rest (a gap of 1% or more, so that rounding cannot move the
    crossing), must give the same done, conv_iter and converged flags, the
    same NaN rows from the crossing on, and the same frozen state as the
    plain chunk."""
    chunk, warmup = 30, 10
    inf = float("inf")
    for dt_name in ("float32", "float64"):
        tol_err = FV_F32_TOL if dt_name == "float32" else FV_F64_TOL
        p = fv_params(128, 128, dt_name)
        ops = fv_ops(p)
        S = fvk.statics(p, ops)
        st0 = fvm.initial_state(ops)
        rel = fvk.chunk_plain(S, st0, 0, inf, chunk, 1e-30, warmup,
                              FV_K)[4][:, 0].double().cpu().numpy()
        tol = None
        for i in range(warmup + 2, chunk - 5):
            above = float(np.min(rel[warmup:i]))
            if above > 1.01 * rel[i]:
                tol = float(np.sqrt(above * rel[i]))
                break
        check(tol is not None, f"FV flags {dt_name}: no mid-chunk crossing "
              f"in the probe rows {rel}")
        out_k = fvk.make_fv_chunk_runner(p, ops, chunk, tol, warmup, FV_K)(
            st0, 0, inf)
        out_p = fvk.chunk_plain(S, st0, 0, inf, chunk, tol, warmup, FV_K)
        flags_k = [int(out_k[i]) for i in (1, 2, 3)]
        flags_p = [int(out_p[i]) for i in (1, 2, 3)]
        nan_k = torch.isnan(out_k[4]).cpu()
        nan_p = torch.isnan(out_p[4]).cpu()
        conv = flags_p[1]
        e_state = max(rel_err(a, b) for a, b in zip(out_k[0], out_p[0]))
        e_rows = max(rel_err(out_k[4][:, c], out_p[4][:, c])
                     for c in range(7))
        print(f"[fv flags] 128x128 {dt_name} tol {tol:.6e}: flags kernel "
              f"{flags_k} plain {flags_p}; NaN rows from {conv}; state "
              f"{e_state:.2e} rows {e_rows:.2e} (tol {tol_err:.0e})",
              flush=True)
        check(flags_p[0] == 1 and flags_p[2] == 1 and conv == i + 1,
              f"FV flags {dt_name}: the plain chunk did not converge at "
              f"iteration {i + 1}: {flags_p}")
        check(flags_k == flags_p, f"FV flags {dt_name} differ: {flags_k} vs "
              f"{flags_p}")
        check(torch.equal(nan_k, nan_p) and bool(nan_p[conv:].all())
              and not bool(nan_p[:conv].any()),
              f"FV flags {dt_name}: NaN rows differ")
        check(max(e_state, e_rows) <= tol_err, f"FV flags {dt_name}: "
              f"relative error {max(e_state, e_rows):.3e} > {tol_err:.0e}")


def fv_kernel_checks(p, ops, state, summary):
    """Each FV kernel on the main path's inputs (one step from a developing
    N=128 float32 flow): its outputs' absolute error against the plain
    function it stands for, then the time of one iteration's launch of it
    (bench entry of the library, CUDA events) beside that plain function,
    and the time of the launch without its folded phase. fv_bicgstab's
    assembly (the coefficients, the pressure gradient and Du) and its
    u*, v* are held against plain_momentum. fv_pressure is held against
    plain_pressure_stage started from the kernel's own momentum solution
    u*, v*: rhs_p, p' after the gauge, the new state, the six metrics
    formed from the stage's partial sums (part_c, part_q), and the six
    metrics its control phase wrote, within FV_F32_TOL relative."""
    S = fvk.statics(p, ops)
    ws = fvk.bench_workspace(S, ops, state, FV_K)
    cur = fvk.pad_state(state)
    c, us, vs = fvk.plain_momentum(S, *cur, FV_K)
    xu, xv = ws["x"][0], ws["x"][1]
    rhsp = fvk.plain_rhie_chow(S, c, xu, xv, cur[2])[3]
    pp = fvk.plain_pressure(S, rhsp)
    new, met = fvk.plain_pressure_stage(S, c, xu, xv, cur[2])
    cs = ws["part_c"].double().sum(0)
    qs = ws["part_q"].double().sum(0)
    dA = ops.dx * ops.dy
    met_parts = torch.stack([cs[0].sqrt(), cs[1].sqrt(), qs[0].sqrt(),
                             0.5 * cs[2] * dA, 0.5 * qs[1] * dA,
                             0.5 * qs[2] * dA])
    assembly = [(ws[k], c[name]) for k, name in (
        ("aPr", "aP_rel"), ("aE", "aE"), ("aW", "aW"), ("aN", "aN"),
        ("aS", "aS"), ("gpx", "gpx"), ("gpy", "gpy"))]
    assembly.append((ws["Du"], S["dx"] * S["dy"] / (c["aP"] + 1e-14)))
    momentum = assembly + [(xu, us), (xv, vs)]
    stage_out = ([(ws["rhsp"], rhsp), (ws["pp"] - ws["pp"][0, 0], pp),
                  (met_parts, met), (ws["metrics"], met)]
                 + list(zip((ws[k] for k in fvm.FVState._fields),
                            fvk.unpad_state(*new))))

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    summary["fv_bicgstab"]["max_abs_err"] = max(err(a, b)
                                                for a, b in momentum)
    summary["fv_pressure"]["max_abs_err"] = max(err(a, b)
                                                for a, b in stage_out)
    e_asm = max(rel_err(a, b) for a, b in assembly)
    e_stage = max(rel_err(a, b) for a, b in stage_out)
    print("[fv kernels] N=128 float32 developing flow: abs err "
          + ", ".join(f"{k} {summary[k]['max_abs_err']:.3e}"
                      for k in fvk.KERNELS)
          + f"; assembly relative {e_asm:.3e}, fv_pressure relative "
          f"{e_stage:.3e}", flush=True)
    check(e_asm <= FV_F32_TOL, f"fv_bicgstab's assembly against "
          f"plain_assemble: relative error {e_asm:.3e} > {FV_F32_TOL:.0e}")
    check(e_stage <= FV_F32_TOL, f"fv_pressure against plain_pressure_stage:"
          f" relative error {e_stage:.3e} > {FV_F32_TOL:.0e}")

    reps = 50  # the bench launches update ws in place: errors first
    alone = {}
    for name in fvk.KERNELS:
        summary[name]["ms"] = cuda_ms(
            lambda: fvk.bench_kernel(S, ops, ws, name, FV_K, reps), 1) / reps
        alone[name] = cuda_ms(lambda: fvk.bench_kernel(
            S, ops, ws, name, FV_K, reps, folded=False), 1) / reps
    done = torch.zeros((), dtype=torch.bool, device=ops.device)
    flags = (done, torch.full((), -1, dtype=torch.int32, device=ops.device),
             done)
    ctl = (0, flags, torch.full((), float("inf"), dtype=ops.dtype,
                                device=ops.device), 1e-30, 10, False)
    plain = {"fv_bicgstab": lambda: fvk.plain_momentum(S, *cur, FV_K),
             "fv_pressure": lambda: fvk.plain_pressure_launch(
                 S, c, xu, xv, cur, ctl)}
    for name, fn in plain.items():
        summary[name]["plain_ms"] = cuda_ms(fn, 20)
    for name, (flops, nbytes) in fv_work(ops).items():
        b_ms, b_by = bound(flops, nbytes, ops.dtype)
        summary[name].update(bound_ms=b_ms, bound_by=b_by, library_ms=None)
    summary["fv_pressure"]["library_ms"] = dense_library_ms(ops)
    for name, phase in zip(fvk.KERNELS, ("the assembly", "control")):
        lib = summary[name]["library_ms"]
        print(f"[fv kernels] {name} at N=128 float32, one iteration's "
              f"launch: kernel {summary[name]['ms']:.4f} ms ({alone[name]:.4f}"
              f" without {phase}: {phase} "
              f"{summary[name]['ms'] - alone[name]:.4f}), plain "
              f"{summary[name]['plain_ms']:.4f} ms, bound "
              f"{summary[name]['bound_ms']:.5f} ms "
              f"({summary[name]['bound_by']})"
              + ("" if lib is None else f", its products as torch.matmul "
                 f"{lib:.4f} ms"), flush=True)


def fv_work(ops):
    """(operations, bytes) of one SIMPLE iteration's launch of each FV
    kernel at ny x nx cells (c of them), from the shapes; arithmetic not
    counted below only lowers the bound. A phase folded into a launch
    keeps its work there; what one phase writes and the next reads within
    the launch is not counted.

    - fv_bicgstab: the assembly (~60 operations a cell), then K iterations
      on the two momentum systems, each two 5-point applications with the
      Jacobi scaling (11 operations a cell), four dots and six axpys (2
      each): 40 operations a cell a system an iteration. It reads the
      state (u, v, p and the two face fluxes) and the boundary statics
      aP_bc, b_bc_u (7 c) and writes the five coefficient arrays, the
      pressure gradient, Du and the two solutions (10 c);
    - fv_pressure: 4 (1 + n_refine) products of the separable pressure
      solve, 2 ny^2 nx or 2 ny nx^2 each, ~80 operations a cell for
      Rhie-Chow, the refinement residual, the corrections and the metrics,
      and ~4 for control's norms; it reads the two eigenvector bases and
      the eigenvalue inverses, the momentum solution, Du, the pressure
      gradient, p, u and v (ny^2 + nx^2 + 9 c) and writes the new state
      (5 c) and a history row.
    """
    ny, nx = ops.ny, ops.nx
    c, e = ny * nx, torch.finfo(ops.dtype).bits // 8
    solves = 1 + ops.n_refine
    return {
        "fv_bicgstab": (60 * c + FV_K * 2 * 40 * c, e * 17 * c),
        "fv_pressure": (solves * (4 * ny * ny * nx + 4 * ny * nx * nx)
                        + 84 * c, e * (ny * ny + nx * nx + 14 * c + 7)),
    }


def dense_library_ms(ops):
    """torch.matmul doing fv_pressure's products: per solve, the two basis
    changes and their inverses (V1^T R, . V2, V1 ., . V2^T) on ny x nx
    operands in the working dtype, TF32 off."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    g = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(dtype=ops.dtype, device="cuda", generator=g)
    V1 = torch.randn(ops.ny, ops.ny, **kw)
    V2 = torch.randn(ops.nx, ops.nx, **kw)
    R = torch.randn(ops.ny, ops.nx, **kw)

    def products():
        t = R
        for _ in range(1 + ops.n_refine):
            t = V1 @ ((V1.T @ t) @ V2) @ V2.T
        return t

    return cuda_ms(products, 50)


def profile_fv_chunk(p, ops, state):
    """Device busy time by kernel and the idle share of one 100-iteration
    N=128 float32 chunk."""
    run = fvk.make_fv_chunk_runner(p, ops, 100, 1e-30, 10, FV_K)
    profile_chunk(lambda: run(state, 0, float("inf")),
                  "fv profile N=128 float32 100-iteration chunk")


def ghia_u_error_fv(solver) -> float:
    """Max |u - Ghia| along x = 0.5 by bilinear evaluation of the cell
    fields, NaN-masked (tests/test_fv.py's check)."""
    re = int(solver.params.Re)
    data = np.genfromtxt(
        ROOT / f"data/validation/ghia/ghia_Re{re}_u_centerline.csv",
        delimiter=",", names=True)
    u_c, _ = solver._evaluate_at_points(np.full(len(data), 0.5), data["y"])
    valid = ~np.isnan(u_c)
    return float(np.max(np.abs(u_c[valid] - data["u"][valid])))


def phase_fv_solve(re):
    target, l2_max = FV_TARGETS[re]
    solver = fvm.FVSolver(params=fv_params(128, 128, "float32", Re=re,
                                           tolerance=1e-6,
                                           max_iterations=30_000))
    t0 = time.time()
    solver.solve()
    torch.cuda.synchronize()
    wall = time.time() - t0
    m = solver.metrics
    errs = solver.compute_validation_errors(base_dir=ROOT, save_plots=False)
    ghia = ghia_u_error_fv(solver)
    ratio = m.iterations / target
    print(f"[fv] N=128 Re={re:g} tol=1e-6 float32: {m.iterations} iterations "
          f"({ratio:.3f} x JAX record {target}), wall "
          f"{m.wall_time_seconds:.3f}s (call {wall:.3f}s, first chunk "
          f"{solver.first_chunk_time:.3f}s), converged={m.converged}; L2 "
          + " ".join(f"{k}={v:.6f}" for k, v in errs.items())
          + f"; Ghia u-centerline max err {ghia:.4f}", flush=True)
    check(m.converged, f"FV Re={re:g} did not converge")
    FV_B1_ITERATIONS[re] = m.iterations
    check(0.8 <= ratio <= 1.2, f"FV Re={re:g} iterations {m.iterations} "
          f"outside 20% of the JAX record {target}")
    for key in ("u_L2_error", "v_L2_error"):
        check(errs.get(key, np.inf) <= l2_max, f"FV Re={re:g} {key} "
              f"{errs.get(key)} > {l2_max}")
    check(ghia <= FV_GHIA_MAX_ERR, f"FV Re={re:g} Ghia error {ghia:.4f} > "
          f"{FV_GHIA_MAX_ERR}")


def phase_sg():
    solver = SGSolver(params=params(128, "float32"))
    t0 = time.time()
    solver.solve(max_iter=50_000)
    torch.cuda.synchronize()
    wall = time.time() - t0
    it = solver.metrics.iterations
    first = solver.first_chunk_time
    chunk = int(solver.params.chunk_size)
    net = (it - chunk) / max(solver.metrics.wall_time_seconds - first, 1e-9)
    print(f"[sg] N=128 Re=1000 float32: {it} iterations in "
          f"{solver.metrics.wall_time_seconds:.3f}s (call {wall:.3f}s), "
          f"first_chunk_seconds {first:.3f}, steps/s net of the first chunk "
          f"{net:.1f}, converged={solver.metrics.converged}", flush=True)
    u, v, p = solver.state
    check(all(bool(torch.isfinite(t).all()) for t in (u, v, p)),
          "SG state is not finite")
    check(it == 50_000 or solver.metrics.converged,
          f"SG stopped at {it} without converging")
    return net


def ghia_u_error(solver, re=1000) -> float:
    """Max |u - Ghia| along the vertical centerline x = 0.5: the degree-N
    Chebyshev interpolant of the x=0.5 node column, at Ghia's y."""
    data = np.genfromtxt(
        ROOT / f"data/validation/ghia/ghia_Re{re}_u_centerline.csv",
        delimiter=",", names=True)
    xn = solver.grid["x_nodes"]
    yn = solver.grid["y_nodes"]
    xc = int(np.argmin(np.abs(xn - 0.5)))
    u_col = solver.fields.u.reshape(len(xn), len(yn))[xc, :]
    interp = np.polynomial.chebyshev.Chebyshev.fit(
        yn, u_col, deg=len(yn) - 1, domain=[float(yn[0]), float(yn[-1])])
    return float(np.max(np.abs(interp(data["y"]) - data["u"])))


def phase_fsg():
    solver = FSGSolver(params=params(96, "float32", tolerance=1e-6,
                                     max_iterations=400_000, multigrid="fsg",
                                     n_levels=2, coarse_tolerance_factor=1.0))
    solver.solve()
    m = solver.metrics
    levels = ", ".join(f"N={lv['n']}: {lv['iterations']} it "
                       f"({lv['wall_time']:.2f}s, first chunk "
                       f"{lv['first_chunk_time']:.2f}s)"
                       for lv in solver.levels)
    errs = solver.compute_validation_errors(base_dir=ROOT, save_plots=False)
    ghia = ghia_u_error(solver)
    ratio = m.iterations / JAX_FSG_ITERATIONS
    print(f"[fsg] N=96 Re=1000 tol=1e-6 float32: ladder "
          f"{[lv['n'] for lv in solver.levels]}; {levels}; total "
          f"{m.iterations} iterations ({ratio:.3f} x JAX record), wall "
          f"{m.wall_time_seconds:.3f}s, converged={m.converged}; L2 "
          + " ".join(f"{k}={v:.5f}" for k, v in errs.items())
          + f"; Ghia u-centerline max err {ghia:.4f}", flush=True)
    check(m.converged, "FSG did not converge")
    check(0.8 <= ratio <= 1.2, f"FSG iterations {m.iterations} outside 20% "
          f"of the JAX record {JAX_FSG_ITERATIONS}")
    check(ghia <= GHIA_MAX_ERR, f"Ghia error {ghia:.4f} > {GHIA_MAX_ERR}")
    FSG_MARCH.update(iterations=m.iterations, ghia=ghia,
                     wall=m.wall_time_seconds,
                     levels=[(lv["n"], lv["iterations"])
                             for lv in solver.levels])


def vmg_params(n, re, **kw):
    # conf/solver/spectral/vmg.yaml on the sg.yaml numerics
    base = dict(Re=re, multigrid="vmg", n_levels=3,
                coarse_tolerance_factor=1.0, max_iterations=400_000)
    base.update(kw)
    return params(n, "float32", **base)


def phase_vmg_wide():
    """Phase 7: 2,000 V-cycles of VMG [192, 96] Re=1000 from rest."""
    solver = vmg.VMGSolver(params=vmg_params(192, 1000.0, tolerance=0.0,
                                             max_iterations=8000))
    t0 = time.time()
    solver.solve()
    torch.cuda.synchronize()
    wall = time.time() - t0
    m = solver.metrics
    first = solver.first_chunk_time
    chunk = 50
    rate = (m.iterations - chunk) / max(m.wall_time_seconds - first, 1e-9)
    print(f"[vmg] [192, 96] Re=1000 float32: ladder {solver.ladder}, "
          f"{m.iterations} V-cycles in {m.wall_time_seconds:.3f}s (call "
          f"{wall:.3f}s), first_chunk_seconds {first:.3f}, cycles/s net of "
          f"the first chunk {rate:.1f}, fine-step equivalents/s "
          f"{4 * rate:.1f}, energy {m.final_energy:.6f}", flush=True)
    check(solver.ladder == [192, 96], f"ladder {solver.ladder}")
    check(m.iterations == 2000, f"{m.iterations} V-cycles, not 2000")
    check(all(bool(torch.isfinite(t).all()) for t in solver.state),
          "VMG state is not finite")
    return solver


def profile_vmg_chunk(solver):
    """Device busy time by kernel and the idle share of one 50-cycle chunk
    of the phase-7 hierarchy from its final state, by torch.profiler, after
    a warm-up chunk."""
    levels = vmg.build_vmg_levels(solver.params)
    smoothers = {i: sgk.make_sg_smoother(lv.ops) for i, lv in enumerate(levels)}
    cycle = vmg.make_v_cycle(levels, smoothers=smoothers)
    run = TR.make_chunk_runner(cycle, lambda s: (s.u, s.v), 50, 0.0)
    inf = torch.tensor(float("inf"), device=solver.device)
    profile_chunk(lambda: run(solver.state, 0, inf),
                  "vmg profile [192, 96] 50-cycle chunk")


def check_against_jax(what, solver, ref, ladder):
    m = solver.metrics
    cycles, energy, ghia_ref = ref
    ghia = ghia_u_error(solver, re=100)
    ratio = m.iterations / cycles
    e_rel = abs(m.final_energy - energy) / energy
    print(f"[{what}] ladder {ladder}: {m.iterations} iterations ({ratio:.3f} "
          f"x JAX {cycles}), wall {m.wall_time_seconds:.3f}s (first chunk "
          f"{solver.first_chunk_time:.3f}s), converged={m.converged}, energy "
          f"{m.final_energy:.9f} (JAX {energy:.9f}, rel {e_rel:.2e}), Ghia "
          f"Re=100 u max err {ghia:.5f} (JAX {ghia_ref:.5f})", flush=True)
    check(m.converged, f"{what} did not converge")
    check(0.9 <= ratio <= 1.1, f"{what}: {m.iterations} iterations outside "
          f"10% of the JAX count {cycles}")
    check(e_rel <= 1e-4, f"{what}: energy {m.final_energy} vs JAX {energy}")
    check(ghia <= ghia_ref + 0.005, f"{what}: Ghia error {ghia:.5f}")


def phase_vmg48():
    """Phase 8: VMG N=48 Re=100 tol 1e-6, converged."""
    solver = vmg.VMGSolver(params=vmg_params(48, 100.0, tolerance=1e-6))
    solver.solve()
    check(solver.ladder == [48, 24], f"ladder {solver.ladder}")
    check_against_jax("vmg N=48 Re=100", solver, JAX_VMG48, solver.ladder)


def phase_fmg96():
    """Phase 9: FMG N=96 Re=100 tol 1e-6 (conf/solver/spectral/fmg.yaml),
    with matmul_algorithm=x6: its coarsest (N=24) level runs the x6 route
    of the SG chunk kernel, quadratures every step."""
    solver = vmg.FMGSolver(params=params(
        96, "float32", Re=100.0, tolerance=1e-6, max_iterations=400_000,
        multigrid="fmg", n_levels=3, coarse_tolerance_factor=10.0,
        matmul_algorithm="x6"))
    solver.solve()
    ladder = [lv["n"] for lv in solver.levels]
    check(ladder == [24, 48, 96], f"ladder {ladder}")
    print("[fmg] levels: " + ", ".join(
        f"N={lv['n']}: {lv['iterations']} it ({lv['wall_time']:.2f}s)"
        for lv in solver.levels), flush=True)
    check_against_jax("fmg N=96 Re=100", solver, JAX_FMG96, ladder)


def fsg_sweep_params(cs):
    """conf/experiment/optimization/corner_smoothing.yaml at N=40: FSG
    (fsg.yaml, 2 levels) Re=1000 tol 1e-6, float32, the cap at 200,000."""
    return params(40, "float32", Re=1000.0, tolerance=1e-6,
                  max_iterations=200_000, multigrid="fsg", n_levels=2,
                  coarse_tolerance_factor=1.0, corner_smoothing=cs)


def phase_fsg_sweep():
    """Phase 10: one round of the corner-smoothing optimization, 8 lanes."""
    css = [round(0.03 + 0.01 * k, 2) for k in range(8)]
    solvers = [FSGSolver(params=fsg_sweep_params(cs)) for cs in css]
    t0 = time.time()
    results = TB.run_batched(solvers)
    torch.cuda.synchronize()
    call = time.time() - t0
    wall = results[0].wall_time
    cap = int(solvers[0].params.max_iterations)
    for cs, solver, r in zip(css, solvers, results):
        errs = solver.compute_validation_errors(base_dir=ROOT,
                                                save_plots=False)
        capped = [lv["n"] for lv in r.levels
                  if lv["iterations"] >= cap and not lv["converged"]]
        print(f"[fsg sweep] corner_smoothing {cs:.2f}: "
              + ", ".join(f"N={lv['n']}: {lv['iterations']} it "
                          f"(converged={lv['converged']})" for lv in r.levels)
              + f"; total {r.iterations}, converged={r.converged}"
              + (f", RAN TO ITS CAP ({cap:,}) at N={capped}" if capped else "")
              + f"; FV-truth L2 u {errs['u_L2_error']:.5f} v "
              f"{errs['v_L2_error']:.5f}", flush=True)
        check([lv["n"] for lv in r.levels] == [20, 40],
              f"fsg sweep ladder {[lv['n'] for lv in r.levels]}")
        check(all(bool(torch.isfinite(t).all()) for t in solver.state),
              f"fsg sweep lane {cs} is not finite")
    steps = sum(r.iterations for r in results)
    print(f"[fsg sweep] N=40 Re=1000 tol 1e-6 float32, 8 lanes, ladder "
          f"[20, 40]: shared wall {wall:.3f}s (call {call:.3f}s, first "
          f"chunks {results[0].first_chunk_time:.3f}s), {steps} lane-steps, "
          f"aggregate {steps / wall:.1f} lane-steps/s", flush=True)
    for k in (0, 7):
        one = FSGSolver(params=fsg_sweep_params(css[k]))
        t0 = time.time()
        one.solve()
        torch.cuda.synchronize()
        same_levels = [(lv["n"], lv["iterations"]) for lv in one.levels] == [
            (lv["n"], lv["iterations"]) for lv in results[k].levels]
        bits = all(same_bits(a, b) for a, b in zip(one.state,
                                                   solvers[k].state))
        print(f"[fsg sweep] lane {k} again as FSGSolver.solve(): "
              + ", ".join(f"N={lv['n']}: {lv['iterations']} it"
                          for lv in one.levels)
              + f" in {time.time() - t0:.3f}s; same levels and iterations "
              f"{same_levels}, bit-equal state {bits}", flush=True)
        check(same_levels and bits,
              f"fsg sweep lane {k} differs from its FSGSolver solve")


@contextlib.contextmanager
def kept_solvers():
    """The solvers the port's driver solves in the block: its run_solver
    and its batches (parallel.batched.run_batched) are wrapped to keep
    theirs; the driver's work is unchanged."""
    kept = []
    run_solver, run_batched = cli.run_solver, TB.run_batched

    def solver_kept(*a, **kw):
        out = run_solver(*a, **kw)
        kept.append(out[2])
        return out

    def batch_kept(solvers, *a, **kw):
        kept.extend(solvers)
        return run_batched(solvers, *a, **kw)

    cli.run_solver, TB.run_batched = solver_kept, batch_kept
    try:
        yield kept
    finally:
        cli.run_solver, TB.run_batched = run_solver, run_batched


def ghia_u_error_stored(run) -> float:
    """Phase A's Ghia u error from a tracked run's solution.vts artifact:
    the degree-N Chebyshev interpolant of its x=0.5 node column, at Ghia's
    y (the fields as the store holds them)."""
    x, y, U, _, _ = restructure_fields(
        load_fields_from_vts(Path(run["path"]) / "artifacts"))
    data = np.genfromtxt(ROOT / "data/validation/ghia/ghia_Re1000_u_centerline"
                         ".csv", delimiter=",", names=True)
    col = U[:, int(np.argmin(np.abs(x - 0.5)))]
    interp = np.polynomial.chebyshev.Chebyshev.fit(
        y, col, deg=len(y) - 1, domain=[float(y[0]), float(y[-1])])
    return float(np.max(np.abs(interp(data["y"]) - data["u"])))


def phase_cli_fsg():
    """Phase A: the flagship through the port's CLI, ``python -m
    anap3_tpu_torch solver=gpu/fsg N=96 Re=1000`` (in process): phase 4's
    ladder and iterations, and the run read back from the store."""
    with tempfile.TemporaryDirectory() as tmp, kept_solvers() as kept:
        t0 = time.time()
        cli.main(["solver=gpu/fsg", "N=96", "Re=1000", "plots=false",
                  "experiment_name=chip-smoke-cli",
                  f"mlflow.tracking_uri={tmp}/mlruns"])
        wall = time.time() - t0
        runs = TT.search_runs("chip-smoke-cli", status="FINISHED")
        check(len(runs) == 1 and len(kept) == 1,
              f"the CLI run: {len(runs)} finished runs, {len(kept)} solves")
        m, solver = runs[0]["metrics"], kept[0]
        ghia = ghia_u_error_stored(runs[0])
        levels = [(lv["n"], lv["iterations"]) for lv in solver.levels]
        print(f"[cli fsg] python -m anap3_tpu_torch solver=gpu/fsg N=96 "
              f"Re=1000: ladder {levels} (phase 4: {FSG_MARCH.get('levels')})"
              f"; stored: iterations {int(m['iterations'])}, converged "
              f"{int(m['converged'])}, wall_time_seconds "
              f"{m['wall_time_seconds']:.3f}, first_chunk_seconds "
              f"{m['first_chunk_seconds']:.3f}, L2 u {m['u_L2_error']:.5f} v "
              f"{m['v_L2_error']:.5f}, Ghia u-centerline max err {ghia:.4f} "
              f"(from the stored solution.vts); the driver's call "
              f"{wall:.3f}s", flush=True)
    check(levels == FSG_MARCH.get("levels")
          and int(m["iterations"]) == FSG_MARCH.get("iterations"),
          f"the CLI flagship: {levels}, {int(m['iterations'])} iterations, "
          f"phase 4 {FSG_MARCH.get('levels')}")
    check(int(m["converged"]) == 1, "the CLI flagship did not converge")
    check(ghia <= GHIA_MAX_ERR, f"the CLI flagship's Ghia error {ghia:.4f}")


def phase_cli_optimization():
    """Phase B: one round of the corner-smoothing optimization through the
    port's CLI (8 trials, one batch of 8 FSG N=40 lanes); lanes 0 and 7
    again as FSGSolver.solve()."""
    with tempfile.TemporaryDirectory() as tmp, kept_solvers() as kept:
        t0 = time.time()
        best = cli.main(["-m", "+experiment/optimization=corner_smoothing",
                         "solver=gpu/fsg", "N=40", "hydra.sweeper.params.N=40",
                         "optuna.n_trials=8", "plots=false",
                         "experiment_name=chip-smoke-opt",
                         f"mlflow.tracking_uri={tmp}/mlruns"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        runs = TT.search_runs("chip-smoke-opt")
        parents = [r for r in runs if r["tags"].get("is_parent") == "true"]
        children = [r for r in runs if r["tags"].get("sweep") == "child"]
        check(len(parents) == 1, f"{len(parents)} parent runs")
        trials = json.loads((Path(parents[0]["path"]) / "artifacts"
                             / "optuna_trials.json").read_text())
        pm = parents[0]["metrics"]
    check(len(kept) == 8 and all(isinstance(s, FSGSolver) for s in kept),
          f"the round ran {len(kept)} lanes in a batch, not 8 FSG lanes")
    for r in sorted(children, key=lambda r: float(r["params"]
                                                  ["corner_smoothing"])):
        print(f"[cli optimization] child corner_smoothing "
              f"{float(r['params']['corner_smoothing']):.5f}: iterations "
              f"{int(r['metrics']['iterations'])}, converged "
              f"{int(r['metrics']['converged'])}, L2 u "
              f"{r['metrics']['u_L2_error']:.5f} v "
              f"{r['metrics']['v_L2_error']:.5f}", flush=True)
    print(f"[cli optimization] python -m anap3_tpu_torch -m "
          f"+experiment/optimization=corner_smoothing N=40 optuna.n_trials=8:"
          f" {len(children)} child runs, {len(trials['data'])} trials, best "
          f"objective {pm['best_objective']:.6f} (returned {best:.6f}), "
          f"shared batch wall {pm['batch_wall_time_seconds']:.3f}s, "
          f"aggregate {pm['aggregate_lane_steps_per_sec']:.1f} lane-steps/s;"
          f" the driver's call {wall:.3f}s", flush=True)
    check(len(children) == 8 and len(trials["data"]) == 8,
          f"{len(children)} child runs, {len(trials['data'])} trials")
    check(np.isfinite(pm["best_objective"]), "best_objective not finite")
    with uncounted():
        for k in (0, 7):
            lane = kept[k]
            one = FSGSolver(params=dataclasses.replace(lane.params))
            one.solve()
            torch.cuda.synchronize()
            same = [(lv["n"], lv["iterations"]) for lv in one.levels] == [
                (lv["n"], lv["iterations"]) for lv in lane.levels]
            bits = all(same_bits(a, b) for a, b in zip(one.state, lane.state))
            print(f"[cli optimization] lane {k} (corner_smoothing "
                  f"{lane.params.corner_smoothing:.5f}) again as "
                  f"FSGSolver.solve(): "
                  + ", ".join(f"N={lv['n']}: {lv['iterations']} it"
                              for lv in one.levels)
                  + f"; same levels and iterations {same}, bit-equal state "
                  f"{bits}", flush=True)
            check(same and bits, f"CLI optimization lane {k} differs from its "
                  "FSGSolver solve")


SG_SWEEP_LANES = [(re, cs) for cs in (0.15, 0.10)
                  for re in (100.0, 400.0, 1000.0, 3200.0)]
# phase 11's sweep without a mesh: (wall, iterations, states), which the
# sweep over a mesh repeats
SG_SWEEP = {}


def sg_sweep_params(re, cs):
    """Phase 11's lanes: N=128 float32, 5,000 steps at tolerance 0."""
    return params(128, "float32", Re=re, corner_smoothing=cs, tolerance=0.0,
                  max_iterations=5000, chunk_size=1000,
                  convergence_metric="rel_iter")


def phase_sg_sweep():
    """Phase 11: 8 SG N=128 lanes, 5,000 steps from rest."""
    lanes = SG_SWEEP_LANES
    mk = sg_sweep_params
    solvers = [SGSolver(params=mk(*lane)) for lane in lanes]
    t0 = time.time()
    results = TB.run_batched(solvers)
    torch.cuda.synchronize()
    call = time.time() - t0
    SG_SWEEP.update(wall=results[0].wall_time,
                    iterations=[r.iterations for r in results],
                    states=[s.state for s in solvers])
    r0 = results[0]
    net = 8 * (5000 - 1000) / max(r0.wall_time - r0.first_chunk_time, 1e-9)
    print(f"[sg sweep] N=128 float32, 8 lanes x 5000 steps: shared wall "
          f"{r0.wall_time:.3f}s (call {call:.3f}s, first chunk "
          f"{r0.first_chunk_time:.3f}s), aggregate lane-steps/s net of the "
          f"first chunk {net:.1f}", flush=True)
    check(all(r.iterations == 5000 for r in results),
          f"sg sweep iterations {[r.iterations for r in results]}")
    check(all(bool(torch.isfinite(t).all()) for s in solvers for t in s.state),
          "sg sweep state is not finite")
    k = lanes.index((1000.0, 0.15))
    one = SGSolver(params=mk(1000.0, 0.15))
    one.solve()
    bits = all(same_bits(a, b) for a, b in zip(one.state, solvers[k].state))
    print(f"[sg sweep] the Re=1000 / 0.15 lane against SGSolver.solve(): "
          f"{one.metrics.iterations} steps, bit-equal state {bits}",
          flush=True)
    check(bits, "sg sweep lane differs from its SGSolver run")
    return net


def phase_fv_sweep():
    """Phase 12: FV N=128 Re 100, 400, 1000 as 3 lanes, tol 1e-6."""
    res = (100.0, 400.0, 1000.0)
    l2_max = {100.0: 0.003, 400.0: 0.004, 1000.0: 0.004}
    solvers = [fvm.FVSolver(params=fv_params(128, 128, "float32", Re=re,
                                             tolerance=1e-6,
                                             max_iterations=30_000))
               for re in res]
    t0 = time.time()
    results = TB.run_batched(solvers)
    torch.cuda.synchronize()
    call = time.time() - t0
    for re, solver, r in zip(res, solvers, results):
        errs = solver.compute_validation_errors(base_dir=ROOT,
                                                save_plots=False)
        one = FV_B1_ITERATIONS.get(re)
        print(f"[fv sweep] Re={re:g}: {r.iterations} iterations (one-lane "
              f"solve: {one}), converged={r.converged}; L2 "
              + " ".join(f"{k}={v:.6f}" for k, v in errs.items()), flush=True)
        check(r.converged, f"fv sweep Re={re:g} did not converge")
        for key in ("u_L2_error", "v_L2_error"):
            check(errs.get(key, np.inf) <= l2_max[re], f"fv sweep Re={re:g} "
                  f"{key} {errs.get(key)} > {l2_max[re]}")
        if one is not None:
            check(r.iterations == one, f"fv sweep Re={re:g}: {r.iterations} "
                  f"iterations, the one-lane solve took {one}")
    check(set(FV_B1_ITERATIONS) >= {100.0, 1000.0},
          "phases 5 and 6 left no one-lane counts")
    steps = sum(r.iterations for r in results)
    print(f"[fv sweep] N=128 float32, 3 lanes: shared wall "
          f"{results[0].wall_time:.3f}s (call {call:.3f}s), {steps} "
          f"lane-iterations, aggregate {steps / results[0].wall_time:.1f} "
          f"lane-iterations/s", flush=True)


def nk_system(n, lid, dt):
    """The preconditioner of the Newton matvec at order N on the card, and
    the Schur system of one application to a seeded vector: (pre, rhs,
    inv_dt as a 0-d tensor, inv_hlam)."""
    p = SpectralParameters(nx=n, ny=n, dtype="float64", device="cuda",
                           **({"Re": 1000.0, "corner_treatment": "singular"}
                              if lid == "singular" else
                              {"Re": 250.0, "corner_treatment": "smoothing"}))
    ops, grid = core.build_spectral_ops(p)
    prob = steady._SteadyProblem(ops)
    pre = steady._StokesPreconditioner(prob, grid)
    inv_dt = torch.full((), 1.0 / dt, dtype=torch.float64, device="cuda")
    inv_hlam = pre.inv_hlam(inv_dt)
    r = prob.to_device(np.random.default_rng(5).standard_normal(prob.n_tot))
    r_u, r_v, r_p = prob.unflatten(r)
    S = pre.schur
    rhs = r_p - pre.beta_sq * nkk.div(S, nkk.hsolve(S, r_u, inv_hlam),
                                      nkk.hsolve(S, r_v, inv_hlam))
    return pre, rhs.contiguous(), inv_dt, inv_hlam


def norm_rel(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def schur_on_cpu(S):
    """The Schur operators of ``S`` on the CPU."""
    return nkk.SchurOps(beta_sq=S.beta_sq, **{
        f.name: getattr(S, f.name).cpu() for f in dataclasses.fields(S)
        if f.init and f.name != "beta_sq"})


def cpu_loop(Sc, rhs, inv_dt, inv_hlam, budget):
    """The plain loop on the CPU operators ``Sc`` in one torch thread: the
    yardstick of rounding of phase 2f and of tests/test_torch_nk.py, the
    same sum order on every host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return nkk.schur_plain(Sc, rhs.cpu(), inv_dt.cpu(), inv_hlam.cpu(),
                               1e-8, budget)
    finally:
        torch.set_num_threads(threads)


def perturbed(rhs, seed):
    """rhs times (1 + 1e-15 g), g seeded standard normal."""
    g = np.random.default_rng(seed).standard_normal(tuple(rhs.shape))
    return rhs * (1.0 + 1e-15 * torch.as_tensor(g, device=rhs.device))


def phase_nk_kernel(summary):
    """Phase 2f: the Schur kernel against the masked plain loop (on the
    card, and on the CPU as the yardstick of rounding)."""
    t0 = time.time()
    worst = {b: 0.0 for b in NK_EARLY}
    abs8 = 0.0
    logs = []  # log(kernel residual / plain residual), unconverged solves
    failures = []
    timed = []

    def want(cond, msg):
        if not cond:
            failures.append(msg)

    with uncounted():
        for n in NK_N:
            resident, grid = nkk.schur_geometry(n - 1)
            print(f"[nk] N={n}: {'resident' if resident else 'streamed'} "
                  f"operator bands, {grid} blocks", flush=True)
            want(resident == (n not in NK_STREAMED),
                 f"N={n}: resident {resident}")
        for lid in ("singular", "smoothing"):
            for n in NK_N:
                for dt in (0.05, 1.0, 3e3):
                    pre, rhs, inv_dt, inv_hlam = nk_system(n, lid, dt)
                    S, Sc = pre.schur, schur_on_cpu(pre.schur)
                    what = f"nk N={n} {lid} dt={dt:g}"

                    def res(x, b=rhs):
                        return norm_rel(nkk.schur_apply(S, x, inv_dt,
                                                        inv_hlam), b)

                    def card_pair(b, budget):
                        x_k, k_k = nkk.schur_kernel(S, b, inv_dt, inv_hlam,
                                                    1e-8, budget)
                        torch.cuda.synchronize()  # a fault shows here
                        x_p, k_p = nkk.schur_plain(S, b, inv_dt, inv_hlam,
                                                   1e-8, budget)
                        return x_k, int(k_k), x_p, int(k_p)

                    line = []
                    budgets = NK_EARLY + (() if n in NK_STREAMED else (40,))
                    if n >= 96:
                        timed.append((n, lid, dt, pre, rhs, inv_dt,
                                      inv_hlam))
                    for budget in budgets:
                        x_k, k_k, x_p, k_p = card_pair(rhs, budget)
                        x_c, k_c = cpu_loop(Sc, rhs, inv_dt, inv_hlam,
                                            budget)
                        x_c = x_c.cuda()
                        err, spread = norm_rel(x_k, x_p), norm_rel(x_c, x_p)
                        head = (f"budget {budget}: k {k_k} (plain {k_p}, cpu "
                                f"{int(k_c)}) rel {err:.3e} (cpu {spread:.3e})")
                        if budget in NK_EARLY:
                            worst[budget] = max(worst[budget], err)
                            if n == 128 and budget == 8:
                                abs8 = max(abs8, float((x_k - x_p).abs().max()))
                            tol = max(NK_B8_TOL, NK_SPREAD * spread)
                            want(k_k == k_p == budget and err <= tol,
                                 f"{what} budget {budget}: k {k_k}, {k_p}, "
                                 f"rel {err:.3e} > {tol:.3e}")
                            line.append(head)
                            continue
                        r_k, r_p, r_c = res(x_k), res(x_p), res(x_c)
                        head += (f" residual {r_k:.2e} (plain {r_p:.2e}, cpu "
                                 f"{r_c:.2e})")
                        want(abs(k_k - k_p) <= 2,
                             f"{what} budget 40: k {k_k}, plain {k_p}")
                        if k_k < budget:  # the kernel converged
                            want(r_k <= NK_RES_TOL,
                                 f"{what}: converged, residual {r_k:.2e}")
                        if k_p < budget:  # the plain loop converged
                            want(k_k < budget and r_p <= NK_RES_TOL,
                                 f"{what}: plain converged in {k_p} "
                                 f"(residual {r_p:.2e}), kernel k {k_k}")
                        else:
                            rk, rp = [r_k], [r_p]
                            for seed in range(1, NK_PERTURB + 1):
                                b = perturbed(rhs, seed)
                                y_k, _, y_p, _ = card_pair(b, budget)
                                rk.append(res(y_k, b))
                                rp.append(res(y_p, b))
                            logs += [float(np.log(a / c))
                                     for a, c in zip(rk, rp)]
                            med_k, med_p = np.median(rk), np.median(rp)
                            head += (f"; unconverged, median residual over "
                                     f"{len(rk)} right-hand sides {med_k:.2e}"
                                     f" (plain {med_p:.2e})")
                            want(med_k <= NK_UNCONV_MED * med_p,
                                 f"{what}: median residual {med_k:.2e}, "
                                 f"plain {med_p:.2e}")
                        line.append(head)
                    print(f"[nk] {what}: " + "; ".join(line), flush=True)
        gm = float(np.exp(np.mean(logs)))
        print(f"[nk] unconverged solves at budget 40: geometric mean of the "
              f"kernel's residual over the plain loop's {gm:.3f} over "
              f"{len(logs)} solves (bound {NK_UNCONV_GM})", flush=True)
        want(gm <= NK_UNCONV_GM, f"unconverged residual ratio {gm:.3f}")
        for code, A, b in ((-10, [[0.0, 2.0, 2.0], [1.0, 1.0, 2.0],
                                  [1.0, -1.0, -2.0]], [0.0, -1.0, 0.0]),
                           (-11, [[1.0, -2.0], [1.0, 0.0]], [1.0, 0.0]),
                           # S = 2 I: s = 0 after the first half-step, the
                           # ||s|| exit with x = b / 2
                           (1, [[2.0, 0.0], [0.0, 2.0]], [1.0, -3.0])):
            M = torch.tensor(A, dtype=torch.float64, device="cuda")
            eye = torch.eye(len(b), dtype=torch.float64, device="cuda")
            zero = torch.zeros_like(eye)
            ops_m = nkk.SchurOps(Gxr=M, IyTr=eye, Ixr=zero, GyTr=zero,
                                 Vxi=eye, Vyi=eye, Vx=eye, Vy=eye, Dxi=eye,
                                 DyTi=zero, beta_sq=-1.0)
            rhs = torch.zeros_like(eye)
            rhs[:, 0] = torch.tensor(b, dtype=torch.float64, device="cuda")
            x_k, k_k = nkk.schur_kernel(ops_m, rhs, 0.0, torch.ones_like(eye),
                                        1e-8, 10)
            x_p, k_p = nkk.schur_plain(ops_m, rhs, 0.0, torch.ones_like(eye),
                                       1e-8, 10)
            print(f"[nk] {'exit on ||s||' if code > 0 else 'breakdown'}: k "
                  f"{int(k_k)} (plain {int(k_p)}, want {code})", flush=True)
            want(int(k_k) == int(k_p) == code and torch.equal(x_k, x_p),
                 f"code {code}: k {int(k_k)}, plain {int(k_p)}")
            if code > 0:
                want(torch.equal(x_k, rhs / 2), "the ||s|| exit's x")
        check(not failures, "phase 2f: " + "; ".join(failures))
        for n, lid, dt, pre, rhs, inv_dt, inv_hlam in timed:
            k = int(nkk.schur_kernel(pre.schur, rhs, inv_dt, inv_hlam, 1e-8,
                                     40)[1])
            t_k = cuda_ms(lambda: nkk.schur_kernel(
                pre.schur, rhs, inv_dt, inv_hlam, 1e-8, 40), 10)
            t_p = cuda_ms(lambda: nkk.schur_plain(
                pre.schur, rhs, inv_dt, inv_hlam, 1e-8, 40), 2)
            ni = n - 1
            b_ms, b_by = bound(nkk.schur_flops(ni, k), nkk.schur_bytes(ni),
                               torch.float64)
            print(f"[nk] N={n} {lid} dt={dt:g} budget 40: kernel {t_k:.4f} "
                  f"ms ({k} iterations, {t_k / max(k, 1) * 1e3:.1f} us an "
                  f"iteration), plain {t_p:.4f} ms (40 masked), bound "
                  f"{b_ms:.5f} ms ({b_by}; the folded kernel's own "
                  f"{nkk.schur_folded_flops(ni, k) / 1e9:.4f} GFLOP)",
                  flush=True)
            if (n, lid, dt) == (128, "singular", 1.0):  # the cold solve's
                summary["nk_schur"].update(ms=t_k, plain_ms=t_p,
                                           bound_ms=b_ms, bound_by=b_by,
                                           library_ms=None, max_abs_err=abs8)
    print(f"[nk] phase 2f: worst rel at budget "
          + ", ".join(f"{b} {worst[b]:.3e}" for b in NK_EARLY)
          + f"; {time.time() - t0:.1f}s", flush=True)


def newton_params(**kw):
    """The Newton knobs of conf/solver/spectral/newton.yaml (float64, 50
    PTC steps, GMRES(60), dt0 0.05, dt_max 3e3, 40 Schur iterations, no
    prelude), tolerance 1e-6 (RMS steady residual), on the sharp lid
    (corner_treatment=singular) at N=128 Re=1000 on the Legendre-Gauss-
    Lobatto grid: the grid of the stored exact states in data/steady/
    (the parameters' default basis; sg.yaml's Chebyshev grid is another
    discretization, on which those states are not steady)."""
    base = dict(newton_max_steps=50, gmres_vectors=60, newton_dt0=0.05,
                newton_dt_max=3e3, newton_schur_iters=40, newton_prelude=0,
                tolerance=1e-6, basis_type="legendre")
    base.update(kw)
    return params(128, "float64", "singular", **base)


def steady_rms(solver) -> float:
    """The RMS steady residual ||F||_rms of the solver's state."""
    prob = steady._SteadyProblem(solver.ops)
    F = prob.F(prob.state_to_x(solver.state))
    return float(torch.linalg.norm(F)) / prob.n_tot ** 0.5


def step_rms(solver) -> list:
    """||F||_rms after each accepted PTC step, from the residual history."""
    ts, n_tot = solver.time_series, steady._SteadyProblem(solver.ops).n_tot
    return [float(np.sqrt(u * u + v * v + c * c) / np.sqrt(n_tot))
            for u, v, c in zip(ts.u_residual, ts.v_residual,
                               ts.continuity_residual)]


def state_distance(solver) -> dict:
    """max |state - sharp_Re1000_N128.npz| of u, v and p less its mean."""
    d = np.load(STEADY_RE1000)
    got = {k: t.detach().cpu().numpy() for k, t in zip("uvp", solver.state)}
    # the inner pressure's constant is free (null space of F): compare
    # the pressure less its mean
    ref = {"u": d["u"], "v": d["v"], "p": d["p"] - d["p"].mean()}
    got["p"] = got["p"] - got["p"].mean()
    return {k: float(np.max(np.abs(got[k] - ref[k]))) for k in "uvp"}


def newton_line(what, solver, call) -> float:
    """Print a Newton solve's numbers; return its final ||F||_rms."""
    m = solver.metrics
    vec = solver.newton_stats.get("gmres_vectors", [])
    rms = steady_rms(solver)
    diff = ", ".join(f"{k} {e:.3e}" for k, e in
                     state_distance(solver).items())
    print(f"[{what}] N=128 Re=1000 singular {solver.params.basis_type} "
          f"tol={solver.params.tolerance:g} float64: {m.iterations} PTC "
          f"steps, converged={m.converged}, "
          f"wall {m.wall_time_seconds:.3f}s (call {call:.3f}s), "
          f"{m.wall_time_seconds / max(m.iterations, 1):.3f} s per PTC "
          f"step, GMRES vectors per attempted step {vec} (mean "
          f"{np.mean(vec) if vec else 0.0:.1f}), F evaluations "
          f"{solver.newton_stats.get('F_evals')}, final ||F||_rms "
          f"{rms:.3e}, psi_min {m.psi_min:.7f}, omega_center "
          f"{m.omega_center:.6f}, energy {m.final_energy:.9f}; max |state - "
          f"sharp_Re1000_N128.npz| (p less its mean) {diff}", flush=True)
    return rms


def cold_noise(n_tot, seed):
    """The seeded 1e-15 perturbation of the cold solve's x0 (none for
    seed 0)."""
    if not seed:
        return np.zeros(n_tot)
    return np.random.default_rng(seed).standard_normal(n_tot) * 1e-15


def cold_solve(prob, pre, p, seed):
    """steady.ptc_solve from rest plus ``cold_noise(seed)`` with the knobs
    of the parameters ``p``: (PTC steps, converged, GMRES vectors,
    ||F||_rms)."""
    x0 = steady._host(prob.state_to_x(core.initial_state(prob.ops)))
    stats = {}
    x, conv, _, steps = steady.ptc_solve(
        prob, pre, x0 + cold_noise(prob.n_tot, seed), tol_rms=p.tolerance,
        max_steps=int(p.newton_max_steps), gmres_vectors=int(p.gmres_vectors),
        dt0=float(p.newton_dt0), dt_max=float(p.newton_dt_max), stats=stats)
    rms = float(np.linalg.norm(steady._host(prob.F(x)))
                / np.sqrt(prob.n_tot))
    return steps, conv, sum(stats["gmres_vectors"]), rms


def phase_newton_cold():
    """The Newton N=128 Re=1000 sharp-lid solve from rest, tol 1e-6; then
    the same solve from x0 + 1e-15 noise of NEWTON_SEEDS."""
    solver = steady.NewtonSolver(params=newton_params())
    t0 = time.time()
    solver.solve()
    torch.cuda.synchronize()
    rms = newton_line("newton cold", solver, time.time() - t0)
    steps_j, rms_j, psi_j = JAX_NEWTON_COLD[:3]
    print(f"[newton cold] JAX (CPU): {steps_j} PTC steps, ||F||_rms "
          f"{rms_j:.3e}, psi_min {psi_j:.7f}", flush=True)
    lead = step_rms(solver)[:len(JAX_NEWTON_COLD_LEAD)]
    errs = [abs(a - b) / b for a, b in zip(lead, JAX_NEWTON_COLD_LEAD)]
    print(f"[newton cold] ||F||_rms after the first steps {lead} (JAX "
          f"{list(JAX_NEWTON_COLD_LEAD)}): relative differences "
          + ", ".join(f"{e:.2e}" for e in errs), flush=True)
    runs = [(solver.metrics.iterations, solver.metrics.converged,
             sum(solver.newton_stats["gmres_vectors"]), rms)]
    prob = steady._SteadyProblem(solver.ops)
    pre = steady._StokesPreconditioner(
        prob, solver.grid, schur_iters=solver.params.newton_schur_iters)
    t0 = time.time()
    with uncounted():  # the distribution's other draws
        for seed in NEWTON_SEEDS:
            runs.append(cold_solve(prob, pre, solver.params, seed))
    steps = [r[0] for r in runs]
    median = float(np.median(steps))
    lo, hi = PLAIN_COLD_STEPS
    print(f"[newton cold] from x0 and x0 + 1e-15 noise of seeds "
          f"{list(NEWTON_SEEDS)} ({time.time() - t0:.1f}s): PTC steps "
          f"{steps}, median {median:g} (the plain loop's band {lo}-{hi}, "
          f"JAX {steps_j}); GMRES vectors {[r[2] for r in runs]}, median "
          f"{np.median([r[2] for r in runs]):g}; ||F||_rms "
          + ", ".join(f"{r[3]:.3e}" for r in runs), flush=True)
    check(solver.metrics.converged and rms <= 1e-6,
          f"the cold Newton solve did not converge (||F||_rms {rms:.3e})")
    check(len(errs) == len(JAX_NEWTON_COLD_LEAD)
          and max(errs) <= NEWTON_LEAD_TOL,
          f"the cold solve's first steps leave JAX's trajectory: {errs}")
    dist = state_distance(solver)
    check(max(dist["u"], dist["v"]) <= NEWTON_COLD_STATE_TOL,
          f"the converged cold state is {dist} from the stored one")
    check(all(r[1] and r[3] <= 1e-6 for r in runs),
          f"a perturbed cold solve did not converge: {runs}")
    check(lo <= median <= hi,
          f"the cold solves' median {median:g} PTC steps ({steps}) is "
          f"outside the plain loop's band {lo}-{hi}")
    return solver


def phase_newton_warm():
    """The Newton N=128 Re=1000 solve warm from the stored exact state,
    tol 1e-8, against Botella & Peyret."""
    solver = steady.NewtonSolver(params=newton_params(
        tolerance=1e-8, initial_state_path=str(STEADY_RE1000)))
    t0 = time.time()
    solver.solve()
    torch.cuda.synchronize()
    newton_line("newton warm", solver, time.time() - t0)
    m = solver.metrics
    psi_ref, psi_tol, om_ref, om_tol = BOTELLA_RE1000
    print(f"[newton warm] JAX (CPU): {JAX_NEWTON_WARM[0]} PTC steps, psi_min "
          f"{JAX_NEWTON_WARM[2]:.7f}, omega_center {JAX_NEWTON_WARM[3]:.6f}; "
          f"Botella psi_min {psi_ref} omega {om_ref}", flush=True)
    check(m.converged and m.iterations <= 1,
          f"the warm Newton solve: {m.iterations} steps, converged "
          f"{m.converged}")
    check(abs(m.psi_min - psi_ref) < psi_tol,
          f"psi_min {m.psi_min} against Botella {psi_ref}")
    check(abs(abs(m.omega_center) - om_ref) < om_tol,
          f"omega_center {m.omega_center} against Botella {om_ref}")
    # one PTC step from the stored state through the graphed matvec
    step = steady.NewtonSolver(params=newton_params(
        tolerance=0.0, newton_max_steps=1,
        initial_state_path=str(STEADY_RE1000)))
    t0 = time.time()
    step.solve()
    torch.cuda.synchronize()
    rms = newton_line("newton warm step", step, time.time() - t0)
    check(step.newton_stats["gmres_vectors"] and rms <= 1e-8,
          f"the PTC step from the stored state: ||F||_rms {rms:.3e}")


def phase_newton_warm256():
    """The Newton N=256 Re=5000 sharp-lid solve warm from the stored state
    with the knobs of phase 14 at tolerance 1e-6 (0 PTC steps), then one
    PTC step from it through the graphed matvec, whose Schur kernel
    streams its operator bands at this order."""
    kw = dict(nx=256, ny=256, Re=5000.0,
              initial_state_path=str(STEADY_RE5000_N256))
    solver = steady.NewtonSolver(params=newton_params(**kw))
    t0 = time.time()
    solver.solve()
    torch.cuda.synchronize()
    call = time.time() - t0
    m = solver.metrics
    rms0 = steady_rms(solver)
    print(f"[newton warm N=256] Re=5000 singular legendre tol=1e-6 float64 "
          f"from {STEADY_RE5000_N256.name}: {m.iterations} PTC steps, "
          f"converged={m.converged}, wall {m.wall_time_seconds:.3f}s (call "
          f"{call:.3f}s), ||F||_rms {rms0:.3e}, psi_min {m.psi_min:.7f}",
          flush=True)
    check(m.converged and m.iterations == 0,
          f"the warm N=256 solve: {m.iterations} steps, converged "
          f"{m.converged}, ||F||_rms {rms0:.3e}")
    launches = nkk.LAUNCHES["nk_schur"]
    step = steady.NewtonSolver(params=newton_params(
        tolerance=0.0, newton_max_steps=1, **kw))
    t0 = time.time()
    step.solve()
    torch.cuda.synchronize()
    call = time.time() - t0
    rms = steady_rms(step)
    vec = step.newton_stats.get("gmres_vectors", [])
    print(f"[newton warm N=256] one PTC step from the stored state: wall "
          f"{step.metrics.wall_time_seconds:.3f}s (call {call:.3f}s), GMRES "
          f"vectors {vec}, nk_schur launches "
          f"{nkk.LAUNCHES['nk_schur'] - launches} (the whole phase "
          f"{nkk.LAUNCHES['nk_schur']}), ||F||_rms {rms0:.3e} -> {rms:.3e}",
          flush=True)
    check(vec and rms <= 1e-8,
          f"the PTC step from the stored N=256 state: ||F||_rms {rms:.3e}")


def profile_ptc_step(solver):
    """The cold solve's first PTC step (from rest at dt0) unprofiled, its
    graph capture included; then 20 GMRES vectors of a matvec captured
    from the same point: the unprofiled wall a vector and, by
    torch.profiler, the device activities a vector, the idle share and the
    leading device operations."""
    prob = steady._SteadyProblem(solver.ops)
    pre = steady._StokesPreconditioner(
        prob, solver.grid, schur_iters=solver.params.newton_schur_iters)
    x0 = steady._host(prob.state_to_x(core.initial_state(solver.ops)))
    stats = {}
    torch.cuda.synchronize()
    t0 = time.time()
    steady.ptc_solve(prob, pre, x0, tol_rms=0.0, max_steps=1,
                     gmres_vectors=60, dt0=0.05, dt_max=3e3, stats=stats)
    torch.cuda.synchronize()
    step_wall = time.time() - t0
    mv = steady._Matvec(prob, pre)
    mv.set_step(x0, 1.0 / 0.05)
    F0 = steady._host(prob.F(x0))
    n_vec = 20
    used = []

    def run():
        used.append(steady._gmres(mv, mv.precond_apply, F0, n_vec, 0.0)[2])

    run()  # capture
    torch.cuda.synchronize()
    launches = nkk.LAUNCHES["nk_schur"]
    t0 = time.time()
    run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    per_run = nkk.LAUNCHES["nk_schur"] - launches
    traced = trace_device(run, "newton profile")
    print(f"[newton profile] one PTC step from rest (dt0 0.05; "
          f"{stats['gmres_vectors'][0]} GMRES vectors, {stats['F_evals']} F "
          f"evaluations, the capture included): unprofiled wall "
          f"{step_wall:.3f}s", flush=True)
    if traced is not None:
        dev, host = traced
        vec = used[-1]
        print(f"[newton profile] {vec} GMRES vectors of the captured matvec "
              f"and one P^-1 (nk launches {per_run}): unprofiled wall "
              f"{wall:.4f}s, {wall / vec * 1e3:.3f} ms a vector; "
              f"{len(dev) / vec:.1f} device activities a vector; profiled "
              f"host {host:.4f}s, {device_breakdown(dev)}", flush=True)


def phase_newton_prelude():
    """The Newton prelude, 200 marched RK4 steps at N=128 float64 on the
    sharp lid from rest, through the solver's route on CUDA (the SG step
    kernel) against the plain prelude (use_pallas=false)."""
    n = 200
    solver = steady.NewtonSolver(params=newton_params(newton_prelude=n))
    t0 = time.time()
    out_k = solver._march_prelude(solver.state, n)
    torch.cuda.synchronize()
    t_k = time.time() - t0
    plain = steady.NewtonSolver(params=newton_params(newton_prelude=n,
                                                     use_pallas="false"))
    t0 = time.time()
    out_p = plain._march_prelude(plain.state, n)
    torch.cuda.synchronize()
    t_p = time.time() - t0
    err = max(rel_err(a, b) for a, b in zip(out_k, out_p))
    print(f"[newton prelude] {n} steps N=128 float64 singular: kernel route "
          f"{t_k:.3f}s, plain {t_p:.3f}s, max relative error {err:.3e} "
          f"(bound 1e-11)", flush=True)
    check(err <= 1e-11, f"the prelude differs from the plain one: {err}")


def phase_fsg_polished():
    """The FSG flagship of phase 4 with newton_polish=true: the same march,
    then the float64 polish on the card."""
    solver = FSGSolver(params=params(96, "float32", tolerance=1e-6,
                                     max_iterations=400_000, multigrid="fsg",
                                     n_levels=2, coarse_tolerance_factor=1.0,
                                     newton_polish=True))
    solver.solve()
    torch.cuda.synchronize()
    m = solver.metrics
    info = solver._polish_info
    ghia = ghia_u_error(solver)
    print(f"[fsg polished] N=96 Re=1000 tol=1e-6 float32 march: "
          f"{m.iterations} iterations (phase 4: {FSG_MARCH.get('iterations')}"
          f", {FSG_MARCH.get('wall', 0.0):.3f}s); float64 polish: "
          f"{m.polish_steps} PTC steps in {info['wall']:.3f}s, "
          f"converged={info['converged']}, steady_residual_rms "
          f"{m.steady_residual_rms:.3e}; total wall {m.wall_time_seconds:.3f}s"
          f"; Ghia u-centerline max err {FSG_MARCH.get('ghia', np.nan):.5f} "
          f"marched, {ghia:.5f} polished; psi_min {m.psi_min:.7f}",
          flush=True)
    check(m.iterations == FSG_MARCH.get("iterations"),
          f"the polished flagship marched {m.iterations} iterations, phase 4 "
          f"{FSG_MARCH.get('iterations')}")
    check(info["converged"] and m.polish_steps <= 12
          and m.steady_residual_rms <= 1e-9,
          f"the polish: {m.polish_steps} steps, rms "
          f"{m.steady_residual_rms:.3e}, converged {info['converged']}")
    check(solver.state.u.dtype == torch.float64, "the polish is not float64")


def resume_check(what, make, chunk):
    """Three chunks in one solve against two chunks with checkpoints and a
    new solver resumed for the third: states and iterations bit-equal."""
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.time()
        ref = make(max_iterations=3 * chunk)
        ref.solve()
        first = make(max_iterations=2 * chunk, checkpoint_dir=ck,
                     checkpoint_every_chunks=1)
        first.solve()
        resumed = make(max_iterations=3 * chunk, checkpoint_dir=ck,
                       checkpoint_every_chunks=1)
        resumed.solve()
        torch.cuda.synchronize()
        saved = sorted(p.name for p in Path(ck).glob("ckpt_*.npz"))
    same = [same_bits(a, b) for a, b in zip(resumed.state, ref.state)]
    print(f"[{what}] {ref.metrics.iterations} iterations in one solve; "
          f"{first.metrics.iterations} + resumed to "
          f"{resumed.metrics.iterations} (checkpoints {saved}); bit-equal "
          f"fields {same} ({time.time() - t0:.1f}s)", flush=True)
    check(resumed.metrics.iterations == ref.metrics.iterations == 3 * chunk,
          f"{what}: iterations {resumed.metrics.iterations} against "
          f"{ref.metrics.iterations}")
    check(all(same), f"{what}: the resumed state differs from the "
          "uninterrupted one")


def phase_sg_resume():
    """SG N=128 float32 through the chunk kernel, chunks of 1,000."""
    resume_check("sg resume N=128 float32", lambda **kw: SGSolver(
        params=params(128, "float32", tolerance=0.0, chunk_size=1000,
                      convergence_metric="rel_iter", **kw)), 1000)


def phase_fv_resume():
    """FV N=128 float32 through the FV chunk kernels, chunks of 100."""
    resume_check("fv resume N=128 float32", lambda **kw: fvm.FVSolver(
        params=fv_params(128, 128, "float32", tolerance=0.0,
                         chunk_size=100, **kw)), 100)


@contextlib.contextmanager
def nccl_world():
    """A one-rank NCCL process group on card 0 (an in-process store),
    destroyed on the way out: NCCL refuses two ranks on one card, so the
    distributed paths run here at world size 1 through the real backend
    and collectives."""
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def in_nccl_world(phase):
    def run():
        with nccl_world():
            return phase()

    return run


@contextlib.contextmanager
def uncounted():
    """Kernel launches and plain calls made to hold a path against a
    yardstick count for no main path: the counters are restored."""
    saved = [(dict(getattr(c, "LAUNCHES", {})), dict(c.PLAIN_CALLS))
             for c in COUNTERS]
    try:
        yield
    finally:
        for c, (launches, plain) in zip(COUNTERS, saved):
            getattr(c, "LAUNCHES", {}).update(launches)
            c.PLAIN_CALLS.update(plain)


def kinetic_energy(ops, u, v) -> float:
    """0.5 sum W2d (u^2 + v^2), in float64 from the final fields."""
    u, v, w = (t.double() for t in (u, v, ops.W2d))
    return float(0.5 * torch.sum(w * (u * u + v * v)))


def phase_sharded():
    """Phase 18: the x-sharded SG N=128 Re=1000 solve at world size 1 over
    NCCL (sg.yaml numerics); no kernel of the port, as in the JAX
    module."""
    from torch.distributed.device_mesh import init_device_mesh

    inf = float("inf")
    # float64: 200 steps against the plain sg_step chunk
    p64 = params(128, "float64")
    ops64 = core.build_spectral_ops(p64)[0]
    dev = ops64.device
    mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("x",))
    sh64 = SP.shard_ops(SP.build_sharded_ops(p64)[0], 0, 1)
    s0 = core.initial_state(ops64)
    run = SP.make_sharded_chunk_runner(mesh, sh64, 200, 0.0)
    (u, v, pp), done, ci, conv, rows, _ = run(
        (s0.u, s0.v, SP.pad_pressure(s0.p)), 0, inf)
    plain = TR.make_chunk_runner(lambda s: core.sg_step(ops64, s),
                                 lambda s: (s.u, s.v), 200, 0.0)
    ps, pdone, pci, pconv, prows, _ = plain(
        s0, 0, torch.tensor(inf, dtype=torch.float64, device=dev))
    err = max(rel_err(u, ps.u), rel_err(v, ps.v),
              rel_err(SP.unpad_pressure(pp), ps.p))
    flags = [(bool(a), int(b), bool(c)) for a, b, c in
             ((done, ci, conv), (pdone, pci, pconv))]
    print(f"[sharded] N=128 float64, 200 steps from rest: relative max "
          f"error against the plain sg_step chunk {err:.3e} (bound 1e-11), "
          f"rows {rel_err(rows, prows):.3e}; flags {flags[0]} / {flags[1]}",
          flush=True)
    check(err <= 1e-11 and flags[0] == flags[1],
          f"sharded float64 chunk: error {err:.3e}, flags {flags}")

    # float32: a 64-step chunk from a developing flow against the kernel
    # chunk on the same tensors
    p32 = params(128, "float32")
    ops32 = core.build_spectral_ops(p32)[0]
    sh32 = SP.shard_ops(SP.build_sharded_ops(p32)[0], 0, 1)
    inf32 = torch.tensor(inf, device=dev)
    with uncounted():
        dev_state = sgk.make_sg_chunk_runner(ops32, 500, 0.0)(
            core.initial_state(ops32), 0, inf32)[0]
        ks, kdone, kci, _, _, _ = sgk.make_sg_chunk_runner(ops32, 64, 1e-8)(
            dev_state, 500, inf32)
    (u, v, pp), done, ci, _, _, _ = SP.make_sharded_chunk_runner(
        mesh, sh32, 64, 1e-8)((dev_state.u, dev_state.v,
                               SP.pad_pressure(dev_state.p)), 500, inf)
    err = max(rel_err(u, ks.u), rel_err(v, ks.v),
              rel_err(SP.unpad_pressure(pp), ks.p))
    same = (bool(done), int(ci)) == (bool(kdone), int(kci))
    print(f"[sharded] N=128 float32, a 64-step chunk from the flow after 500 "
          f"steps: relative max error against the kernel chunk {err:.3e} "
          f"(bound 1e-4); done/conv_iter equal {same}", flush=True)
    check(err <= 1e-4 and same,
          f"sharded float32 chunk: error {err:.3e}, flags equal {same}")

    # float32 timing: 2,000 steps from rest against the kernel chunk
    s0 = core.initial_state(ops32)
    whole = (s0.u, s0.v, SP.pad_pressure(s0.p))
    run = SP.make_sharded_chunk_runner(mesh, sh32, 2000, 0.0)
    torch.cuda.synchronize()  # the runs above warmed cuBLAS and NCCL
    t0 = time.time()
    (u, v, pp), *_ = run(SP.shard_state(mesh, whole), 0, inf)
    torch.cuda.synchronize()
    ms = (time.time() - t0) / 2000 * 1e3
    with uncounted():
        krun = sgk.make_sg_chunk_runner(ops32, 2000, 0.0)
        krun(s0, 0, inf32)
        torch.cuda.synchronize()
        t0 = time.time()
        kstate = krun(s0, 0, inf32)[0]
        torch.cuda.synchronize()
        kms = (time.time() - t0) / 2000 * 1e3
    finite = all(bool(torch.isfinite(t).all()) for t in (u, v, pp))
    ke, kke = kinetic_energy(ops32, u, v), kinetic_energy(ops32, kstate.u,
                                                          kstate.v)
    ke_err = abs(ke - kke) / abs(kke)
    run20 = SP.make_sharded_chunk_runner(mesh, sh32, 20, 0.0)
    prof = profile_chunk(lambda: run20(SP.shard_state(mesh, whole), 0, inf),
                         "sharded profile N=128 float32 20-step chunk")
    per_step = (f"{len(prof[0]) / 20:.1f} device activities a step"
                if prof else "launches a step not measured")
    print(f"[sharded] N=128 float32, 2,000 steps from rest: {ms:.4f} ms a "
          f"step ({1e3 / ms:.1f} steps/s), {per_step}; the kernel chunk "
          f"{kms:.4f} ms a step; finite {finite}; kinetic energy {ke:.9e} "
          f"against the kernel path's {kke:.9e} (relative {ke_err:.3e}, "
          f"bound 1e-4)", flush=True)
    check(finite, "the sharded float32 state is not finite")
    check(ke_err <= 1e-4, f"sharded kinetic energy off by {ke_err:.3e}")


def phase_sg_sweep_mesh():
    """Phase 19: phase 11's sweep through run_batched(mesh=...) at world
    size 1: every lane bit-equal to the sweep without a mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    check(SG_SWEEP, "phase 11 left no sweep to repeat")
    solvers = [SGSolver(params=sg_sweep_params(*lane))
               for lane in SG_SWEEP_LANES]
    mesh = init_device_mesh(solvers[0].device.type, (1,),
                            mesh_dim_names=("sweep",))
    t0 = time.time()
    results = TB.run_batched(solvers, mesh=mesh)
    torch.cuda.synchronize()
    call = time.time() - t0
    iters = [r.iterations for r in results]
    bits = [all(same_bits(a, b) for a, b in zip(s.state, ref))
            for s, ref in zip(solvers, SG_SWEEP["states"])]
    print(f"[sg sweep mesh] N=128 float32, 8 lanes x 5000 steps over a "
          f"('sweep',) mesh of 1 rank (NCCL): shared wall "
          f"{results[0].wall_time:.3f}s (call {call:.3f}s) against "
          f"{SG_SWEEP['wall']:.3f}s without a mesh; iterations {iters}; "
          f"every lane bit-equal {all(bits)}", flush=True)
    check(iters == SG_SWEEP["iterations"], f"mesh sweep iterations {iters}")
    check(all(bits), f"mesh sweep lanes differ: {bits}")


def phase_scaling():
    """Phase 20: the scaling probe at one rank, N=127 (a reading of the
    mechanism on one card, not a scaling claim)."""
    out = measure_scaling(n=127, device="cuda")
    print("[scaling] one rank, N=127: " + json.dumps(out), flush=True)
    check(all(np.isfinite(v) for k, v in out.items()
              if isinstance(v, float)), f"scaling keys not finite: {out}")


def phase_dryrun():
    """dryrun_multigpu over every card: in a one-rank NCCL world when the
    machine shows one card (its 2-process sweep is then not measured)."""
    n = torch.cuda.device_count()
    t0 = time.time()
    if n == 1:
        with nccl_world():
            dryrun_multigpu(1, "cuda")
    else:
        dryrun_multigpu(n, "cuda")
    print(f"[dryrun] {n} card(s): {time.time() - t0:.1f}s", flush=True)


def flagship_vmg() -> int:
    """The converged VMG [192, 96] Re=1000 tol 1e-6 float32 solve."""
    card = phase_device()
    solver = vmg.VMGSolver(params=vmg_params(192, 1000.0, tolerance=1e-6,
                                             chunk_size=2000))
    sgk.reset_counts()
    solver.solve()
    torch.cuda.synchronize()
    m = solver.metrics
    errs = solver.compute_validation_errors(base_dir=ROOT, save_plots=False)
    ghia = ghia_u_error(solver)
    cycles, l2u, l2v = JAX_VMG192
    print(f"[flagship vmg] {card}; ladder {solver.ladder}, Re=1000 tol 1e-6 "
          f"float32: {m.iterations} V-cycles ({m.iterations / cycles:.3f} x "
          f"the JAX record {cycles}), converged={m.converged}, wall "
          f"{m.wall_time_seconds:.3f}s (first chunk "
          f"{solver.first_chunk_time:.3f}s), {m.iterations / m.wall_time_seconds:.1f} "
          f"cycles/s; L2 " + " ".join(f"{k}={v:.5f}" for k, v in errs.items())
          + f" (JAX u {l2u} v {l2v}); Ghia u-centerline max err {ghia:.4f}; "
          f"launches {sgk.LAUNCHES}, plain calls {sgk.PLAIN_CALLS}",
          flush=True)
    check(m.converged, "the VMG flagship did not converge")
    return 0


# the main paths: (name, phase, the kernels it must launch)
SG_NO_CONTROL = ("sg_stage", "sg_diag")
MAIN_PATHS = (
    ("sg N=128", phase_sg, sgk.KERNELS),
    ("fsg N=96", phase_fsg, sgk.KERNELS),
    # the flagship again with the float64 Newton polish (after phase 4,
    # whose march it repeats)
    ("fsg N=96 polished", phase_fsg_polished, sgk.KERNELS + nkk.KERNELS),
    # the port's CLI (python -m anap3_tpu_torch): the flagship, then one
    # round of the corner-smoothing optimization as one batch on the SG
    # lane kernels
    ("cli fsg N=96", phase_cli_fsg, sgk.KERNELS),
    ("cli optimization N=40", phase_cli_optimization, sgl.KERNELS),
    # the Newton iteration: each GMRES vector replays one CUDA graph of
    # the matvec, whose Schur BiCGSTAB is the nk kernel (no pallas_call in
    # the JAX module)
    ("newton N=128 cold", phase_newton_cold, nkk.KERNELS),
    ("newton N=128 warm", phase_newton_warm, nkk.KERNELS),
    # the Schur kernel's streamed geometry on a real system
    ("newton N=256 warm", phase_newton_warm256, nkk.KERNELS),
    ("newton prelude N=128", phase_newton_prelude, SG_NO_CONTROL),
    ("sg resume N=128", phase_sg_resume, sgk.KERNELS),
    ("fv resume N=128", phase_fv_resume, fvk.KERNELS),
    ("fv Re=100", lambda: phase_fv_solve(100.0), fvk.KERNELS),
    ("fv Re=1000", lambda: phase_fv_solve(1000.0), fvk.KERNELS),
    # the V-cycles step through the smoother and the step, whose tail is
    # tail_kernel (sg_diag); FMG's x6 chunk samples every step: no
    # control_kernel on these paths
    ("vmg [192, 96]", phase_vmg_wide, SG_NO_CONTROL),
    ("vmg N=48", phase_vmg48, SG_NO_CONTROL),
    ("fmg N=96", phase_fmg96, SG_NO_CONTROL),
    ("fsg sweep N=40", phase_fsg_sweep, sgl.KERNELS),
    ("sg sweep N=128", phase_sg_sweep, ("sg_lanes_aligned",)),
    ("fv sweep N=128", phase_fv_sweep, fvl.KERNELS),
    # the distributed paths at world size 1 over NCCL: the x-sharded solve
    # runs torch.matmul and collectives (no pallas_call in the JAX
    # module), the mesh sweep the lane kernels, the scaling probe both
    ("sg N=128 x-sharded", in_nccl_world(phase_sharded), ()),
    ("sg sweep N=128 over a mesh", in_nccl_world(phase_sg_sweep_mesh),
     ("sg_lanes_aligned",)),
    ("scaling probe", in_nccl_world(phase_scaling), ("sg_lanes_tiled",)),
)
# every module that counts kernel launches or plain calls
COUNTERS = (sgk, fvk, sgl, fvl, TS, nkk)
# the paths of --newton, in order
NEWTON_PATHS = ("fsg N=96", "fsg N=96 polished", "newton N=128 cold",
                "newton N=128 warm", "newton N=256 warm",
                "newton prelude N=128")


def run_main_paths(paths, names, summary):
    """Each main path with the counters zeroed just before it; every kernel
    it runs must have launched and no plain version run."""
    for path, phase, kernels in paths:
        for counter in COUNTERS:  # the path starts here
            counter.reset_counts()
        t0 = time.time()
        out = phase()
        torch.cuda.synchronize()
        launches = {k: v for c in COUNTERS
                    for k, v in getattr(c, "LAUNCHES", {}).items()}
        plain = {k: v for c in COUNTERS for k, v in c.PLAIN_CALLS.items()}
        print(f"[main path] {path} ({time.time() - t0:.1f}s): kernel launches "
              f"{launches}; plain calls {plain}", flush=True)
        for k in kernels:
            check(launches[k] > 0, f"kernel {k} was not launched on {path}")
        check(not any(plain.values()), f"plain versions ran on {path}: {plain}")
        for k in names:
            summary[k]["launches"] += launches[k]
        if phase is phase_vmg_wide:
            profile_vmg_chunk(out)
        if phase is phase_newton_cold:
            profile_ptc_step(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--flagship-vmg", action="store_true",
                    help="run only the converged VMG [192, 96] Re=1000 solve")
    ap.add_argument("--newton", action="store_true",
                    help="run only the Newton phases (1, 2f, 4, 4b, 13-15, 14b)")
    args = ap.parse_args()
    if args.flagship_vmg:
        return flagship_vmg()
    t_start = time.time()
    names = (sgk.KERNELS + fvk.KERNELS + sgl.KERNELS + fvl.KERNELS
             + nkk.KERNELS)
    summary = {k: {"name": k, "route": "cuda",
                   "source": SOURCES.get(k, f"anap3_tpu_torch/csrc/{k}.cu"),
                   "replaces": REPLACES[k], "launches": 0} for k in names}
    phase_device()
    if args.newton:
        phase_nk_kernel(summary)
        run_main_paths([m for m in MAIN_PATHS if m[0] in NEWTON_PATHS],
                       names, summary)
        print(f"[chip_smoke] --newton {time.time() - t_start:.1f}s",
              flush=True)
        return 0
    phase_kernels(summary)
    phase_fv_kernels(summary)
    phase_fv_flags()
    phase_smoother()
    phase_sg_lanes(summary)
    phase_fv_lanes(summary)
    phase_nk_kernel(summary)
    run_main_paths(MAIN_PATHS, names, summary)
    phase_dryrun()
    kernels = [{key: summary[k][key] for key in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for k in names]
    # sg_diag's two kernels (dt_kernel, tail_kernel) alone
    kernels[names.index("sg_diag")]["parts"] = summary["sg_diag"]["parts"]
    print(f"[chip_smoke] {time.time() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, NoDeviceActivity) as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
