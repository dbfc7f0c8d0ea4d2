"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each printing its own line:
  1. device   — the card's name and power limit (nvidia-smi); TF32 off
  2. build    — nvcc builds the stencil kernels from iemic_tpu_torch/csrc
  3. kernel   — every entry point of the kernel library against the
                plain PyTorch version, periodic and not, f32 and bf16
                coefficients: the wide kernels on the global 96x38x12
                grid (and f32 at 12x38x100), the general-shape kernels
                at 12x38x97, 12x38x100 (bf16), 6x6x3, 2x3x1 and 2x3x2;
                each also on an x kept on the two edge columns in i;
                wherever the wide kernel runs, the general-shape kernel
                on the same values (forced by a misaligned x) equal to
                it value for value; CUDA-event times beside the bound
                (the bytes of the coefficients whose neighbour lies in
                the grid, of x and of y, over 3.35 TB/s), cuSPARSE
                beside them at 12x38x97 and 12x38x100, and one read of
                all coefficients by PyTorch
  4. assembly — F and the f64 stencil tensor An of the global grid
                computed on the card against the port on the CPU
  5. effort   — one production solve (BGS + Mixed, tol 1e-3) of the
                configuration whose effort TESTLOG.md:139 records for
                the JAX package (69 MV to relres 6.92e-4): the port must
                meet the tolerance with MV within 10% of that record;
                then the wide and the general-shape kernel, f32 and bf16,
                on that model's own Jacobian and the solve's vectors:
                equal value for value, and against the f64 product; and
                every entry point and cuSPARSE timed on that Jacobian
  6. variants — on the effort phase's model and Jacobian, one Mixed
                solve of J x = -F at tol 1e-3, capped at 150 inner
                iterations (3 for M2 and M3, see VARIANTS), for each
                other branch of the BGS sweep
                (saddle schemes SL, SR and KRYLOV, symmetric
                Gauss-Seidel, the rho/mu transform, orderings M2 and M3,
                Columns on ATS, MG on Auv and on the 2D saddle,
                piecewise-constant MG prolongation): MV, true relative
                residual, seconds, kernel launches; a variant that stalls
                short of 1e-3 is printed as such, one whose output is not
                finite or whose residual is not below 1 fails.  Then Teko,
                MILU and Amesos on the masked 8x8x4 grid, CUDA tensors
                through the host-side factorizations
  7. eigen    — JDQZ as run_ocean attaches it (jdqz_params.xml, real
                shift 0: shift-invert Arnoldi whose every step is a Mixed
                Ocean.solve): a run_ocean run with eigenvalue analysis on
                a 4x4x3 basin, whose pairs are held to the solver's limit
                on the true pencil residual and to the dense spectrum;
                then the analysis at 96x38x12, every solve held to 150
                inner iterations, over one search space of 16: the Ritz
                values, which
                pairs converged if any, each pair's true pencil residual,
                solves, MV and launches; F and An unchanged to the bit
                after both; and a solve with the shifted pencil J - 0.1 B
                at 96x38x12
  8. main     — run_ocean on a copy of run/ocean/global (BGS + Mixed)
                on the card, cut to one continuation step of three
                Newton iterations at FGMRES tolerance 5e-2; checks the
                exit status, that every kernel launch went through the
                wide f32 kernel, falling |F| and every solve's true
                relative residual (< the tolerance, so < 1).  Then the
                same run once more with the wrapper made to take the
                general-shape f32 kernel, held to the same checks; its
                MV per solve and cdata are printed beside the first
                run's
  9. transient — (a) time_ocean on a copy of run/ocean/global at full
                forcing (theta 1, dt 1e-3, adaptive; cut to three time
                steps, see _spinup_copy): one line per time step (dt,
                Newton iterations, |F|, MV and true relres per solve), the
                tdata rows, timers and wall time per step; every step's
                Newton converged, every launch through the wide f32
                kernel, every solve below its tolerance, |x| finite and
                nonzero.  (b) Two stochastic theta steps of that state
                (seed of run/2dmoc/ams_params.xml; sigma and Newton
                tolerance cut, see STOCHASTIC_CUTS): G only on the surface
                S rows, Newton converged.  (c) The wide and the
                general-shape kernel, f32 and bf16, on the last
                J - B/(theta dt): equal value for value, and against the
                f64 product.  (d)
                run_ams's AMS, TAMS and GPA on run/2dmoc's 4x32x16 grid
                with direct solves, on the card and on the CPU: the same
                iterations and time steps, probability and MFPT to 1e-8;
                then RARE_EVENT_STEPS of the methods' stochastic step with
                the bundle's BGS + Mixed on the card: Newton converged at
                the cut tolerance, every solve within its tolerance,
                every launch through the wide f32 kernel, and the state's
                difference from the CPU's direct step printed per unknown
                (the cuts are printed).  (e)
                Seasonal forcing: F on the card against the CPU at three
                times of the year.
 10. topo     — (a) on the masked global 96x38x12 grid with the salinity
                integral condition: analyze_jacobian1/2 of the shipped mask
                (problem P rows, S columns with a nonzero integral), then
                get_land_mask(adjust_mask=True) on mask 1 with one water
                column walled in, which the fix cycle must land, no
                problem P row left; cells landed, fixes, seconds.  (b)
                run_topo on a copy of run/ocean/global from its shipped
                mask to mask 1 (a seamount, written by the port's
                write_mask_file), from rest, cut to TOPO_STEPS steps in
                Delta (see _topo_copy): one line per Newton iteration
                (Delta, |F_h|, |F_B|, MV and true relres per solve), wall
                and launches per Newton iteration; status 0, Delta rising,
                every blended solve below its tolerance, cdata finite,
                every launch through the wide f32 kernel
 11. lyapunov — run_lyapunov on a copy of run/lyapunov (4x32x16) with
                direct solves, cut to one continuation step (see
                _lyapunov_copy): trace finite and positive, spectrum
                non-negative, rails' residual and the seconds of the dense
                Jacobian, the Schur step and rails; the same run of a copy
                cut to 4x16x8 and three rails iterations on the card
                against the CPU (trace and spectrum to 1e-6); one solve of
                the bundle's BGS + Mixed at the point, capped, through the
                f32 kernel
 12. coupled  — (a) run/aquaplanet cut to 16x8x4 (ocean on BGS, scheme
                C/F) on the card against the CPU: F, J v and the six
                coupling blocks to 1e-10, one f64 BGS sweep and the first
                Newton solve from rest to the solve's tolerance, the
                solve's iterations within 2.  (b) run_coupled on a copy of
                run/aquaplanet at full width (64x32x12) from rest, one
                continuation step (cut, see _aquaplanet_copy): every
                coupled solve's iterations, true relres and seconds (a
                stalled one printed as stalled), the Newton |F| sequence,
                whether the step was accepted, and one coupled FGMRES
                iteration split with synchronised timers.  (c)
                time_coupled there, COUPLED_TIME_STEPS theta steps: NR, MV
                and seconds per step, status 0.  The coupled path is f64
                and launches no kernel: the phase's launch count is
                printed and must be 0
 13. parallel — the domain-decomposed ocean (iemic_tpu_torch/parallel,
                main/multichip.py) on the masked global 96x38x12 grid at
                the effort phase's state.  (a) One rank over NCCL: the
                partitioned F and An against Ocean._rhs/_jacobian to
                1e-13 (at the effort state and a random one) and their
                seconds, the sharded f64 matvec against
                Ocean.apply_matrix to 1e-12, the sharded Double solve at
                1e-2 (MV, relres, true relres, seconds) beside the serial
                Ocean.solve in Double at 1e-2, the sharded Mixed solve at
                2e-2, both through the partitioned BGS sweep, and the
                partitioned sweeps of -F of PARALLEL_SWEEPS (one saddle
                iteration, the solve's thirty, and each branch of the
                sweep that runs the 2D saddle or a build option: scheme
                KRYLOV, orderings M2 and M3, rho/mu, MG on Auv); for
                each, the bytes of the
                stencil tensor and the factor set, the peak device memory,
                build seconds, seconds per sweep, message rounds and
                bytes of whole fields summed over the ranks in the build
                and per sweep, and
                whether the saddle iteration replays CUDA graphs or runs
                eagerly; the dry run's stage 3 at 96x38x12 (one continuation
                step of a ShardedOcean from rest at Combined Forcing 0 on
                the BGS/Double solve at 5e-2, at most three Newton
                iterations, the default Preconditioner sublist: 60 saddle
                iterations to 1e-8, THCM row scaling, as Ocean.solve)
                held to the serial Continuation on an Ocean with the same
                solver parameters, par and state to 1e-12.  (b) Four
                ranks spawned on the one card over gloo: on the rank grids
                1x4 (decomp2d's) and 2x2 the gathered sharded matvec
                against the serial product to 1e-12, per rank the seconds
                and bytes of a 1-deep halo exchange and the seconds of a
                sharded matvec; the gathered partitioned F and An against
                the serial ones to 1e-13, per rank the seconds of the
                partitioned residual and Jacobian and of a 2-deep
                exchange with its bytes; the partitioned sweeps of (a)
                on each rank grid, held to (a)'s (PARALLEL_SWEEPS' bounds),
                each rank's bytes no more than (a)'s / 4 plus the pieces
                held whole on every rank, and the same per-rank lines as
                in (a); then the dry run's three stages
                at 96x38x12 (stage 2 fails the run if it misses 2e-2),
                per rank MV, outer iterations, true relres and seconds,
                the per-rank lines of each stage's BGS preconditioner,
                none of whose builds may gather,
                stage 1's Newton update held to (a)'s within the two
                solves' tolerances (|J (z4 - z1)| <= 2e-2 |F|), stage 3's
                step on 2x2 (every solve's MV, relres and seconds per
                rank) held to (a)'s step within the JAX test's bounds (par
                1e-5, state rtol 1e-3 atol 1e-6).  (c) The dry run at its
                own 8x8x3 grid (stage 3 on the 8x8x4 box) on four ranks.
                (d) The sharded solve's other methods, ShardedOcean.solve
                beside Ocean.solve on the same solver parameters: (d1)
                one NCCL rank at 96x38x12 at the effort state, b = -F,
                None/Double, None/Mixed, Teko/Double, Teko/Mixed and
                Columns/Mixed capped at 20 iterations (see METHODS): the
                same MV and the iterate to 1e-10; (d2) the same five on
                four gloo ranks on 2x2, per rank MV, relres, seconds,
                message rounds and gathers per application, held to
                (d1)'s, no gather; (d3) Amesos and MILU, Double and Mixed,
                on the masked 8x8x4 grid, on one rank against Ocean.solve
                and on 2x2, their gathers to rank 0 and bytes gathered per
                build and per application.  The phase's launches of the
                stencil kernel, the ranks' included, are printed (0)

The line before the last is the kernels' JSON record: ms, plain_ms and
bound_ms on the kernel phase's random coefficients; library_ms cuSPARSE
on the effort phase's periodic 96x38x12 Jacobian, the main path's own
operator, whose zero coefficients CSR leaves out (the effort line gives
every entry point's time on it beside cuSPARSE); launches of the main
phase (both runs), the transient, topo, lyapunov, coupled and parallel
phases.  The last line is {"ok": true, "device": {...}}.
Any failed check raises (exit code 1), and a run that outlasts
WATCHDOG_S seconds prints its stack and exits with code 1.
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BUNDLE = os.path.join(REPO, "run", "ocean", "global")
# |kernel - plain| <= KTOL * max|plain|: both accumulate in f32, in
# another order
KTOL = 2e-5
# published peaks of one H100 SXM: device memory rate, and the f32 rate
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# F and An on the card against the CPU, max-norm scaled
ATOL = 1e-12
# the JAX package's effort on the effort phase's configuration
# (TESTLOG.md:139, variant spp60@1e-8): MV and relres at tol 1e-3
EFFORT_TOL = 1e-3
EFFORT_MV = 69
# the variants phase: inner iterations allowed to one solve, and how far
# the true residual may lie above the one the solve reports (both are
# the f64 residual of the same row-scaled system)
VARIANT_CAP = 150
RELRES_MARGIN = 1.01
# BGS settings that differ from the bundle's, each with the inner
# iterations its solve may take.  "Auv Precond" acts only where the sweep
# has a separate momentum solve (scheme KRYLOV, M2, M3).  Orderings M2
# and M3 put the SIMPLE sweep with its inner Chat FGMRES inside the 2D
# saddle's 60-iteration FGMRES, eager: about 4.3 s a sweep on the card,
# so they get 3 iterations (6 until the parallel phase took their
# partitioned sweeps and the default sweep of stage 3, whose time these
# 3 x 2 iterations make room for; at 6 they stalled at 0.111 and 0.671,
# PERF.md).
VARIANTS = [
    ("scheme SL", {"Saddlepoint scheme": "SL"}, VARIANT_CAP),
    ("symmetric Gauss-Seidel", {"Scheme": "symmetric Gauss-Seidel"},
     VARIANT_CAP),
    ("rho/mu transform", {"ATS rho/mu Transform": True}, VARIANT_CAP),
    ("permutation 2", {"Permutation": 2}, 3),
    ("permutation 3", {"Permutation": 3}, 3),
    ("ATS Columns", {"ATS Precond": "Columns"}, VARIANT_CAP),
    ("scheme KRYLOV, Auv MG", {"Saddlepoint scheme": "KRYLOV",
                               "Auv Precond": "MG"}, VARIANT_CAP),
    ("scheme KRYLOV, saddle Jacobi", {"Saddlepoint scheme": "KRYLOV",
                                      "Saddlepoint Precond": "Jacobi"},
     VARIANT_CAP),
    ("MG prolongation weight 0", {"MG prolongation weight": 0.0},
     VARIANT_CAP),
]
# Two branches whose sweep is not finite on the masked global grid, in the
# JAX package as in the port (tests/test_torch_bgs_unbounded.py holds the
# two packages' sweeps together at 32x16x8): SIMPLER's second Chat V-cycle
# squares the gain of the coarsest level's 1e-12 shift (max |z| of order
# 1e23, past what an f32 inner FGMRES can square), and the point blocks
# of the 2D saddle's multigrid smoother are singular where the pressure
# has no centre coefficient.  At 96x38x12 the phase prints one sweep of
# each; their solve runs on the masked 8x8x4 grid.
SMALL_GRID_VARIANTS = [
    ("scheme SR", {"Saddlepoint scheme": "SR"}),
    ("scheme KRYLOV, saddle MG", {"Saddlepoint scheme": "KRYLOV",
                                  "Saddlepoint Precond": "MG"}),
]
ISLAND = {
    "Global Grid-Size n": 8, "Global Grid-Size m": 8,
    "Global Grid-Size l": 4, "Read Land Mask": True,
    "Land Mask": "test8x8x4_3",
    "Starting Parameters": {"Combined Forcing": 0.5,
                            "Temperature Forcing": 10.0,
                            "Salinity Forcing": 0.1, "Wind Forcing": 1.0}}
# the masked global grid of the effort, variants and eigen phases, at the
# state whose solve the repo records (scripts/diagnose.py sweep)
GLOBAL_THCM = {
    "Global Grid-Size n": 96, "Global Grid-Size m": 38,
    "Global Grid-Size l": 12,
    "Global Bound xmin": 0.0, "Global Bound xmax": 360.0,
    "Global Bound ymin": -85.5, "Global Bound ymax": 85.5,
    "Periodic": True, "Read Land Mask": True,
    "Land Mask": "mask_global_96x38x12",
    "Starting Parameters": {"Combined Forcing": 0.1,
                            "Temperature Forcing": 10.0,
                            "Wind Forcing": 1.0,
                            "Salinity Forcing": 0.1}}
# the eigen phase's jdqz_params.xml.  "Solver tolerance" is the tightest
# the shift-invert solves are asked for.  The analysis fills one search
# space of 16 and stops ("Max JD iterations" 16): a Krylov-Schur restart
# (17, 28 steps) took 136 s more at 96x38x12 and converged no pair either
# (PERF.md), and the whole run must stay within half the smoke's limit
JDQZ_PARAMS = {"Shift (real part)": 0.0, "Shift (imaginary part)": 0.0,
               "Number of eigenvalues": 2, "Tolerance": 1e-4,
               "Max size search space": 16, "Max JD iterations": 16,
               "Solver tolerance": 1e-3}
# the kernel of the main path: the bundle's f32 coefficients on its
# 96x38x12 grid take the wide kernel
MAIN_ENTRY = "stencil_matvec_f32_wide"
# the whole run must end within the smoke's 1200 s: a solve that falls
# into a GMRES-IR tail of hours fails the run here instead
WATCHDOG_S = 1140
# FGMRES tolerance and Newton iterations of the main phase (see
# _bundle_copy)
SOLVE_TOL = 5e-2
NEWTON_ITERS = 3
# the transient phase: the time stepper's parameters, time steps of the
# spin-up, stochastic steps after it (see _spinup_copy)
TIMESTEPPER = os.path.join(REPO, "run", "ocean", "timestepper_params.xml")
SPINUP_STEPS = 3
SPINUP_NEWTON_TOL = 2e-3
# the stochastic steps, at the bundle's dt 1e-3 from the spun-up state,
# cut from the bundles' sigma 100 and Newton tolerance: with Newton
# tolerance 2e-3 the third Newton update's solve stalls (its f32 inner
# solve at 0.88-0.97) with |F| at 7e-2, for every sigma from 100 to 0.001;
# at sigma 100 a solve of the second step stalls, at dt 1e-3 with Newton
# tolerance 0.1 and at dt 1e-4 with 2e-3 (PERF.md).  Each step of (a) and
# (b) prints whether it reached the bundle's Newton tolerance as well
STOCHASTIC_STEPS = 2
STOCHASTIC_CUTS = {"sigma": 1.0, "Newton tolerance": 0.1}
# the rare-event methods: run_ams on a copy of run/2dmoc, the grid its
# ams_params.xml is written for (4x32x16), on the card and, the same run,
# on the CPU, with direct solves (Amesos) on both: the methods' layers on
# the card's tensors, the linear algebra on the host.  What is cut, and
# why (each printed on a line of its own):
#  - direct solves, where the bundle asks BGS + Mixed: with BGS + Mixed
#    the f32 inner solve of a step's second Newton update stalls and the
#    solve falls into the GMRES-IR tail, at FGMRES tolerance 1e-3 and
#    5e-2 alike, and a step of one Newton update leaves out the flow's
#    response to the noise (below), so that AMS finds no initial
#    trajectory within its time (ROADMAP queue 3).  The bundle's solver
#    runs the methods' step instead (RARE_EVENT_STEPS);
#  - Combined Forcing 0.001, where a few Newton steps from rest reach a
#    steady state A (|F| 4e-6 after 6); the bundle's own states come from
#    a continuation, and Newton from rest diverges at 0.01 and above;
#  - sigma 1, where the bundle asks 100: at 100 the first implicit step's
#    Newton explodes (|dx| 1e2 to 1e4) at every dt tried;
#  - 3 experiments of the bundle's 100, 1 iteration, "maximum time" per
#    method (AMS runs to 100 times it) so that each trajectory takes at
#    most 2 time steps of the bundle's dt 1.0, of its 5e4;
#  - B = A + 0.05 randn (|A| + 0.1), close enough that the noise reaches
#    it within those steps, and "B distance" 0.85 (a score of 0.15 counts
#    as converged): a smoke run of the methods, not an estimate of a rare
#    event;
#  - A and B held in memory (run_ams's states), as the card's machine
#    has no h5py to read the bundle's .h5 states.
AMS_BUNDLE = os.path.join(REPO, "run", "2dmoc")
RARE_EVENT_FORCING = 0.001
RARE_EVENT_NEWTON = 6
RARE_EVENT_DISPLACEMENT = 0.05
RARE_EVENT_DIRECT = {"Preconditioning": "Amesos",
                     "FGMRES tolerance": 1e-10, "FGMRES iterations": 300}
RARE_EVENT_CUTS = {
    "sigma": 1.0, "number of experiments": 3,
    "number of initial experiments": 3, "maximum iterations": 1,
    "B distance": 0.85, "write file": ""}
RARE_EVENT_METHODS = {"AMS": {"maximum time": 0.02},
                      "TAMS": {"maximum time": 2.0},
                      "GPA": {"maximum time": 1.0, "GPA time step": 1.0}}
# the step that the methods repeat, RARE_EVENT_STEPS steps of dt 1.0
# from A, on the card with the bundle's BGS + Mixed solves (their f32
# inner operator is the wide kernel), beside the CPU's direct solves from
# the same state with the same noise.  Newton tolerance 1e-2 and FGMRES
# tolerance SOLVE_TOL, where the bundles ask 1e-4 and 1e-3: a step then
# takes one Newton update, whose solve ends at the f32 inner solve's
# stall at a true relative residual of 3e-3 to 2e-2 (see above).  The
# step is held to the solve's contract, not to the direct step: the
# update leaves u, v, w, p and T where they were (the residual of the w
# and p rows is small in the row-scaled norm the solve measures), so the
# state differs from the direct one by all of the flow's response.  Each
# step prints that difference per unknown
RARE_EVENT_STEPS = 3
RARE_EVENT_STEP_CUTS = {"FGMRES tolerance": SOLVE_TOL,
                        "Newton tolerance": 1e-2}
# times of the year at which the seasonal forcing is held card to CPU
SEASON_TIMES = (0.1, 0.45, 0.8)
# the topo phase: run_topo on a copy of run/ocean/global, cut to
# TOPO_STEPS continuation steps in "Delta" of TOPO_NEWTON_ITERS Newton
# iteration each, at FGMRES tolerance SOLVE_TOL (see _topo_copy); the
# mask analysis solves at the effort phase's EFFORT_TOL
TOPO_STEPS = 2
TOPO_NEWTON_ITERS = 1
TOPO_FORCING = 0.1
# the lyapunov phase: run_lyapunov on a copy of run/lyapunov (4x32x16),
# cut to LYAPUNOV_STEPS continuation steps with direct solves (see
# _lyapunov_copy).  The card is held against the CPU on the same run of a
# copy cut to LYAPUNOV_CHECK_GRID (m, l): on the CPU the dense Jacobian
# and the minimal-norm Schur step of the bundle's grid take 94 s and 64 s
# (measured on an 8-core host), past the phase's time.  That run's rails
# stops after LYAPUNOV_CHECK_ITERS iterations, and the point's trace and
# spectrum are held to LYAPUNOV_CHECK_TOL: each unconverged rails
# iteration picks the dominant eigenvectors of a Lanczos estimate of the
# residual, and that choice turns rounding differences into 1e-4 of the
# trace after six iterations (tests/test_torch_lyapunov.py)
LYAPUNOV_BUNDLE = os.path.join(REPO, "run", "lyapunov")
LYAPUNOV_STEPS = 1
LYAPUNOV_CHECK_GRID = (16, 8)
LYAPUNOV_CHECK_ITERS = 3
LYAPUNOV_CHECK_TOL = 1e-6
# the coupled phase: run/aquaplanet (ocean 64x32x12 periodic, atmosphere
# and sea ice 64x32; scheme C, forward block Gauss-Seidel, the ocean on
# BGS).  (a) holds the card to the CPU on a copy cut to
# COUPLED_CHECK_GRID (n, m, l): F, J v, the six coupling blocks and one
# coupled solve to COUPLED_CHECK_TOL, the solve's iterations within 2.
# (b) and (c) run the bundle at full width; what is cut there is in
# _aquaplanet_copy.
AQUAPLANET = os.path.join(REPO, "run", "aquaplanet")
COUPLED_CHECK_GRID = (16, 8, 4)
COUPLED_CHECK_TOL = 1e-10
COUPLED_NEWTON_ITERS = 3
# the continuation's "predictor bound" at full width: at rest |F| is 1.7e3
# (the sea ice's background fluxes over 2,048 surface cells), above the
# default bound of 1e3, so with it the step is rejected at the predictor
# before any Newton iteration (seen on the card)
COUPLED_PREDICTOR_BOUND = 1e6
COUPLED_TIME_STEPS = 2
# coupled FGMRES iterations of the solve the per-iteration split is
# taken from
COUPLED_SPLIT_ITERS = 10
# the parallel phase: the domain-decomposed ocean on the masked global
# grid (GLOBAL_THCM, the dry run's model at that grid) at the effort
# phase's state.  (a) one rank over NCCL; (b) PARALLEL_RANKS ranks on the
# one card over gloo (NCCL takes one rank per card), the sharded matvec
# on each rank grid of PARALLEL_SHAPES (decomp2d's and an explicit 2x2)
# held to the serial product to PARALLEL_MATVEC_TOL, then the dry run's
# three stages there; (c) the dry run at its own small grid
PARALLEL_GRID = (96, 38, 12)
PARALLEL_RANKS = 4
PARALLEL_SHAPES = [(1, 4), (2, 2)]
PARALLEL_MATVEC_TOL = 1e-12
# the partitioned F and An against the serial ones, relative to their
# largest entries, at the effort state and at a random one (seed
# PARALLEL_SEED, amplitude 0.01)
PARALLEL_ASSEMBLY_TOL = 1e-13
PARALLEL_SEED = 0
# the one-rank continuation step (multichip's stage 3 at PARALLEL_GRID)
# against the serial Continuation on Ocean with the same solver
# parameters, par and state
PARALLEL_STEP_TOL = 1e-12
# the four-rank step against the one-rank step: the bounds of the JAX
# package's tests/test_parallel.py:303-306
PARALLEL_PAR_TOL, PARALLEL_RTOL, PARALLEL_ATOL = 1e-5, 1e-3, 1e-6
# the partitioned BGS sweeps of -F at the effort state on four ranks
# against the one-rank sweep of the same options, relative to its
# largest entry: name -> (bgs.apply's keywords, bgs.build's keywords over
# the sharded solve's build, bound).  With one saddle iteration only the
# rounding of the sums over the ranks differs (1.8e-15 to 2.0e-15 on the
# card); with the sharded solve's thirty the rounding grows through the
# inner FGMRES (1.7e-9 on the card at this grid, whose saddle converges;
# PERF.md §6).  The branches of the depth-averaged 2D saddle (scheme
# KRYLOV, orderings M2 and M3; the 2D saddle made whole on every rank) take
# one saddle and one Auv iteration.  M3 solves its 2D saddle after the
# tracers, whose multigrid rounds otherwise on four ranks, with SIMPLE's
# inner Chat FGMRES to 1e-6, whose stopping iteration that rounding can
# move (4.5e-7 on the CPU at 16x10x3, tests/test_torch_parallel_bgs.py):
# it is held to 5e-6, and M3 with Jacobi on the 2D saddle to 1e-10.  SR
# and the 2D saddle's MG give no finite sweep on this grid (ROADMAP queue
# 3 B); the CPU tests hold them
_ONE = {"nit_spp": 1, "nit_uv": 1}
PARALLEL_SWEEPS = {
    "one saddle iteration": ({"nit_spp": 1}, {}, 1e-10),
    "the solve's sweep": ({}, {}, 1e-6),
    "KRYLOV, Jacobi on the 2D saddle": (dict(_ONE, spp_scheme="KRYLOV"),
                                        {}, 1e-10),
    "M2": (dict(_ONE, permutation=2), {}, 1e-10),
    "M3": (dict(_ONE, permutation=3), {}, 5e-6),
    "M3, Jacobi on the 2D saddle": (dict(_ONE, permutation=3,
                                         spp_scheme="KRYLOV"), {}, 1e-10),
    "rho/mu under M1/SI": (_ONE, {"rhomu": True}, 1e-10),
    "MG on Auv under M2": (dict(_ONE, permutation=2),
                           {"uv_precond": "MG"}, 1e-10)}

# (d) the sharded solve's methods besides BGS and Columns/Double, as
# ShardedOcean.solve against Ocean.solve on the same solver parameters:
# (d1) one NCCL rank and (d2) four gloo ranks on 2x2 at PARALLEL_GRID's
# effort state, b = -F, each solve capped at METHODS_ITERS iterations;
# the Double ones at the main phase's 5e-2, the Mixed ones at a tolerance
# their first refinement sweep meets (so no GMRES-IR tail runs).  The
# serial Ocean takes "Matvec kernel" "xla": the sharded f32 product is
# plain PyTorch (so is the JAX package's), and the kernel's summation
# order would part the two solves' iterates, and count its launches here.
# (d3) Amesos and MILU, whose factors neither package builds at
# 96x38x12 in reasonable time and memory (scripts/host_method_limits.py:
# splu takes minutes and hundreds of millions of nonzeros in L and U,
# MILU runs out of memory), on the masked 8x8x4 grid (ISLAND).
# After 20 iterations None is at 5.8e-3, Teko and Columns stop at 0.3636
# (the serial Ocean.solve likewise, on an H100), so the Mixed solves take
# 0.5.
METHODS_ITERS = 20
METHODS_MIXED_TOL = 0.5
METHODS = [("None", "Double", SOLVE_TOL),
           ("None", "Mixed", METHODS_MIXED_TOL),
           ("Teko", "Double", SOLVE_TOL),
           ("Teko", "Mixed", METHODS_MIXED_TOL),
           ("Columns", "Mixed", METHODS_MIXED_TOL)]
HOST_METHODS = [("Amesos", "Double", 1e-8), ("Amesos", "Mixed", 1e-8),
                ("MILU", "Double", 1e-3), ("MILU", "Mixed", 1e-3)]
HOST_METHODS_ITERS = 300
# (d1) and the one-rank (d3) against Ocean.solve: the same MV, the iterate
# within METHODS_SAME of its largest entry.  (d2) against (d1): relres
# within METHODS_RELRES relative (Mixed: at most max(tol, 1.01 x (d1)'s)),
# the true unscaled residual of the gathered iterate at most twice the
# relres.  (d3) on four ranks: Amesos' iterate within HOST_SAME relative
# of one rank's; MILU's true residual (of the row-scaled, deflated system
# the solve solves, computed apart, as the variants phase takes it) at most
# twice its tolerance, and its MV within MILU_MV_SLACK of the range that
# the serial Ocean.solve itself spans on the card and on the CPU: its
# factor is rank 0's of the gathered tensor, so only the sums' rounding
# differs, but at 1e-3 on this grid the solve is on a plateau where
# rounding alone moves it (the serial solve takes 123 MV on an H100 and
# 88 on the CPU)
METHODS_SAME = 1e-10
METHODS_RELRES = 1e-3
HOST_SAME = 1e-6
MILU_MV_SLACK = 5


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fns, reps: int = 21, batches: int = 5) -> float:
    """Device time of one call.  fns are calls of one function on
    separate copies of its large input, taken in turn, so that no call
    finds in the 50 MB L2 what the call before it read (the solver's
    calls are a whole preconditioner sweep apart).  reps calls are
    recorded into one CUDA graph, so that the host's enqueue, which takes
    longer than the fast kernels, is not timed; CUDA events around a
    replay, over reps; the median of batches replays."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            fns[r % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def bound_ms(itemsize: int, l: int, m: int, n: int,
             periodic: bool) -> tuple[float, str]:
    """The least time the card could take for one matvec: the larger of
    the bytes it must move (the needed coefficients and x read once, y
    written once) over the memory rate and its two operations per needed
    coefficient over the f32 rate; and which of the two it is."""
    from iemic_tpu_torch.ops.stencil_hopper import needed_coefficients
    need = needed_coefficients(l, m, n, periodic)
    t_bytes = (need * itemsize + 2 * 6 * l * m * n * 4) / HBM_BYTES_PER_S
    t_ops = 2 * need / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def library_operator(An: torch.Tensor, periodic: bool) -> torch.Tensor:
    """The operator of the stencil tensor An as a CUDA CSR tensor with
    int32 indices and f32 values (ops.stencil.stencil_to_csr, which keeps
    zero entries out), for cuSPARSE through torch.sparse: the library call
    that computes the kernel's function, on flat vectors."""
    from iemic_tpu_torch.ops.stencil import stencil_to_csr
    data, indices, indptr = stencil_to_csr(An, periodic=periodic)
    n = len(indptr) - 1
    return torch.sparse_csr_tensor(
        torch.as_tensor(indptr.astype(np.int32)), torch.as_tensor(indices),
        torch.as_tensor(data, dtype=torch.float32), size=(n, n),
        device="cuda")


def loop_ms(fn, reps: int = 21, batches: int = 5) -> float:
    """Device time of one call, for a library call that a CUDA graph may
    not capture: CUDA events around reps calls queued back to back, the
    median of batches.  Only for calls whose device time exceeds the
    host's enqueue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def library_ms(hopper, An: torch.Tensor, AnK: torch.Tensor, x: torch.Tensor,
               periodic: bool) -> tuple[float, int]:
    """cuSPARSE's time for the kernel's function on the same coefficients
    (An in f64, AnK their f32 copy) and x, after holding its product to
    the plain version; returns (ms, stored nonzeros)."""
    from iemic_tpu_torch.ops.stencil import to_flat
    A = library_operator(An, periodic)
    xf = to_flat(x.float()).contiguous()
    y = A @ xf
    ref = to_flat(hopper.apply_plain(AnK, x, periodic=periodic))
    err, scale = float((y - ref).abs().max()), float(ref.abs().max())
    if not err <= KTOL * scale:
        raise AssertionError(f"cuSPARSE product disagrees: {err:.3e}")
    return loop_ms(lambda: A @ xf), int(A.values().numel())


def _check_kernel(hopper, AnK, x, periodic, what):
    """One launch against the plain version; returns (error, scale)."""
    y = hopper.apply_stencil_prepared(AnK, x, periodic=periodic)
    ref = hopper.apply_plain(AnK, x, periodic=periodic)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    scale = float(ref.abs().max())
    if not (bool(torch.isfinite(y).all()) and err <= KTOL * scale):
        raise AssertionError(f"kernel {what} periodic={periodic} "
                             f"disagrees: {err:.3e} (limit {KTOL:.0e} x "
                             f"{scale:.3e})")
    return err, scale


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """The values of x in a tensor 4 bytes off a 16-byte boundary: the
    wrapper then takes the general-shape kernel."""
    return torch.empty(x.numel() + 1, device=x.device,
                       dtype=x.dtype)[1:].view_as(x).copy_(x)


def _general_and_wide(hopper, AnK, x, periodic, what):
    """The wide kernel's output and the general-shape kernel's on the same
    values, forced by a misaligned x; fails unless they are equal value
    for value (the same fmaf chain per output).  Returns both."""
    _, l, m, n = x.shape
    wide_entry = hopper.kernel_variant(AnK.dtype, l, m, n)
    general_entry = wide_entry.removesuffix("_wide")
    before = dict(hopper.LAUNCHES_BY_ENTRY)
    wide = hopper.apply_stencil_prepared(AnK, x, periodic=periodic)
    general = hopper.apply_stencil_prepared(AnK, _misaligned(x),
                                            periodic=periodic)
    if not (wide_entry.endswith("_wide")
            and hopper.LAUNCHES_BY_ENTRY[wide_entry]
            == before[wide_entry] + 1
            and hopper.LAUNCHES_BY_ENTRY[general_entry]
            == before[general_entry] + 1):
        raise AssertionError(f"{what}: not {wide_entry} and "
                             f"{general_entry} once each")
    if not torch.equal(wide, general):
        raise AssertionError(
            f"{what}: {general_entry} and {wide_entry} differ in "
            f"{int((wide != general).sum())} of {wide.numel()} values")
    return wide, general


# the kernel phase's grids: the global grid's rows of 96 (wide in f32 and
# bf16), rows of 97 and of 100 (wide in f32 only), the 2DMOC fixture's
# 6x6x3, and rows of 1 and 2 points, where the periodic wrap folds the
# three di onto one or two columns
KERNEL_SHAPES = ((12, 38, 96), (12, 38, 97), (12, 38, 100), (6, 6, 3),
                 (2, 3, 1), (2, 3, 2))


def phase_kernel(hopper, card_line: str) -> dict:
    """Every entry point of the kernel library against the plain PyTorch
    version at KERNEL_SHAPES, periodic and not, with a random x and with
    an x kept on the two edge columns in i, where a wrong wrap or zero
    boundary shows in every term; where the wide kernel runs, the
    general-shape kernel on the same values equal to it value for value.
    Returns the record of each entry point at its first shape, periodic
    (the bundle's setting)."""
    rec, lib = {}, {}
    for l, m, n in KERNEL_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        An = torch.randn((27, 6, 6, l, m, n), generator=g, device="cuda",
                         dtype=torch.float64)
        # f32, as the Krylov loop hands it over
        x = torch.randn((6, l, m, n), generator=g, device="cuda",
                        dtype=torch.float32)
        edge = torch.zeros_like(x)
        edge[..., 0], edge[..., -1] = x[..., 0], x[..., -1]
        for dtype in (torch.float32, torch.bfloat16):
            AnK = hopper.prepare(An, dtype)
            entry = hopper.kernel_variant(dtype, l, m, n)
            copies = [AnK, AnK.clone(), AnK.clone()]     # see time_ms
            for periodic in (False, True):
                bound, bound_by = bound_ms(AnK.element_size(), l, m, n,
                                           periodic)
                need = hopper.needed_coefficients(l, m, n, periodic) \
                    * AnK.element_size()
                before = hopper.LAUNCHES_BY_ENTRY[entry]
                err, scale = _check_kernel(hopper, AnK, x, periodic, entry)
                eerr, escale = _check_kernel(hopper, AnK, edge, periodic,
                                             entry + " (edge columns)")
                if hopper.LAUNCHES_BY_ENTRY[entry] != before + 2:
                    raise AssertionError(f"{entry} was not the kernel "
                                         f"launched at {(l, m, n)}")
                if entry.endswith("_wide"):
                    for v in (x, edge):
                        _general_and_wide(hopper, AnK, v, periodic,
                                          f"kernel at {(l, m, n)}")
                    print(f"kernel {entry.removesuffix('_wide')} forced by "
                          f"a misaligned x at shape=(27,6,6,{l},{m},{n}) "
                          f"periodic={periodic}: equal to {entry} in all "
                          f"{x.numel()} values, random and edge-column x",
                          flush=True)
                ms = time_ms([lambda a=a: hopper.apply_stencil_prepared(
                    a, x, periodic=periodic) for a in copies])
                plain_ms = time_ms([lambda a=a: hopper.apply_plain(
                    a, x, periodic=periodic) for a in copies])
                print(f"kernel {entry} periodic={periodic} "
                      f"shape=(27,6,6,{l},{m},{n}) max_abs_err={err:.3e} "
                      f"(limit {KTOL:.0e} x {scale:.3e}) edge columns "
                      f"{eerr:.3e} (x {escale:.3e}) kernel {ms:.4f} ms "
                      f"plain {plain_ms:.4f} ms bound {bound:.4f} ms by "
                      f"{bound_by} ({100 * bound / ms:.0f}% of bound; "
                      f"{need} coefficient bytes needed) "
                      f"[{card_line}]", flush=True)
                # cuSPARSE beside each entry point's first shape, and
                # beside both kernels at the row of 100
                if periodic and (entry not in rec or n == 100):
                    if (l, m, n) not in lib:
                        lib[(l, m, n)] = library_ms(hopper, An, AnK, x,
                                                    periodic)
                    lib_ms, nnz = lib[(l, m, n)]
                    print(f"kernel library cuSPARSE (torch.sparse_csr_tensor,"
                          f" int32 indices, f32 values, {nnz} nonzeros) of "
                          f"the same coefficients at {(l, m, n)} periodic: "
                          f"{lib_ms:.4f} ms, against {entry} {ms:.4f} ms "
                          f"[{card_line}]", flush=True)
                    rec.setdefault(entry, dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=bound_by))
            if (l, m, n) == (12, 38, 96):
                # what the card's memory gives in practice: one read of
                # all coefficients, the skipped ones too, by a PyTorch
                # reduction (it does not compute the kernel's function)
                read_ms = time_ms([lambda a=a: a.sum() for a in copies])
                nbytes = AnK.numel() * AnK.element_size()
                print(f"kernel read of all {nbytes} coefficient bytes by "
                      f"AnK.sum() ({entry}'s input): {read_ms:.4f} ms, "
                      f"{nbytes / read_ms * 1e-9:.3f} TB/s; the kernel, "
                      f"periodic: {need / rec[entry]['ms'] * 1e-9:.3f} TB/s "
                      f"of needed coefficient bytes [{card_line}]",
                      flush=True)
            del AnK, copies
    if set(rec) != set(hopper.ENTRIES):
        raise AssertionError(f"entry points not exercised: "
                             f"{set(hopper.ENTRIES) - set(rec)}")
    return rec


def phase_assembly() -> None:
    """F and An of the global grid: card against CPU, same state."""
    from iemic_tpu_torch.config import read_xml
    from iemic_tpu_torch.models.ocean import Ocean
    from iemic_tpu_torch import interop

    oceans = [Ocean(read_xml(os.path.join(BUNDLE, "ocean_params.xml")),
                    data_dir=os.path.join(REPO, "data"), device=d)
              for d in ("cuda", "cpu")]
    rng = np.random.default_rng(1)
    x = 0.05 * rng.standard_normal(tuple(oceans[0].state.shape))
    x[4] += np.linspace(1.0, -1.0, x.shape[1])[:, None, None]
    out = []
    for o in oceans:
        interop.install_state(o, x)
        t0 = time.perf_counter()
        o.compute_rhs()
        o.compute_jacobian()
        if o.device.type == "cuda":
            torch.cuda.synchronize()
        out.append((o.rhs.cpu(), o.jac.cpu(), time.perf_counter() - t0))
    for name, i in (("F", 0), ("An", 1)):
        ref = out[1][i]
        err = float((out[0][i] - ref).abs().max() / ref.abs().max())
        print(f"assembly {name} shape={tuple(ref.shape)} cuda-vs-cpu "
              f"relative max error {err:.3e} (limit {ATOL:.0e})",
              flush=True)
        if not (err <= ATOL and torch.isfinite(out[0][i]).all()):
            raise AssertionError(f"assembly {name} disagrees: {err:.3e}")
    print(f"assembly wall: cuda {out[0][2]:.3f} s, cpu {out[1][2]:.3f} s "
          "(rhs + Jacobian, first call)", flush=True)


def _check_model_operator(hopper, o, vectors,
                          what: str = "effort model operator") -> None:
    """The wide and the general-shape kernel, f32 and bf16 coefficients,
    on the model's own masked Jacobian and vectors of its solve: the two
    equal value for value, and against the f64 product of the same
    coefficients.  Each output row A is held to KTOL times the largest
    sum of |terms| of that row, which is what bounds an f32 sum's
    round-off: the rows differ by orders of magnitude, and terms
    cancel."""
    from iemic_tpu_torch.ops.stencil import apply_stencil
    An = o.jac
    _, _, _, l, m, n = An.shape
    periodic = o.cfg.periodic
    for dtype in (torch.float32, torch.bfloat16):
        AnK = hopper.prepare(An, dtype)
        AnK64 = AnK.double()
        for name, v in vectors:
            x = v.reshape(6, l, m, n).float()
            wide, general = _general_and_wide(
                hopper, AnK, x, periodic, f"{what} {dtype} x={name}")
            plain = hopper.apply_plain(AnK, x, periodic=periodic)
            x64 = x.double()
            ref = apply_stencil(AnK64, x64, periodic=periodic)
            # a row of zeros has error 0 over scale 0
            scale = apply_stencil(AnK64.abs(), x64.abs(), periodic=periodic
                                  ).amax(dim=(1, 2, 3)).clamp_min(1e-300)
            errs = {k: (y.double() - ref).abs().amax(dim=(1, 2, 3)) / scale
                    for k, y in (("wide", wide), ("general", general),
                                 ("plain", plain))}
            print(f"{what} {dtype} x={name} periodic={periodic}: error "
                  "against the f64 product over the row's largest sum of "
                  "|terms|, rows A=0..5: " + "; ".join(
                      f"{k} " + " ".join(f"{e:.2e}" for e in v.tolist())
                      for k, v in errs.items())
                  + f" (limit {KTOL:.0e}); wide and general equal in all "
                  f"{wide.numel()} values", flush=True)
            for k in ("wide", "general"):
                if not bool((errs[k] <= KTOL).all()):
                    raise AssertionError(
                        f"{k} kernel disagrees on the model's operator, "
                        f"{dtype} x={name}: {errs[k]}")
        del AnK, AnK64


def phase_effort(hopper, card_line: str):
    """The production solve of scripts/diagnose.py's sweep (the masked
    global grid at its initial state, Combined Forcing 0.1, default BGS
    parameters, Mixed, tol 1e-3, b = -F), whose MV the repo records for
    the JAX package: the port's preconditioner must do as well.  Returns
    the model, with F and the Jacobian of that state, and cuSPARSE's ms on
    that Jacobian."""
    from iemic_tpu_torch.models.ocean import Ocean

    o = Ocean({"THCM": dict(GLOBAL_THCM)},
        solver_params={"Preconditioning": "BGS", "Precision": "Mixed",
                       "FGMRES tolerance": EFFORT_TOL,
                       "FGMRES iterations": 200},
        data_dir=os.path.join(REPO, "data"), device="cuda")
    o.compute_rhs()
    o.compute_jacobian()
    t0 = time.perf_counter()
    dx = o.solve(-o.rhs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mv, relres = o.solve_iters, o.solve_relres
    print(f"effort MV {mv} relres {relres:.3e} in {wall:.3f} s (JAX record "
          f"{EFFORT_MV} MV to 6.92e-4, tol {EFFORT_TOL:g}) [{card_line}]",
          flush=True)
    if not (relres < EFFORT_TOL and abs(mv - EFFORT_MV) <= 0.1 * EFFORT_MV):
        raise AssertionError(f"effort: {mv} MV to {relres:.3e}; the JAX "
                             f"package needs {EFFORT_MV} MV to reach "
                             f"{EFFORT_TOL:g}")
    _check_model_operator(hopper, o, (("-F", -o.rhs), ("dx", dx)))
    return o, _model_library_ms(hopper, o, card_line)


def _model_library_ms(hopper, o, card_line: str) -> float:
    """Every entry point and cuSPARSE on the model's own Jacobian, whose
    zero coefficients the CSR operator leaves out and the kernels read:
    the library call's time on the main path's operator.  The
    general-shape kernels are made to run at 96x38x12 by an x 4 bytes off
    a 16-byte boundary.  Returns cuSPARSE's ms."""
    periodic = o.cfg.periodic
    x = -o.rhs.float()
    off = _misaligned(x)
    lib_ms, nnz = library_ms(hopper, o.jac, hopper.prepare(o.jac), x,
                             periodic)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        AnK = hopper.prepare(o.jac, dtype)
        copies = [AnK, AnK.clone(), AnK.clone()]     # see time_ms
        for v in (x, off):
            before = dict(hopper.LAUNCHES_BY_ENTRY)
            hopper.apply_stencil_prepared(AnK, v, periodic=periodic)
            entry = next(k for k in hopper.ENTRIES
                         if hopper.LAUNCHES_BY_ENTRY[k] != before[k])
            times[entry] = time_ms([
                lambda a=a, v=v: hopper.apply_stencil_prepared(
                    a, v, periodic=periodic) for a in copies])
        del AnK, copies
    print(f"effort model operator (periodic 96x38x12 Jacobian): cuSPARSE "
          f"{lib_ms:.4f} ms ({nnz} nonzeros of {o.jac.numel()} "
          f"coefficients); " + ", ".join(f"{k} {v:.4f} ms"
                                          for k, v in times.items())
          + f" [{card_line}]", flush=True)
    if set(times) != set(hopper.ENTRIES):
        raise AssertionError(f"model operator: entry points timed {times}")
    return lib_ms


def _set_solver(o, prec: dict, **solver) -> None:
    """Give the model another solver configuration, keeping its state, F
    and Jacobian; the factors are rebuilt at the next solve."""
    from iemic_tpu_torch.config import ParameterList
    from iemic_tpu_torch.models.ocean.ocean import default_solver_params
    sp = ParameterList("solver", dict(
        {"Preconditioning": "BGS", "Precision": "Mixed",
         "FGMRES tolerance": EFFORT_TOL, "FGMRES iterations": 200},
        Preconditioner=dict(prec), **solver))
    sp.validate_and_set_defaults(default_solver_params())
    o.solver_params = sp
    o._build_solver()


def _true_relres(o, x, b) -> float:
    """||P (R b - R J x)|| / ||P R b|| in f64: the row-scaled, deflated
    system the solve works on, computed apart from it."""
    from iemic_tpu_torch.models.ocean.ocean import _proj
    nullq = o._get_deflator()
    flat_b = _proj((b * o._rowscale).reshape(-1), nullq)
    r = flat_b - o._mv64(x.reshape(-1), nullq)
    return float(torch.linalg.norm(r) / torch.linalg.norm(flat_b))


def _capped_solve(o, b, cap: int):
    """o.solve(b) with the Mixed path held to cap inner Krylov iterations
    in all: each f32 inner solve gets what is left of cap, an exhausted
    budget returns a zero correction, which ends the refinement loop, and
    the GMRES-IR tail (up to 120 outer iterations of full inner solves)
    is given no outer iteration.  A solve that converges within cap never
    meets any of this."""
    inner, tail, maxiter = o._inner, o._gmres_ir_host, o._maxiter
    used = [0]

    def capped_inner(factors32, r, nullq, tol):
        left = cap - used[0]
        if left <= 0:
            return torch.zeros_like(r), 0, 1.0
        o._maxiter = min(maxiter, left)
        dz, its, relres = inner(factors32, r, nullq, tol)
        used[0] += its
        return dz, its, relres

    o._inner = capped_inner
    o._gmres_ir_host = lambda *a: tail(*a, maxouter=0)
    try:
        return type(o).solve(o, b)
    finally:
        o._inner, o._gmres_ir_host, o._maxiter = inner, tail, maxiter


def _variant_solve(hopper, o, b, name, prec, cap, card_line, where=""):
    """One capped Mixed solve of J x = b with the BGS settings prec."""
    _set_solver(o, prec)
    before = hopper.LAUNCHES
    t0 = time.perf_counter()
    x = _capped_solve(o, b, cap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hopper.LAUNCHES - before
    true = _true_relres(o, x, b)
    verdict = "converged" if true < EFFORT_TOL else \
        f"stalled short of {EFFORT_TOL:g}"
    print(f"variant {name}{where}: MV {o.solve_iters} (at most {cap}) true "
          f"relres {true:.3e} (the solve reports {o.solve_relres:.3e}) in "
          f"{wall:.3f} s, {launches} kernel launches: {verdict} "
          f"[{card_line}]", flush=True)
    finite = bool(torch.isfinite(x).all())
    if not (finite and true < 1.0 and launches > 0
            and true <= RELRES_MARGIN * o.solve_relres + 1e-14):
        raise AssertionError(f"variant {name} failed: finite {finite}, "
                             f"true relres {true:.3e}, reported "
                             f"{o.solve_relres:.3e}, {launches} launches")


def _small_ocean(solver_params: dict, device: str = "cuda"):
    """The masked 8x8x4 grid on device, with F and the Jacobian."""
    from iemic_tpu_torch.models.ocean import Ocean
    s = Ocean({"THCM": dict(ISLAND)}, solver_params=solver_params,
              data_dir=os.path.join(REPO, "data"), device=device)
    s.compute_rhs()
    s.compute_jacobian()
    return s


def phase_variants(hopper, o, card_line: str) -> None:
    """Every BGS branch the bundle does not take, on the effort phase's
    model, F and Jacobian; then what only a small grid can run: the two
    branches whose sweep is not finite at that size, and the factory's
    other methods."""
    b = -o.rhs
    for name, prec, cap in VARIANTS:
        _variant_solve(hopper, o, b, name, prec, cap, card_line)

    small = _small_ocean({"Preconditioning": "BGS", "Precision": "Mixed"})
    for name, prec in SMALL_GRID_VARIANTS:
        _set_solver(o, prec)
        f64, f32 = o._get_prec_factors()
        r = b * o._rowscale
        z64 = o._prec_apply(f64, r)
        z32 = o._prec_apply(f32, r.float())
        print(f"variant {name} at 96x38x12, one sweep of -F: f64 finite "
              f"{bool(torch.isfinite(z64).all())}, max |z| "
              f"{float(z64.abs().max()):.3e}; f32 finite "
              f"{bool(torch.isfinite(z32).all())} (its solve runs on the "
              "small grid)", flush=True)
        _variant_solve(hopper, small, -small.rhs, name, prec, VARIANT_CAP,
                       card_line, " (masked 8x8x4)")
    _set_solver(o, {})

    # MILU and Amesos factor and solve on the host, so every application
    # carries a CUDA tensor across and back
    for method, tol in (("Teko", 1e-3), ("MILU", 1e-3), ("Amesos", 1e-8)):
        s = _small_ocean({"Preconditioning": method, "Precision": "Mixed",
                          "FGMRES tolerance": tol,
                          "FGMRES iterations": 300})
        t0 = time.perf_counter()
        x = s.solve(-s.rhs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        true = _true_relres(s, x, -s.rhs)
        print(f"variant method {method} (masked 8x8x4): MV {s.solve_iters} "
              f"true relres {true:.3e} (tol {tol:g}) in {wall:.3f} s, x on "
              f"{x.device} [{card_line}]", flush=True)
        if not (x.is_cuda and bool(torch.isfinite(x).all()) and true <= tol):
            raise AssertionError(f"method {method}: true relres {true:.3e} "
                                 f"against tol {tol:g}")


def _pencil_residual(o, lam, v) -> float:
    """||J v - lam B v|| / (||J v|| + |lam| ||B v||) in f64 on the model's
    device, for the model's current Jacobian."""
    shape = tuple(o.state.shape)
    Jv = torch.complex(o.apply_matrix(v.real.reshape(shape)),
                       o.apply_matrix(v.imag.reshape(shape)))
    Bv = torch.complex(o.apply_mass_matrix(v.real.reshape(shape)),
                       o.apply_mass_matrix(v.imag.reshape(shape)))
    return float(torch.linalg.norm(Jv - lam * Bv)
                 / (torch.linalg.norm(Jv) + abs(lam) * torch.linalg.norm(Bv)))


def _eigen_small(hopper, card_line: str) -> None:
    """run_ocean on a bundle of the 4x4x3 basin of the eigensolver's own
    tests, with a jdqz_params.xml and eigenvalue analysis at every
    converged point (one continuation step from the trivial solution).
    At this size the solves reach what they are asked, so the pairs
    converge: each is held to the solver's own limit on the true pencil
    residual and to the dense generalized eigenvalues of the same pencil,
    and F and An must come out of the analysis unchanged to the bit."""
    import scipy.linalg
    import scipy.sparse as sp
    from iemic_tpu_torch.config import ParameterList, write_xml
    from iemic_tpu_torch.main import run_ocean
    from iemic_tpu_torch.ops.stencil import stencil_to_csr, to_flat

    with tempfile.TemporaryDirectory() as tmp:
        write_xml(ParameterList("Ocean", {"THCM": {
            "Global Grid-Size n": 4, "Global Grid-Size m": 4,
            "Global Grid-Size l": 3,
            "Starting Parameters": {"Combined Forcing": 0.0,
                                    "Temperature Forcing": 10.0,
                                    "Wind Forcing": 1.0}}}),
            os.path.join(tmp, "ocean_params.xml"))
        write_xml(ParameterList("Continuation parameters", {
            "continuation parameter": "Combined Forcing",
            "initial step size": 0.05, "destination 0": 1.0,
            "maximum number of steps": 1, "Newton tolerance": 1e-6,
            "eigenvalue analysis": "P"}),
            os.path.join(tmp, "continuation_params.xml"))
        write_xml(ParameterList("Solver parameters", {
            "Preconditioning": "BGS", "Precision": "Mixed",
            "FGMRES tolerance": 1e-6, "FGMRES iterations": VARIANT_CAP}),
            os.path.join(tmp, "solver_params.xml"))
        write_xml(ParameterList("JDQZ parameters", dict(JDQZ_PARAMS)),
                  os.path.join(tmp, "jdqz_params.xml"))
        hopper.reset_launches()
        t0 = time.perf_counter()
        status, s, continuation = run_ocean.run(tmp, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        info = open(os.path.join(tmp, "info_0.txt")).read()
    jdqz = continuation.eigen_solver
    launches = hopper.LAUNCHES
    entry = hopper.kernel_variant(torch.float32, *s.state.shape[1:])
    solves = re.findall(r"FGMRES solve: (\d+) iters, relres=(\S+)",
                        info[info.index("JDQZ: solve"):])
    ptol = max(100.0 * jdqz.tol, 1e-8)
    print(f"eigen run_ocean (4x4x3, eigenvalue analysis P) status {status}: "
          f"{jdqz.kmax_converged} of {jdqz.kmax} pairs converged (tolerance "
          f"{jdqz.tol:g}) in {jdqz.op_applications} solves of the analysis, "
          f"{sum(int(mv) for mv, _ in solves)} MV; run {wall:.1f} s, "
          f"{launches} kernel launches {dict(hopper.LAUNCHES_BY_ENTRY)}; MV "
          "per solve " + " ".join(mv for mv, _ in solves) + " | relres "
          + " ".join(r for _, r in solves) + f" [{card_line}]", flush=True)
    if status != 0 or jdqz.kmax_converged == 0:
        raise AssertionError(f"eigen: status {status}, "
                             f"{jdqz.kmax_converged} pairs converged")
    if launches <= 0 or hopper.LAUNCHES_BY_ENTRY[entry] != launches:
        raise AssertionError(f"eigen: the solves did not go through {entry}: "
                             f"{hopper.LAUNCHES_BY_ENTRY}")
    F0, An0 = s.rhs.clone(), s.jac.clone()
    data, indices, indptr = stencil_to_csr(s.jac, periodic=s.cfg.periodic)
    dense = scipy.linalg.eig(
        sp.csr_matrix((data, indices, indptr)).toarray(),
        np.diag(to_flat(s.diagB).cpu().numpy()), right=False)
    dense = dense[np.isfinite(dense)]
    for lam, v in zip(jdqz.eigenvalues, jdqz.eigenvectors):
        pr = _pencil_residual(s, lam, v)
        off = float(np.abs(dense - lam).min())
        print(f"eigen lambda = {lam.real:.8e} {lam.imag:+.8e}i pencil "
              f"residual {pr:.3e} (limit {ptol:g}), {off:.3e} from the "
              f"nearest dense eigenvalue (limit {1e-4 * max(1.0, abs(lam)):g})",
              flush=True)
        if not (pr < ptol and off < 1e-4 * max(1.0, abs(lam))):
            raise AssertionError(f"eigen pair {lam}: pencil residual "
                                 f"{pr:.3e}, {off:.3e} from the dense set")
    # the analysis left the Jacobian of the converged point: computing F
    # and An again from that state gives the same bits
    s.compute_rhs()
    s.compute_jacobian()
    if not (torch.equal(s.rhs, F0) and torch.equal(s.jac, An0)):
        raise AssertionError("eigen: F or An changed by the analysis")
    print("eigen F and An unchanged to the bit", flush=True)


def _eigen_global(hopper, card_line: str) -> None:
    """JDQZ at 96x38x12 as run_ocean sets it up: a bundle of the effort
    phase's model with a jdqz_params.xml (JDQZ_PARAMS) and eigenvalue
    analysis "P", the analysis run on the bundle's starting point.  Every
    Arnoldi step is a Mixed Ocean.solve through the kernel, held to
    VARIANT_CAP inner iterations with no GMRES-IR tail (_capped_solve):
    the BGS-preconditioned stack does not reach 1e-3 for the right-hand
    sides B v of the Arnoldi vectors, and a solve left to itself goes on
    for hours.  With such solves no pair need converge; the phase says
    whether one did after each search space (one, with JDQZ_PARAMS),
    prints the leading Ritz values with their true pencil residuals, holds
    every pair the solver accepted to the solver's own limit, and checks
    that F and An are unchanged to the bit."""
    from iemic_tpu_torch.config import ParameterList, write_xml
    from iemic_tpu_torch.main import run_ocean

    with tempfile.TemporaryDirectory() as tmp:
        write_xml(ParameterList("Ocean", {
            "THCM": dict(GLOBAL_THCM),
            "Data directory": os.path.join(REPO, "data"),
            "Save state": False}),
            os.path.join(tmp, "ocean_params.xml"))
        write_xml(ParameterList("Continuation parameters", {
            "continuation parameter": "Combined Forcing",
            "initial step size": 0.01, "destination 0": 1.0,
            "eigenvalue analysis": "P"}),
            os.path.join(tmp, "continuation_params.xml"))
        write_xml(ParameterList("Solver parameters", {
            "Preconditioning": "BGS", "Precision": "Mixed",
            "FGMRES tolerance": EFFORT_TOL, "FGMRES iterations": 200}),
            os.path.join(tmp, "solver_params.xml"))
        write_xml(ParameterList("JDQZ parameters", dict(JDQZ_PARAMS)),
                  os.path.join(tmp, "jdqz_params.xml"))
        with run_ocean.bundle(tmp, "cuda") as (o, continuation):
            continuation.initialize()
            o.compute_jacobian()
            F0, An0 = o.rhs.clone(), o.jac.clone()
            o.solve = lambda b: _capped_solve(o, b, VARIANT_CAP)
            hopper.reset_launches()
            t0 = time.perf_counter()
            continuation.run_eigen_solver()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del o.solve
        info = open(os.path.join(tmp, "info_0.txt")).read()
    jdqz = continuation.eigen_solver
    launches = hopper.LAUNCHES
    entry = hopper.kernel_variant(torch.float32, *o.state.shape[1:])
    solves = re.findall(r"FGMRES solve: (\d+) iters, relres=(\S+)", info)
    ptol = max(100.0 * jdqz.tol, 1e-8)
    print(f"eigen JDQZ at 96x38x12 (run_ocean's set-up, eigenvalue analysis "
          f"P at the starting point, at most {VARIANT_CAP} inner iterations a "
          f"solve): {jdqz.op_applications} solves, "
          f"{sum(int(mv) for mv, _ in solves)} MV in {wall:.1f} s, {launches} "
          f"kernel launches {dict(hopper.LAUNCHES_BY_ENTRY)}; MV per solve "
          + " ".join(mv for mv, _ in solves) + " | relres "
          + " ".join(r for _, r in solves) + f" [{card_line}]", flush=True)
    cycles = re.findall(r"JDQZ: (\d+) steps, search space (\d+): (\d+) of "
                        r"\d+ converged; (.*)", info)
    for k, (steps, space, nconv, ritz) in enumerate(cycles):
        bound = "the first bound" if k == 0 else "the bound widened once"
        said = f"{nconv} of {jdqz.kmax} pairs converged" if int(nconv) \
            else "no pair converged"
        print(f"eigen 96x38x12 after {steps} steps ({bound}, search space "
              f"{space}): {said}; {ritz}", flush=True)
    if len(solves) != jdqz.op_applications or not cycles \
            or int(cycles[-1][2]) != jdqz.kmax_converged:
        raise AssertionError("eigen: the run's log does not hold the whole "
                             f"analysis: {len(solves)} solves, {cycles}")
    if launches <= 0 or hopper.LAUNCHES_BY_ENTRY[entry] != launches:
        raise AssertionError(f"eigen: the solves did not go through {entry}: "
                             f"{hopper.LAUNCHES_BY_ENTRY}")
    for lam, v, rel in zip(jdqz.eigenvalues, jdqz.eigenvectors,
                           jdqz.ritz_residuals):
        accepted = rel < jdqz.tol
        pr = _pencil_residual(o, lam, v)
        print(f"eigen 96x38x12 Ritz value {lam.real:.8e} {lam.imag:+.8e}i: "
              f"Ritz residual {rel:.3e} (tolerance {jdqz.tol:g}: "
              f"{'accepted' if accepted else 'not converged'}), pencil "
              f"residual {pr:.3e} (limit {ptol:g} for an accepted pair)",
              flush=True)
        if not (np.isfinite(lam) and np.isfinite(pr)
                and bool(torch.isfinite(torch.view_as_real(v)).all())):
            raise AssertionError(f"eigen: Ritz pair {lam} is not finite")
        if accepted and not pr < ptol:
            raise AssertionError(f"eigen pair {lam}: accepted with pencil "
                                 f"residual {pr:.3e}")
    o.compute_rhs()
    o.compute_jacobian()
    if not (torch.equal(o.rhs, F0) and torch.equal(o.jac, An0)):
        raise AssertionError("eigen: F or An changed by the analysis")
    print("eigen 96x38x12 F and An unchanged to the bit", flush=True)


def phase_eigen(hopper, o, card_line: str) -> None:
    """JDQZ through run_ocean: on a small basin, where the pairs converge
    and are held to the dense spectrum; at 96x38x12 under a bound on every
    solve; and on the effort phase's model o a solve with the shifted
    pencil J - sigma B, which must use factors and a prepared f32 operator
    of the shifted matrix and leave An as it was."""
    from iemic_tpu_torch.models.ocean.ocean import _proj

    _eigen_small(hopper, card_line)
    _eigen_global(hopper, card_line)

    # the shifted pencil at full size
    _set_solver(o, {})
    sigma, b = 0.1, -o.rhs
    o.compute_jacobian()
    o.compute_mass_matrix()
    An0 = o.jac.clone()
    o.solve(b)                       # factors of the unshifted matrix
    o.add_mass_to_jacobian(-sigma)
    before = hopper.LAUNCHES
    x = _capped_solve(o, b, VARIANT_CAP)
    launches = hopper.LAUNCHES - before
    # the residual of the shifted, row-scaled, deflated system, from the
    # unshifted tensor kept above
    nullq, R = o._get_deflator(), o._rowscale
    r = _proj((R * (o._apply(An0, x) - sigma * o.diagB * x - b)).reshape(-1),
              nullq)
    true = float(torch.linalg.norm(r)
                 / torch.linalg.norm(_proj((R * b).reshape(-1), nullq)))
    print(f"eigen shifted solve (J - {sigma:g} B) x = -F at 96x38x12: MV "
          f"{o.solve_iters}, the solve reports {o.solve_relres:.3e}, the "
          f"residual with the shifted pencil is {true:.3e}, {launches} "
          f"kernel launches [{card_line}]", flush=True)
    o.compute_jacobian()
    if not (true < 1.0 and launches > 0
            and true <= RELRES_MARGIN * o.solve_relres + 1e-14
            and torch.equal(o.jac, An0)):
        raise AssertionError("eigen: the shifted solve did not use the "
                             "shifted matrix, or An was not restored")


def _bundle_copy(tmp: str) -> str:
    """Copy run/ocean/global into tmp and cut it to a bounded first
    continuation step: absolute data path, no checkpoint files.

    What is cut, and why.  At the Newton iterates of the bundle's first
    step the BGS-preconditioned solves stop short of the bundle's 1e-4:
    the Mixed stack's f32 inner solve stalls at a relative residual
    between 7e-4 and 2e-2, and the Double stack does no better there
    (3.6e-2 after 400 iterations, PERF.md).  A request below where the
    solve stalls hands the rest to GMRES-IR, whose 300-iteration inner
    solves cost about 20 s each on the card, for up to 120 outer
    iterations, and Newton with such solves does not reach the bundle's
    1e-4 in its 10 iterations.  So the copy asks FGMRES tolerance
    SOLVE_TOL, above where the solves stall, so that every solve is one
    f32 inner solve run to its end, and runs NEWTON_ITERS Newton
    iterations of one step, keeping the unconverged point.  The effort
    phase holds a solve to 1e-3 where the repo records that the stack
    reaches it."""
    from iemic_tpu_torch.config import read_xml, write_xml
    work = os.path.join(tmp, "global")
    shutil.copytree(BUNDLE, work)
    op = read_xml(os.path.join(work, "ocean_params.xml"))
    op.set("Data directory", os.path.join(REPO, "data"))
    op.set("Save state", False)
    write_xml(op, os.path.join(work, "ocean_params.xml"))
    cp = read_xml(os.path.join(work, "continuation_params.xml"))
    cp.set("maximum number of steps", 1)
    cp.set("maximum Newton iterations", NEWTON_ITERS)
    cp.set("reject failed iteration", False)
    write_xml(cp, os.path.join(work, "continuation_params.xml"))
    sp = read_xml(os.path.join(work, "solver_params.xml"))
    sp.set("FGMRES tolerance", SOLVE_TOL)
    write_xml(sp, os.path.join(work, "solver_params.xml"))
    return work


def phase_main(hopper, card_line: str, entry: str = MAIN_ENTRY) -> dict:
    """run_ocean on the cut bundle.  entry is the kernel the run must go
    through: the wrapper's own choice, or the general-shape f32 kernel,
    which the wrapper is then made to take.  Returns the launches by
    entry point, the MV of each solve and the cdata rows."""
    from iemic_tpu_torch.main import run_ocean

    choose = hopper.kernel_variant
    if entry != MAIN_ENTRY:
        hopper.kernel_variant = \
            lambda *shape: choose(*shape).removesuffix("_wide")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            work = _bundle_copy(tmp)
            hopper.reset_launches()
            t0 = time.perf_counter()
            status = run_ocean.main([work, "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = hopper.LAUNCHES
            by_entry = dict(hopper.LAUNCHES_BY_ENTRY)
            info = open(os.path.join(work, "info_0.txt")).read()
            cdata = open(os.path.join(work, "cdata.txt")).read()
            profile = open(os.path.join(work, "profile_output")).read()
    finally:
        hopper.kernel_variant = choose

    tag = "main" if entry == MAIN_ENTRY else f"main {entry}"
    print(f"{tag} status={status} wall={wall:.1f} s "
          f"kernel launches={launches} {by_entry}", flush=True)
    for line in cdata.strip().splitlines():
        print(f"{tag} cdata " + line, flush=True)
    solves = [(int(a), float(b)) for a, b in re.findall(
        r"FGMRES solve: (\d+) iters, relres=(\S+)", info)]
    print(f"{tag} MV per solve " + " ".join(str(s[0]) for s in solves)
          + " | true relres " + " ".join(f"{s[1]:.2e}" for s in solves),
          flush=True)
    pred = [float(v) for v in re.findall(r"predictor: .*\|rhs\|=(\S+)",
                                         info)]
    newton = [float(v) for v in re.findall(r"Newton iter \d+: \|R\|=(\S+)",
                                           info)]
    print(f"{tag} |F| predictor " + " ".join(f"{v:.3e}" for v in pred)
          + " | after each Newton iteration "
          + " ".join(f"{v:.3e}" for v in newton), flush=True)
    prof = {}
    for line in profile.splitlines()[1:]:
        parts = line.rsplit(None, 3)
        if len(parts) == 4:
            prof[parts[0].strip()] = (float(parts[1]), float(parts[2]))
    nits = prof.get("Continuation: Newton iterations...", (0, 0))[0]
    newton_s = prof.get("Continuation: Newton", (0.0, 0))[0]
    for key in ("Ocean: compute rhs", "Ocean: compute jacobian",
                "Ocean: build preconditioner", "Ocean: solve",
                "Continuation: Newton"):
        if key in prof:
            print(f"{tag} timer {key}: {prof[key][0]:.3f} s over "
                  f"{int(prof[key][1])} calls [{card_line}]", flush=True)
    if nits:
        print(f"{tag} wall per Newton iteration {newton_s / nits:.3f} s "
              f"({int(nits)} iterations) [{card_line}]", flush=True)

    if status != 0:
        raise AssertionError(f"run_ocean returned {status}")
    if by_entry[entry] <= 0 or by_entry[entry] != launches:
        raise AssertionError(f"the main path did not go through "
                             f"{entry} alone: {by_entry}")
    if not solves or not all(np.isfinite(r) and r < SOLVE_TOL
                             for _, r in solves):
        raise AssertionError("a solve missed its tolerance "
                             f"{SOLVE_TOL:g} or stalled: {solves}")
    if not pred or not newton or not newton[-1] < pred[0]:
        raise AssertionError("|F| did not fall across the Newton "
                             f"iterations: {pred} -> {newton}")
    rows = [ln.split() for ln in cdata.splitlines()
            if ln.strip() and not ln.startswith("#")]
    if len(rows) != 1 or not all(np.isfinite(float(v)) for v in rows[0]):
        raise AssertionError(f"expected one finite cdata row: {rows}")
    return dict(launches=by_entry, mv=[mv for mv, _ in solves], cdata=rows)


def _spinup_copy(tmp: str) -> str:
    """Copy run/ocean/global into tmp with run/ocean's
    timestepper_params.xml (theta 1, dt 1e-3, adaptive, at most 10 Newton
    iterations), for time_ocean.

    What is changed, and why.  Combined Forcing starts at 1.0, the full
    forcing and the continuation's destination: at the bundle's 0.0 the
    forcing is zero and the state never leaves rest.  The run is cut to
    SPINUP_STEPS time steps of the bundle's 100, so that it fits the smoke
    run, and writes no HDF5 state ("HDF5 output frequency" 0): the card's
    machine has no h5py.  The solves of J - B/(theta dt) stall as those of
    the continuation's first step do (PERF.md): the second solve of
    the first step reaches 7.6e-4, short of the bundle's 1e-4, and its
    third stops at 0.25 and then 1.0; below where a solve stalls the
    GMRES-IR tail runs for hours, and Newton converges only linearly, to
    an |F| of about 1e-3 before a solve stalls.  So the copy asks FGMRES
    tolerance SOLVE_TOL, as the main phase does, and Newton tolerance
    SPINUP_NEWTON_TOL, where the bundle asks 1e-4 for both (at Newton
    tolerance 1e-3 the second step's fifth solve stalls).  Absolute data
    path, no checkpoint files."""
    from iemic_tpu_torch.config import read_xml, write_xml
    work = os.path.join(tmp, "spinup")
    shutil.copytree(BUNDLE, work)
    op = read_xml(os.path.join(work, "ocean_params.xml"))
    op.set("Data directory", os.path.join(REPO, "data"))
    op.set("Save state", False)
    op.sublist("THCM").sublist("Starting Parameters").set(
        "Combined Forcing", 1.0)
    write_xml(op, os.path.join(work, "ocean_params.xml"))
    sp = read_xml(os.path.join(work, "solver_params.xml"))
    sp.set("FGMRES tolerance", SOLVE_TOL)
    write_xml(sp, os.path.join(work, "solver_params.xml"))
    tp = read_xml(TIMESTEPPER)
    tp.set("number of time steps", SPINUP_STEPS)
    tp.set("HDF5 output frequency", 0)
    tp.set("Newton tolerance", SPINUP_NEWTON_TOL)
    write_xml(tp, os.path.join(work, "timestepper_params.xml"))
    return work


def _time_steps(info: str) -> list[dict]:
    """The spin-up's attempts at a time step, from time_ocean's
    info_0.txt: dt, Newton |F| per iteration, MV and relres per solve,
    and whether Newton converged."""
    steps = []
    for block in info.split("Timestepping: ")[1:]:
        steps.append(dict(
            dt=float(re.search(r"dt = (\S+)", block).group(1)),
            F=[float(v) for v in re.findall(r"\|\|F\|\|=(\S+)", block)],
            solves=[(int(a), float(b)) for a, b in re.findall(
                r"FGMRES solve: (\d+) iters, relres=(\S+)", block)],
            converged="Newton did not converge" not in block))
    return steps


def _profile(path: str) -> dict:
    prof = {}
    for line in open(path).read().splitlines()[1:]:
        parts = line.rsplit(None, 3)
        if len(parts) == 4:
            prof[parts[0].strip()] = (float(parts[1]), float(parts[2]))
    return prof


def _bundle_newton_tol() -> float:
    """The Newton tolerance that run/ocean/timestepper_params.xml asks."""
    from iemic_tpu_torch.config import read_xml
    return read_xml(TIMESTEPPER).get("Newton tolerance")


def _spinup(hopper, card_line: str):
    """(a) time_ocean on the masked global 96x38x12 grid at full width,
    on the card.  Returns (ocean, stepper, launches by entry point)."""
    from iemic_tpu_torch.config import read_xml
    from iemic_tpu_torch.main import time_ocean

    with tempfile.TemporaryDirectory() as tmp:
        work = _spinup_copy(tmp)
        tol = read_xml(os.path.join(work, "solver_params.xml")).get(
            "FGMRES tolerance")
        hopper.reset_launches()
        t0 = time.perf_counter()
        status, ocean, stepper = time_ocean.run(work, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by_entry = hopper.LAUNCHES, dict(hopper.LAUNCHES_BY_ENTRY)
        info = open(os.path.join(work, "info_0.txt")).read()
        tdata = open(os.path.join(work, "tdata.txt")).read()
        prof = _profile(os.path.join(work, "profile_output"))
    steps = _time_steps(info)
    bundle_tol = _bundle_newton_tol()
    print(f"transient spin-up (time_ocean, masked global 96x38x12, Combined "
          f"Forcing 1.0, theta {stepper.model.theta:g}) status={status} "
          f"wall={wall:.1f} s, {stepper.time_steps} time steps, kernel "
          f"launches={launches} {by_entry} [{card_line}]", flush=True)
    for k, st in enumerate(steps):
        reached = bool(st["F"]) and st["F"][-1] < bundle_tol
        print(f"transient step {k + 1}: dt {st['dt']:.6g}, Newton "
              f"{len(st['F'])} iterations, "
              f"{'converged' if st['converged'] else 'NOT converged'} at "
              f"Newton tolerance {SPINUP_NEWTON_TOL:g}, the bundle's "
              f"{bundle_tol:g} {'reached' if reached else 'NOT reached'}, "
              "|F| " + " ".join(f"{v:.3e}" for v in st["F"])
              + " | MV " + " ".join(str(mv) for mv, _ in st["solves"])
              + " | true relres "
              + " ".join(f"{r:.2e}" for _, r in st["solves"]),
              flush=True)
    print(f"transient spin-up: "
          f"{sum(bool(st['F']) and st['F'][-1] < bundle_tol for st in steps)}"
          f" of {len(steps)} steps reached the bundle's Newton tolerance "
          f"{bundle_tol:g}; the run asks {SPINUP_NEWTON_TOL:g}", flush=True)
    for line in tdata.strip().splitlines():
        print("transient tdata " + line, flush=True)
    for key in ("Ocean: compute rhs", "Ocean: compute jacobian",
                "Ocean: build preconditioner", "Ocean: solve"):
        if key in prof:
            print(f"transient timer {key}: {prof[key][0]:.3f} s over "
                  f"{int(prof[key][1])} calls [{card_line}]", flush=True)
    if stepper.time_steps:
        print(f"transient wall per time step {wall / stepper.time_steps:.3f} "
              f"s ({sum(len(st['F']) for st in steps)} Newton iterations, "
              f"{sum(mv for st in steps for mv, _ in st['solves'])} MV) "
              f"[{card_line}]", flush=True)

    if status != 0 or stepper.time_steps != SPINUP_STEPS:
        raise AssertionError(f"time_ocean returned {status} after "
                             f"{stepper.time_steps} time steps")
    if not steps or not all(st["converged"] for st in steps):
        raise AssertionError("a time step's Newton did not converge")
    if by_entry[MAIN_ENTRY] <= 0 or by_entry[MAIN_ENTRY] != launches:
        raise AssertionError(f"the spin-up did not go through {MAIN_ENTRY} "
                             f"alone: {by_entry}")
    solves = [r for st in steps for _, r in st["solves"]]
    if not solves or not all(np.isfinite(r) and r < tol for r in solves):
        raise AssertionError(f"a solve missed its tolerance {tol:g}: {solves}")
    rows = [ln.split() for ln in tdata.splitlines()
            if ln.strip() and not ln.startswith("#")]
    norms = [float(r[3]) for r in rows]
    if len(rows) != SPINUP_STEPS or not all(np.isfinite(v) and v > 0
                                            for v in norms):
        raise AssertionError(f"tdata |x| not finite and nonzero: {rows}")
    return ocean, stepper, by_entry


def _stochastic_steps(hopper, ocean, stepper, card_line: str):
    """(b) Two stochastic theta steps of the spun-up state at the bundle's
    dt, through factory.get_time_step, with the seed of
    run/2dmoc/ams_params.xml and STOCHASTIC_CUTS.  G must be zero off the
    surface S rows (and on the integral row, where the configuration has
    one).  Returns the launches by entry point and the stochastic
    model."""
    from iemic_tpu_torch.config import read_xml
    from iemic_tpu_torch.ops.stencil import SS
    from iemic_tpu_torch.transient.factory import get_time_step
    from iemic_tpu_torch.transient.theta import StochasticThetaModel

    ams = read_xml(os.path.join(AMS_BUNDLE, "ams_params.xml"))
    pars = dict(read_xml(TIMESTEPPER).items())
    pars.update(sigma=ams.get("sigma"), seed=ams.get("seed", 0))
    pars.update(STOCHASTIC_CUTS)
    model = StochasticThetaModel(ocean, pars)
    step = get_time_step(model, pars)
    l = ocean.cfg.l
    surface = torch.zeros_like(ocean.state, dtype=torch.bool)
    surface[SS, l - 1] = torch.as_tensor(ocean.landm[l, 1:-1, 1:-1] == 0,
                                         device=surface.device)
    if ocean.cfg.sres == 0:
        surface[ocean.rowintcon] = False
    x = ocean.get_state()
    dt = pars["time step"]
    for key in STOCHASTIC_CUTS:
        print(f"transient stochastic steps cut: {key} = {pars[key]}",
              flush=True)
    bundle_tol = _bundle_newton_tol()
    reached = 0
    hopper.reset_launches()
    for k in range(STOCHASTIC_STEPS):
        t0 = time.perf_counter()
        x = step(x, dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        G = model.G
        off = float(G[~surface].abs().max())
        ok = step.newton.norm_F < bundle_tol
        reached += ok
        print(f"transient stochastic step {k + 1} (sigma {model.sigma:g}, "
              f"seed {pars['seed']}, dt {dt:g}): Newton "
              f"{step.newton.steps} iterations, "
              f"{'converged' if step.newton.converged else 'NOT converged'}"
              f" at Newton tolerance {pars['Newton tolerance']:g}, the "
              f"bundle's {bundle_tol:g} "
              f"{'reached' if ok else 'NOT reached'}, "
              f"|F| {step.newton.norm_F:.3e}, max |G| on surface S rows "
              f"{float(G[surface].abs().max()):.3e}, elsewhere {off:.1e}, "
              f"MV {ocean.solve_iters}, {wall:.3f} s [{card_line}]",
              flush=True)
        if not (step.newton.converged and off == 0.0
                and float(G[surface].abs().max()) > 0.0):
            raise AssertionError(f"stochastic step {k + 1}: converged "
                                 f"{step.newton.converged}, |G| off the "
                                 f"surface S rows {off}")
    print(f"transient stochastic steps: {reached} of {STOCHASTIC_STEPS} "
          f"reached the bundle's Newton tolerance {bundle_tol:g}; the run "
          f"asks {pars['Newton tolerance']:g}", flush=True)
    if not bool(torch.isfinite(x).all()):
        raise AssertionError("stochastic steps: state not finite")
    return dict(hopper.LAUNCHES_BY_ENTRY), model


def _ams_copy(tmp: str, name: str, solver: dict | None) -> str:
    """Copy run/2dmoc into tmp/name at RARE_EVENT_FORCING, its solver
    files replaced by solver where one is given, else its FGMRES
    tolerance cut as RARE_EVENT_STEP_CUTS says."""
    from iemic_tpu_torch.config import ParameterList, read_xml, write_xml
    work = os.path.join(tmp, name)
    shutil.copytree(AMS_BUNDLE, work)
    op = read_xml(os.path.join(work, "ocean_params.xml"))
    op.set("Save state", False)
    op.sublist("THCM").sublist("Starting Parameters").set(
        "Combined Forcing", RARE_EVENT_FORCING)
    write_xml(op, os.path.join(work, "ocean_params.xml"))
    path = os.path.join(work, "solver_params.xml")
    if solver is not None:
        os.remove(os.path.join(work, "ocean_preconditioner_params.xml"))
        write_xml(ParameterList("Solver parameters", dict(solver)), path)
    else:
        sp = read_xml(path)
        sp.set("FGMRES tolerance", RARE_EVENT_STEP_CUTS["FGMRES tolerance"])
        write_xml(sp, path)
    return work


def _bundle_ocean(work: str, device: str):
    """The ocean of the bundle copy work on device, as run_ams builds it."""
    from iemic_tpu_torch.config import read_xml
    from iemic_tpu_torch.main.run_ocean import read_solver_params
    from iemic_tpu_torch.models.ocean import Ocean

    cwd = os.getcwd()
    os.chdir(work)
    try:
        return Ocean(read_xml("ocean_params.xml"),
                     solver_params=read_solver_params(), device=device)
    finally:
        os.chdir(cwd)


def _rare_event_states(work: str) -> tuple[dict, float]:
    """A, a steady state from RARE_EVENT_NEWTON Newton steps from rest on
    the CPU with the bundle copy's (direct) solves, and B, displaced from
    it, as tests/test_stochastic_ocean.py makes them (with a smaller
    displacement), as run_ams's states; and |F(A)|."""
    o = _bundle_ocean(work, "cpu")
    solA = torch.zeros_like(o.state)
    for _ in range(RARE_EVENT_NEWTON):
        o.set_state(solA)
        o.compute_rhs()
        o.compute_jacobian()
        solA = solA + o.solve(-o.rhs)
    o.set_state(solA)
    o.compute_rhs()
    rng = np.random.default_rng(3)
    solB = solA + RARE_EVENT_DISPLACEMENT * o._tensor(
        rng.standard_normal(tuple(solA.shape))) * (solA.abs() + 0.1)
    return ({"solution 1": o.to_flat(solA).numpy(),
             "solution 2": o.to_flat(solB).numpy()},
            float(torch.linalg.vector_norm(o.rhs)))


def _ams_params() -> dict:
    from iemic_tpu_torch.config import read_xml
    return dict(read_xml(os.path.join(AMS_BUNDLE, "ams_params.xml")).items())


def _rare_events_on(work: str, device: str, states: dict) -> dict:
    """run_ams of AMS, TAMS and GPA in the bundle copy work on device,
    with run/2dmoc/ams_params.xml cut by RARE_EVENT_CUTS."""
    from iemic_tpu_torch.config import ParameterList, write_xml
    from iemic_tpu_torch.main import run_ams

    out = {}
    for method, cut in RARE_EVENT_METHODS.items():
        pars = dict(_ams_params(), **RARE_EVENT_CUTS, method=method, **cut)
        write_xml(ParameterList("AMS", pars),
                  os.path.join(work, "ams_params.xml"))
        t0 = time.perf_counter()
        status, _, tr = run_ams.run(work, device, states=states)
        if device == "cuda":
            torch.cuda.synchronize()
        out[method] = dict(status=status, its=tr.its,
                           time_steps=tr.time_steps,
                           probability=float(tr.get_probability()),
                           mfpt=float(tr.get_mfpt()),
                           seconds=time.perf_counter() - t0)
    return out


def _trajectory(work: str, device: str, states: dict) -> list:
    """RARE_EVENT_STEPS steps of the rare-event methods' stochastic theta
    step (transient.factory.get_time_step of a StochasticThetaModel, as
    transient_factory builds it) from A, with the bundle copy work's
    solves on device: per step the state on the CPU, Newton updates, |F|,
    MV and true relres of the last solve, seconds."""
    from iemic_tpu_torch.transient.factory import get_time_step
    from iemic_tpu_torch.transient.theta import StochasticThetaModel

    o = _bundle_ocean(work, device)
    pars = dict(_ams_params(), **RARE_EVENT_CUTS, **RARE_EVENT_STEP_CUTS)
    model = StochasticThetaModel(o, pars)
    step = get_time_step(model, pars)
    x = o.from_flat(o._tensor(states["solution 1"]))
    out = []
    for _ in range(RARE_EVENT_STEPS):
        t0 = time.perf_counter()
        x = step(x, pars["time step"])
        if device == "cuda":
            torch.cuda.synchronize()
        out.append(dict(x=o.to_flat(x).cpu(), newton=step.newton.steps,
                        converged=step.newton.converged,
                        F=step.newton.norm_F, mv=o.solve_iters,
                        relres=o.solve_relres,
                        seconds=time.perf_counter() - t0))
    return out


def _rare_events(hopper, card_line: str) -> dict:
    """(d) run_ams's three methods on run/2dmoc's grid, on the card and on
    the CPU with direct solves; then the methods' step with the bundle's
    BGS + Mixed solves on the card beside the direct solves on the CPU.
    Returns the kernel launches of that card run by entry point."""
    cuts = dict(RARE_EVENT_CUTS, **{
        "solver": RARE_EVENT_DIRECT["Preconditioning"],
        "Combined Forcing": RARE_EVENT_FORCING,
        "B displacement": RARE_EVENT_DISPLACEMENT,
        "states": "A and B held in memory"})
    for method, cut in RARE_EVENT_METHODS.items():
        cuts.update({f"{method} {k}": v for k, v in cut.items()})
    cuts.update({f"BGS + Mixed steps {k}": v
                 for k, v in RARE_EVENT_STEP_CUTS.items()})
    for key, val in cuts.items():
        print(f"transient rare events cut: {key} = {val}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        direct = [_ams_copy(tmp, d, RARE_EVENT_DIRECT)
                  for d in ("cuda", "cpu")]
        states, fa = _rare_event_states(direct[1])
        print(f"transient rare events: run/2dmoc 4x32x16, A from "
              f"{RARE_EVENT_NEWTON} Newton steps with direct solves on the "
              f"cpu, |F(A)| {fa:.3e}", flush=True)
        runs = {d: _rare_events_on(w, d, states)
                for d, w in zip(("cuda", "cpu"), direct)}
        bgs = _ams_copy(tmp, "bgs", None)
        hopper.reset_launches()
        card = _trajectory(bgs, "cuda", states)
        launches, by_entry = hopper.LAUNCHES, dict(hopper.LAUNCHES_BY_ENTRY)
        ref = _trajectory(direct[1], "cpu", states)
    for method in RARE_EVENT_METHODS:
        c, h = runs["cuda"][method], runs["cpu"][method]
        print(f"transient {method} (direct solves): probability "
              f"{c['probability']!r} (cpu {h['probability']!r}), mfpt "
              f"{c['mfpt']!r} (cpu {h['mfpt']!r}), its {c['its']} (cpu "
              f"{h['its']}), time steps {c['time_steps']} (cpu "
              f"{h['time_steps']}), {c['seconds']:.1f} s on the card, "
              f"{h['seconds']:.1f} s on the cpu [{card_line}]", flush=True)
        same = (c["status"] == h["status"] == 0 and c["its"] == h["its"]
                and c["time_steps"] == h["time_steps"] > 0
                and all(np.isfinite(c[k]) and abs(c[k] - h[k])
                        <= 1e-8 * max(1.0, abs(h[k]))
                        for k in ("probability", "mfpt")))
        if not same:
            raise AssertionError(f"{method}: the card's run differs from "
                                 f"the cpu's, or is not finite: {c} "
                                 f"against {h}")
    bundle_tol = _ams_params()["Newton tolerance"]
    x0 = torch.as_tensor(states["solution 1"]).reshape(-1, 6)
    for k, (c, h) in enumerate(zip(card, ref)):
        moved = (h["x"].reshape(-1, 6) - x0).abs().amax(dim=0)
        err = (c["x"] - h["x"]).reshape(-1, 6).abs().amax(dim=0)
        print(f"transient rare-event step {k + 1} with BGS + Mixed on the "
              f"card: Newton updates {c['newton']} (cpu, direct: "
              f"{h['newton']}), "
              f"{'converged' if c['converged'] else 'NOT converged'} at "
              f"Newton tolerance {RARE_EVENT_STEP_CUTS['Newton tolerance']:g}"
              f", the bundle's {bundle_tol:g} "
              f"{'reached' if c['F'] < bundle_tol else 'NOT reached'}, |F| "
              f"{c['F']:.3e} (cpu {h['F']:.3e}), last solve {c['mv']} MV to "
              f"true relres {c['relres']:.2e}, {c['seconds']:.2f} s (cpu "
              f"{h['seconds']:.2f} s); max |card - direct| per unknown "
              "u v w p T S " + " ".join(f"{v:.2e}" for v in err.tolist())
              + " against the direct step's max |x - A| "
              + " ".join(f"{v:.2e}" for v in moved.tolist())
              + f" [{card_line}]", flush=True)
        tol = RARE_EVENT_STEP_CUTS["FGMRES tolerance"]
        if not (c["converged"] and bool(torch.isfinite(c["x"]).all())
                and c["relres"] < tol):
            raise AssertionError(f"rare-event step {k + 1} on the card: "
                                 f"converged {c['converged']}, last solve "
                                 f"at {c['relres']:.3e} (tolerance {tol:g})")
    print(f"transient rare-event steps launches {by_entry} [{card_line}]",
          flush=True)
    if by_entry[MAIN_ENTRY] <= 0 or by_entry[MAIN_ENTRY] != launches:
        raise AssertionError(f"the rare-event steps did not go through "
                             f"{MAIN_ENTRY} alone: {by_entry}")
    return by_entry


def _seasonal(card_line: str) -> None:
    """(e) Seasonal forcing: random monthly fields installed on a small
    grid, F on the card against the CPU at three times of the year."""
    from iemic_tpu_torch import interop
    from iemic_tpu_torch.models.ocean import Ocean
    from iemic_tpu_torch.models.ocean.forcing_data import (R0DIM,
                                                           SECS_PER_YEAR, UDIM)

    rng = np.random.default_rng(5)
    l, m, n = 3, 4, 4
    monthly = {k: rng.standard_normal((12, m, n))
               for k in ("mtaux", "mtauy", "mtatm", "memip")}
    x = 0.1 * rng.standard_normal((6, l, m, n))
    year = SECS_PER_YEAR / (R0DIM / UDIM)     # nondimensional year
    rhs = {}
    for device in ("cuda", "cpu"):
        o = Ocean({"THCM": {
            "Global Grid-Size n": n, "Global Grid-Size m": m,
            "Global Grid-Size l": l, "Levitus T": 0, "Levitus S": 0,
            "Wind Forcing Type": 1, "Time Dependent Forcing": True,
            "Starting Parameters": {"Combined Forcing": 1.0,
                                    "Temperature Forcing": 10.0,
                                    "Salinity Forcing": 1.0,
                                    "Wind Forcing": 1.0}}}, device=device)
        interop.install_monthly_forcing(o, **monthly)
        interop.install_state(o, x)
        rhs[device] = []
        for t in SEASON_TIMES:
            o.set_par("Time", t * year)
            o.compute_rhs()
            rhs[device].append(o.rhs.cpu())
    for t, a, b in zip(SEASON_TIMES, rhs["cuda"], rhs["cpu"]):
        err = float((a - b).abs().max() / b.abs().max())
        print(f"transient seasonal forcing at {t:g} year: F cuda-vs-cpu "
              f"relative max error {err:.3e} (limit {ATOL:.0e})", flush=True)
        if not (err <= ATOL and bool(torch.isfinite(a).all())):
            raise AssertionError(f"seasonal forcing at {t:g} year: {err:.3e}")
    if torch.equal(rhs["cpu"][0], rhs["cpu"][1]):
        raise AssertionError("seasonal forcing: F does not follow the season")


def phase_transient(hopper, card_line: str) -> dict:
    """time_ocean's spin-up at full width, two stochastic steps of its
    state, the kernel on its last shifted Jacobian, the rare-event methods
    on the 2DMOC grid and their step with BGS + Mixed, and the seasonal
    forcing.  Returns the kernel launches of the transient path, (a), (b)
    and the BGS + Mixed steps of (d), by entry point."""
    t0 = time.perf_counter()
    ocean, stepper, spinup = _spinup(hopper, card_line)
    stochastic, model = _stochastic_steps(hopper, ocean, stepper, card_line)
    print(f"transient spin-up launches {spinup}", flush=True)
    print(f"transient stochastic steps launches {stochastic}", flush=True)
    print(f"transient (a)+(b) {time.perf_counter() - t0:.1f} s", flush=True)
    # (c) ocean.jac is J - B/(theta dt) of the last Newton iteration, whose
    # right-hand side was the theta residual and whose solution is ocean.sol
    _check_model_operator(
        hopper, ocean, (("theta residual", model.rhs), ("dx", ocean.sol)),
        "transient J - B/(theta dt) of the last stochastic step,")
    t0 = time.perf_counter()
    rare = _rare_events(hopper, card_line)
    print(f"transient rare events {time.perf_counter() - t0:.1f} s",
          flush=True)
    _seasonal(card_line)
    by_entry = {k: spinup[k] + stochastic[k] + rare[k] for k in spinup}
    print(f"transient phase launches {by_entry}", flush=True)
    return by_entry


@contextlib.contextmanager
def _no_gmres_ir_tail():
    """Ocean.solve with its GMRES-IR tail given no outer iteration: a
    Mixed solve whose f32 inner solves stall short of the tolerance
    returns its best iterate at once, where the tail would run up to 120
    full inner solves (hours at 96x38x12, ROADMAP queue 3).  A solve that
    meets its tolerance never enters the tail, so this changes no solve
    that a phase's checks accept."""
    from iemic_tpu_torch.models.ocean import Ocean
    tail = Ocean._gmres_ir_host
    Ocean._gmres_ir_host = lambda self, *a: tail(self, *a, maxouter=0)
    try:
        yield
    finally:
        Ocean._gmres_ir_host = tail


def _global_raw_mask() -> np.ndarray:
    """The raw (l, m, n) land mask of run/ocean/global."""
    from types import SimpleNamespace
    from iemic_tpu_torch.models.ocean import landmask as lm
    l, m, n = (GLOBAL_THCM[f"Global Grid-Size {c}"] for c in "lmn")
    landm = lm.read_mask_file(
        os.path.join(REPO, "data", "mkmask", GLOBAL_THCM["Land Mask"]),
        SimpleNamespace(l=l, m=m, n=n))
    return landm[1:l + 1, 1:m + 1, 1:n + 1].copy()


def _open_ocean(raw: np.ndarray, size: int, avoid=None) -> tuple:
    """(j, i) of the first size x size block of columns that are water at
    every depth, searched from the middle of the grid outward, apart from
    the block avoid = (j, i, size)."""
    _, m, n = raw.shape
    deep = (raw == 0).all(axis=0)
    for j in sorted(range(m - size + 1), key=lambda j: abs(j - m // 2)):
        for i in sorted(range(n - size + 1), key=lambda i: abs(i - n // 2)):
            if avoid is not None:
                aj, ai, asz = avoid
                if aj - size < j < aj + asz and ai - size < i < ai + asz:
                    continue
            if deep[j:j + size, i:i + size].all():
                return j, i
    raise AssertionError(f"no open {size}x{size} block of ocean")


def _topo_mask1():
    """Mask 1, derived from mask 0, the shipped mask of run/ocean/global:
    the bottom two levels of a 2 x 2 block of columns landed in the middle
    of an open basin, a seamount (as tests/test_topo.py makes one).
    Returns (mask 1, the 4 x 4 block around the seamount as (j, i, 4))."""
    raw = _global_raw_mask()
    j, i = _open_ocean(raw, 4)
    mask1 = raw.copy()
    mask1[0:2, j + 1:j + 3, i + 1:i + 3] = 1
    return mask1, (j, i, 4)


def _topo_analysis(hopper, card_line: str, mask1, seamount, tmp: str):
    """(a) The mask analysis at full width: analyze_jacobian on the
    shipped mask, then get_land_mask(adjust_mask=True) on mask 1 with one
    water column walled in by land at every depth, which the fix cycle
    must land.  The model takes the salinity integral condition
    ("Restoring Salinity Profile" 0, its row at the seamount's ocean
    column), under which the S column analysis applies: under the
    bundle's restoring it flags every surface ocean column (3,066 here;
    the port's analysis then flags none, ROADMAP queue 3)."""
    from iemic_tpu_torch.models.ocean import Ocean, analysis
    from iemic_tpu_torch.post.masks import write_mask_file

    thcm = dict(GLOBAL_THCM, **{
        "Restoring Salinity Profile": 0,
        "Integral row coordinate i": seamount[1] + 1,
        "Integral row coordinate j": seamount[0] + 1})
    o = Ocean({"THCM": thcm},
              solver_params={"Preconditioning": "BGS", "Precision": "Mixed",
                             "FGMRES tolerance": EFFORT_TOL,
                             "FGMRES iterations": 200},
              data_dir=os.path.join(REPO, "data"), device="cuda")
    t0 = time.perf_counter()
    with _no_gmres_ir_tail():
        flags = [(f == 2).sum() for f in (analysis.analyze_jacobian1(o),
                                          analysis.analyze_jacobian2(o))]
    torch.cuda.synchronize()
    print(f"topo analysis: on the shipped mask (salinity integral "
          f"condition) {flags[0]} problem P rows and {flags[1]} S columns "
          f"with a nonzero integral, in {time.perf_counter() - t0:.3f} s "
          f"(the S analysis's test state is one Newton step at Combined "
          f"Forcing 1e-8, its solve asked FGMRES tolerance {EFFORT_TOL:g}, "
          f"where the bundle asks 1e-4, with no GMRES-IR tail: MV "
          f"{o.solve_iters}, true relres {o.solve_relres:.2e}) "
          f"[{card_line}]", flush=True)
    if not o.solve_relres < 1.0:
        raise AssertionError("the S analysis's solve made no progress: "
                             f"{o.solve_relres:.2e}")

    j, i = _open_ocean(mask1, 3, avoid=seamount)
    walled = mask1.copy()
    walled[:, j:j + 3, i:i + 3] = 1
    walled[:, j + 1, i + 1] = 0
    path = os.path.join(tmp, "mask_1_walled_column.txt")
    write_mask_file(path, walled)
    swaps = [0]
    set_land_mask = o.set_land_mask

    def counted(*args, **kw):
        swaps[0] += 1
        return set_land_mask(*args, **kw)

    o.set_land_mask = counted
    t0 = time.perf_counter()
    with _no_gmres_ir_tail():
        fixed = o.get_land_mask(path, adjust_mask=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    interior = fixed[1:-1, 1:-1, 1:-1]
    landed = int(((interior != 0) & (walled == 0)).sum())
    problems = int((analysis.analyze_jacobian1(o) == 2).sum())
    print(f"topo analysis: mask 1 with the water column (j, i) = "
          f"({j + 1}, {i + 1}) walled in: the fix cycle landed {landed} "
          f"cells in {swaps[0] - 1} fixes ({swaps[0]} mask swaps) in "
          f"{wall:.3f} s; {problems} problem P rows after it [{card_line}]",
          flush=True)
    if not ((interior[:, j + 1, i + 1] != 0).all() and problems == 0
            and landed >= walled.shape[0]):
        raise AssertionError("the fix cycle did not land the walled-in "
                             f"column: landed {landed}, {problems} problem "
                             "P rows left")


def _topo_copy(tmp: str, mask1) -> str:
    """Copy run/ocean/global into tmp for run_topo from its shipped mask
    (mask 0) to mask 1, written with the port's write_mask_file.

    What is changed, and why.  The leg starts from rest, x_A, which must
    solve the blended system at Delta 0.  With the bundle's rotation the
    u and v rows are relaxation rows there and the blended Jacobian is
    singular (the pressure is held only up to a constant per water
    column, tests/test_torch_topo.py), so the copy sets Rossby-Number 0,
    where those rows keep their physics; and Wind Forcing 0, since the
    wind drives those rows and rest would not solve them.  Combined
    Forcing TOPO_FORCING (the effort phase's), since at 0 rest is the
    steady state under every mask and the leg does nothing.  The run is
    cut: FGMRES tolerance SOLVE_TOL, as in the main phase, and
    TOPO_STEPS steps in Delta of the bundle's step size, far short of
    Delta 1, of TOPO_NEWTON_ITERS Newton iteration each, unconverged
    points kept, backtracking off, and the step held at the bundle's
    initial 0.05.  A second Newton update stalls: its solve of
    J_h z = -F_h ends at 0.49 and then 1.0 (on the H100), where
    |F_h| (2.6e-2) is what is left of facB |F_B| (|F_B| 401) against
    M (x - x_A), below the f32 operator's rounding.  After one-iteration
    steps the step adaptation doubles the step, and the secant predictor
    then lands at |F_h| 309, whose solves take 200-360 MV to 1e-2 to
    0.13 (on the H100; PERF.md).  Absolute data path, no checkpoint
    files."""
    from iemic_tpu_torch.config import ParameterList, read_xml, write_xml
    from iemic_tpu_torch.post.masks import write_mask_file
    work = os.path.join(tmp, "topo")
    shutil.copytree(BUNDLE, work)
    write_mask_file(os.path.join(work, "mask_1.txt"), mask1)
    op = read_xml(os.path.join(work, "ocean_params.xml"))
    op.set("Data directory", os.path.join(REPO, "data"))
    op.set("Save state", False)
    sp = op.sublist("THCM").sublist("Starting Parameters")
    sp.set("Combined Forcing", TOPO_FORCING)
    sp.set("Rossby-Number", 0.0)
    sp.set("Wind Forcing", 0.0)
    write_xml(op, os.path.join(work, "ocean_params.xml"))
    write_xml(ParameterList("Topo parameters", {
        "Number of mask files": 2,
        "Mask file 0": GLOBAL_THCM["Land Mask"],
        "Mask file 1": "mask_1.txt"}),
        os.path.join(work, "topo_params.xml"))
    cp = read_xml(os.path.join(work, "continuation_params.xml"))
    cp.set("continuation parameter", "Delta")
    cp.set("maximum number of steps", TOPO_STEPS)
    cp.set("maximum Newton iterations", TOPO_NEWTON_ITERS)
    cp.set("maximum step size", cp.get("initial step size"))
    cp.set("reject failed iteration", False)
    cp.set("enable backtracking", False)
    write_xml(cp, os.path.join(work, "continuation_params.xml"))
    sp = read_xml(os.path.join(work, "solver_params.xml"))
    sp.set("FGMRES tolerance", SOLVE_TOL)
    write_xml(sp, os.path.join(work, "solver_params.xml"))
    return work


def _newton_records(info: str) -> tuple[list, list]:
    """From a run's info_0.txt: the solves before the first predictor (the
    initial tangent), and per Newton iteration its parameter, |R|, the
    last Topo line's |F_B| and the solves since the previous one."""
    solves, records, topo_fb = [], [], None
    head = None
    for line in info.splitlines():
        if head is None and "predictor:" in line:
            head, solves = solves, []
        if (mt := re.search(r"FGMRES solve: (\d+) iters, relres=(\S+)",
                            line)):
            solves.append((int(mt.group(1)), float(mt.group(2))))
        elif (mt := re.search(r"Topo: Delta=\S+ \|F_h\|=\S+ \|F_B\|=(\S+)",
                              line)):
            topo_fb = float(mt.group(1))
        elif (mt := re.search(r"Newton iter \d+: \|R\|=(\S+) .* l=(\S+)",
                              line)):
            records.append(dict(par=float(mt.group(2)),
                                F=float(mt.group(1)), FB=topo_fb,
                                solves=solves))
            solves = []
    return (head or []), records


def phase_topo(hopper, card_line: str) -> dict:
    """(a) The mask analysis and fix cycle at full width; (b) run_topo on
    the masked global 96x38x12 grid from its shipped mask to a seamount,
    on the card.  Returns the kernel launches of (b) by entry point."""
    from iemic_tpu_torch.main import run_topo

    mask1, seamount = _topo_mask1()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _topo_analysis(hopper, card_line, mask1, seamount, tmp)
        print(f"topo (a) {time.perf_counter() - t0:.1f} s", flush=True)
        work = _topo_copy(tmp, mask1)
        hopper.reset_launches()
        t0 = time.perf_counter()
        with _no_gmres_ir_tail():
            status, topo, _ = run_topo.run(work, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by_entry = hopper.LAUNCHES, dict(hopper.LAUNCHES_BY_ENTRY)
        info = open(os.path.join(work, "info_0.txt")).read()
        cdata = open(os.path.join(work, "cdata.txt")).read()
        prof = _profile(os.path.join(work, "profile_output"))
    j, i, _ = seamount
    print(f"topo leg (run_topo, masked global 96x38x12, Combined Forcing "
          f"{TOPO_FORCING:g}, Rossby-Number 0, Wind Forcing 0, mask "
          f"{GLOBAL_THCM['Land Mask']} -> the bottom two levels of columns "
          f"(j, i) = ({j + 2}..{j + 3}, {i + 2}..{i + 3}) landed) "
          f"status={status} wall={wall:.1f} s, kernel launches={launches} "
          f"{by_entry} [{card_line}]", flush=True)
    head, records = _newton_records(info)
    print("topo initial tangent solves: MV "
          + " ".join(str(mv) for mv, _ in head) + " | true relres "
          + " ".join(f"{r:.2e}" for _, r in head), flush=True)
    for k, rec in enumerate(records):
        print(f"topo Newton {k + 1}: Delta {rec['par']:.6e} |F_h| "
              f"{rec['F']:.3e} |F_B| {rec['FB']:.3e} | MV "
              + " ".join(str(mv) for mv, _ in rec["solves"])
              + " | true relres "
              + " ".join(f"{r:.2e}" for _, r in rec["solves"]), flush=True)
    for line in cdata.strip().splitlines():
        print("topo cdata " + line, flush=True)
    nits = prof.get("Continuation: Newton iterations...", (0, 0))[0]
    newton_s = prof.get("Continuation: Newton", (0.0, 0))[0]
    for key in ("Ocean: compute rhs", "Ocean: compute jacobian",
                "Ocean: build preconditioner", "Ocean: solve"):
        if key in prof:
            print(f"topo timer {key}: {prof[key][0]:.3f} s over "
                  f"{int(prof[key][1])} calls [{card_line}]", flush=True)
    if nits:
        print(f"topo wall per Newton iteration {newton_s / nits:.3f} s "
              f"({int(nits)} iterations, {launches / nits:.1f} launches "
              f"each) [{card_line}]", flush=True)
    rows = [[float(v) for v in ln.split()] for ln in cdata.splitlines()
            if ln.strip() and not ln.startswith("#")]
    deltas = [r[0] for r in rows]
    print(f"topo: the leg is cut at Delta {deltas[-1] if deltas else 0:.6e}"
          f" of 1 ({TOPO_STEPS} steps of {TOPO_NEWTON_ITERS} Newton "
          f"iteration, FGMRES tolerance {SOLVE_TOL:g})", flush=True)

    if status != 0:
        raise AssertionError(f"run_topo returned {status}")
    if len(rows) != TOPO_STEPS or not all(
            b > a for a, b in zip([0.0] + deltas, deltas)):
        raise AssertionError(f"Delta did not rise step by step: {deltas}")
    if not all(np.isfinite(v) for r in rows for v in r):
        raise AssertionError(f"topo cdata not finite: {rows}")
    solves = head + [s for rec in records for s in rec["solves"]]
    if not solves or not all(np.isfinite(r) and r < SOLVE_TOL
                             for _, r in solves):
        raise AssertionError("a blended solve missed its tolerance "
                             f"{SOLVE_TOL:g}: {solves}")
    if by_entry[MAIN_ENTRY] <= 0 or by_entry[MAIN_ENTRY] != launches:
        raise AssertionError(f"the leg did not go through {MAIN_ENTRY} "
                             f"alone: {by_entry}")
    return by_entry


def _lyapunov_copy(tmp: str, name: str = "lyapunov", grid=None,
                   rails_iters: int | None = None) -> str:
    """Copy run/lyapunov into tmp/name for run_lyapunov, cut to
    LYAPUNOV_STEPS continuation steps, with direct solves (Amesos, host
    LU) in place of the bundle's BGS + Mixed, no checkpoint files (no
    h5py on the card's machine); grid (m, l) and rails_iters cut it
    further for the comparison with the CPU.

    Why direct solves.  With the bundle's BGS + Mixed the continuation's
    Newton solves fall into the GMRES-IR tail, the f32 inner solve
    stalling short of the tolerance: at FGMRES tolerance 1e-4 the next
    inner solve after the tangent's (68 MV to 3.7e-4) stalls at 0.996; at
    5e-2 with the bundle's step 0.1 Newton's fourth solve takes 200 MV to
    1.2e-2 and the fifth stalls; at 5e-2 with step 0.01 the first
    Newton update's second solve stalls (on the H100, PERF.md; the
    sweeps are the JAX package's, ROADMAP queue 3).  So the continuation
    takes direct solves, as the rare-event phase does, and the bundle's
    BGS + Mixed runs one capped solve at the point (phase_lyapunov)."""
    from iemic_tpu_torch.config import ParameterList, read_xml, write_xml
    work = os.path.join(tmp, name)
    shutil.copytree(LYAPUNOV_BUNDLE, work)
    op = read_xml(os.path.join(work, "ocean_params.xml"))
    op.set("Save state", False)
    if grid is not None:
        op.sublist("THCM").set("Global Grid-Size m", grid[0])
        op.sublist("THCM").set("Global Grid-Size l", grid[1])
    write_xml(op, os.path.join(work, "ocean_params.xml"))
    cp = read_xml(os.path.join(work, "continuation_params.xml"))
    cp.set("maximum number of steps", LYAPUNOV_STEPS)
    write_xml(cp, os.path.join(work, "continuation_params.xml"))
    if rails_iters is not None:
        lp = read_xml(os.path.join(work, "lyapunov_params.xml"))
        lp.set("Maximum Iterations", rails_iters)
        write_xml(lp, os.path.join(work, "lyapunov_params.xml"))
    write_xml(ParameterList("Solver parameters", dict(RARE_EVENT_DIRECT)),
              os.path.join(work, "solver_params.xml"))
    return work


def _lyapunov_bgs_solve(hopper, x, par, card_line: str) -> dict:
    """At the point's state, one solve of the bundle's BGS + Mixed on the
    card of the continuation's tangent system J y = -dF/dpar (Combined
    Forcing), held to VARIANT_CAP inner iterations with no GMRES-IR tail:
    MV, true relres, launches by entry point."""
    from iemic_tpu_torch.config import read_xml
    from iemic_tpu_torch.main.run_ocean import read_solver_params
    from iemic_tpu_torch.models.ocean import Ocean
    cwd = os.getcwd()
    os.chdir(LYAPUNOV_BUNDLE)
    try:
        o = Ocean(read_xml("ocean_params.xml"),
                  solver_params=read_solver_params(), device="cuda")
    finally:
        os.chdir(cwd)
    tol = o.solver_params.get("FGMRES tolerance")
    o.set_state(x.cuda())
    o.par = par.cuda()
    cf = o.get_par("Combined Forcing")
    o.compute_rhs()
    F = o.rhs
    o.set_par("Combined Forcing", cf + 1e-6)
    o.compute_rhs()
    o.set_par("Combined Forcing", cf)
    b = -(o.rhs - F) / 1e-6
    o.compute_jacobian()
    hopper.reset_launches()
    t0 = time.perf_counter()
    y = _capped_solve(o, b, VARIANT_CAP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_entry = dict(hopper.LAUNCHES_BY_ENTRY)
    true = _true_relres(o, y, b)
    print(f"lyapunov BGS + Mixed at the point (the bundle's solver, "
          f"tangent system, at most {VARIANT_CAP} inner iterations, no "
          f"GMRES-IR tail): MV {o.solve_iters}, true relres {true:.3e} "
          f"({'within' if true < tol else 'short of'} the bundle's "
          f"{tol:g}), {wall:.3f} s, launches {by_entry} [{card_line}]",
          flush=True)
    entries = {k for k, v in by_entry.items() if v}
    if not (entries and entries <= {MAIN_ENTRY, "stencil_matvec_f32"}
            and bool(torch.isfinite(y).all()) and true < 1.0):
        raise AssertionError(f"lyapunov BGS + Mixed solve: {by_entry}, "
                             f"true relres {true:.3e}")
    return by_entry


def phase_lyapunov(hopper, card_line: str) -> dict:
    """run_lyapunov on its bundle's own grid on the card (direct solves);
    the same run of a smaller cut of the bundle on the card against the
    CPU; and the bundle's BGS + Mixed solve at the first run's point.
    Returns the kernel launches of that solve by entry point."""
    from iemic_tpu_torch.config import read_xml
    from iemic_tpu_torch.main import run_lyapunov

    with tempfile.TemporaryDirectory() as tmp:
        work = _lyapunov_copy(tmp)
        tol = read_xml(os.path.join(work, "solver_params.xml")).get(
            "FGMRES tolerance")
        rtol = read_xml(os.path.join(work, "lyapunov_params.xml")).get(
            "Tolerance")
        t0 = time.perf_counter()
        status, lyap, _ = run_lyapunov.run(work, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        info = open(os.path.join(work, "info_0.txt")).read()
        data = open(os.path.join(work, "lyapunov_data.txt")).read()
        print(f"lyapunov (run_lyapunov, run/lyapunov 4x32x16, "
              f"{LYAPUNOV_STEPS} continuation step, direct solves) "
              f"status={status} wall={wall:.1f} s [{card_line}]",
              flush=True)
        solves = [(int(a), float(b)) for a, b in re.findall(
            r"FGMRES solve: (\d+) iters, relres=(\S+)", info)]
        newton = re.findall(r"Newton iter \d+: \|R\|=(\S+)", info)
        print("lyapunov Newton |F| " + " ".join(newton) + " | relres "
              + " ".join(f"{r:.2e}" for _, r in solves), flush=True)
        for line in data.strip().splitlines():
            print("lyapunov data " + line, flush=True)
        for r in lyap.results:
            spec = r["spectrum"]
            print(f"lyapunov point par {r['par']:.6e}: trace "
                  f"{r['trace']:.6e}, rails {r['iterations']} iterations, "
                  f"residual estimate {r['resnorm']:.3e}, "
                  f"{'converged' if r['converged'] else 'NOT converged'} "
                  f"at the bundle's tolerance {rtol:g} of |B B^T|, "
                  f"spectrum {spec[0]:.4e} {spec[1]:.4e} "
                  f"{spec[2]:.4e} ... min {spec.min():.3e}; seconds: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in
                              r["seconds"].items()) + f" [{card_line}]",
                  flush=True)

        if status != 0:
            raise AssertionError(f"run_lyapunov returned {status}")
        if not solves or not all(np.isfinite(r) and r < tol
                                 for _, r in solves):
            raise AssertionError(f"a solve missed its tolerance {tol:g}: "
                                 f"{solves}")
        if len(lyap.results) != LYAPUNOV_STEPS:
            raise AssertionError(f"{len(lyap.results)} covariance solves")
        for r in lyap.results:
            spec = r["spectrum"]
            if not (np.isfinite(r["trace"]) and r["trace"] > 0
                    and np.all(np.isfinite(spec))
                    and spec.min() >= -1e-8 * max(1.0, abs(spec[0]))):
                raise AssertionError(f"covariance at par {r['par']}: trace "
                                     f"{r['trace']}, spectrum {spec}")

        x, par = lyap.get_state().cpu(), lyap.par.cpu()

        # card against CPU: the same run of the copy cut to
        # LYAPUNOV_CHECK_GRID and LYAPUNOV_CHECK_ITERS rails iterations
        runs = {}
        for device in ("cuda", "cpu"):
            small = _lyapunov_copy(tmp, "check_" + device,
                                   LYAPUNOV_CHECK_GRID, LYAPUNOV_CHECK_ITERS)
            t0 = time.perf_counter()
            st, model, _ = run_lyapunov.run(small, device)
            if device == "cuda":
                torch.cuda.synchronize()
            runs[device] = (st, model.results[0], time.perf_counter() - t0)
    (st_card, got, t_card), (st_cpu, want, t_cpu) = (runs["cuda"],
                                                     runs["cpu"])
    gap_trace = abs(got["trace"] - want["trace"]) / abs(want["trace"])
    gap_spec = (np.abs(got["spectrum"] - want["spectrum"]).max()
                / abs(want["spectrum"][0]))
    m, l = LYAPUNOV_CHECK_GRID
    print(f"lyapunov card against CPU: run_lyapunov on the copy cut to "
          f"4x{m}x{l}, {LYAPUNOV_CHECK_ITERS} rails iterations, point par "
          f"{got['par']:.10e} against {want['par']:.10e}: trace "
          f"{got['trace']:.10e} against {want['trace']:.10e} (gap "
          f"{gap_trace:.2e}), spectrum gap {gap_spec:.2e} of its largest "
          f"(limit {LYAPUNOV_CHECK_TOL:g}); card {t_card:.1f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in got["seconds"].items())
          + f"), CPU {t_cpu:.1f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in want["seconds"].items())
          + f") [{card_line}]", flush=True)
    if not (st_card == 0 and st_cpu == 0
            and abs(got["par"] - want["par"]) <= 1e-10 * abs(want["par"])
            and gap_trace <= LYAPUNOV_CHECK_TOL
            and gap_spec <= LYAPUNOV_CHECK_TOL
            and got["iterations"] == want["iterations"]):
        raise AssertionError("the card's covariance disagrees with the "
                             f"CPU's: trace gap {gap_trace:.2e}, spectrum "
                             f"gap {gap_spec:.2e}")
    return _lyapunov_bgs_solve(hopper, x, par, card_line)


def _aquaplanet_copy(tmp: str, name: str, grid=None) -> str:
    """Copy run/aquaplanet into tmp/name, no state file (the card's
    machine has no h5py), the grid cut to grid = (n, m, l) where given.

    What is cut at full width, and why.  Continuation: one step
    ("maximum number of steps" 1, bundle 500) and no retry of a rejected
    step ("minimum step size" the initial step: from rest the bundle's
    first step fails and retries at halved steps down to 1e-8, 20 resets
    in both packages on run/coupled's 6x6x4 cut), with the predictor
    bound COUPLED_PREDICTOR_BOUND (default 1e3), of at most
    COUPLED_NEWTON_ITERS Newton iterations (bundle 8): from rest the
    coupled Newton is erratic, |F| 368 -> 4 -> 4710 -> 968 on the 16x8x4
    cut on the CPU, with solves that end at the 200-iteration cap.
    Time stepping: COUPLED_TIME_STEPS steps (bundle 100), "HDF5 output
    frequency" 0 (the coupled model writes no state file anyway).  The
    grid, the schemes, FGMRES 1e-3 and 200 iterations are the bundle's."""
    from iemic_tpu_torch.config import read_xml, write_xml
    work = os.path.join(tmp, name)
    shutil.copytree(AQUAPLANET, work)

    def edit(fname, fn):
        p = read_xml(os.path.join(work, fname))
        fn(p)
        write_xml(p, os.path.join(work, fname))

    def ocean(p):
        p.set("Save state", False)
        if grid:
            t = p.sublist("THCM")
            for k, v in zip("nml", grid):
                t.set(f"Global Grid-Size {k}", v)

    def surface(p):
        if grid:
            p.set("Global Grid-Size n", grid[0])
            p.set("Global Grid-Size m", grid[1])

    def continuation(p):
        p.set("maximum number of steps", 1)
        p.set("minimum step size", p.get("initial step size"))
        p.set("maximum Newton iterations", COUPLED_NEWTON_ITERS)
        p.set("predictor bound", COUPLED_PREDICTOR_BOUND)

    def stepper(p):
        p.set("number of time steps", COUPLED_TIME_STEPS)
        p.set("HDF5 output frequency", 0)

    edit("ocean_params.xml", ocean)
    edit("atmosphere_params.xml", surface)
    edit("seaice_params.xml", surface)
    edit("continuation_params.xml", continuation)
    edit("timestepper_params.xml", stepper)
    return work


def _coupled_pieces(c, seed: int = 0) -> tuple[dict, int]:
    """F, J v and the six coupling blocks at a seeded small state (numpy
    inputs, sea-ice mask nonzero), and at rest, where the bundle starts,
    one application of the ocean's f64 BGS sweep and the first Newton
    solve (J x = -F, driven by the sea ice's background fluxes), as
    numpy; and the solve's (iterations, true relres, tolerance)."""
    from iemic_tpu_torch import interop
    rng = np.random.default_rng(seed)
    c.set_state(interop.tensor(0.05 * rng.standard_normal(c.dim), c.device))
    c.compute_rhs()
    c.compute_jacobian()
    out = {"F": c.get_rhs()}
    v = interop.tensor(rng.standard_normal(c.dim), c.device)
    out["J v"] = c.apply_matrix(v)
    parts = c.split(v)
    for i in range(3):
        for j in range(3):
            if i != j:
                out[f"C{i}{j} v"] = c.coupling_apply(i, j, parts[j])
    c.set_state(torch.zeros_like(c.get_state()))
    c.compute_rhs()
    c.compute_jacobian()
    # the pressure modes the coupled solve deflates from the ocean block
    q = c.ocean._get_deflator()
    out["null modes"] = q if q is not None else c.get_state()[:0]
    out["BGS sweep"] = c._model_precon(0, parts[0])
    out["solve"] = c.solve(-c.get_rhs())
    return ({k: t.cpu().numpy() for k, t in out.items()},
            (c.solve_iters, c.solve_relres, c.solve_tol))


def _coupled_check(tmp: str, card_line: str) -> None:
    """(a) the card against the CPU on the cut aquaplanet."""
    from iemic_tpu_torch.models.coupled import build_coupled_from_files
    work = _aquaplanet_copy(tmp, "check", COUPLED_CHECK_GRID)
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[device] = _coupled_pieces(
            build_coupled_from_files(work, device=device))
        runs[device] += (time.perf_counter() - t0,)
    (got, (its_card, rel_card, tol), t_card), (ref, (its_cpu, rel_cpu, _),
                                               t_cpu) = (runs["cuda"],
                                                         runs["cpu"])
    gaps = {k: float(np.abs(got[k] - ref[k]).max(initial=0.0)
                     / max(np.abs(ref[k]).max(initial=0.0), 1e-300))
            for k in ref}
    n, m, l = COUPLED_CHECK_GRID
    modes = got["null modes"].shape[-1], ref["null modes"].shape[-1]
    print(f"coupled card against CPU, run/aquaplanet cut to {n}x{m}x{l}: "
          f"pressure modes deflated {modes[0]} on the card, {modes[1]} on "
          f"the CPU; "
          + ", ".join(f"{k} {g:.2e}" for k, g in gaps.items())
          + f" (limit {COUPLED_CHECK_TOL:g}, the BGS sweep and the solve "
          f"{tol:g}); solve {its_card} iterations to true relres "
          f"{rel_card:.3e} on the card, {its_cpu} to {rel_cpu:.3e} on the "
          f"CPU; card {t_card:.1f} s, CPU {t_cpu:.1f} s [{card_line}]",
          flush=True)
    # the BGS sweep's inner Krylov solves stop on tolerances, so where
    # rounding moves an inner iterate across one the two sweeps part; the
    # sweep and the solve built on it are held to the solve's tolerance
    exact = [k for k in gaps if k not in ("BGS sweep", "solve")]
    if not (modes[0] == modes[1]
            and all(gaps[k] <= COUPLED_CHECK_TOL for k in exact)
            and gaps["BGS sweep"] <= tol and gaps["solve"] <= tol
            and max(rel_card, rel_cpu) <= tol
            and abs(its_card - its_cpu) <= 2):
        raise AssertionError(f"the coupled model on the card disagrees "
                             f"with the CPU: {gaps}, {its_card} against "
                             f"{its_cpu} iterations")


_COUPLED_SOLVE = re.compile(
    r"CoupledModel: FGMRES (\d+) iters, relres=(\S+) \(estimate (\S+), "
    r"tolerance (\S+)\) in (\S+) s")


def _coupled_solves(info: str) -> list[tuple[int, float, float, float]]:
    """(iterations, true relres, tolerance, seconds) of every coupled
    solve in a run's info_0.txt."""
    return [(int(a), float(b), float(d), float(e))
            for a, b, _, d, e in _COUPLED_SOLVE.findall(info)]


def _print_solves(what: str, solves) -> None:
    for k, (its, rel, tol, sec) in enumerate(solves):
        print(f"{what} solve {k + 1}: {its} iterations, true relres "
              f"{rel:.3e} ({'reached' if rel <= tol else 'STALLED short of'}"
              f" {tol:g}), {sec:.3f} s", flush=True)


def _synced(fn, reps: int = 3) -> float:
    """Median wall seconds of fn() between two synchronisations."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return float(np.median(out))


def _coupled_split(c, card_line: str) -> None:
    """One coupled FGMRES iteration at full width taken apart with
    synchronised timers, at the model's last Jacobian: the ocean's f64
    matvec and BGS apply, the atmosphere's LU solve, the sea ice's solve,
    each coupling block, and the host's Arnoldi (a solve of
    COUPLED_SPLIT_ITERS iterations less its matvecs and preconditioner
    applications)."""
    from iemic_tpu_torch import interop
    rng = np.random.default_rng(1)
    v = interop.tensor(rng.standard_normal(c.dim), c.device)
    parts = c.split(v)
    t_jac = _synced(c.compute_jacobian, 1)
    t_blocks = _synced(lambda: [c._block(i, j) for i in range(3)
                                for j in range(3) if i != j], 1)
    t_factors = _synced(lambda: c._model_precon(0, parts[0]), 1)
    t_lu = _synced(lambda: c.atmos.solve(parts[1]), 1)
    pieces = {
        "ocean f64 matvec": _synced(lambda: c.ocean.apply_matrix(parts[0])),
        "ocean BGS apply": _synced(lambda: c._model_precon(0, parts[0])),
        "atmosphere LU solve": _synced(lambda: c.atmos.solve(parts[1])),
        "sea-ice solve": _synced(lambda: c.seaice.solve(parts[2])),
    }
    for i in range(3):
        for j in range(3):
            if i != j:
                pieces[f"coupling C{i}{j}"] = _synced(
                    lambda i=i, j=j: c.coupling_apply(i, j, parts[j]))
    spent = {"mv": 0.0, "pc": 0.0}
    mv, pc = c.apply_matrix, c.apply_precon

    def timed(key, fn):
        def call(x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(x)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            return y
        return call

    c.apply_matrix, c.apply_precon = timed("mv", mv), timed("pc", pc)
    tol, iters = c.fgmres_tol, c.fgmres_iters
    c.fgmres_tol, c.fgmres_iters = 1e-14, COUPLED_SPLIT_ITERS
    try:
        total = _synced(lambda: c.solve(v), 1)
    finally:
        c.apply_matrix, c.apply_precon = mv, pc
        c.fgmres_tol, c.fgmres_iters = tol, iters
    n_it = c.solve_iters
    # the solve applies the matrix once more for its true residual
    pieces["host Arnoldi"] = (total - spent["mv"] - spent["pc"]) / n_it
    per_it = (total - spent["mv"] / (n_it + 1)) / n_it
    print(f"coupled iteration split at 64x32x12 (seconds; per-Jacobian: "
          f"Jacobian {t_jac:.3f}, coupling blocks {t_blocks:.3f}, ocean "
          f"factors and first BGS apply {t_factors:.3f}, atmosphere LU "
          f"factor and first solve {t_lu:.3f}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in pieces.items())
          + f"; one coupled FGMRES iteration {per_it:.4f} ({n_it} "
          f"iterations: matvec {spent['mv'] / (n_it + 1):.4f}, "
          f"preconditioner {spent['pc'] / n_it:.4f}) [{card_line}]",
          flush=True)


def phase_coupled(hopper, card_line: str) -> dict:
    """(a) the card against the CPU on the cut aquaplanet; (b) run_coupled
    and (c) time_coupled on run/aquaplanet at full width on the card.
    Returns the kernel launches of (b) and (c) by entry point: none, as
    the coupled path runs f64 throughout."""
    from iemic_tpu_torch.main import run_coupled, time_coupled

    with tempfile.TemporaryDirectory() as tmp:
        _coupled_check(tmp, card_line)

        work = _aquaplanet_copy(tmp, "full")
        hopper.reset_launches()
        t0 = time.perf_counter()
        status, cpl, cont = run_coupled.run(work, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        info = open(os.path.join(work, "info_0.txt")).read()
        cdata = open(os.path.join(work, "cdata.txt")).read()
        print(f"coupled run_coupled on run/aquaplanet (64x32x12, C/F, BGS "
              f"ocean, FGMRES 1e-3 / 200) from rest: status={status} "
              f"wall={wall:.1f} s [{card_line}]", flush=True)
        solves = _coupled_solves(info)
        _print_solves("coupled", solves)
        newton = re.findall(r"(?:Newton iter \d+: \|R\|=|norm too big! )"
                            r"(\S+)", info)
        pred = re.findall(r"predictor: .*\|rhs\|=(\S+)", info)
        rows = [ln for ln in cdata.splitlines()
                if ln.strip() and not ln.startswith("#")]
        outcome = ("accepted" if rows else "rejected: "
                   + "; ".join(sorted(set(re.findall(
                       r"(norm too big|Newton failed after \d+ steps|"
                       r"Reached dsMin|dx\| = \S+ >> old)", info)))))
        print(f"coupled step: |F| predictor {' '.join(pred)} | after each "
              f"Newton iteration {' '.join(newton)} ({len(newton)} Newton "
              f"iterations); step {outcome}", flush=True)
        for line in cdata.strip().splitlines():
            print("coupled cdata " + line, flush=True)
        _coupled_split(cpl, card_line)
        x = cpl.get_state()
        finite = bool(torch.isfinite(x).all())
        del cpl, cont

        work = os.path.join(tmp, "full")
        t0 = time.perf_counter()
        tstatus, tcpl, _ = time_coupled.run(work, "cuda")
        torch.cuda.synchronize()
        twall = time.perf_counter() - t0
        by_entry = dict(hopper.LAUNCHES_BY_ENTRY)
        tinfo = open(os.path.join(work, "info_0.txt")).read()
        tdata = [ln.split() for ln in
                 open(os.path.join(work, "tdata.txt")).read().splitlines()
                 if ln.strip() and not ln.startswith("#")]
        steps = tinfo.split("Timestepping: t =")[1:]
        print(f"coupled time_coupled on run/aquaplanet (64x32x12) from "
              f"rest, {COUPLED_TIME_STEPS} theta steps: status={tstatus} "
              f"wall={twall:.1f} s [{card_line}]", flush=True)
        for k, block in enumerate(steps):
            ss = _coupled_solves(block)
            nr = len(re.findall(r"Newton iter \d+:", block))
            newton_ok = "did not converge" not in block
            print(f"coupled time step attempt {k + 1}: dt "
                  f"{block.split('dt =')[1].split()[0]}, NR {nr}, MV "
                  f"{sum(s[0] for s in ss)} (per solve "
                  f"{' '.join(str(s[0]) for s in ss)}), solves "
                  f"{sum(s[3] for s in ss):.3f} s, Newton "
                  f"{'converged' if newton_ok else 'did not converge'}",
                  flush=True)
        for row in tdata:
            print("coupled tdata " + " ".join(row), flush=True)
        tfinite = bool(torch.isfinite(tcpl.get_state()).all())

    if not solves or not all(np.isfinite(r) for _, r, _, _ in solves):
        raise AssertionError(f"a coupled solve is not finite: {solves}")
    if not (finite and all(np.isfinite(float(v)) for v in newton)):
        raise AssertionError("the coupled continuation's state or |F| is "
                             "not finite")
    if sum(by_entry.values()):
        raise AssertionError(f"the coupled path launched the f32 kernel: "
                             f"{by_entry}")
    if not (tstatus == 0 and len(tdata) == COUPLED_TIME_STEPS and tfinite):
        raise AssertionError(f"time_coupled returned {tstatus} after "
                             f"{len(tdata)} of {COUPLED_TIME_STEPS} steps")
    return by_entry


def _assembly_gaps(ops, o, x) -> tuple[float, float]:
    """The relative gaps of make_sharded_ops' partitioned F and An (one
    rank) to Ocean._rhs and Ocean._jacobian at x."""
    F, An = ops["rhs"](x, o.par), ops["jac"](x, o.par)
    Fs, As = o._rhs(x, o.par), o._jacobian(x, o.par)
    return (float((F - Fs).abs().max() / Fs.abs().max()),
            float((An - As).abs().max() / As.abs().max()))


def _print_step(tag: str, step: dict, card_line: str) -> None:
    """A continuation step's solves and its seconds per Newton
    iteration."""
    solves = " ".join(f"{mv} MV {rr:.3e} {sec:.3f} s"
                      for mv, rr, sec in step["solves"])
    newton = max(step["newton"], 1)
    print(f"{tag}: status {step['status']}, {step['steps']} step, "
          f"{step['newton']} Newton iterations, par {step['par']:.10e}, "
          f"{step['seconds']:.3f} s ({step['seconds'] / newton:.3f} s per "
          f"Newton iteration); residual {np.mean(step['rhs_s']):.3f} s, "
          f"Jacobian {np.mean(step['jac_s']):.3f} s per call; solves "
          f"(MV, relres, s): {solves} [{card_line}]", flush=True)


def _print_bgs(tag: str, stats: dict, peak, card_line: str) -> None:
    """A partitioned BGS preconditioner's per-rank line."""
    from iemic_tpu_torch.parallel.bgs import format_stats
    mem = "not measured" if peak is None else f"{peak / 1e9:.3f} GB"
    print(f"{tag}: {format_stats(stats)}; peak device memory {mem} "
          f"[{card_line}]", flush=True)


def _parallel_one_rank(multichip, card_line: str):
    """(a): one NCCL rank on the card, a 1x1 Domain of the masked global
    model at the effort phase's state.  The sharded ops are made before
    any Jacobian, so the Double solve deflates nothing, as the dry run's
    stage 1; the Mixed solve after it, as stage 2.  The partitioned F and
    An against the serial ones there and at a random state; the dry run's
    stage 3 at PARALLEL_GRID (a ShardedOcean continuation step) against
    the serial Continuation on an Ocean with the same solver parameters
    (ShardedOcean.solve is Ocean.solve); the
    partitioned sweeps of PARALLEL_SWEEPS.  Returns F, the Jacobian, the
    Double solve's update, the step and the sweeps (by name: the sweep
    and the stats), for (b)."""
    import torch.distributed as dist
    from iemic_tpu_torch.continuation import Continuation
    from iemic_tpu_torch.models.ocean import Ocean
    from iemic_tpu_torch.parallel import Domain, make_sharded_ops
    from iemic_tpu_torch.parallel.bgs import PartitionedBGS, int_row_of
    from iemic_tpu_torch.parallel.halo import make_sharded_solve
    from iemic_tpu_torch.parallel.multihost import initialize_environment

    tol1, tol2 = multichip.STAGE1_TOL, multichip.STAGE2_TOL
    with tempfile.TemporaryDirectory() as tmp:
        initialize_environment("nccl", init_method=f"file://{tmp}/store",
                               world_size=1, rank=0, timeout_s=300.0)
        dom = Domain(*PARALLEL_GRID, periodic=True, device="cuda")
        o = Ocean({"THCM": dict(GLOBAL_THCM)}, solver_params={
            "Preconditioning": "BGS", "Precision": "Double",
            "FGMRES tolerance": tol1,
            "FGMRES iterations": multichip.STAGE1_ITERS},
            data_dir=os.path.join(REPO, "data"), device=dom.device)
        ops = make_sharded_ops(o, dom)
        x = dom.shard_state(o.state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        F = ops["rhs"](x, o.par)
        An = ops["jac"](x, o.par)
        torch.cuda.synchronize()
        fsec = time.perf_counter() - t0
        xr = o._tensor(0.01 * np.random.default_rng(PARALLEL_SEED)
                       .standard_normal(tuple(o.state.shape)))
        gaps = {"effort": _assembly_gaps(ops, o, x),
                "random": _assembly_gaps(ops, o, xr)}
        rhs_s = multichip._seconds(lambda: ops["rhs"](xr, o.par), dom.device,
                                   3)
        jac_s = multichip._seconds(lambda: ops["jac"](xr, o.par), dom.device,
                                   3)
        o.compute_rhs()
        o.compute_jacobian()
        y = ops["matvec"](An, -F)
        ref = o.apply_matrix(-o.rhs)
        gap = float((y - ref).abs().max() / ref.abs().max())
        sweeps = {}
        for name, (opts, build, _) in PARALLEL_SWEEPS.items():
            torch.cuda.reset_peak_memory_stats()
            prec = PartitionedBGS(An, o.landm, dom,
                                  int_row=int_row_of(o, float(o.cfg.int_sign)),
                                  apply_opts=opts, build_opts=build,
                                  held=(An,))
            z = prec(-F)
            sweeps[name] = (z.cpu().numpy(), prec.stats(),
                            torch.cuda.max_memory_allocated())
            del prec
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = ops["solve"](An, -F, tol1, multichip.STAGE1_ITERS)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        double = (multichip._bgs_stats(ops["solve"]),
                  torch.cuda.max_memory_allocated())
        true = float(torch.linalg.norm(F + ops["matvec"](An, res.x))
                     / torch.linalg.norm(F))
        t0 = time.perf_counter()
        zs = o.solve(-o.rhs)
        torch.cuda.synchronize()
        ssec = time.perf_counter() - t0
        strue = float(torch.linalg.norm(o.rhs + o.apply_matrix(zs))
                      / torch.linalg.norm(o.rhs))
        mixed = make_sharded_solve(o, dom, precision="Mixed",
                                   apply_opts=multichip.STAGE2_APPLY,
                                   inner_tol=multichip.STAGE2_INNER_TOL)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res2 = mixed(dom.shard_stencil(o.jac), dom.shard_state(-o.rhs), tol2,
                     multichip.STAGE2_ITERS)
        torch.cuda.synchronize()
        msec = time.perf_counter() - t0
        mixed_bgs = (multichip._bgs_stats(mixed),
                     torch.cuda.max_memory_allocated())
        backend = dom.backend

        # the dry run's stage 3 at PARALLEL_GRID, and the serial step
        thcm3, solver3 = multichip.stage3_config(PARALLEL_GRID, (1, 1))
        step = multichip.sharded_continuation(dom, thcm3, solver3,
                                              multichip.STAGE3_CONT)
        so = Ocean({"THCM": dict(thcm3)}, solver_params=dict(solver3),
                   data_dir=os.path.join(REPO, "data"), device=dom.device)
        t0 = time.perf_counter()
        sres = Continuation(so, dict(multichip.STAGE3_CONT)).run()
        torch.cuda.synchronize()
        step_serial_s = time.perf_counter() - t0
        spar = so.get_par(multichip.STAGE3_CONT["continuation parameter"])
        sx = so.state.cpu().numpy()
        dist.destroy_process_group()
    print(f"parallel (a) one rank over {backend}, 1x1 Domain of the masked "
          f"global {PARALLEL_GRID} at the effort state: residual and "
          f"Jacobian {fsec:.3f} s, sharded f64 matvec against "
          f"Ocean.apply_matrix {gap:.3e} (limit {PARALLEL_MATVEC_TOL:g}) "
          f"[{card_line}]", flush=True)
    for name, (fg, jg) in gaps.items():
        print(f"parallel (a) partitioned assembly at the {name} state: F "
              f"gap {fg:.3e}, An gap {jg:.3e} to Ocean._rhs/_jacobian "
              f"(limit {PARALLEL_ASSEMBLY_TOL:g})", flush=True)
    print(f"parallel (a) partitioned residual {rhs_s:.4f} s, Jacobian "
          f"{jac_s:.4f} s at the random state [{card_line}]", flush=True)
    print(f"parallel (a) sharded Double solve (tol {tol1:g}): {res.mv} MV, "
          f"relres {res.relres:.3e}, true relres {true:.3e}, {sec:.3f} s; "
          f"serial Ocean.solve Double (row-scaled, default BGS): "
          f"{o.solve_iters} MV, relres {o.solve_relres:.3e}, unscaled true "
          f"relres {strue:.3e}, {ssec:.3f} s [{card_line}]", flush=True)
    print(f"parallel (a) sharded Mixed solve (tol {tol2:g}): {res2.mv} MV, "
          f"{res2.outer} outer, relres {res2.relres:.3e}, {msec:.3f} s "
          f"[{card_line}]", flush=True)
    _print_bgs("parallel (a) Double solve's", *double, card_line)
    _print_bgs("parallel (a) Mixed solve's", *mixed_bgs, card_line)
    for name, (_, stats, peak) in sweeps.items():
        _print_bgs(f"parallel (a) sweep of -F, {name}", stats, peak,
                   card_line)
    _print_step("parallel (a) ShardedOcean continuation step", step,
                card_line)
    _print_bgs("parallel (a) ShardedOcean step's", step["bgs"], None,
               card_line)
    par_gap = abs(step["par"] - spar)
    state_gap = float(np.abs(step["state"] - sx).max()
                      / max(np.abs(sx).max(), 1e-300))
    print(f"parallel (a) serial Continuation on Ocean: status "
          f"{sres.status}, {sres.sum_newton_iters} Newton iterations, "
          f"{step_serial_s:.3f} s, solves (MV, relres) {so.solve_log}; "
          f"against the ShardedOcean step: par {par_gap:.3e}, state "
          f"{state_gap:.3e} (limit {PARALLEL_STEP_TOL:g})", flush=True)
    if not gap <= PARALLEL_MATVEC_TOL:
        raise AssertionError(f"parallel (a): sharded matvec gap {gap:.3e}")
    if not all(g <= PARALLEL_ASSEMBLY_TOL for pair in gaps.values()
               for g in pair):
        raise AssertionError(f"parallel (a): partitioned assembly {gaps}")
    if not (res.relres <= tol1 and true <= 2 * tol1
            and res2.relres <= tol2):
        raise AssertionError(f"parallel (a): a sharded solve missed its "
                             f"tolerance ({true:.3e}, {res2.relres:.3e})")
    if not (step["status"] == sres.status == 0 and step["steps"] == 1
            and par_gap <= PARALLEL_STEP_TOL
            and state_gap <= PARALLEL_STEP_TOL):
        raise AssertionError("parallel (a): the ShardedOcean step is not "
                             "the serial one")
    return -F, o.apply_matrix, res.x, step, sweeps


def _parallel_sweeps(out, k0: int, sweeps: dict, card_line: str) -> None:
    """(b)'s partitioned sweeps (job_bgs results from job k0 on) against
    (a)'s one-rank sweeps, per rank grid of PARALLEL_SHAPES, and each
    rank's bytes against (a)'s / PARALLEL_RANKS plus its pieces held
    whole."""
    names = list(PARALLEL_SWEEPS)
    for k, shape in enumerate(PARALLEL_SHAPES):
        for rank, r in enumerate(out):
            res = r[k0 + k]
            for name, sw in zip(names, res["sweeps"]):
                z1, stats1, _ = sweeps[name]
                st = sw["stats"]
                gap = float(np.abs(sw["z"] - z1).max() / np.abs(z1).max())
                bound = stats1["bytes"] / PARALLEL_RANKS \
                    + st["replicated_bytes"]
                _print_bgs(f"parallel (b) {shape[0]}x{shape[1]} rank {rank} "
                           f"({res['ry']},{res['rx']}) sweep of -F, {name}",
                           st, res["peak"], card_line)
                print(f"parallel (b) {shape[0]}x{shape[1]} rank {rank} "
                      f"sweep of -F, {name}: against (a)'s {gap:.3e} (limit "
                      f"{PARALLEL_SWEEPS[name][2]:g}); {st['bytes']} bytes, "
                      f"(a)'s / {PARALLEL_RANKS} plus the pieces held whole "
                      f"{bound:.0f}", flush=True)
                if not (np.isfinite(sw["z"]).all()
                        and gap <= PARALLEL_SWEEPS[name][2]):
                    raise AssertionError(f"parallel (b) {shape}: the "
                                         f"partitioned sweep ({name}) is "
                                         f"{gap:.3e} from (a)'s")
                if not (st["bytes"] <= bound and st["build_gathers"] == 0):
                    raise AssertionError(f"parallel (b) {shape}: rank "
                                         f"{rank} holds {st['bytes']} bytes "
                                         f"or gathered in its build")


def _methods_solver(method: str, precision: str, tol: float,
                    iters: int = METHODS_ITERS) -> dict:
    return {"Preconditioning": method, "Precision": precision,
            "FGMRES tolerance": tol, "FGMRES iterations": iters,
            "Matvec kernel": "xla"}


def _methods_one_rank(thcm: dict, cases, iters: int, card_line: str,
                      tag: str) -> tuple[dict, object]:
    """(d1) and the one-rank half of (d3): on one NCCL rank, for each
    (method, precision, tol) of cases, ShardedOcean.solve of J x = -F at
    the model's starting state against Ocean.solve on the same solver
    parameters: the same MV and the iterate within METHODS_SAME.  Returns
    each case's MV, relres and seconds, and the serial model (its F and
    Jacobian, for the true residuals of (d2))."""
    import torch.distributed as dist
    from iemic_tpu_torch.models.ocean import Ocean
    from iemic_tpu_torch.parallel import Domain, ShardedOcean
    from iemic_tpu_torch.parallel.methods import format_stats
    from iemic_tpu_torch.parallel.multihost import initialize_environment

    data = os.path.join(REPO, "data")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        initialize_environment("nccl", init_method=f"file://{tmp}/store",
                               world_size=1, rank=0, timeout_s=300.0)
        try:
            dom = Domain(*(thcm[f"Global Grid-Size {k}"] for k in "nml"),
                         periodic=thcm["Periodic"], device="cuda")
            o = Ocean({"THCM": dict(thcm)}, data_dir=data,
                      device=dom.device)
            o.compute_rhs()
            o.compute_jacobian()
            for method, precision, tol in cases:
                solver = _methods_solver(method, precision, tol, iters)
                _set_solver(o, {}, **solver)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                z = o.solve(-o.rhs)
                torch.cuda.synchronize()
                ssec = time.perf_counter() - t0
                so = ShardedOcean(o, dom)
                so.compute_rhs()
                so.compute_jacobian()
                t0 = time.perf_counter()
                zs = so.solve(-so.rhs)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                gap = float((zs - z).abs().max() / z.abs().max())
                stats = so._solve.preconditioner().stats()
                print(f"parallel {tag} {method}/{precision} (tol {tol:g}, "
                      f"{iters} iterations) on one rank over "
                      f"{dom.backend}: {so.solve_iters} MV "
                      f"({so.solve_sweeps} refinement sweeps, "
                      f"{so.solve_outer} tail iterations), relres "
                      f"{so.solve_relres:.3e}, {sec:.3f} s; Ocean.solve "
                      f"{o.solve_iters} MV, relres {o.solve_relres:.3e}, "
                      f"{ssec:.3f} s; iterate gap {gap:.3e} (limit "
                      f"{METHODS_SAME:g}); {format_stats(stats)} "
                      f"[{card_line}]", flush=True)
                if not (so.solve_iters == o.solve_iters
                        and gap <= METHODS_SAME):
                    raise AssertionError(
                        f"parallel {tag} {method}/{precision}: "
                        f"ShardedOcean.solve {so.solve_iters} MV, gap "
                        f"{gap:.3e} to Ocean.solve's {o.solve_iters} MV")
                out[method, precision] = {"mv": so.solve_iters,
                                          "relres": so.solve_relres,
                                          "seconds": sec,
                                          "z": zs.cpu().numpy()}
                del so
        finally:
            dist.destroy_process_group()
    return out, o


def _methods_four_ranks(rows: list, one: dict, o, cases, tag: str,
                        card_line: str) -> None:
    """(d2) and the four-rank half of (d3): each rank's MV, relres,
    seconds, message rounds and gathers per application, the bytes
    gathered, against the one-rank solves one; o is the serial model of
    the one-rank solves (F and J, for the true residuals)."""
    from iemic_tpu_torch.parallel.methods import format_stats
    from iemic_tpu_torch.solvers.factory import HOST_METHODS as HOST
    for (method, precision, tol), per_rank in zip(cases, rows):
        ref = one[method, precision]
        z = torch.as_tensor(per_rank[0]["z"], device=o.jac.device)
        true = float(torch.linalg.norm(o.apply_matrix(z) + o.rhs)
                     / torch.linalg.norm(o.rhs))
        relres = per_rank[0]["relres"]
        for rank, r in enumerate(per_rank):
            print(f"parallel {tag} {method}/{precision} rank {rank} of 2x2 "
                  f"over gloo: {r['mv']} MV (one rank {ref['mv']}; "
                  f"{r['sweeps']} refinement sweeps, {r['outer']} tail "
                  f"iterations), relres "
                  f"{r['relres']:.3e} (one rank {ref['relres']:.3e}), "
                  f"{r['seconds']:.3f} s, {r['gathers']} gathers in the "
                  f"solve; {format_stats(r['prec'])} [{card_line}]",
                  flush=True)
        z1 = ref["z"]
        xgap = float(np.abs(per_rank[0]["z"] - z1).max() / np.abs(z1).max())
        scaled = _true_relres(o, z, -o.rhs)
        print(f"parallel {tag} {method}/{precision} on 2x2: true relres of "
              f"the gathered iterate {true:.3e} unscaled, {scaled:.3e} of "
              f"the row-scaled, deflated system (the solve's relres "
              f"{relres:.3e}), iterate against one rank's {xgap:.3e}",
              flush=True)
        same_mv = all(r["mv"] == per_rank[0]["mv"] for r in per_rank)
        if method in HOST:
            counted = all(r["gathers"] == 1 + r["prec"]["applications"]
                          and r["prec"]["rounds_per_apply"] == 2
                          for r in per_rank)
            if method == "Amesos":
                ok = per_rank[0]["mv"] == ref["mv"] and xgap <= HOST_SAME
            else:
                spread = (ref["mv"], ref["cpu_mv"])
                ok = (min(spread) - MILU_MV_SLACK <= per_rank[0]["mv"]
                      <= max(spread) + MILU_MV_SLACK and scaled <= 2 * tol)
            ok = ok and relres <= tol
        else:
            counted = all(r["gathers"] == r["prec"]["build_gathers"] == 0
                          for r in per_rank)
            capped = ref["mv"] == METHODS_ITERS
            ok = ((not capped or per_rank[0]["mv"] == ref["mv"])
                  and abs(relres - ref["relres"])
                  <= METHODS_RELRES * ref["relres"]
                  and true <= 2 * relres
                  and (precision != "Mixed"
                       or relres <= max(tol, 1.01 * ref["relres"])))
        if not (same_mv and counted and ok):
            raise AssertionError(
                f"parallel {tag} {method}/{precision} on 2x2: MV "
                f"{[r['mv'] for r in per_rank]} (one rank {ref['mv']}), "
                f"relres {relres:.3e} (one rank {ref['relres']:.3e}), true "
                f"{true:.3e}, gathers {[r['gathers'] for r in per_rank]}")


def _parallel_methods(multichip, card_line: str) -> list:
    """(d): the sharded solve's other methods.  (d1) METHODS on one NCCL
    rank at PARALLEL_GRID's effort state against Ocean.solve; (d3) on one
    rank the same for HOST_METHODS on ISLAND; then one spawn of four gloo
    ranks on 2x2 runs (d2) METHODS and (d3) HOST_METHODS, held to the
    one-rank solves.  Returns the ranks' kernel launches."""
    island = dict(ISLAND, Periodic=False)
    t0 = time.perf_counter()
    one, o = _methods_one_rank(GLOBAL_THCM, METHODS, METHODS_ITERS,
                               card_line, "(d1)")
    host, small = _methods_one_rank(island, HOST_METHODS,
                                    HOST_METHODS_ITERS, card_line, "(d3)")
    for method, precision, tol in HOST_METHODS:
        cpu = _small_ocean(_methods_solver(method, precision, tol,
                                           HOST_METHODS_ITERS), "cpu")
        cpu.solve(-cpu.rhs)
        host[method, precision]["cpu_mv"] = cpu.solve_iters
        print(f"parallel (d3) {method}/{precision} serial Ocean.solve on "
              f"the CPU: {cpu.solve_iters} MV, relres "
              f"{cpu.solve_relres:.3e}", flush=True)
    print(f"parallel (d1) and (d3) on one rank {time.perf_counter() - t0:.1f}"
          f" s [{card_line}]", flush=True)
    t0 = time.perf_counter()
    jobs = [("model_solve", dict(
        thcm=GLOBAL_THCM, shape=(2, 2), x=None,
        solver=_methods_solver(m, p, tol))) for m, p, tol in METHODS]
    jobs += [("model_solve", dict(
        thcm=island, shape=(2, 2), x=None,
        solver=_methods_solver(m, p, tol, HOST_METHODS_ITERS)))
        for m, p, tol in HOST_METHODS]
    jobs.append(("launches", {}))
    out = multichip.run_ranks(PARALLEL_RANKS, jobs, device="cuda",
                              backend="gloo", timeout_s=300.0)
    print(f"parallel (d2) and (d3) on {PARALLEL_RANKS} gloo ranks "
          f"{time.perf_counter() - t0:.1f} s [{card_line}]", flush=True)
    rows = [[r[k] for r in out] for k in range(len(jobs) - 1)]
    k = len(METHODS)
    _methods_four_ranks(rows[:k], one, o, METHODS, "(d2)", card_line)
    _methods_four_ranks(rows[k:], host, small, HOST_METHODS, "(d3)",
                        card_line)
    return [r[-1] for r in out]


def phase_parallel(hopper, card_line: str) -> dict:
    """(a) one rank over NCCL; (b) PARALLEL_RANKS ranks on the one card
    over gloo: the sharded matvec and the partitioned assembly on each of
    PARALLEL_SHAPES against the serial ones, timed per rank, then the dry
    run's three stages at PARALLEL_GRID, its Newton update and its
    continuation step held to (a)'s; (c) the dry run at its own grid; (d)
    the sharded solve's other methods.  Returns the kernel launches of
    the phase, the ranks' included, by entry point: none, as the sharded
    path contracts its windows in plain PyTorch (the JAX package's
    reaches no Pallas kernel)."""
    from iemic_tpu_torch.main import multichip
    from iemic_tpu_torch.parallel import decomp2d

    if multichip.global_thcm(*PARALLEL_GRID) != GLOBAL_THCM:
        raise AssertionError("the dry run's global model is not the effort "
                             "phase's")
    if decomp2d(PARALLEL_RANKS, *PARALLEL_GRID[:2]) != PARALLEL_SHAPES[0]:
        raise AssertionError("decomp2d's rank grid changed")
    hopper.reset_launches()
    t0 = time.perf_counter()
    b, apply_J, z1, step1, sweeps = _parallel_one_rank(multichip, card_line)
    print(f"parallel (a) {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    n, m, l = PARALLEL_GRID
    xr = 0.01 * np.random.default_rng(PARALLEL_SEED).standard_normal(
        (6, l, m, n))
    jobs = [("ops", dict(thcm=GLOBAL_THCM, shape=shape, timed=True))
            for shape in PARALLEL_SHAPES]
    jobs += [("assembly", dict(thcm=GLOBAL_THCM, shape=shape, x=xr,
                               gathered=False, timed=True))
             for shape in PARALLEL_SHAPES]
    jobs += [("bgs", dict(thcm=GLOBAL_THCM, shape=shape, f32=False,
                          cases=[o for o, _, _ in PARALLEL_SWEEPS.values()],
                          builds=[b for _, b, _ in PARALLEL_SWEEPS.values()]))
             for shape in PARALLEL_SHAPES]
    jobs += [("dryrun", {"grid": PARALLEL_GRID}), ("launches", {})]
    out = multichip.run_ranks(PARALLEL_RANKS, jobs, device="cuda",
                              backend="gloo", timeout_s=300.0)
    wall = time.perf_counter() - t0
    print(f"parallel (b) {PARALLEL_RANKS} ranks over gloo on one card, "
          f"{wall:.1f} s [{card_line}]", flush=True)
    for k, shape in enumerate(PARALLEL_SHAPES):
        for rank, r in enumerate(out):
            ops = r[k]
            print(f"parallel (b) {shape[0]}x{shape[1]} rank {rank} "
                  f"({ops['ry']},{ops['rx']}): gathered matvec gap "
                  f"{ops['gap']:.3e}, halo exchange "
                  f"{ops['halo_s'] * 1e3:.3f} ms of {ops['halo_bytes']} "
                  f"bytes sent, sharded matvec {ops['matvec_s'] * 1e3:.3f} ms",
                  flush=True)
            if not ops["gap"] <= PARALLEL_MATVEC_TOL:
                raise AssertionError(f"parallel (b) {shape}: sharded matvec "
                                     f"gap {ops['gap']:.3e}")
    k0 = len(PARALLEL_SHAPES)
    for k, shape in enumerate(PARALLEL_SHAPES):
        for rank, r in enumerate(out):
            a = r[k0 + k]
            print(f"parallel (b) {shape[0]}x{shape[1]} rank {rank} "
                  f"({a['ry']},{a['rx']}): partitioned F gap "
                  f"{a['F_gap']:.3e}, An gap {a['An_gap']:.3e} (limit "
                  f"{PARALLEL_ASSEMBLY_TOL:g}); partitioned residual "
                  f"{a['rhs_s']:.4f} s, Jacobian {a['jac_s']:.4f} s (the "
                  f"replicated ones before the partition, PERF.md: "
                  f"0.334-0.348 s together); 2-deep "
                  f"halo exchange {a['halo2_s'] * 1e3:.3f} ms of "
                  f"{a['halo2_bytes']} bytes sent [{card_line}]", flush=True)
            if not max(a["F_gap"], a["An_gap"]) <= PARALLEL_ASSEMBLY_TOL:
                raise AssertionError(f"parallel (b) {shape}: partitioned "
                                     f"assembly gaps {a['F_gap']:.3e} "
                                     f"{a['An_gap']:.3e}")
    _parallel_sweeps(out, 2 * k0, sweeps, card_line)
    ranks = [dict(r[-2], launches=r[-1]) for r in out]
    multichip.print_ranks(ranks, "parallel (b) dry run")
    built = [st for r in ranks for st in (r["bgs"], r["mixed_bgs"],
                                          r["step"]["bgs"])]
    if not all(st is not None and st["build_gathers"] == 0 for st in built):
        raise AssertionError("parallel (b): a stage of the dry run built "
                             "no partitioned BGS or gathered in its build")
    for r in ranks:
        _print_step(f"parallel (b) dry run stage 3, rank {r['rank']} "
                    f"({r['ry']},{r['rx']})", r["step"], card_line)
    step4 = ranks[0]["step"]
    par_gap = abs(step4["par"] - step1["par"])
    close = np.allclose(step4["state"], step1["state"], rtol=PARALLEL_RTOL,
                        atol=PARALLEL_ATOL)
    worst = float(np.max(np.abs(step4["state"] - step1["state"])
                         - PARALLEL_RTOL * np.abs(step1["state"])))
    print(f"parallel (b) stage 3's four-rank step against (a)'s one-rank "
          f"step: par {par_gap:.3e} (limit {PARALLEL_PAR_TOL:g}), state "
          f"within rtol {PARALLEL_RTOL:g} atol {PARALLEL_ATOL:g}: {close} "
          f"(largest excess over rtol {worst:.3e})", flush=True)
    if not (par_gap <= PARALLEL_PAR_TOL and close):
        raise AssertionError("parallel (b): the four-rank continuation "
                             "step parts from the one-rank step")
    z4 = torch.as_tensor(ranks[0]["update"], device=z1.device)
    dz = apply_J(z4 - z1)
    rgap = float(torch.linalg.norm(dz) / torch.linalg.norm(b))
    zgap = float(torch.linalg.norm(z4 - z1) / torch.linalg.norm(z1))
    print(f"parallel (b) stage 1 update against (a)'s: |J (z4 - z1)| / |F| "
          f"{rgap:.3e} (limit {2 * multichip.STAGE1_TOL:g}, two solves "
          f"within {multichip.STAGE1_TOL:g}), |z4 - z1| / |z1| {zgap:.3e}",
          flush=True)
    if not rgap <= 2 * multichip.STAGE1_TOL:
        raise AssertionError(f"parallel (b): the four-rank Newton update "
                             f"is {rgap:.3e} from the one-rank update")

    # two NCCL ranks on the one card: Domain must refuse them
    t0 = time.perf_counter()
    try:
        multichip.run_ranks(2, [("halo", dict(
            x=np.zeros((6, 3, 8, 8)), shape=None, periodic=True))],
            device="cuda", backend="nccl", timeout_s=60.0)
    except torch.multiprocessing.ProcessRaisedException as e:
        if "NCCL takes one rank per card" not in str(e):
            raise
        print(f"parallel (b) two NCCL ranks on one card refused by Domain "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    else:
        raise AssertionError("parallel (b): two NCCL ranks on one card "
                             "were not refused")

    t0 = time.perf_counter()
    small = multichip.dryrun_multichip(PARALLEL_RANKS, device="cuda")
    print(f"parallel (c) {time.perf_counter() - t0:.1f} s [{card_line}]",
          flush=True)

    t0 = time.perf_counter()
    methods = _parallel_methods(multichip, card_line)
    print(f"parallel (d) {time.perf_counter() - t0:.1f} s [{card_line}]",
          flush=True)
    launches = dict(hopper.LAUNCHES_BY_ENTRY)
    for counts in [r["launches"] for r in ranks + small] + methods:
        for entry, n in counts.items():
            launches[entry] += n
    return launches


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    t_start = time.perf_counter()
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    card_line = card()
    print(f"device {card_line}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    from iemic_tpu_torch.ops import stencil_hopper as hopper
    t0 = time.perf_counter()
    lib = hopper.build(verbose=True)
    print(f"build {os.path.relpath(lib, REPO)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    rec = phase_kernel(hopper, card_line)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_assembly()
    print(f"assembly phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    model, jacobian_library_ms = phase_effort(hopper, card_line)
    print(f"effort phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_variants(hopper, model, card_line)
    print(f"variants phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_eigen(hopper, model, card_line)
    print(f"eigen phase {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    t0 = time.perf_counter()
    main_run = phase_main(hopper, card_line)
    main_launches = main_run["launches"]
    print(f"main phase {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"main phase launches {main_launches}", flush=True)
    t0 = time.perf_counter()
    general_run = phase_main(hopper, card_line, "stencil_matvec_f32")
    general_launches = general_run["launches"]
    print(f"main phase through stencil_matvec_f32 "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"main phase through stencil_matvec_f32 launches "
          f"{general_launches}", flush=True)
    same = all(main_run[k] == general_run[k] for k in ("mv", "cdata"))
    print(f"main MV per solve {MAIN_ENTRY} {main_run['mv']} | "
          f"stencil_matvec_f32 {general_run['mv']}; cdata "
          f"{main_run['cdata']} | {general_run['cdata']} "
          f"({'the same' if same else 'they differ'})", flush=True)
    t0 = time.perf_counter()
    transient_launches = phase_transient(hopper, card_line)
    print(f"transient phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    topo_launches = phase_topo(hopper, card_line)
    print(f"topo phase {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"topo phase launches {topo_launches}", flush=True)
    t0 = time.perf_counter()
    lyapunov_launches = phase_lyapunov(hopper, card_line)
    print(f"lyapunov phase {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"lyapunov phase launches {lyapunov_launches}", flush=True)
    t0 = time.perf_counter()
    coupled_launches = phase_coupled(hopper, card_line)
    print(f"coupled phase {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"coupled phase launches {sum(coupled_launches.values())} "
          f"{coupled_launches}", flush=True)
    t0 = time.perf_counter()
    parallel_launches = phase_parallel(hopper, card_line)
    print(f"parallel phase {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"parallel phase launches {sum(parallel_launches.values())} "
          f"{parallel_launches}", flush=True)

    print(f"smoke total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [dict(
        name=entry, route="cuda",
        source="iemic_tpu_torch/csrc/stencil_matvec.cu",
        replaces="iemic_tpu/ops/stencil_pallas.py:84",
        launches=sum(phase[entry] for phase in (
            main_launches, general_launches, transient_launches,
            topo_launches, lyapunov_launches, coupled_launches,
            parallel_launches)),
        library_ms=jacobian_library_ms, **rec[entry])
        for entry in hopper.ENTRIES]}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
