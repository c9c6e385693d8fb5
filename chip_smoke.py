#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (astrild_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed S] [--runs N]

Phases, each printing its own lines; a failure in any phase raises and
exits non-zero before the final line:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels K1 (windowed deposit), K2 (tile-binned CIC/TSC
     painter and its adjoint), K3 (pair tiles) and K4 (chunk-sorted
     deposit) from csrc/,
     one nvcc each, all started together; print each kernel's registers,
     shared memory and spills;
  3. hold both entry points of K1 (`deposit_flat` on keys as they come,
     `deposit_sorted` on them sorted) against the plain PyTorch version
     on the card: 2^24 keys into 2^24 cells (counts and weighted) and the
     edge cases (empty windows, all keys in one cell, 2^24 keys in one
     cell, N not a multiple of the block size, a partly filled last
     window, ~29 keys a cell over whole windows, the lens planes' junk
     cell, keys outside [0, n_cells), 2^30 + 5 cells, 1025 windows).
     Counts must be equal, weighted sums within 2e-5 * max; then K4
     against its plain version: 2^24 keys into 2^24
     cells in random, coherent (lattice) and one-cell orders, and the edge
     cases (fewer keys than segments, N not a multiple of the segments, one
     segment, empty windows, a partly filled last window, shuffled and
     globally sorted keys), with the same bars;
  4. hold K2 against its plain version, CIC and TSC, with and without
     weights: 2^24 particles onto 256^3, an odd 97^3 grid, positions at
     0, box, -0.0 and a third shifted by +-box, all particles in one cell,
     N not a multiple of the block, particles on and an ulp beside tile
     borders, every particle in one tile, most tiles empty. Max |kernel -
     plain| <= 2e-5 * max, total mass to rtol 1e-5; count the particles
     whose base cell the kernel's bin pass puts elsewhere than the plain
     version's keys (on a boundary-heavy input) and print the count;
  5. hold K3 against its plain version: 2^15 tracers in a 500 Mpc/h box
     with the halos.py default bins (rtol 1e-4 in bins of >= 1000 pairs,
     1e-4 of the largest bin elsewhere), and the edge cases (n not a
     multiple of the tile, junk rows past n_valid, coincident particles,
     every pair beyond the last bin; pairs whose squared separation is the
     cut s_max of the last and of a middle bin edge and an ulp below it;
     clumps whose tile boxes lie just inside and just outside reach;
     tracers around the origin; nbins = 128; a lattice beyond reach,
     where only the diagonal tile pairs may be visited; all tracers in
     one cell);
  6. drive the z=0 analysis suite at bench size (512^3 particles, a 256^3
     grid over 2^27 fine cells, 64 lens planes, 2048^2 maps): one warm-up
     and N timed runs, the per-stage split and the matter sub-stages (the
     device time of the program's `suite.*` and `power.*` spans in one
     profiled pass), then check the outputs (finite, shapes, P(k) of the
     kernel deposit equal to the scatter deposit's to rtol 1e-5, P(k) of
     uniform particles at the shot-noise level, the deposit conserving the
     particle count);
  7. drive the forward model at the pm_catalog defaults: 512^3 particles
     on a 512^3 mesh in a 500 Mpc/h box, EH98 P(k), 2LPT at z=9, 20 log-a
     KDK steps to z=0 in GR and in f(R) (fR0=1e-5) from the same ICs, the
     P(k) of both snapshots and v12 of a 2^17-tracer subsample; check the
     launches, finiteness, momentum, linear growth, the f(R) enhancement,
     infall, K3 against its plain version on those 2^17 tracers (and the
     path's v12 against the plain version's), two K3 calls on them equal
     bit for bit, v12 of 2^20 tracers through K3 (finite, infall; its time,
     memory and scratch printed), and the kernel paint's P(k)
     against the scatter paint's; split a step's device time by the time
     loop's profiler spans (3 traced steps);
  8. the file lane, on the GR z=0 snapshot of phase 7: write its 512^3
     particles (positions, velocities in km/s, ids) in the PM code's own
     (lattice) order as an 8-file Gadget snapshot under build/, read it
     back (bit-identical), move the flat components to the card, and
     measure P(k) (256^3, 64 bins, 2^27 fine cells) through K4
     (`deposit="kernel_seg"`) and K1 on the file order and on a shuffled
     order, and through the `PowerSpectrum3D` facade; then the TSC density,
     velocity and divergence grids through `Ecosmog.density_fields` (K2).
     The four fine deposits must be equal, every P(k) within rtol 1e-5 of
     the scatter deposit's, the density's mass N to rtol 1e-5; the facade
     given the positions as read (numpy, no `device`) must run on the card
     (one more K1 launch) and give the same P(k);
  9. the lightcone lane: `pm_lightcone_planes` at 512^3 particles on a
     512^3 mesh (500 Mpc/h, fov 0.2 rad, 2048^2 pixels, 16 planes to
     z = 1, a seeded randomize generator; K2 in every force evaluation, K1
     once per plane), Born kappa, its C_ell against the halofit Limber
     prediction, peaks, and the multi-plane ray trace of the same planes
     against the Born map (at the pixel above a floor; above 0.99 on block
     means, with the planes smoothed, and with the planes scaled down so
     the rays stay on their Born lines; the rays' rms shift printed);
     one plane through K1 against the per-plane scan on the card; then
     five HEALPix shells (nside 1024, 150-650 Mpc/h, 27 box images) of the
     GR z=0 snapshot through K1, their totals against a plain count, one
     box image and a weighted call against `index_add_`, and Born kappa on
     the sphere; K1 timed at the lane's two shapes;
 10. time K1, K2, K3 and K4 against their plain versions and, for K1 and
     K4, against `index_add_` at the main paths' shapes, in turns (plain,
     kernel, kernel, plain): K1's `deposit_flat` on the keys as they come
     and `deposit_sorted` on them sorted, each beside `index_add_` of the
     same keys, at the suite's, a lens plane's and a shell image's shape,
     and a profiler trace that shows `deposit_flat` runs no radix sort;
     K3's parts from a profiler trace, with the tile pairs it visits, the
     pairs they hold and the in-range pairs;
 11. the clustering lane (examples/clustering_toolkit.py on the GR z=0
     snapshot of phase 7, run after phase 9): P_thetatheta and P_deltatheta
     at 256^3 (infall below k = 0.1 h/Mpc, -P_dtheta / (aHf P_d) near 1),
     the marked P(k) (p = 0 equal to the plain P(k) with V/N), counts in
     128^3 cells, density-split profiles of the 2^17 v12 tracers, BAO
     reconstruction of all 2^27 particles against the painted 2LPT initial
     field (the propagator rises), xi(r), xi_0 and xi_2 in redshift space
     and wp(rp) of the 2^17 tracers against the halofit FFTLog wp, the
     pairwise-velocity PDF (its total against a direct count) and the kSZ
     estimator of 2^15 tracers in a lightcone frame, v12 from their
     transverse velocities through K3, and the BAO scale of a 256^3 EH98
     Gaussian field; K2 and K3 launches held to the counts the stages
     predict; K2 on a signed velocity weight and on counts at 2^27 onto
     256^3 against its plain version, and timed there in turns;
 12. the galaxy-mocks path (examples/galaxy_mocks_voids.py at twice its
     side, after phase 11 on the same GR z=0 snapshot): a 128^3 Zel'dovich
     halo mock in 500 Mpc/h with the example's toy P(k) and masses, HOD
     galaxies (~4.7 M; n_gal, central share, overflow), xi(s, mu) of 2^17
     of them in redshift and real space (xi_0 > 0 at the smallest s; xi_2
     < 0 beyond 12 Mpc/h and below its real-space value), their CIC grid
     on 128^3 through K2, SVF voids (sorted, overlaps <= 0.5) and 3D
     watershed voids (>= 1), stacked density and velocity profiles around
     the 64 largest SVF voids (delta < 0 inside and rising, outflow),
     find_tunnels_auto (candidates within its final capacity) and the 2D
     watershed on phase 9's Born kappa map; then the 2^27 particles onto
     768^3 through K2, SO halos (M200m, up to 32,768), their mass function
     against Tinker08's n(>M) (0.25-1.5 at 1.5x the radius floor and at
     3e14, Poisson bounds of that band at 1e15) and the most massive
     halo's axis ratios; every output finite; K2 launches held stage by
     stage (exactly 2); K2 at both new shapes against its plain version
     and timed in turns;
 13. the shear-survey path (examples/shear_survey.py stages 1-6 at twice
     its side, 1024^2 over 10 deg, after phase 12): the example's halofit
     Limber table -> a seeded Gaussian kappa map -> periodic spin-2 shear
     in a SkyArray built from numpy (on the card) -> xi_pm (16 bins over
     1.5-100') against the FFTLog theory, COSEBIs (n <= 5 over 3-85'), the
     exact Gaussian covariance with shape noise (sigma_e 0.26, 30 per
     arcmin^2) and without, and their COSEBIs propagation, the stacked
     tangential shear around 64 peaks above 2 sigma, xi_pm of 2^15
     catalog galaxies (periodic, tiles of 4096 rows), a full-grid 128^2
     catalog against the map estimator, and the Monte-Carlo covariance of
     200 maps; then phase 9's 2048^2 Born map through both shear routes
     against the halofit xi_+ and its COSEBIs. Every output finite; xi_+
     within 4 sigma of theory (the noise-free analytic diagonal) over
     2-30'; |B_n| < 4 sigma_B; the Monte-Carlo variance within 30% of the
     analytic one in every non-empty bin; gamma_t > 0 in the three inner
     annuli and max |gamma_x| < 0.25 max gamma_t; the full-grid catalog
     within 1e-5 of <|gamma|^2> of the map estimator; the Born xi_+ > 0
     below 10'; numpy input to every new entry point on the card; K1-K4
     launches exactly 0;
 14. the theory and forecast path (examples/theory_and_rsd.py whole and
     examples/shear_survey.py stages 7-8 at their own parameters, after
     phase 13): linear, halofit and halo-model P(k) at 64 k in 1e-3-10
     h/Mpc (finite; halofit / linear and halo model / linear >= 0.97 at
     every k and > 1 beyond 1 h/Mpc); the Kaiser multipoles on 1024 k
     through FFTLog (the BAO peak of s^2 xi_0 in 95-110 Mpc/h); the
     Zel'dovich RSD closure with the example's toy P(k) at 64^3 in 1000
     Mpc/h (16 bins) and at 256^3 in 4000 Mpc/h (2^24 particles, 64
     bins), each painted through K2 (CIC): P2/P0 in the bin nearest k =
     0.047 within 3 sigma of Kaiser, sigma from
     `covariance.gaussian_multipole_covariance`; Born and ray-traced
     `SkyArray.from_density_planes` of 8 seeded planes of 256^2 (finite,
     omega not 0; the ray trace with TF32 allowed within 1e-6 of max
     |kappa| of the run without); `shear_fisher` (10 ells, z_s 0.6 / 1.0
     / 1.6, fsky 0.36, nchi 128), `xipm_survey_fisher` (512^2 over 5 deg,
     12 bins from 2', 40 fields) and `threex2pt_fisher` (Om0, sigma8,
     log_mmin, A_IA; Smail n(z), z0 0.64 on 120 nodes; 10 xi bins) from
     numpy input: F symmetric to 1e-6 of its max and positive definite,
     every marginalized error finite and > 0, F within 1e-3 of its max of
     the same call on the CPU, the card's Jacobian of the mean model
     (torch.func.jacfwd) within 5e-3 of each column's max of central
     differences (step 1e-4 of each parameter) of the port in float64 on
     the CPU; numpy input to every new theory entry point on the card; K2
     launches exactly 2 (one each RSD paint), K1, K3 and K4 0; each
     forecast's seconds on the card, again (warm) and on the CPU; then K2
     at both RSD shapes against its plain version and timed in turns;
 15. the map-analysis and catalog facades (after phase 14): (a)
     examples/full_pipeline.py stages 1-4 at its own parameters (4
     realizations of 64^3 clumpy particles from a torch generator in 250
     Mpc/h, TSC P(k) on 128^3, the CIC bispectrum, Born kappa of 32
     slabs, SkyArray.smoothing -> TunnelsFinder -> Voids -> trim_edges ->
     profiles -> bootstrap statistics): the batch's P(k) within 1e-5 of
     four separate calls, every output within 1e-4 of the same port on
     the CPU with the same particles (the same void catalog); (b) the
     void stage at full width on phase 9's 2048^2 Born map (mean profile
     at r/R = 0 below 0, the bootstrap envelope bracketing the mean in
     every bin), Peaks.from_tunnels_finder, WatershedFinder, troughs
     (below the map's mean), the smoothed layer equal to filters.gaussian;
     a seeded 2048^2 Gaussian map of the halofit C_ell through
     AngularPowerSpectrum.to_flat_map (numpy, so onto the card): V0, V1,
     V2 within the Gaussian prediction's tolerances of
     tests/test_minkowski.py, <M_ap^2> within 12% of map2_theory at 2, 4,
     8'; (c) phase 12's SO halos with velocities from the snapshot's CIC
     velocity grids: Rockstar HMF (non-increasing), xi and v12 (< 0 in
     the innermost bin of >= 100 pairs; K3), SubFind.power_spectrum at
     256^3 (weighted TSC, K2), Halos.populate_hod, and
     SphericalVoidFinder3D.from_particles of the 2^27 particles onto 256^3
     (K2); numpy input to every new entry point that returns a tensor on
     the card; K2 launches exactly 15 (4 + 4 + 1 + 4 + 1 + 1), K3 1, K1
     and K4 0; then K2 at the new shapes (TSC and CIC of 2^18 onto 128^3, the
     halos' weighted TSC onto 256^3, 2^27 onto 256^3) and K3 on the halos
     against their plain versions and timed in turns;
 16. the moving-lens, SZ and ISW path (after phase 15): (a) a halo
     lightcone of phase 12's SO halos with phase 15's velocities over 3
     box replicas along the line of sight (100-1500 Mpc/h), its z, D_A,
     Duffy concentrations, v_los and M500c / r500c / E(z) in physical
     units; (b) dT/T, alpha_x, alpha_y, kSZ and Compton-y on the 8192^2,
     20 deg canvas through SkyArray.from_halo_dataframe (101-pixel
     patches); (c) SkyArray.filter (DGD3) -> Dipoles.from_sky ->
     find_nearest -> both transverse-velocity estimators: on the matched
     halos whose crop holds no other halo's patch (>= 10 of them), the
     matched filter's median |v_rec - v_true| / |v_true| under 0.35 for
     each component (the reference mode's printed beside it); (d) the kSZ
     map's stacked aperture photometry at the halo centres, receding
     stack < 0 < approaching stack; Cl_yy at ell 100-5000 beside the y
     map's flat-sky C_ell (printed); (e) sph_surface_density of the 2^27
     particles onto 2048^2 (4 buckets, log-uniform smoothing lengths;
     mass to 1e-5), kappa_to_phi of phase 9's Born map ->
     shear_from_potential (its kappa correlating > 0.9 with the Born
     map) and fermat_potential, the image finder behind the most massive
     halo's 1024^2 deflection patch (n_found and the magnifications'
     signs printed), the Born map remapped by that deflection; (f)
     LinearAngularPowerSpectrum's C_TT at ell 2-2000 and P_dpdp
     (positive), Bispectrum2D of the Born map in 16 bins; (g) (b) and
     (c) on a 2048^2 / 5 deg canvas, (e)'s image finder and remap and (f)
     on the card against the same port on the CPU: maps within 2e-5 of
     their max, the isolated matched halos' velocities and the image
     positions within 1e-3, the rest within 1e-4; (h) numpy input to every new entry point on the card;
     K1-K4 launches exactly 0;
 17. the modified-gravity growth, flat-sky MASTER, HMC and the analysis
     toolbox (after phase 16): (a) GR and fR0 = 1e-4 KDK evolutions (16
     steps from 2LPT at z = 9, the same ICs) of 512^3 particles on 512^3
     in 6400 Mpc/h under a flat P(k) = 20 (tests/test_nbody.py's f(R)
     test at the pm_catalog width), both snapshots painted through K2 and
     binned in 10 bins: P_fR/P_GR on bins 1-8 within 3% of linear theory,
     fofr_pk_enhancement(k, 0) / fofr_pk_enhancement(k, 9), which exceeds
     1.1 there; K2 exactly 2 x 17 + 2 launches; (b) the mu0 = 1/3 growth
     tables ('const', 'lambda') on the traced route on the card within
     1e-10 of the host tables; growth_factor_k and fofr_pk_enhancement at
     256 k in 1e-4-10 h/Mpc for fR0 1e-4, 1e-5, 1e-6, n 1 and 2, z 0 and
     1: the float route's card result equal to its CPU placement, the
     traced route on the card within 1e-6 of it and rising in k above
     0.01 h/Mpc; F4 at k = 0.1 in 1.15-1.32 and F5 in 1.03-1.12; GR
     within 1e-6 of 1; the traced enhancement's CUDA kernels and those of
     its jacfwd in fR0 (profiler), and the jacfwd's seconds; the
     full_pipeline theory anchors on the card within 1e-5 of the CPU;
     (c) MASTER on MA_REALIZATIONS seeded 2048^2 maps over 10 deg of the
     example's C_ell = 1/(l(l+1)) on a table with unit ell steps, under
     its edge mask (the columns below 30/128 of the width) with 256 seeded
     holes of 2' radius, 16 bands: the realizations' mean of MASTER within
     5% of the unmasked maps' mean C_ell on bands of >= 10^4 modes and
     under half the largest <w^2> pseudo-Cl bias there (printed), and of
     their E-only shear (kappa_to_shear_maps)
     spin-2 MASTER: BB/EE summed below 1e-2 (raw pseudo BB/EE printed),
     EE within 5% of the unmasked EE; the coupling builds' seconds at
     2048^2 on the card; at 512^2 the couplings within 1e-10 of the CPU
     build's max and the spectra within 1e-5; SkyNamaster on
     distributed_and_masked.py's stages 3 and 6 at its own parameters and
     at 2048^2, where the second compute_cl reuses the cached coupling
     (its seconds printed; its full-sky paths run in phase 18); (d) HMC
     from CUDA generators: tests/test_inference.py's correlated Gaussian
     with its checks, its shear posterior (sigma8) with its checks against
     shear_fisher, a 3-bin (z 0.5, 1, 1.5) posterior in (Om0, sigma8)
     over 16 ells (nchi 64, fsky 0.3, inv_mass from shear_fisher; 100
     warm-up steps and 100 samples of 8 leapfrogs): means within 3
     sigma_F, std / sigma_F in 0.5-2, acceptance > 0.5, ms and CUDA
     kernels per log-density gradient printed; the 3x2pt posterior
     at tests/test_inference.py's settings: |logp(truth)| < 1e-6, a
     finite gradient, the barrier below -1e3; (e) lognormal_map at
     2048^2 (min >= -1 - 1e-5, |mean| < 0.2) against the same port on
     the CPU from the same white fields within 1e-5 of max; (f)
     bootstrap_statistic of 10^6 values with 1000 resamples (and 100
     resamples' medians from the same indices on the CPU),
     nonlinear_least_squares of a noisy NFW profile, pca,
     covariance_from_realizations and snapshot_info_table (F5, traced on
     the card) against the CPU within 1e-5; K1-K4 0 launches but (a);
 18. the full sky (after phase 17, on phase 7's GR z=0 snapshot kept
     for it): see phase_full_sky's docstring; K1 launches once a flush of
     phase 9's shells, K2-K4 0 times.
 19. CMB lensing (after phase 18, on the same snapshot, freed after its
     shells): see phase_cmb_lensing's docstring; K1 launches once a
     flush of the shells, K2-K4 0 times.
 20. field-level inference through the PM simulator and the checkpointed
     evolution and lightcone (after phase 19): see
     phase_field_inference's docstring; K2 and its adjoint launch
     nsteps + 2 times a gradient, K1 once a lightcone plane, K3-K4 0
     times.
 21. the file path (after phase 20): ECOSMOG grav files and Ray-Ramses
     ray dumps written, compressed and taken to the card, the native C++
     oracle against K3 and kappa_to_alpha, the observability stages,
     trace and checks: see phase_file_path's docstring; K2 and K3 launch
     once each, K1, K4 and K2's adjoint 0 times.
 22. the distributed layer, part A (after phase 21), on a world of one
     over NCCL at phase 6's width: the composed suite, the CIC P(k) and
     multipoles, the pencil FFT, the sharded filter and PowerSpectrum3D's
     mesh= against the single-device path, then a 4-rank gloo world on
     the host CPU (this script's --gloo-worker ranks) against a world of
     one: see phase_distributed's docstring; K1 launches 3 times, K2
     twice, K3, K4 and K2's adjoint 0 times.

The last lines are a JSON object describing each kernel (K1-K4 and K2's
adjoint: launches on its main path, error, times, and the least time the
card could take for the same work), the card's name and power limit, and
the `{"ok": true, "device": ...}` result line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_SIDE, NGRID, NPIX, BOX, NPLANES = 512, 256, 2048, 500.0, 64
# forward model: particles per side (= force mesh), steps, redshifts,
# v12 subsample and bins (halos.py defaults)
PM_SIDE, PM_STEPS, Z_INIT, FR0 = 512, 20, 9.0, 1e-5
V12_N, V12_BINS = 1 << 17, (0.0, 50.0, 25)
K3_N = 1 << 15       # uniform tracers of the K3 check
K3_LARGE_N = 1 << 20  # tracers of the K3 run without a plain version
K3_PLAIN_BLOCK = 2048  # tile rows of K3's plain version at the v12 size
# K1/K2 sums: max|kernel - plain| <= WEIGHTED_TOL * max|plain|
WEIGHTED_TOL = 2e-5
# K2's adjoint against autograd of its plain version, each gradient
# (positions, weights) relative to its max: the same float32 products
# summed in another order, on the same stencil (the bin pass's decisions)
K2_ADJ_TOL = 1e-5
MASS_RTOL = 1e-5     # K2 total mass against N (or the summed weights)
K3_RTOL, K3_MIN_PAIRS = 1e-4, 1000
PK_RTOL = 1e-5       # P(k), kernel deposit vs scatter deposit
GROWTH_TOL = 0.05    # same-realization growth vs D(0)/D(z_init)
MOMENTUM_TOL = 1e-3  # |sum p| / sum |p| after the evolution
# the file lane: Gadget files of the GR snapshot, P(k) grid and bins
LANE_FILES, LANE_NGRID, LANE_BINS = 8, 256, 64
# the lightcone lane: field of view [rad], pixels, planes, source redshift,
# KDK steps of the first leg and between planes; HEALPix shells
LC_FOV, LC_NPIX, LC_PLANES, LC_Z_SOURCE = 0.2, 2048, 16, 1.0
LC_STEPS_INIT, LC_STEPS_PLANE = 8, 2
LC_NSIDE, LC_EDGES, LC_SHELL_SOURCE = 1024, (150.0, 650.0, 6), 700.0
LC_WEIGHTED_N = 1 << 24
# C_ell against halofit is held on bands below this multipole (k < 1.7
# h/Mpc at the lensing kernel's peak, inside the 512^3 mesh's Nyquist
# frequency of 3.2 h/Mpc). Born against ray-traced kappa: at the pixel the
# planes' shot noise (1-2 particles a pixel a plane) decorrelates once a
# ray leaves its Born line by a pixel, so the pixel-scale correlation is
# held to a floor and the bar of 0.99 to block means of LC_BLOCK pixels a
# side (5.5 arcmin), to planes smoothed over LC_SMOOTH pixels, and to the
# same planes scaled by LC_WEAK, where the rays stay on their lines and
# the trace must return the Born map pixel for pixel
LC_ELL_MAX, LC_BLOCK = 2000.0, 16
LC_PIXEL_CORR_FLOOR, LC_SMOOTH, LC_WEAK = 0.85, 4.0, 0.01
# the clustering lane: grid and bins of the spectra; smoothing of the mark,
# the reconstruction and the split [Mpc/h]; counts-in-cells cells and
# overflow count; the split's query lattice and shells (r_min above the
# 256^3 cell, so that a quantile's innermost shell holds ~500 tracers);
# pair-estimator tracers, tile rows, s / rp edges, mu and pi bins, the
# lightcone distance of the box; the BAO fit's bins and alpha grid
CL_NGRID, CL_BINS = 256, 64
CL_MARK_R, CL_RECON_R, CL_SPLIT_R = 10.0, 10.0, 20.0
CL_CIC_CELLS, CL_CIC_MAX = 128, 1024
CL_QUERY, CL_SPLIT_RMIN, CL_SPLIT_RMAX = 16, 5.0, 100.0
CL_PAIR_N, CL_BLOCK = 1 << 15, 2048
CL_S_EDGES, CL_NMU = (0.0, 100.0, 21), 20
CL_RP_EDGES, CL_PI_MAX, CL_N_PI = (4.0, 60.0, 13), 80.0, 40
CL_LC_DIST = 1000.0
CL_BAO_BINS, CL_ALPHAS = 32, (0.7, 1.3, 301)
# the galaxy-mocks path: Zel'dovich halo lattice side (twice the example's,
# in twice its box: the same density), void grid, HOD parameters and
# satellite cap, xi(s, mu) tracers and bins, profile range and bins, voids
# stacked and centers a chunk; SO grid (0.65 Mpc/h cells: a 1.5-cell
# radius floor of ~840 particles), catalog capacity and radius ladder
GM_SIDE, GM_VGRID, GM_MAX_SAT = 128, 128, 16
GM_HOD = (12.6, 0.3, 12.5, 13.6, 1.0)
GM_SUB, GM_S_EDGES, GM_NMU = 1 << 17, (2.0, 40.0, 16), 20
GM_KAISER_S = 12.0  # xi_2's Kaiser check from ~3 halo-lattice spacings
GM_PROFILE, GM_NVOIDS, GM_CENTRE_CHUNK = (2.0, 60.0, 12), 64, 8
SO_NGRID, SO_MAX, SO_RADII = 768, 32768, 40
# the shear-survey path (examples/shear_survey.py stages 1-6 at twice its
# side, at its 0.59' pixel: 4x its area): map side and field [deg], xi bins
# (n, theta_min', theta_max'), COSEBIs (nmax, theta_min', theta_max'), shape
# noise (sigma_e, galaxies per arcmin^2), peaks (count, edge), the stack
# (patch half-side, radial edges in pixels), the catalog (galaxies, edges
# in arcmin, tile rows: 4096, not the JAX signature's 512, as phase 12's
# pair tiles), realizations of the Monte-Carlo covariance; the full-grid
# catalog check's map side
SS_NPIX, SS_OA = 1024, 10.0
SS_XI, SS_COSEBIS = (16, 1.5, 100.0), (5, 3.0, 85.0)
SS_SIGMA_E, SS_NGAL = 0.26, 30.0
SS_PEAKS, SS_EDGE_PIX, SS_PATCH, SS_R_EDGES = 64, 48, 48, (2.0, 40.0, 11)
SS_NCAT, SS_CAT_EDGES, SS_CAT_BLOCK = 1 << 15, (3.0, 60.0, 9), 4096
SS_NREAL, SS_GRID_CAT = 200, 128
# the theory path (examples/theory_and_rsd.py and shear_survey.py stages
# 7-8 at their own parameters): the halofit and halo-model P(k) may fall
# below linear by this share at most; the BAO peak's window [Mpc/h]; the
# RSD closure's (ngrid, box, bins): the example's, and 64x its particles
# at its density (64 bins: a quarter of the example's bin width), the k
# of its bin 3 and the pull allowed; the ray trace's kappa with TF32
# allowed against the run without, relative to its max; the Fisher
# matrices' asymmetry, card against CPU, and card Jacobian against
# central differences of the port in float64 on the CPU, each relative
# to the matrix's or the column's max
THEORY_LIN_DROP, THEORY_BAO = 0.03, (95.0, 110.0)
THEORY_RSD = ((64, 1000.0, 16), (256, 4000.0, 64))
THEORY_RSD_K, THEORY_RSD_PULL = 0.047, 3.0
THEORY_TF32_TOL = 1e-6
THEORY_SYM_TOL, THEORY_CPU_TOL, THEORY_FD_TOL = 1e-6, 1e-3, 5e-3
# the map-analysis and catalog facades: examples/full_pipeline.py stages 1-4
# at its own parameters (box, grid, realizations of particles, P(k) bins,
# bispectrum shells, Born slabs, the void stage's smoothing, profile reach
# and bins, bootstrap resamples); the full-width void stage on phase 9's
# map (its resamples; trough count, fraction, radius in arcmin, profile
# bins); the Gaussian halofit map's smoothing for the Minkowski functionals
# [pixels] and aperture scales [arcmin]; the halo facades' grids (velocity
# sampling, SubFind P(k), the SVF of the snapshot) and the pairs a v12 bin
# needs for its infall check; (a) on the card against the CPU, relative
FP_BOX, FP_NGRID, FP_SIDE, FP_SIMS = 250.0, 128, 64, 4
FP_PK_BINS, FP_BS_BINS, FP_SLABS = 32, 4, 32
FP_SMOOTH, FP_REACH, FP_PROFILE_BINS, FP_BOOT = 2.0, 2.0, 10, 30
MA_BOOT, MA_TROUGHS, MA_TROUGH_FRAC, MA_TROUGH_ARCMIN = 100, 20000, 0.2, 5.0
MA_MF_SMOOTH_PIX, MA_MF_BINS, MA_AP_SCALES = 4.0, 24, (2.0, 4.0, 8.0)
MA_VEL_NGRID, MA_PK_NGRID, MA_SVF_NGRID, MA_V12_MIN_PAIRS = 256, 256, 256, 100
FP_CPU_TOL = 1e-4
# the moving-lens, SZ and ISW path: the halo lightcone's box replicas
# along the line of sight from its nearest distance [Mpc/h]; the full-width
# canvas and field [deg] and the patch side and extent (the defaults of
# SkyArray.from_halo_catalogue_to_temperature_perturbation_map); the DGD3
# detection (SNR cut and edge; its scale is the painted patches' R200, 50
# pixels of the canvas), the estimators' crop half-side and the matched
# filter's bar (the JAX package's test_dipoles_pipeline); the stacked
# aperture [arcmin]; the Cl_yy ells; the SPH projection (pixels, buckets,
# log-uniform smoothing lengths [Mpc/h]); the strong-lensing patch
# (pixels, extent in R200; the source is the image of the point that many
# Einstein radii out on the patch's axis); the ISW ells
# and redshifts; the 2D bispectrum's bins; the card / CPU comparison's
# canvas and field, and its bars (maps relative to their max, velocities
# and the rest relative)
ML_REPLICAS, ML_CHI_MIN = 3, 100.0
ML_NPIX, ML_OA, ML_PATCH, ML_EXTENT = 8192, 20.0, 101, 1.0
ML_SNR, ML_EDGE = 2.0, 4
ML_CROP, ML_VT_BAR = 64, 0.35
ML_AP_ARCMIN, ML_YY_ELLS = 3.0, (100.0, 5000.0, 16)
ML_SPH_NPIX, ML_SPH_BUCKETS, ML_HSML = 2048, 4, (0.05, 2.0)
ML_SL_NPIX, ML_SL_EXTENT, ML_SL_IMAGE = 1024, 0.2, 1.1
ML_ISW_ELLS, ML_ISW_Z, ML_BS_BINS = (2, 2000), (0.08, 0.9), 16
ML_SMALL_NPIX, ML_SMALL_OA = 2048, 5.0
ML_MAP_TOL, ML_VT_TOL, ML_CPU_TOL = 2e-5, 1e-3, 1e-4
# the modified-gravity growth, MASTER and inference phase: (a) the f(R) PM
# pair at the pm_catalog width with the JAX test's cell (12.5 Mpc/h) and
# flat P(k), its steps, fR0 and P(k) bins, the bar on bins 1-8 and the
# theory's least peak there; (b) the growth grid (k range, fR0, n, z), the
# k above which the traced enhancement must rise, the traced route / mu0
# tables / theory anchors on the card against the CPU (relative); (c) the
# survey map and field [deg], bands, holes and their radius ['], the
# example's masked edge share, the bar against the unmasked C_ell on bands
# of >= MA_MIN_MODES modes, the spin-2 BB/EE bar, the card / CPU side and
# bars, the realizations averaged (a single map's two lowest bands scatter
# by 2-10%: the few lowest modes hold most of a steep spectrum's power); (d) HMC (samples, warm-up, leapfrogs, step): the Gaussian of
# tests/test_inference.py, its shear posterior, the wider 3-bin one (ells,
# source redshifts, chi nodes), fsky and prior box; the chains cut in depth
# to keep the script inside its time limit: the Gaussian to 1000 samples
# after 250 warm-up steps (the test's 2000 / 500), the shear posterior to
# 200 after 100 (400 / 150), the 3-bin one to 100 after 100 (it took 151 s
# at 200 after 150 on an H100 whose host ran the launch-bound chains
# slowly); (e) the lognormal
# map's side and card / CPU bar; (f) bootstrap values and resamples (and
# those compared with the CPU), PCA and covariance shapes, the bar
MG_SIDE, MG_BOX, MG_PK, MG_STEPS, MG_FR0, MG_BINS = (512, 6400.0, 20.0, 16,
                                                      1e-4, 10)
MG_RATIO_TOL, MG_TEETH = 0.03, 1.1
MG_K, MG_FR0S, MG_NS, MG_ZS = (1e-4, 10.0, 256), (1e-4, 1e-5, 1e-6), \
    (1.0, 2.0), (0.0, 1.0)
MG_MONO_K, MG_TRACED_TOL, MG_TABLE_TOL, MG_ANCHOR_TOL = 1e-2, 1e-6, 1e-10, \
    1e-5
MA_NPIX, MA_FOV, MA_NBINS, MA_HOLES, MA_HOLE_ARCMIN = 2048, 10.0, 16, 256, 2.0
MA_EDGE, MA_MIN_MODES, MA_TOL, MA_BB = 30 / 128, 10 ** 4, 0.05, 1e-2
MA_CPU_NPIX, MA_COUP_TOL, MA_SPEC_TOL = 512, 1e-10, 1e-5
MA_REALIZATIONS, MA_REPEAT_TOL = 16, 1e-4
HMC_GAUSS, HMC_SHEAR, HMC_WIDE = (1000, 250, 12, 0.3), (200, 100, 8, 0.01), \
    (100, 100, 8)
HMC_WIDE_ELLS, HMC_WIDE_Z, HMC_WIDE_NCHI = (100.0, 3000.0, 16), \
    (0.5, 1.0, 1.5), 64
HMC_FSKY, HMC_BOUNDS = 0.3, {"sigma8": (0.6, 1.0), "Om0": (0.1, 0.6)}
LN_NPIX, LN_TOL = 2048, 1e-5
BOOT_N, BOOT_NB, BOOT_CPU_NB = 10 ** 6, 1000, 100
PCA_N, PCA_F, COV_SHAPE, TOOLBOX_TOL = 100000, 16, (1000, 64), 1e-5
# the full-sky phase: (b) nside, lmax and the super-Nyquist lmax (3 nside -
# 1, healpy's default); 32 log bands over 10 <= l <= 1536, the EE / kk bar,
# the BB / EE bar, the round trip's pull, CG's bias bar above 2 nside and
# the xi_pm angles [arcmin]; (c) the largest table case and its bars
# (synthesis relative to the map's max, analysis to the largest alm), the
# card / CPU size and bar; (d) MASTER's nside, lmax, bands, mask (galactic
# cut half-width, holes, hole radius [deg]), scalar and spin-2 maps, pull
# and BB / EE bars, repeats of the cached facade; (e) the example's (nside,
# lmax, fwhm), ray samples, the projection (pixels, deg), the beam
# [arcmin] and its bar
FS_NSIDE, FS_LMAX, FS_LMAX_HI = 1024, 2048, 3071
FS_BANDS, FS_ELL_RANGE, FS_EE_TOL, FS_BB_TOL = 32, (10, 1536), 0.02, 1e-3
FS_PULL, FS_CG_BIAS, FS_XI_ARCMIN = 5.0, 0.02, (2.0, 200.0, 16)
FS_TABLE_NSIDE, FS_TABLE_LMAX, FS_SYNTH_TOL, FS_ANA_TOL = 256, 512, 5e-4, \
    1e-4
FS_CPU_NSIDE, FS_CPU_LMAX, FS_CPU_TOL = 64, 128, 1e-5
FS_MASTER_NSIDE, FS_MASTER_LMAX, FS_MASTER_NBINS = 512, 1024, 16
FS_MASK_CUT_DEG, FS_MASK_HOLES, FS_MASK_HOLE_DEG = 20.0, 128, 2.0
FS_MASTER_MAPS, FS_MASTER_SPIN_MAPS, FS_MASTER_PULL, FS_MASTER_BB = 8, 16, \
    4.0, 1e-2
FS_REPEAT_TOL = 1e-6
FS_EXAMPLE, FS_COLUMNS, FS_PROJ = (32, 64, 0.05), 10 ** 7, (2048, 10.0)
FS_BEAM_ARCMIN, FS_BEAM_TOL = 10.0, 0.05
# the CMB-lensing phase: (b) the traced sources [Mpc/h] (one, and the
# tomographic pair), 8 log bands over FS_ELL_RANGE, the traced / Born
# (band-limited) pixel correlation floor and C_l ratio bar, omega's power
# over kappa's and the traced shear's BB / EE, the near source against its
# own run (relative to kappa's max), one shell against w kap_bl; (c) the
# CMB's damping multipole, the zero-kappa shift (relative to the CMB's
# max), lensed - unlensed against alpha . grad T (correlation floor, rms
# ratio bar), the nudge's C_l bias against the un-nudged remap; (d) the
# QE's lmax_filter and lmax_out, 6 log bands over 30 <= L <= 1000 and the
# cross-ratio bar; (e) the flat patches (side, field [deg], count), the
# filter band, the TT cross-ratio bar on 4 bands over 100 <= L <= 1000,
# the unlensed auto / N0 bar, the EB null and pure-mode bars; (f) the card
# / CPU bar, the transforms' and the stencil's at nside 64
CL_CHI_S, CL_TOMO = 700.0, (450.0, 700.0)
CL_BANDS, CL_CORR, CL_RATIO_TOL = 8, 0.999, 0.05
# the traced / Born-bl gap, split: the tracer reads its fields CL_NUDGE
# pixel widths (sqrt(pi/3) / nside) off the pixel centres, a smoothing
# that is first order in the field and shows alone on the Born map read
# there; the rest is post-Born and shrinks with the field. At CL_WEAK of
# the shells the traced map against CL_WEAK times that read Born map is
# held to CL_WEAK times the bars above: a fault linear in the field (the
# float32 scan's gap, a wrong table) keeps its size there
CL_NUDGE, CL_WEAK = 0.02, 0.1
CL_OMEGA, CL_BB, CL_SOURCE_TOL = 1e-3, 1e-3, 1e-6
# one shell: the smoothed farthest shell (FWHM in arcmin: b_l = 1/e at l ~
# 700, the JAX test's band share) within the JAX test's 2% of max; the raw
# N-body shell, whose pixel-scale power the tracer's 0.02-pixel nudge
# samples, within 1.5 times the JAX package's reach at nside 256
CL_SMOOTH_ARCMIN, CL_ONE_SHELL_TOL, CL_RAW_SHELL_TOL = 16.5, 0.02, 0.037
CL_ELL_D, CL_SHIFT_TOL, CL_FIRST_CORR, CL_FIRST_RMS = 1500.0, 2e-3, 0.65, \
    0.06
CL_NUDGE_TOL = 1e-3
CL_QE_LMAX_OUT, CL_QE_RANGE, CL_QE_BANDS, CL_QE_TOL = 1024, (30, 1000), \
    6, 0.35
CL_FLAT = (1024, 10.0, 8)
CL_FLAT_BAND, CL_FLAT_EB_BAND, CL_FLAT_TOL, CL_N0_TOL = (40, 3000), \
    (40, 1500), 0.15, 0.2
CL_EB_NULL, CL_EB_TOL = 0.05, 0.12
CL_CPU_TOL, CL_CPU_NSIDE, CL_CPU_LMAX, CL_STENCIL_SHARE = 2e-5, 64, 128, \
    0.999
# the stencil's weights on the pixels both devices pick: a weight is a
# position in ring-pixel units, phi 4 nside / 2pi, so one float32 ulp of
# phi near 2pi (the card's contracted multiply-adds) moves it by
# ulp(2pi) 4 nside / 2pi = 1.9e-5 at nside 64; held to 2.5 such ulps
CL_STENCIL_WEIGHT_TOL = 5e-5
# the field-inference and checkpointing phase: (a) examples/field_level_
# inference.py at its own size (grid, box [Mpc/h], KDK steps, z_init,
# noise variance), its two Adam stages (iterations, lr), its HMC (samples,
# warm-up, leapfrogs) and mode-correlation bands (in fundamental modes);
# the card / CPU comparison's Adam iterations and bar on the first loss
# (relative, the same start; the rest within FI_GAP_FACTOR of the CPU's
# own gap from a start moved by 1e-7); (b) full width: particles per side (= mesh), box, steps,
# noise variance, Adam iterations and lr (at the 1.95 Mpc/h cell the chain
# is deeply nonlinear: on the CPU at 64^3 in 125 Mpc/h, the same cell and
# steps, 30 Adam iterations at lr 0.05 raise the loss 8x, at 0.01 lower it
# 3.7x, at 0.003 5.4x: tools/field_sensitivity.py --part lr), the bars
# on the K2 gradient against the
# scatter route's, relative to the max and to the mean (three and 2.6
# times the gaps measured on the H100: 6.7e-3 and 3.8e-4 in three runs,
# where the scatter route from a start moved by 1e-7 of itself parts by
# 6.1e-3 and 8.6e-5, and K2 from itself by 1.9e-3 and 2.2e-5), the bars
# on it against the scatter route that divides by h as K2 does (measured
# 3.6e-4 and 7.8e-6: K2's own gap from itself, with its 3.4e-3 max in
# another run, so 1e-2 and 1e-4), and the steps of that comparison (the
# scatter route's autograd does not fit the card at 10);
# (c) the checkpointed
# evolution's segment steps; the bar on the P(k) of the resumed run
# against the plain one's (relative, every bin), and the factor over two
# plain runs' own gap that the resumed run's gap may reach (positions
# periodic, planes relative to their max), with the floor it may always
# reach; (d) the checkpointed lightcone's depth cut (particles per side,
# planes, pixels) and its planes between saves
FI_EX = (32, 400.0, 4, 9.0, 1e-2)
FI_ADAM, FI_HMC = ((200, 0.1), (200, 0.02)), (24, 24, 6)
FI_BANDS = ((0.5, 4), (4, 8), (8, 12), (12, 16))
FI_CPU_ITERS, FI_CPU_TOL = 12, 1e-5
FI_FULL, FI_FULL_ADAM = (256, 500.0, 10, 1e-2), (50, 0.003)
FI_GRAD_TOL, FI_GRAD_DIV_TOL = (2e-2, 1e-3), (1e-2, 1e-4)
FI_CMP_STEPS = 4
# (b)'s control: the scale error put into the adjoint's position gradient,
# which the bars must catch (on the H100 it moves the gradient by 2.9e-2
# of its max and of its mean)
FI_CTL_SCALE = 1e-2
FI_SEGMENT, FI_PK_TOL, FI_GAP_FACTOR, FI_GAP_FLOOR = 8, 1e-3, 4.0, 1e-5
FI_LC, FI_LC_EVERY = (256, 8, 1024), 4
KERNELS = ("deposit_sorted", "paint_windowed", "pairwise_accumulate",
           "deposit_segmented")
SOURCES = {
    "deposit_sorted": ("astrild_tpu_torch/csrc/deposit_sorted.cu",
                       "astrild_tpu/ops/paint_pallas.py:163"),
    "deposit_segmented": ("astrild_tpu_torch/csrc/deposit_segmented.cu",
                          "astrild_tpu/ops/paint_pallas.py:426"),
    "paint_windowed": ("astrild_tpu_torch/csrc/paint_windowed.cu",
                       "astrild_tpu/ops/paint_pallas.py:651"),
    # K2's gradient: the TPU kernel had none (the JAX package
    # differentiated only the XLA scatter)
    "paint_windowed_adjoint": ("astrild_tpu_torch/csrc/paint_windowed.cu",
                               "astrild_tpu/ops/paint_pallas.py:651"),
    "pairwise_accumulate": ("astrild_tpu_torch/csrc/pairwise_accumulate.cu",
                            "astrild_tpu/ops/pallas_pairwise.py:103"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(card)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from astrild_tpu_torch import _ext

    t0 = time.perf_counter()
    _ext.build(KERNELS)
    for name in KERNELS:
        _ext.load(name)
    log(f"# phase build: {', '.join(KERNELS)} ready in "
        f"{time.perf_counter() - t0:.3f} s")
    for name in KERNELS:
        for line in _ext.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {name}: {line.strip()}")


# K1's kernels by name (csrc/deposit_sorted.cu), for reading a trace
K1_KERNELS = ("deposit_hist", "deposit_plan", "deposit_partition",
              "deposit_bounds", "deposit_zero", "deposit_accumulate")


def compare_k1(keys, n_cells: int, gen, weighted: bool = True) -> float:
    """Both entry points of K1 against the plain version on the same keys:
    `deposit_flat` on the keys as they come, `deposit_sorted` on them
    sorted, counts and (unless told otherwise) random weights in [0.5,
    1.5) carried with their keys; keys outside [0, n_cells) must be
    dropped (the plain version is given only the others). Raises on a
    mismatch; returns the larger max |kernel - plain| of the weighted
    deposits (0 without weights)."""
    from astrild_tpu_torch.ops import paint_cuda

    vals = torch.rand(keys.shape[0], generator=gen, device=keys.device) + 0.5
    keys_sorted, order = torch.sort(keys, stable=False)
    err = 0.0
    for name, deposit, k, v in (
            ("deposit_flat", paint_cuda.deposit_flat, keys, vals),
            ("deposit_sorted", paint_cuda.deposit_sorted, keys_sorted,
             vals[order].contiguous())):
        inside = (k >= 0) & (k < n_cells)
        got = deposit(k, None, n_cells)
        want = paint_cuda.deposit_sorted_reference(k[inside], None, n_cells)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 {name} counts differ from the plain "
                                 f"deposit (n={k.numel()}, "
                                 f"n_cells={n_cells})")
        if not weighted:
            continue
        gotw = deposit(k, v, n_cells)
        wantw = paint_cuda.deposit_sorted_reference(k[inside], v[inside],
                                                    n_cells)
        e = float((gotw - wantw).abs().max()) if n_cells else 0.0
        scale = float(wantw.abs().max()) if n_cells else 0.0
        if e > WEIGHTED_TOL * scale:
            raise AssertionError(f"K1 {name} weighted sums differ: max err "
                                 f"{e} > {WEIGHTED_TOL} * {scale}")
        err = max(err, e)
    return err


def phase_kernel_check(dev, seed: int) -> None:
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand_keys(n, n_cells):
        return torch.randint(0, n_cells, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def ints(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    def shuffled(keys):
        return keys[torch.randperm(keys.numel(), generator=gen, device=dev)]

    last = 5 * 8192 + 77
    plane = 4 * 2048 * 2048 + 1  # four 2048^2 planes and the junk cell
    huge = (1 << 30) + 5
    outside = [-1, -7, -(1 << 31), (1 << 31) - 1]
    # (keys, n_cells, weighted). 2^24 weights summed in one cell round by
    # ~2^12 in float32 in both versions (2e-4 of the sum, above the bar),
    # so that case deposits counts (exact up to 2^24)
    cases = {
        "2^24 keys into 2^24 cells": (rand_keys(1 << 24, 1 << 24), 1 << 24,
                                      True),
        "empty windows (1000 keys, 2^22 cells)": (rand_keys(1000, 1 << 22),
                                                  1 << 22, True),
        "no keys": (torch.zeros(0, dtype=torch.int32, device=dev), 1000,
                    True),
        "all keys in one cell": (torch.full((100000,), 12345,
                                            dtype=torch.int32, device=dev),
                                 1 << 16, True),
        "2^24 keys in one cell, counts": (
            torch.full((1 << 24,), 500, dtype=torch.int32, device=dev), 999,
            False),
        "N not a multiple of the block": (rand_keys((1 << 20) + 12345,
                                                    1 << 20), 1 << 20, True),
        "last window partly filled": (
            torch.cat([rand_keys(5000, last),
                       torch.arange(last - 200, last, dtype=torch.int32,
                                    device=dev).repeat(7)]), last, True),
        "~29 keys a cell over 9 heavy windows": (
            shuffled(torch.arange(3 * 8192, 12 * 8192, dtype=torch.int32,
                                  device=dev).repeat(29)), 1 << 20, True),
        "the lens planes' junk cell n_cells - 1": (
            shuffled(torch.cat([rand_keys(1 << 22, plane - 1),
                                ints([plane - 1]).repeat(100000)])), plane,
            True),
        "keys outside [0, 999) dropped": (
            shuffled(torch.cat([rand_keys(100000, 999),
                                ints(outside + [999, 1006])])), 999, True),
        "2^30 + 5 cells, keys outside dropped": (
            shuffled(torch.cat([rand_keys(1 << 22, huge),
                                ints(outside + [huge, huge - 1])])), huge,
            True),
        "1025 windows (two partition levels)": (
            rand_keys(1 << 22, 1024 * 8192 + 1), 1024 * 8192 + 1, True),
    }
    for name, (keys, n_cells, weighted) in cases.items():
        err = compare_k1(keys, n_cells, gen, weighted)
        torch.cuda.synchronize()
        log(f"# phase kernel: {name}: counts equal (flat and sorted), "
            f"weighted max err {err:.3e}")


def compare_k4(keys, n_cells: int, n_seg: int, gen,
               weighted: bool = True) -> float:
    """K4 vs its plain version on the same keys (counts, and unless told
    otherwise random weights in [0.5, 1.5)); raises on a mismatch, returns
    max |kernel - plain| of the weighted deposit (0 without weights)."""
    from astrild_tpu_torch.ops import paint_cuda

    got = paint_cuda.deposit_flat_segmented(keys, None, n_cells, n_seg)
    want = paint_cuda.deposit_flat_segmented_reference(keys, None, n_cells,
                                                       n_seg)
    if not torch.equal(got, want):
        raise AssertionError(f"K4 counts differ from the plain deposit "
                             f"(n={keys.numel()}, n_cells={n_cells}, "
                             f"n_seg={n_seg})")
    if not weighted:
        return 0.0
    w = torch.rand(keys.shape[0], generator=gen, device=keys.device) + 0.5
    gotw = paint_cuda.deposit_flat_segmented(keys, w, n_cells, n_seg)
    wantw = paint_cuda.deposit_flat_segmented_reference(keys, w, n_cells,
                                                        n_seg)
    err = float((gotw - wantw).abs().max()) if n_cells else 0.0
    scale = float(wantw.abs().max()) if n_cells else 0.0
    if err > WEIGHTED_TOL * scale:
        raise AssertionError(f"K4 weighted sums differ: max err {err} > "
                             f"{WEIGHTED_TOL} * {scale}")
    return err


def lattice_fine_keys(side: int, ngrid: int, dev):
    """Fine NGP keys (fine factor 2, subgrid-major) of the cell centres of
    a side^3 lattice (side = 2 ngrid) in lattice order: the key order of a
    snapshot that keeps its particles where the PM code put them."""
    i = torch.arange(side ** 3, device=dev)
    ux, uy, uz = i // (side * side), (i // side) % side, i % side
    sid = ((ux % 2) * 2 + uy % 2) * 2 + uz % 2
    return ((((sid * ngrid + ux // 2) * ngrid + uy // 2) * ngrid + uz // 2)
            .to(torch.int32))


def phase_k4_check(dev, seed: int) -> None:
    gen = torch.Generator(device=dev).manual_seed(seed + 4)

    def rand_keys(n, n_cells):
        return torch.randint(0, n_cells, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    coherent = lattice_fine_keys(256, 128, dev)
    big = 1 << 24
    last = 5 * 8192 + 77

    def one_cell(n):
        return torch.full((n,), 4321, dtype=torch.int32, device=dev)

    # (keys, n_cells, n_seg, weighted). 2^24 weights summed in one cell
    # round by ~2^12 in float32 in both versions (2e-4 of the sum, above
    # the bar), so that case deposits counts, and the weighted one-cell
    # case holds 10^5 keys, as K1's does
    cases = {
        "2^24 random keys into 2^24 cells": (rand_keys(big, big), big, 64,
                                             True),
        "2^24 coherent (lattice-order) keys": (coherent, big, 64, True),
        "2^24 keys in one cell, counts": (one_cell(big), big, 64, False),
        "10^5 keys in one cell": (one_cell(100000), big, 64, True),
        "coherent keys shuffled": (
            coherent[torch.randperm(big, generator=gen, device=dev)], big,
            64, True),
        "globally sorted keys": (torch.sort(rand_keys(big, big))[0], big,
                                 64, True),
        "fewer keys (40) than segments": (rand_keys(40, 5000), 5000, 64,
                                          True),
        "N not a multiple of the segments": (
            rand_keys((1 << 20) + 12345, 1 << 20), 1 << 20, 64, True),
        "one segment": (rand_keys(1 << 20, 1 << 20), 1 << 20, 1, True),
        "empty windows (1000 keys, 2^22 cells)": (rand_keys(1000, 1 << 22),
                                                  1 << 22, 64, True),
        "last window partly filled": (rand_keys(100000, last), last, 16,
                                      True),
        "no keys": (torch.zeros(0, dtype=torch.int32, device=dev), 1000, 64,
                    True),
    }
    for name, (keys, n_cells, n_seg, weighted) in cases.items():
        err = compare_k4(keys, n_cells, n_seg, gen, weighted)
        torch.cuda.synchronize()
        log(f"# phase k4: {name} (n_seg {n_seg}): counts equal, weighted "
            f"max err {err:.3e}")


def phase_suite(dev, seed: int, runs: int) -> dict:
    from astrild_tpu_torch import suite
    from astrild_tpu_torch.ops import bispectrum, paint_cuda, power

    pos = suite.uniform_positions(N_SIDE, BOX, dev, seed=seed)
    run = suite.make_stages(N_SIDE, NGRID, NPIX, BOX, NPLANES, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the launch counts cover exactly the warm-up and the timed runs
    paint_cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    run(pos)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = run(pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(paint_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if power.last_auto_deposit != "kernel":
        raise AssertionError(f"auto_power_fast chose "
                             f"{power.last_auto_deposit!r}, not the kernel")
    if launches.get("deposit_sorted", 0) < 1 + runs:
        raise AssertionError(f"the suite did not launch K1 once per run: "
                             f"{launches}")

    # stage and matter sub-stage device seconds of one pass, from the
    # program's spans (suite.py, ops/power.py) in a profiler trace
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(pos)
        torch.cuda.synchronize()
    stages = ("matter", "bispectrum", "lensing", "voids")
    parts = {"keygen": "power.keys", "deposit": "power.deposit",
             "fft_bin": "power.fft_bin"}
    spans = _span_ms(prof.key_averages(),
                     tuple(f"suite.{k}" for k in stages)
                     + tuple(parts.values()))
    del prof
    stage_s = {k: spans[f"suite.{k}"]["ms"] / 1e3 for k in stages}
    detail = {"deposit_kind": power.last_auto_deposit,
              **{k: spans[v]["ms"] / 1e3 for k, v in parts.items()}}

    # outputs: shapes and finiteness
    pk, b, kappa, g1, g2, rad = out
    expect = {"P(k)": (pk, (64,)), "kappa": (kappa, (NPIX, NPIX)),
              "gamma1": (g1, (NPIX, NPIX)), "gamma2": (g2, (NPIX, NPIX)),
              "void radii": (rad, (256,))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} (want "
                                 f"{shape}) or non-finite values")
    # B is NaN exactly for the open triangles (zero closed-triangle count)
    n_c = bispectrum.band_limited_size(NGRID, 32.0)
    den = bispectrum.get_bispectrum_tables(n_c, 4, 2.0, 32.0, device=dev)[1]
    if not torch.equal(torch.isfinite(b), den > 1e-10):
        raise AssertionError("bispectrum: finite entries do not match the "
                             "closed triangles")
    n_voids = int((rad > 0).sum())
    if n_voids == 0:
        raise AssertionError("no voids found")

    # the deposit conserves the particle count exactly
    xyz = (pos[:N_SIDE ** 3], pos[N_SIDE ** 3:2 * N_SIDE ** 3],
           pos[2 * N_SIDE ** 3:])
    _, grid = power.auto_power_fast(xyz, NGRID, BOX, nbins=64,
                                    return_coarse_grid=True,
                                    binning=run.binning, deposit="kernel")
    total = int(grid.double().sum())
    if total != N_SIDE ** 3:
        raise AssertionError(f"deposit holds {total} particles, not "
                             f"{N_SIDE ** 3}")
    # kernel deposit vs scatter deposit: same P(k)
    pk_scatter = power.auto_power_fast(xyz, NGRID, BOX, nbins=64,
                                       binning=run.binning,
                                       deposit="scatter").power
    rel = float(((pk - pk_scatter).abs()
                 / pk_scatter.abs().clamp_min(1e-30)).max())
    if not torch.allclose(pk, pk_scatter, rtol=PK_RTOL, atol=0.0):
        raise AssertionError(f"P(k) kernel vs scatter: max rel diff {rel}")
    # uniform particles: shot-noise-subtracted P(k) vanishes at low k
    # (bins 2-16 lie well below the fine grid's NGP aliasing)
    shot = BOX ** 3 / N_SIDE ** 3
    resid = float((pk[2:17] / shot).mean())
    if abs(resid) > 0.05:
        raise AssertionError(f"P(k) of uniform particles is not at the shot "
                             f"noise: mean residual {resid}")
    n_closed = int(den.gt(1e-10).sum())
    log(f"# phase suite: outputs finite; B finite on {n_closed}"
        f"/{den.numel()} closed triangles; {n_voids} voids; P(k) kernel vs "
        f"scatter max rel diff {rel:.2e}; low-k P/shot residual "
        f"{resid:+.4f}")
    result = {
        "suite_s_min": min(times), "suite_s_median": statistics.median(times),
        "suite_s_runs": times, "warmup_s": warm_s, "stages_s": stage_s,
        "matter_detail_s": detail, "deposit": power.last_auto_deposit,
        "peak_mem_gb": peak_gb, "launches": launches,
    }
    log("# suite " + json.dumps(result))
    return launches


def _event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _index_add(keys, n_cells: int, vals=None):
    """The library yardstick of a deposit: one `index_add_` of the weights
    (unit weights if None) at the int32 keys into a grid zeroed first (the
    ones and the grid made ahead)."""
    src = torch.ones(keys.shape[0], device=keys.device) if vals is None \
        else vals
    out = torch.empty(n_cells, device=keys.device)

    def run():
        out.zero_()
        return out.index_add_(0, keys, src)
    return run


def _time_k1(keys, vals, n_cells: int, reps: int = 5) -> dict:
    """K1's two entry points at one shape, in turns: `deposit_flat` on the
    keys as they come (what the callers run), `deposit_sorted` on them
    sorted, the plain version on the keys as they come, and `index_add_`
    on the keys as they come and on the sorted keys; with the byte bound
    of the function ((4 or 8) B an entry read, 4 B a cell written)."""
    from astrild_tpu_torch.ops import paint_cuda

    keys_sorted, order = torch.sort(keys, stable=False)
    vals_sorted = None if vals is None else vals[order].contiguous()
    del order
    fns = {
        "plain": lambda: paint_cuda.deposit_sorted_reference(keys, vals,
                                                             n_cells),
        "flat": lambda: paint_cuda.deposit_flat(keys, vals, n_cells),
        "index_add_unsorted": _index_add(keys, n_cells, vals),
        "sorted": lambda: paint_cuda.deposit_sorted(keys_sorted, vals_sorted,
                                                    n_cells),
        "index_add_sorted": _index_add(keys_sorted, n_cells, vals_sorted),
    }
    ms = {k: [] for k in fns}
    for turn in (list(fns), list(fns)[::-1]):
        for name in turn:
            ms[name].append(_event_ms(fns[name], reps))
    n = keys.shape[0]
    bound = bound_ms((4 if vals is None else 8) * n + 4 * n_cells, n)
    return {"n_keys": n, "n_cells": n_cells, "weighted": vals is not None,
            "reps": reps, "mean": {k: sum(v) / len(v) for k, v in ms.items()},
            "turns": ms, "bound_ms": bound[0], "bound_by": bound[1]}


def _k1_kernel_names(fn) -> dict:
    """Device ms of each kernel one call of `fn` runs, from a profiler
    trace, K1's summed by pass; raises if any is a radix sort (K1 runs
    none) or none is K1's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3)
               for e in prof.key_averages() if e.self_device_time_total > 0]
    if any("RadixSort" in k for k, _ in kernels) \
            or not any(k1 in k for k, _ in kernels for k1 in K1_KERNELS):
        raise AssertionError(f"deposit_flat ran a radix sort or none of "
                             f"K1's kernels: {[k for k, _ in kernels]}")
    ms = {}
    for key, t in kernels:
        name = next((k1 for k1 in K1_KERNELS if k1 in key), key[:40])
        ms[name] = ms.get(name, 0.0) + t
    return ms


def phase_timing(dev, seed: int) -> tuple[float, dict]:
    """K1 at the suite's shape: both entry points against the plain
    version on the suite's uniform keys (counts equal, weighted within
    the bar), their times against `index_add_` (`_time_k1`), and the
    passes of one `deposit_flat` call from a profiler trace, which must
    hold no radix sort. Returns the weighted error and the timings."""
    from astrild_tpu_torch import suite
    from astrild_tpu_torch.ops import paint_cuda, power

    n = N_SIDE ** 3
    n_cells = 8 * NGRID ** 3
    pos = suite.uniform_positions(N_SIDE, BOX, dev, seed=seed)
    keys = power._fast_keys((pos[:n], pos[n:2 * n], pos[2 * n:]), BOX,
                            ngrid=NGRID, fine_factor=2)
    del pos
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    err = compare_k1(keys, n_cells, gen)
    log(f"# phase timing: bench-size K1 vs plain: counts equal, weighted "
        f"max err {err:.3e}")
    timing = _time_k1(keys, None, n_cells, reps=10)
    timing["deposit_flat_passes_ms"] = _k1_kernel_names(
        lambda: paint_cuda.deposit_flat(keys, None, n_cells))
    log("# k1_timing_ms " + json.dumps({"shape": "suite", **timing}))
    return err, timing


# ------------------------------------------------------------------ K2
def compare_k2(pf, w, ngrid: int, box: float, order: int) -> float:
    """K2 vs its plain version on the same flat positions; raises on a
    mismatch, returns max |kernel - plain|."""
    from astrild_tpu_torch.ops import paint_cuda

    got = paint_cuda.paint_windowed(pf, w, ngrid, box, order=order)
    want = paint_cuda.paint_windowed_reference(pf, w, ngrid, box,
                                               order=order)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if err > WEIGHTED_TOL * scale:
        raise AssertionError(f"K2 order {order} differs from the plain "
                             f"painter: max err {err} > {WEIGHTED_TOL} * "
                             f"{scale}")
    mass = float(pf.shape[0] // 3) if w is None else float(w.double().sum())
    # signed weights (a velocity component) may sum to near 0: their total
    # is held against the sum of their magnitudes
    scale = (float(pf.shape[0] // 3) if w is None
             else float(w.double().abs().sum()))
    total = float(got.double().sum())
    if abs(total - mass) > MASS_RTOL * scale:
        raise AssertionError(f"K2 order {order} holds mass {total}, not "
                             f"{mass}")
    return err


def compare_k2_adjoint(pf, w, ngrid: int, box: float, order: int,
                       gen) -> float:
    """K2's adjoint vs its plain version (autograd through
    paint_windowed_reference) on the same positions, weights and a normal
    gradient grid; raises if a gradient is off by more than K2_ADJ_TOL of
    its max, returns the larger of the two relative errors."""
    from astrild_tpu_torch.ops import paint_cuda

    g = torch.randn((ngrid,) * 3, generator=gen, device=pf.device)
    got = paint_cuda.paint_windowed_adjoint(pf, w, g, ngrid, box, order)
    want = paint_cuda.paint_windowed_adjoint_reference(pf, w, g, ngrid, box,
                                                       order)
    rel = 0.0
    for what, a, b in zip(("positions", "weights"), got, want):
        if b is None:
            continue
        rel = max(rel, float((a - b).abs().max() / b.abs().max()))
        if rel > K2_ADJ_TOL:
            raise AssertionError(f"K2's adjoint order {order}: the gradient "
                                 f"of the {what} is off the plain one's by "
                                 f"{rel} of its max > {K2_ADJ_TOL}")
    return rel


def phase_k2_check(dev, seed: int) -> None:
    gen = torch.Generator(device=dev).manual_seed(seed + 2)

    def uniform(n, box=BOX):
        return torch.rand(3 * n, generator=gen, device=dev) * box

    edges = uniform(1 << 20)
    xyz = edges.view(3, 1 << 20)
    n3 = (1 << 20) // 3
    xyz[:, :n3] -= BOX            # a third of the particles below the box
    xyz[:, n3:2 * n3] += BOX      # a third above it
    xyz[:, 0] = torch.tensor([0.0, BOX, -0.0], device=dev)
    # 20,000 particles in one cell: a lost particle (1/N = 5e-5) stays
    # above the mass bar, while float32 sums of ~10^4 per cell stay below
    cell = BOX / 64
    one = (torch.rand(3 * 20000, generator=gen, device=dev) * cell
           + 5 * cell)
    # K2's tiles hold 16 x 16 x 32 base cells (paint_cuda._TILE). On a
    # 128^3 grid: positions on the cell edges where a base cell can change
    # tile (CIC at (k + 0.5) h, TSC at k h, k a multiple of 16) and an ulp
    # to either side; 20,000 particles inside one tile; and a slab 1/20 of
    # the box thick, which leaves most tiles empty
    ng_t, h_t = 128, BOX / 128
    k = torch.arange(0, ng_t + 1, 16, device=dev, dtype=torch.float64)
    on = torch.cat([k, k + 0.5]) * h_t
    pick = on[torch.randint(0, on.numel(), (3 << 20,), generator=gen,
                            device=dev)].to(torch.float32)
    step = torch.randint(-1, 2, pick.shape, generator=gen, device=dev)
    borders = torch.where(step == 0, pick, torch.nextafter(
        pick, torch.where(step < 0, -torch.inf, torch.inf).to(pick)))
    in_tile = (torch.rand(3, 20000, generator=gen, device=dev)
               * torch.tensor([[15.0], [15.0], [31.0]], device=dev)
               + torch.tensor([[16.5], [48.5], [0.5]], device=dev)) * h_t
    slab = uniform(1 << 20).view(3, -1)
    slab[0] = slab[0] * 0.05 + 0.4 * BOX
    cases = {
        "2^24 particles onto 256^3": (uniform(1 << 24), 256),
        "odd grid 97^3": (uniform(1 << 20), 97),
        "edges 0, box, -0.0 and +-box shifts": (edges, 64),
        "all particles in one cell": (one, 64),
        "N not a multiple of the block": (uniform(1000003), 128),
        "particles on tile borders": (borders, ng_t),
        "every particle in one tile": (in_tile.reshape(-1), ng_t),
        "empty tiles (a slab)": (slab.reshape(-1), ng_t),
    }
    for name, (pf, ngrid) in cases.items():
        n = pf.shape[0] // 3
        w = torch.rand(n, generator=gen, device=dev) + 0.5
        errs = {f"{'cic' if order == 2 else 'tsc'}"
                f"{'_w' if wt is not None else ''}":
                compare_k2(pf, wt, ngrid, BOX, order)
                for order in (2, 3) for wt in (None, w)}
        torch.cuda.synchronize()
        log(f"# phase k2: {name}: max err " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))
        adj = {f"{'cic' if order == 2 else 'tsc'}"
               f"{'_w' if wt is not None else ''}":
               compare_k2_adjoint(pf, wt, ngrid, BOX, order, gen)
               for order in (2, 3) for wt in (None, w)}
        torch.cuda.synchronize()
        log(f"# phase k2: {name}: adjoint max err relative to the max "
            + ", ".join(f"{k} {v:.3e}" for k, v in adj.items()))
    for order in (2, 3):
        bad = k2_key_mismatches(borders, ng_t, order)
        log(f"# phase k2: bin pass vs the plain keys on the tile borders, "
            f"order {order}: {bad['keys']} base-cell and {bad['fractions']} "
            f"fraction mismatches of {borders.shape[0] // 3} particles; "
            f"tiles and counts "
            f"{'equal' if bad['tiles_equal'] else 'differ'}")


def k2_key_mismatches(pf, ngrid: int, order: int) -> dict:
    """K2's bin pass against the plain version's keys on the same
    positions: particles whose base cell (or fractions) differ, and whether
    the tiles and per-tile counts agree with the plain keys' (a base cell
    an ulp away that stays in its tile moves no mass out of the tile)."""
    from astrild_tpu_torch.ops import paint_cuda

    tiles, counts, keys, frac = paint_cuda.windowed_bins(pf, ngrid, BOX,
                                                         order)
    want_key, want_frac = paint_cuda._windowed_keys(pf, ngrid, BOX, order)
    want_tiles = paint_cuda._tile_ids(want_key, ngrid, order)
    want_counts = torch.bincount(want_tiles.long(), minlength=counts.numel())
    return {"keys": int((keys != want_key).sum()),
            "fractions": int((frac != want_frac).any(dim=0).sum()),
            "tiles_equal": bool(torch.equal(tiles, want_tiles)
                                and torch.equal(counts.long(), want_counts))}


# ------------------------------------------------------------------ K3
def _pair_counts(pos, n_valid: int, binwidth: float, nbins: int,
                 rows: int = 1024):
    """Pairs i < j < n_valid per bin (for choosing the bins the bar
    applies to)."""
    p = pos[:n_valid]
    counts = torch.zeros(nbins + 1, dtype=torch.int64, device=pos.device)
    for a in range(0, n_valid, rows):
        d = torch.linalg.vector_norm(p[a:a + rows, None, :] - p[None, :, :],
                                     dim=-1)
        t = d / binwidth
        b = torch.where(t < nbins, t.to(torch.int64).clamp(0, nbins), nbins)
        i = torch.arange(a, min(a + rows, n_valid), device=pos.device)
        upper = i[:, None] < torch.arange(n_valid, device=pos.device)[None]
        counts += torch.bincount(b[upper], minlength=nbins + 1)
    return counts[:nbins]


def compare_k3(pos, vel, n_valid: int, binwidth: float, nbins: int,
               block: int = 512):
    """K3 vs its plain version (tiles of `block` rows): rtol K3_RTOL in
    bins of >= K3_MIN_PAIRS pairs (nom, a sum of random-sign terms that can
    cancel, also gets an absolute floor of 1e-6 of its largest |bin|:
    float32 rounding of a sum that size), K3_RTOL of the largest |bin|
    elsewhere. Returns the max abs error, the kernel's and the plain
    version's (nom, den), and the pairs per bin."""
    from astrild_tpu_torch.ops import pairwise_cuda

    got = pairwise_cuda.pairwise_accumulate(pos, vel, n_valid, binwidth,
                                            nbins)
    want = pairwise_cuda.pairwise_accumulate_reference(pos, vel, n_valid,
                                                       binwidth, nbins,
                                                       block=block)
    counts = _pair_counts(pos, n_valid, binwidth, nbins)
    full = counts >= K3_MIN_PAIRS
    err = 0.0
    for what, g, w in zip(("nom", "den"), got, want):
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        scale = w.abs().max()
        bound = torch.where(full, K3_RTOL * w.abs() + 1e-6 * scale,
                            K3_RTOL * scale)
        if bool((diff > bound).any()):
            raise AssertionError(f"K3 {what} differs from the plain tiles: "
                                 f"kernel {g.tolist()} plain {w.tolist()}")
    return err, got, want, counts


def _pair_at(target) -> tuple:
    """(rx, ry) float32 with fadd_rn(fmul_rn(rx, rx), fmul_rn(ry, ry)) ==
    target: a pair at (rx, ry, z) and (0, 0, z) has exactly that s."""
    t = np.float32(target)
    rx = np.float32(np.sqrt(t))
    while np.float32(rx * rx) >= t:
        rx = np.nextafter(rx, np.float32(0.0))
    base = np.float32(rx * rx)
    ry = np.float32(np.sqrt(np.float64(t) - np.float64(base)))
    for _ in range(256):
        s = np.float32(base + np.float32(ry * ry))
        if s == t:
            return rx, ry
        ry = np.nextafter(ry, np.float32(np.inf if s < t else 0.0))
    raise RuntimeError(f"no pair found at s = {t!r}")


def k3_edge_pairs(binw: float, edges, per: int = 64) -> np.ndarray:
    """Pairs along x (and a little y) whose s is s_max of a bin edge (the
    first s beyond it) or an ulp below it, `per` pairs for each, 200 Mpc/h
    apart in z so that only the pairs themselves are in reach."""
    from astrild_tpu_torch.ops.pairwise_cuda import s_max

    targets = []
    for e in edges:
        s = s_max(binw, e)
        targets += [s, np.nextafter(s, np.float32(0.0))]
    rows = []
    for k in range(per * len(targets)):
        rx, ry = _pair_at(targets[k % len(targets)])
        z = np.float32(200.0 * k)
        rows += [(rx, ry, z), (0.0, 0.0, z)]
    return np.asarray(rows, np.float32)


def k3_lattice(side: int = 16, spacing: float = 1.0) -> np.ndarray:
    """A side^3 lattice plus a point at its far corner (so the Morton cells
    align with the lattice): no two tile boxes touch."""
    i = np.arange(side, dtype=np.float32) * spacing
    grid = np.stack(np.meshgrid(i, i, i, indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([grid, np.full((1, 3), side * spacing,
                                         np.float32)])


def phase_k3_check(dev, seed: int) -> None:
    """K3 on uniform tracers and the edge cases (the main path's clustered
    tracers are compared in phase_forward)."""
    from astrild_tpu_torch.ops import pairwise_cuda

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    lo, hi, nb = V12_BINS
    binw = float(np.linspace(lo, hi, nb)[1])
    reach = float(np.sqrt(pairwise_cuda.s_max(binw, nb)))

    def cat(n, box, shift=0.0):
        return (torch.rand((n, 3), generator=gen, device=dev) * box + shift,
                torch.randn((n, 3), generator=gen, device=dev) * 300.0)

    def vel_for(p):
        return torch.randn(p.shape, generator=gen, device=dev) * 300.0

    pos, vel = cat(K3_N, BOX)
    junk_p, junk_v = cat(3000, 100.0)
    junk_p[2900:] = 50.0
    junk_v[2900:] = 1e6
    dup_p, dup_v = cat(3000, 100.0)
    dup_p[1500:] = dup_p[:1500]
    far_p, far_v = cat(2000, 100.0)
    edge_p = torch.from_numpy(k3_edge_pairs(binw, (nb, nb // 2))).to(dev)
    # two clumps of 256 in 2 Mpc/h cubes, their boxes apart by just under
    # and just over the reach along x; the two set-ups 1000 Mpc/h apart
    a = torch.rand((256, 3), generator=gen, device=dev) * 2.0
    shift = torch.tensor([2.0, 0.0, 0.0], device=dev)
    far = torch.tensor([0.0, 1000.0, 0.0], device=dev)
    clumps_p = torch.cat([a, a.flip(0) + shift + reach - 0.05, a + far,
                          a.flip(0) + far + shift + reach + 0.05])
    lattice_p = torch.from_numpy(k3_lattice()).to(dev)
    beyond = "every pair beyond the last bin"
    diagonal = "every pair beyond the last bin, a lattice: diagonal only"
    cases = {
        "2^15 tracers, 500 Mpc/h box": (pos, vel, K3_N, binw, nb),
        "n = 3077, not a multiple of the tile": (*cat(3077, 100.0), 3077,
                                                 binw, nb),
        "junk rows past n_valid = 2900": (junk_p, junk_v, 2900, binw, nb),
        "coincident particles": (dup_p, dup_v, 3000, binw, nb),
        beyond: (far_p, far_v, 2000, 1e-5, nb),
        "pairs at s_max and an ulp below, last and middle edge": (
            edge_p, vel_for(edge_p), edge_p.shape[0], binw, nb),
        "clumps just inside and just outside reach": (
            clumps_p, vel_for(clumps_p), clumps_p.shape[0], binw, nb),
        "2^14 tracers around the origin (negative coordinates)": (
            *cat(1 << 14, 200.0, -100.0), 1 << 14, binw, nb),
        "nbins = 128": (*cat(1 << 14, 100.0), 1 << 14, 0.5, 128),
        diagonal: (lattice_p, vel_for(lattice_p), lattice_p.shape[0], 1e-5,
                   nb),
        "all tracers in one cell": (*cat(4000, 1.0, 10.0), 4000, binw, nb),
    }
    for name, (p, v, n_valid, w, nbins) in cases.items():
        err, (nom, den), _, counts = compare_k3(p, v, n_valid, w, nbins)
        stats = pairwise_cuda.plan_stats(
            pairwise_cuda.plan(p, v, n_valid, w, nbins), nbins)
        if name in (beyond, diagonal) and (float(nom.abs().sum())
                                           or float(den.abs().sum())):
            raise AssertionError("K3 binned pairs beyond the last bin")
        if name == diagonal and (stats["tile_pairs_visited"]
                                 != stats["tiles"]):
            raise AssertionError(f"K3 visited off-diagonal tile pairs of a "
                                 f"lattice beyond reach: {stats}")
        torch.cuda.synchronize()
        log(f"# phase k3: {name}: max err {err:.3e}; in-range pairs "
            f"{int(counts.sum())}; tile pairs visited "
            f"{stats['tile_pairs_visited']} of {stats['tile_pairs']}")


# -------------------------------------------------------- forward model
def _low_mode_power(grid) -> float:
    """Mean |delta_k|^2 of the CIC-compensated modes with 0 < |m| <= 3."""
    from astrild_tpu_torch.ops import power

    n = grid.shape[-1]
    dk = power.delta_k(grid, window="cic")
    ix = power._mode_numbers(n, grid.device)
    iz = power._mode_numbers(n, grid.device, real=True)
    m2 = ix[:, None, None] ** 2 + ix[None, :, None] ** 2 + iz ** 2
    sel = (m2 > 0) & (m2 <= 9.0)
    return float((dk.abs() ** 2)[sel].double().mean())


def _step_split(comps, mom, cosmo, nsteps: int = 3) -> dict:
    """Device milliseconds per step of each part of the real time loop:
    `pm_evolve` over nsteps steps from the snapshot under torch.profiler,
    grouped by the loop's spans (paint, poisson and gather once per step,
    kick twice, drift once); with K2's own kernel time, the device's busy
    time and the host time of the traced call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from astrild_tpu_torch.ops import nbody

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        nbody.pm_evolve(comps, mom, cosmo, PM_SIDE, BOX, 0.9, 1.0, nsteps)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    per_step = {"pm.paint": 1, "pm.poisson": 1, "pm.gather": 1,
                "pm.kick": 2, "pm.drift": 1}
    split = {}
    for e in rows:
        if e.key in per_step:
            split[e.key] = e.device_time_total / 1e3 / e.count * per_step[e.key]
    # the spans also appear on the device's timeline: count kernels only
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and e.key not in per_step]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # K2 is four kernels (csrc/paint_windowed.cu): paint_windowed_bin,
    # _scan, _scatter and _deposit; pm_evolve runs nsteps + 1 force
    # evaluations
    k2_parts = {}
    for e in kernels:
        for part in ("bin", "scan", "scatter", "deposit"):
            if f"paint_windowed_{part}" in e.key:
                k2_parts[part] = (k2_parts.get(part, 0.0)
                                  + e.self_device_time_total / 1e3
                                  / (nsteps + 1))
    return {"ms_per_step": split,
            "k2_kernel_ms_per_paint": sum(k2_parts.values()),
            "k2_parts_ms_per_paint": k2_parts,
            "device_busy_ms": busy_ms, "host_ms": host_ms,
            "idle_share": 1.0 - busy_ms / host_ms, "nsteps": nsteps}


def phase_forward(dev, seed: int):
    """The forward path at the pm_catalog defaults, GR and f(R) from the
    same ICs, then P(k) and v12. Returns the main path's launch counts,
    the GR snapshot (for the K2 timing) and the v12 tracers with their
    bins and K3's max error on them (for the K3 timing)."""
    from astrild_tpu_torch.ops import (linear_power, nbody, paint_cuda,
                                       pairwise, pairwise_cuda, power)
    from astrild_tpu_torch.ops.paint import paint
    from astrild_tpu_torch.utils.cosmology import Cosmology

    gr = Cosmology(Om0=0.3, h=0.7)
    fr = Cosmology(Om0=0.3, h=0.7, fR0=FR0)
    amp = linear_power.normalization(gr)

    def pk_fn(k):
        return linear_power.linear_power(k, gr, 0.0, amplitude=amp)

    def clock(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    evolve_paints = {}
    # the launch counts cover exactly the forward path's run
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    comps, mom = nbody.lpt_catalog(gen, PM_SIDE, BOX, pk_fn, gr, Z_INIT)
    times["ics_s"] = clock(t0)
    p_init = _low_mode_power(paint(comps, PM_SIDE, BOX, window="cic"))
    a0 = 1.0 / (1.0 + Z_INIT)
    snaps = {}
    for name, cosmo in (("gr", gr), ("fofr", fr)):
        before = paint_cuda.LAUNCHES["paint_windowed"]
        t0 = time.perf_counter()
        snaps[name] = nbody.pm_evolve(comps, mom, cosmo, PM_SIDE, BOX, a0,
                                      1.0, PM_STEPS)
        times[f"evolve_{name}_s"] = clock(t0)
        evolve_paints[name] = paint_cuda.LAUNCHES["paint_windowed"] - before
    del comps, mom
    results = {}
    grids = {}
    for name in snaps:
        t0 = time.perf_counter()
        grids[name] = paint(snaps[name][0], PM_SIDE, BOX, window="cic")
        results[name] = power.auto_power(grids[name], BOX, window="cic")
        times[f"pk_{name}_s"] = clock(t0)
    out_gr, mom_gr = snaps["gr"]
    vel_gr = nbody.velocities_kms(mom_gr, 1.0)
    sub = torch.randperm(PM_SIDE ** 3, generator=gen, device=dev)[:V12_N]
    tracers = (torch.stack([c[sub] for c in out_gr], dim=1),
               torch.stack([v[sub] for v in vel_gr], dim=1))
    del vel_gr
    bins = np.linspace(*V12_BINS)
    k3_before = pairwise_cuda.LAUNCHES["pairwise_accumulate"]
    t0 = time.perf_counter()
    rsep, v12 = pairwise.mean_pairwise_velocity(*tracers, bins)
    times["v12_s"] = clock(t0)
    k3_launches = pairwise_cuda.LAUNCHES["pairwise_accumulate"] - k3_before
    launches = {**paint_cuda.LAUNCHES, **pairwise_cuda.LAUNCHES}
    times["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # ---- checks
    for name, n_paint in evolve_paints.items():
        if n_paint < PM_STEPS + 1:
            raise AssertionError(f"{name} evolution launched K2 {n_paint} "
                                 f"times, not >= {PM_STEPS + 1}")
    if k3_launches != 1:
        raise AssertionError(f"v12 launched K3 {k3_launches} times")
    for name, (c, p) in snaps.items():
        if not all(bool(torch.isfinite(t).all()) for t in c + p):
            raise AssertionError(f"{name} snapshot is not finite")
    has_modes = results["gr"].nmodes > 0
    for name, res in results.items():
        if not bool(torch.isfinite(res.power[has_modes]).all()):
            raise AssertionError(f"{name} P(k) is not finite")
    net = [abs(float(p.double().sum())) / float(p.double().abs().sum())
           for p in mom_gr]
    if max(net) > MOMENTUM_TOL:
        raise AssertionError(f"GR momentum not conserved: |sum p|/sum|p| "
                             f"{net}")
    growth = math.sqrt(_low_mode_power(grids["gr"]) / p_init)
    d_ratio = float(gr.growth_factor(0.0) / gr.growth_factor(Z_INIT))
    if abs(growth / d_ratio - 1.0) > GROWTH_TOL:
        raise AssertionError(f"large-scale growth {growth} vs D(0)/D(9) "
                             f"{d_ratio}")
    ratio = (results["fofr"].power / results["gr"].power)[has_modes][:16]
    ratio = ratio.double().cpu().numpy()
    # linear theory's P_fR/P_GR beside it, printed (no check: fR0 = 1e-5
    # at the 500 Mpc/h box's k is beyond linear at z = 0)
    k16 = results["gr"].k[has_modes][:16]
    ratio_theory = (fr.fofr_pk_enhancement(k16, 0.0)
                    / fr.fofr_pk_enhancement(k16, Z_INIT)).double().cpu(
                        ).numpy()
    if ratio.min() < 1.0 or np.any(np.diff(ratio) < 0.0):
        raise AssertionError(f"P_fR/P_GR over the first 16 bins is not >= 1 "
                             f"and rising: {ratio.tolist()}")
    v12_in = v12[:3].cpu().numpy()
    if not np.all(v12_in < 0.0):
        raise AssertionError(f"v12 in the innermost bins is not infall: "
                             f"{v12_in.tolist()}")
    # K3 against its plain version on the main path's own tracers, and the
    # main path's v12 against the plain version's nom / den (the bound
    # follows from compare_k3's on nom and den)
    binw = float(bins[1] - bins[0])
    k3_err, k3_out, (nom_p, den_p), k3_counts = compare_k3(
        *tracers, V12_N, binw, len(bins), block=K3_PLAIN_BLOCK)
    full = k3_counts >= K3_MIN_PAIRS
    # two calls on the same tracers give the same bits
    again = pairwise_cuda.pairwise_accumulate(*tracers, V12_N, binw,
                                              len(bins))
    if not all(torch.equal(x, y) for x, y in zip(k3_out, again)):
        raise AssertionError("two K3 calls on the same tracers differ")
    v12_p = nom_p / den_p
    v12_bound = (2 * K3_RTOL * v12_p.abs()
                 + 1e-6 * nom_p.abs().max() / den_p)
    v12_diff = float((v12 - v12_p).abs()[full].max())
    k3_scale = max(float(nom_p.abs().max()), float(den_p.abs().max()))
    if bool(((v12 - v12_p).abs() > v12_bound)[full].any()):
        raise AssertionError(f"v12 of the main path differs from the plain "
                             f"version's: {v12.tolist()} vs "
                             f"{v12_p.tolist()}")
    k3_large = k3_large_run(out_gr, mom_gr, gen, bins)
    scatter = power.auto_power(paint(out_gr, PM_SIDE, BOX, window="cic",
                                     deposit="scatter"), BOX, window="cic")
    pk_k, pk_s = results["gr"].power[has_modes], scatter.power[has_modes]
    pk_rel = float(((pk_k - pk_s).abs() / pk_s.abs()).max())
    if pk_rel > PK_RTOL:
        raise AssertionError(f"P(k) kernel paint vs scatter paint: max rel "
                             f"diff {pk_rel}")
    del grids, scatter
    split = _step_split(out_gr, mom_gr, gr)
    del snaps
    log(f"# phase forward: finite; K2 launches per evolution "
        f"{evolve_paints}; K3 launches {k3_launches}; |sum p|/sum|p| "
        f"{max(net):.2e}; growth {growth:.5f} vs D(0)/D(9) {d_ratio:.5f}; "
        f"P_fR/P_GR first 16 bins {ratio[0]:.5f} .. {ratio[-1]:.5f} "
        f"(linear theory {ratio_theory[0]:.5f} .. {ratio_theory[-1]:.5f}); "
        f"v12 innermost {v12_in.tolist()}; K3 vs plain on the {V12_N} "
        f"tracers max err {k3_err:.3e} on bin sums up to {k3_scale:.3e}, "
        f"v12 max diff {v12_diff:.3e} km/s; "
        f"P(k) kernel vs scatter max rel diff {pk_rel:.2e}")
    result = {
        **times,
        "step_s_mean": {k: times[f"evolve_{k}_s"] / PM_STEPS
                        for k in evolve_paints},
        "step_split_s": split, "launches": launches,
        "growth": growth, "d_ratio": d_ratio, "momentum": net,
        "pk_ratio_first16": ratio.tolist(),
        "pk_ratio_linear_theory_first16": ratio_theory.tolist(),
        "k_first16": results["gr"].k[has_modes][:16].tolist(),
        "k3_max_abs_err": k3_err, "k3_bin_sum_max": k3_scale,
        "v12": v12.tolist(), "v12_plain": v12_p.tolist(),
        "rsep": rsep.tolist(), "pk_gr": results["gr"].power.tolist()[:64],
        "k3_large": k3_large,
    }
    log("# forward " + json.dumps(result))
    return launches, (out_gr, mom_gr), (*tracers, binw, len(bins), k3_err,
                                        int(k3_counts.sum()))


def k3_large_run(out_gr, mom_gr, gen, bins) -> dict:
    """v12 of K3_LARGE_N tracers drawn from the GR snapshot through K3 (no
    plain version at this size): finite, infall in the innermost bins; its
    time (host clock of the v12 call, CUDA events of K3 alone), the card
    memory it took above what was allocated before, and the plan's scratch
    and visited tile pairs."""
    from astrild_tpu_torch.ops import nbody, pairwise, pairwise_cuda

    dev = out_gr[0].device
    sub = torch.randperm(PM_SIDE ** 3, generator=gen, device=dev)
    sub = sub[:K3_LARGE_N]
    vel = nbody.velocities_kms(mom_gr, 1.0)
    pos = torch.stack([c[sub] for c in out_gr], dim=1)
    vel = torch.stack([v[sub] for v in vel], dim=1)
    binw, nb = float(bins[1] - bins[0]), len(bins)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, v12 = pairwise.mean_pairwise_velocity(pos, vel, bins)
    torch.cuda.synchronize()
    v12_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    k3_ms = _event_ms(lambda: pairwise_cuda.pairwise_accumulate(
        pos, vel, K3_LARGE_N, binw, nb), 2)
    stats = pairwise_cuda.plan_stats(
        pairwise_cuda.plan(pos, vel, K3_LARGE_N, binw, nb), nb)
    inner = v12[:3].cpu().numpy()
    if not bool(torch.isfinite(v12).all()) or not np.all(inner < 0.0):
        raise AssertionError(f"v12 of {K3_LARGE_N} tracers is not finite "
                             f"with infall inside: {v12.tolist()}")
    # the earlier all-tile-pairs design's partial rows: one per (i-tile,
    # j-tile) pair of 256 rows
    old_tiles = -(-K3_LARGE_N // 256)
    result = {"n": K3_LARGE_N, "v12_s": v12_s, "k3_ms": k3_ms,
              "peak_above_base_bytes": peak, **stats,
              "old_design_partials_bytes":
                  old_tiles * (old_tiles + 1) // 2 * 2 * nb * 4,
              "v12": v12.tolist()}
    log(f"# phase forward: K3 on {K3_LARGE_N} tracers: v12 {v12_s:.4f} s, "
        f"K3 {k3_ms:.3f} ms, scratch {stats['scratch_bytes']} B (peak "
        f"{peak} B above base), tile pairs visited "
        f"{stats['tile_pairs_visited']} of {stats['tile_pairs']}; v12 "
        f"innermost {inner.tolist()}")
    return result


def phase_k2_timing(out_gr) -> dict:
    """K2 vs its plain version at the forward path's shape (the evolved GR
    snapshot, 512^3 particles onto 512^3), CIC and TSC, in turns (plain,
    kernel, kernel, plain); with the device time of each of K2's four
    kernels in one traced call, the bin pass's mismatches against the
    plain keys on that snapshot and the per-tile particle counts (the
    deposit's load balance)."""
    from torch.profiler import ProfilerActivity, profile

    from astrild_tpu_torch.ops import paint_cuda

    pf = torch.cat(out_gr)
    stats = {}
    for order, label in ((2, "cic"), (3, "tsc")):
        err = compare_k2(pf, None, PM_SIDE, BOX, order)
        bad = k2_key_mismatches(pf, PM_SIDE, order)
        counts = paint_cuda.windowed_bins(pf, PM_SIDE, BOX, order)[1]
        fns = {
            "plain": lambda: paint_cuda.paint_windowed_reference(
                pf, None, PM_SIDE, BOX, order),
            "kernel": lambda: paint_cuda.paint_windowed(pf, None, PM_SIDE,
                                                        BOX, order),
        }
        ms = {k: [] for k in fns}
        for turn in (list(fns), list(fns)[::-1]):
            for name in turn:
                ms[name].append(_event_ms(fns[name], 3))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fns["kernel"]()
            torch.cuda.synchronize()
        parts = {part: sum(e.self_device_time_total for e in
                           prof.key_averages()
                           if f"paint_windowed_{part}" in e.key) / 1e3
                 for part in ("bin", "scan", "scatter", "deposit")}
        stats[label] = {"max_abs_err": err, "mismatches": bad,
                        "kernel_parts_ms": parts,
                        "tile_particles_max": int(counts.max()),
                        "tiles_empty": int((counts == 0).sum()),
                        "tiles": counts.numel(),
                        "mean": {k: sum(v) / len(v) for k, v in ms.items()},
                        "turns": ms}
        del counts
    log("# k2_timing_ms " + json.dumps({"n": PM_SIDE ** 3,
                                        "ngrid": PM_SIDE, **stats}))
    return stats


# ------------------------------------------------------------ file lane
def _write_snapshot(directory: Path, pos, vel, ids) -> None:
    """The particles as LANE_FILES Gadget files snap_000.0 .. .7 (one
    slice of the given order each; SnapFormat 2)."""
    from astrild_tpu_torch.io.gadget_binary import write_gadget

    bounds = np.linspace(0, len(pos), LANE_FILES + 1).astype(np.int64)
    for f in range(LANE_FILES):
        sl = slice(bounds[f], bounds[f + 1])
        write_gadget(directory / f"snap_000.{f}", pos[sl], vel[sl], ids[sl],
                     BOX, redshift=0.0, omega_m=0.3, omega_l=0.7,
                     hubble=0.7, snap_format=2)


def phase_file_lane(dev, seed: int, comps, mom) -> tuple:
    """The file-driven P(k) lane on the GR z=0 snapshot. Returns the
    lane's launch counts, K4's max error against its plain version on the
    file-order keys, and the file-order and shuffled keys (for the K4
    timing)."""
    from astrild_tpu_torch.io.gadget_binary import read_gadget_multi
    from astrild_tpu_torch.models import Ecosmog, PowerSpectrum3D
    from astrild_tpu_torch.ops import nbody, paint_cuda, power

    n = comps[0].shape[0]
    n_cells = 8 * LANE_NGRID ** 3
    times = {}
    t0 = time.perf_counter()
    pos = torch.stack(comps, dim=1).cpu().numpy()
    vel = torch.stack(nbody.velocities_kms(mom, 1.0), dim=1).cpu().numpy()
    ids = np.arange(n, dtype=np.uint32)
    times["d2h_s"] = time.perf_counter() - t0

    lane_dir = (Path(__file__).resolve().parent / "build"
                / f"file_lane_{os.getpid()}")
    lane_dir.mkdir(parents=True, exist_ok=False)
    try:
        need = pos.nbytes + vel.nbytes + ids.nbytes + LANE_FILES * 1024
        free = shutil.disk_usage(lane_dir).free
        if free < need + (1 << 30):
            raise RuntimeError(
                f"file lane: {lane_dir} has {free / 1e9:.2f} GB free; the "
                f"8-file snapshot needs {need / 1e9:.2f} GB and 1 GB spare")
        t0 = time.perf_counter()
        _write_snapshot(lane_dir, pos, vel, ids)
        times["write_s"] = time.perf_counter() - t0
        times["bytes_written"] = sum(
            p.stat().st_size for p in lane_dir.iterdir())

        t0 = time.perf_counter()
        header, data = read_gadget_multi(str(lane_dir / "snap_000"))
        # host split into flat components, as bench.py's file lane does
        xyz = [np.ascontiguousarray(data["pos"][:, i]) for i in range(3)]
        times["load_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(lane_dir)
    if int(header["npart"].sum()) != n or header["BoxSize"] != BOX:
        raise AssertionError(f"file lane: header npart {header['npart']} "
                             f"BoxSize {header['BoxSize']}")
    for key, want in (("pos", pos), ("vel", vel), ("ids", ids)):
        if not np.array_equal(data[key].view(np.uint32),
                              want.view(np.uint32)):
            raise AssertionError(f"file lane: {key} read back differs from "
                                 f"what was written")
    pos_read, vel_read = data["pos"], data["vel"]
    del data, pos, vel

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    file_xyz = tuple(torch.from_numpy(c).to(dev) for c in xyz)
    torch.cuda.synchronize()
    times["transfer_s"] = time.perf_counter() - t0
    del xyz
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    perm = torch.randperm(n, generator=gen, device=dev)
    shuf_xyz = tuple(c[perm] for c in file_xyz)
    binning = power.get_fast_binning(LANE_NGRID, LANE_BINS, 2, device=dev)

    def pk(xyz, deposit):
        return power.auto_power_fast(xyz, LANE_NGRID, BOX, nbins=LANE_BINS,
                                     binning=binning, deposit=deposit).power

    # the lane's own run: the launch counts cover exactly these calls
    paint_cuda.LAUNCHES.clear()
    spectra = {}
    for order, xyz in (("file", file_xyz), ("shuffled", shuf_xyz)):
        for deposit in ("kernel_seg", "kernel"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            spectra[f"{deposit}_{order}"] = pk(xyz, deposit)
            torch.cuda.synchronize()
            times[f"compute_{deposit}_{order}_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, facade_pk = PowerSpectrum3D().power_from_points(
        torch.stack(file_xyz, dim=1), BOX, LANE_NGRID, nbins=LANE_BINS,
        method="fast")
    times["facade_s"] = time.perf_counter() - t0
    vel_dev = tuple(torch.from_numpy(np.ascontiguousarray(vel_read[:, i]))
                    .to(dev) for i in range(3))
    del vel_read
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fields = Ecosmog(dir_sim=str(Path(__file__).resolve().parent),
                     boxsize=BOX, domain_level=LANE_NGRID).density_fields(
        file_xyz, vel_dev, window="tsc",
        fields=("density", "velocity", "divergence"))
    torch.cuda.synchronize()
    times["density_fields_s"] = time.perf_counter() - t0
    launches = dict(paint_cuda.LAUNCHES)
    times["compute_s"] = times["compute_kernel_seg_file_s"]
    # the facade given the positions as read (numpy, no `device=`) runs on
    # the card: one more K1 launch, the same P(k)
    t0 = time.perf_counter()
    _, facade_numpy_pk = PowerSpectrum3D().power_from_points(
        pos_read, BOX, LANE_NGRID, nbins=LANE_BINS, method="fast")
    times["facade_numpy_s"] = time.perf_counter() - t0
    numpy_launches = (paint_cuda.LAUNCHES["deposit_sorted"]
                      - launches["deposit_sorted"])
    del pos_read

    # ---- checks
    expect = {"deposit_segmented": 2, "deposit_sorted": 3,
              "paint_windowed": 4}
    if any(launches.get(k, 0) != v for k, v in expect.items()):
        raise AssertionError(f"file lane launches {launches}, expected "
                             f"{expect}")
    if numpy_launches != 1:
        raise AssertionError(f"the facade given numpy positions launched "
                             f"K1 {numpy_launches} times, not once")
    keys_file = power._fast_keys(file_xyz, BOX, ngrid=LANE_NGRID,
                                 fine_factor=2)
    keys_shuf = keys_file[perm]
    deps = {f"{name}_{order}": fn(keys, None, n_cells)
            for order, keys in (("file", keys_file), ("shuffled", keys_shuf))
            for name, fn in (("k4", paint_cuda.deposit_flat_segmented),
                             ("k1", paint_cuda.deposit_flat))}
    ref = deps["k1_file"]
    for name, dep in deps.items():
        if not torch.equal(dep, ref):
            raise AssertionError(f"file lane: fine deposit {name} differs "
                                 f"from k1_file")
    if int(ref.double().sum()) != n:
        raise AssertionError("file lane: the fine deposit does not hold N")
    del deps, ref
    k4_err = compare_k4(keys_file, n_cells, 64, gen)
    scatter = pk(file_xyz, "scatter")
    has = binning[2] > 0
    rel = {}
    facades = {"facade": facade_pk, "facade_numpy": facade_numpy_pk}
    for name, p in {**spectra, **{k: torch.from_numpy(v).to(dev)
                                  for k, v in facades.items()}}.items():
        rel[name] = float(((p - scatter).abs()
                           / scatter.abs().clamp_min(1e-30))[has].max())
        if not bool(torch.isfinite(p[has]).all()) or rel[name] > PK_RTOL:
            raise AssertionError(f"file lane: P(k) {name} vs the scatter "
                                 f"deposit's: max rel diff {rel[name]}")
    for name, t in fields.items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"file lane: {name} grid is not finite")
    cell = (BOX / LANE_NGRID) ** 3
    mass = float(fields["density"].double().sum()) * cell
    if abs(mass - n) > MASS_RTOL * n:
        raise AssertionError(f"file lane: density holds mass {mass}, not "
                             f"{n}")
    log(f"# phase file lane: {LANE_FILES} files read back bit for bit; K4 "
        f"{launches['deposit_segmented']}, K1 {launches['deposit_sorted']}, "
        f"K2 {launches['paint_windowed']} launches; four fine deposits "
        f"equal; P(k) max rel diff vs scatter "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f"; density mass {mass:.1f} of {n}; K4 vs plain on the file "
        f"order max err {k4_err:.3e}")
    result = {**times, "n": n, "files": LANE_FILES, "ngrid": LANE_NGRID,
              "nbins": LANE_BINS, "launches": launches,
              "pk_max_rel_diff_vs_scatter": rel, "k4_max_abs_err": k4_err,
              "pk_file_kernel_seg": spectra["kernel_seg_file"].tolist()}
    log("# file_lane " + json.dumps(result))
    del fields, vel_dev, shuf_xyz, file_xyz
    return launches, k4_err, (keys_file, keys_shuf)


def phase_k4_timing(keys_file, keys_shuf) -> dict:
    """K4 against its plain version at the lane's shape (2^27 keys into
    2^27 cells) on the file order and the shuffled order, in turns (plain,
    kernel, ..., kernel, plain): the whole K4 wrapper (counts and
    weighted), `index_add_` of the same keys (alone, and with the plain
    deposit's int64 cast and ones) and K1's `deposit_flat`."""
    from astrild_tpu_torch.ops import paint_cuda

    n_cells = 8 * LANE_NGRID ** 3
    stats = {}
    for label, keys in (("file", keys_file), ("shuffled", keys_shuf)):
        w = torch.rand(keys.shape[0], device=keys.device) + 0.5
        fns = {
            "plain": lambda: paint_cuda.deposit_flat_segmented_reference(
                keys, None, n_cells),
            "kernel": lambda: paint_cuda.deposit_flat_segmented(
                keys, None, n_cells),
            "kernel_weighted": lambda: paint_cuda.deposit_flat_segmented(
                keys, w, n_cells),
            "index_add": _index_add(keys, n_cells),
            "index_add_with_cast": lambda: paint_cuda.deposit_sorted_reference(
                keys, None, n_cells),
            "k1_flat": lambda: paint_cuda.deposit_flat(keys, None,
                                                       n_cells),
        }
        ms = {k: [] for k in fns}
        for turn in (list(fns), list(fns)[::-1]):
            for name in turn:
                ms[name].append(_event_ms(fns[name], 5))
        stats[label] = {"mean": {k: sum(v) / len(v) for k, v in ms.items()},
                        "turns": ms}
        del w, fns
    log("# k4_timing_ms " + json.dumps({"n_keys": keys_file.numel(),
                                        "n_cells": n_cells, **stats}))
    return stats


# ------------------------------------------------------------ lightcone
def _span_ms(rows, names) -> dict:
    """Device milliseconds and call counts of the named profiler spans."""
    return {e.key: {"ms": e.device_time_total / 1e3, "count": e.count}
            for e in rows if e.key in names}


def _kernel_ms(rows, names) -> float:
    """Device milliseconds of the kernels whose name holds one of
    `names`."""
    return sum(e.self_device_time_total for e in rows
               if any(name in e.key for name in names)) / 1e3


def _corr(a, b) -> float:
    a = a.double() - a.double().mean()
    b = b.double() - b.double().mean()
    return float((a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum()))


def _mode_numbers_1d(n: int, dev):
    """Integer FFT mode numbers of a length-n axis, float32."""
    k = torch.arange(n, device=dev)
    return ((k + n // 2) % n - n // 2).to(torch.float32)


def _block_mean(img, f: int):
    n = img.shape[-1] // f
    return img.reshape(n, f, n, f).mean(dim=(1, 3))


def lightcone_planes(dev, seed: int, out_gr) -> dict:
    """`pm_lightcone_planes` at full width under the profiler, its checks,
    Born kappa, C_ell against halofit, peaks, the ray trace, and one plane
    of the GR z=0 snapshot through K1 against the scan."""
    from torch.profiler import ProfilerActivity, profile

    from astrild_tpu_torch.ops import (angular_power, lens_planes, lensing,
                                       linear_power, nbody, paint_cuda,
                                       peaks, raytrace)
    from astrild_tpu_torch.utils.cosmology import Cosmology

    gr = Cosmology(Om0=0.3, h=0.7)
    amp = linear_power.normalization(gr)

    def pk_fn(k):
        return linear_power.linear_power(k, gr, 0.0, amplitude=amp)

    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    rgen = torch.Generator(device=dev).manual_seed(seed + 104)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the launch counts cover exactly the lightcone call
    paint_cuda.LAUNCHES.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        delta, chis, dchi = nbody.pm_lightcone_planes(
            gen, gr, pk_fn, PM_SIDE, BOX, LC_FOV, LC_NPIX, LC_PLANES,
            z_source=LC_Z_SOURCE, z_init=Z_INIT, nsteps_init=LC_STEPS_INIT,
            steps_per_plane=LC_STEPS_PLANE, randomize_generator=rgen)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
    launches = dict(paint_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = prof.key_averages()
    pm_spans = ("pm.paint", "pm.poisson", "pm.gather", "pm.kick", "pm.drift")
    spans = _span_ms(rows, ("lightcone.plane", "planes.keys",
                            "planes.flush") + pm_spans)
    evolve_s = sum(spans[k]["ms"] for k in pm_spans) / 1e3
    k1_ms = _kernel_ms(rows, K1_KERNELS)
    radix_ms = _kernel_ms(rows, ("RadixSort",))
    del prof, rows

    # ---- checks
    steps = LC_STEPS_INIT + (LC_PLANES - 1) * LC_STEPS_PLANE
    # every pm_evolve call evaluates the force once before its first step
    expect = {"deposit_sorted": LC_PLANES, "paint_windowed": steps + LC_PLANES}
    if any(launches.get(k, 0) != v for k, v in expect.items()):
        raise AssertionError(f"lightcone launches {launches}, expected "
                             f"{expect}")
    if spans["planes.flush"]["count"] != LC_PLANES:
        raise AssertionError(f"lightcone flushed {spans['planes.flush']} "
                             f"times, not once per plane")
    if tuple(delta.shape) != (LC_PLANES, LC_NPIX, LC_NPIX) \
            or not bool(torch.isfinite(delta).all()):
        raise AssertionError("lightcone planes: wrong shape or not finite")
    means = delta.mean(dim=(1, 2))
    stds = delta.std(dim=(1, 2), correction=0)
    if bool((means.abs() >= 0.5 * stds).any()):
        raise AssertionError(f"lightcone planes: |mean| not below half the "
                             f"std: {means.tolist()} vs {stds.tolist()}")
    chi_s = float(gr.comoving_distance(LC_Z_SOURCE))
    far = (LC_PLANES - 0.5) / LC_PLANES * chi_s
    if abs(float(chis[-1]) - far) > 1e-2 * chi_s \
            or abs(dchi * LC_PLANES - chi_s) > 1e-3 * chi_s:
        raise AssertionError(f"lightcone geometry: chis[-1] {float(chis[-1])}"
                             f", dchi {dchi}, chi_s {chi_s}")

    z_pl = gr.redshift_at_comoving_distance(chis.cpu().numpy())
    a_pl = torch.as_tensor(1.0 / (1.0 + z_pl), dtype=torch.float32,
                           device=dev)
    dchis = torch.full((LC_PLANES,), dchi, device=dev)
    kappa = lensing.born_convergence(delta, chis, dchis, chi_s, gr.Om0,
                                     scale_factors=a_pl)
    # C_ell over the halofit Limber prediction in ten bands: over the
    # whole map (bands 3,200 wide, most of them beyond the force mesh's
    # resolution: reported) and below LC_ELL_MAX (held to the bars of the
    # JAX package's own lightcone test)
    bands = {}
    for name, ell_max in (("whole_map", None), ("resolved", LC_ELL_MAX)):
        ell, cl = angular_power.cl_flat_sky(kappa, math.degrees(LC_FOV),
                                            nbins=10, ell_max=ell_max)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        theory = angular_power.cl_kappa_limber(ell, gr, LC_Z_SOURCE,
                                               nonlinear=True)
        torch.cuda.synchronize()
        limber_s = time.perf_counter() - t0
        ratio = (cl / theory).double().cpu().numpy()
        bands[name] = {"ell": ell.tolist(), "cl_over_halofit": ratio.tolist(),
                       "band_1_4_mean": float(ratio[1:5].mean())}
    ratio = np.asarray(bands["resolved"]["cl_over_halofit"])
    band = bands["resolved"]["band_1_4_mean"]
    if not 0.55 < band < 1.45 or ratio[0] >= 2.0:
        raise AssertionError(f"lightcone: C_ell / halofit below ell "
                             f"{LC_ELL_MAX}: bands {ratio.tolist()}")
    cat = peaks.find_peaks(kappa, threshold=2.0 * float(kappa.std()))
    if int(cat.n) == 0 or not bool(torch.isfinite(cat.values[0])):
        raise AssertionError("lightcone: no kappa peak above 2 sigma")

    def trace(planes):
        return raytrace.multiplane_raytrace(planes, chis, dchis, chi_s,
                                            gr.Om0, LC_FOV,
                                            scale_factors=a_pl)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traced = trace(delta)
    torch.cuda.synchronize()
    raytrace_s = time.perf_counter() - t0
    if not all(bool(torch.isfinite(t).all()) for t in traced.values()):
        raise AssertionError("lightcone: the ray-traced maps are not finite")
    corr = {f: _corr(_block_mean(traced["kappa"], f), _block_mean(kappa, f))
            for f in (1, 4, 8, LC_BLOCK, 32)}
    omega_share = float(traced["omega"].std() / kappa.std())
    # how far the rays end from their Born lines, in pixels (rms)
    theta = torch.arange(LC_NPIX, device=dev) * (LC_FOV / LC_NPIX)
    ray_shift_pix = float(torch.sqrt(
        ((traced["beta1"] - theta[:, None]) ** 2
         + (traced["beta2"] - theta[None, :]) ** 2).mean())
        / (LC_FOV / LC_NPIX))
    del traced
    # the same trace where the rays stay on their lines: the planes scaled
    # down, at the same size and field, pixel against pixel
    weak = trace(LC_WEAK * delta)["kappa"] / LC_WEAK
    corr_weak = _corr(weak, kappa)
    # (the periodic solve carries no mean, so the maps' means are taken out)
    weak_err = float(((weak - weak.mean()) - (kappa - kappa.mean()))
                     .abs().max() / kappa.abs().max())
    del weak
    # and with the shot noise smoothed over more than the rays' shift: the
    # planes under a periodic Gaussian of LC_SMOOTH pixels, Born and traced
    f = _mode_numbers_1d(LC_NPIX, dev)
    gauss = torch.exp(-0.5 * (2.0 * math.pi * LC_SMOOTH / LC_NPIX) ** 2
                      * (f[:, None] ** 2 + f[None, :LC_NPIX // 2 + 1] ** 2))
    smooth = torch.fft.irfft2(torch.fft.rfft2(delta) * gauss,
                              s=(LC_NPIX, LC_NPIX))
    corr_smooth = _corr(
        trace(smooth)["kappa"],
        lensing.born_convergence(smooth, chis, dchis, chi_s, gr.Om0,
                                 scale_factors=a_pl))
    del smooth, gauss
    if corr[1] <= LC_PIXEL_CORR_FLOOR or corr[LC_BLOCK] <= 0.99 \
            or corr_weak <= 0.999 or corr_smooth <= 0.99 \
            or omega_share >= 0.05:
        raise AssertionError(
            f"lightcone: ray-traced against Born kappa: correlation by "
            f"block size {corr} (pixel floor {LC_PIXEL_CORR_FLOOR}, "
            f"{LC_BLOCK} x {LC_BLOCK} blocks > 0.99), planes x {LC_WEAK} "
            f"{corr_weak} (> 0.999), planes smoothed over {LC_SMOOTH} "
            f"pixels {corr_smooth} (> 0.99), omega rms {omega_share} of "
            f"kappa rms (< 0.05)")

    # one plane (the farthest geometry) of the GR z=0 snapshot through K1
    # against the per-plane scan on the same particles
    geometry = (BOX, far, dchi, 1, LC_FOV, LC_NPIX, 2, None, 0)
    got, _ = lens_planes._plane_counts_deposit(out_gr, *geometry)
    want, _ = lens_planes._plane_counts_scan(out_gr, *geometry)
    scan_err = float((got - want).abs().max())
    scan_max = float(want.max())
    sums = float(got.double().sum()), float(want.double().sum())
    if scan_err > 1e-4 * scan_max + 1e-3 \
            or abs(sums[0] - sums[1]) > 1e-6 * sums[1]:
        raise AssertionError(f"lens plane through K1 differs from the scan: "
                             f"max err {scan_err} on counts up to "
                             f"{scan_max}; sums {sums}")
    del got, want

    # K1 at the lane's plane shape: the farthest plane's entries, in the
    # order a flush hands them to deposit_flat
    keys, vals = lens_planes.plane_entries(out_gr, BOX, far, dchi, LC_FOV,
                                           LC_NPIX)
    k1_timing = _time_k1(keys, vals, LC_NPIX ** 2 + 1)
    del keys, vals

    # a flush is K1 (deposit_flat) and the sum into the planes
    per_plane = {
        "key_pass_ms": spans["planes.keys"]["ms"] / LC_PLANES,
        "flush_ms": spans["planes.flush"]["ms"] / LC_PLANES,
        "k1_ms": k1_ms / LC_PLANES,
        "radix_sort_ms": radix_ms / LC_PLANES,
        "whole_ms": spans["lightcone.plane"]["ms"] / LC_PLANES}
    log(f"# phase lightcone: planes finite; K1 launches "
        f"{launches['deposit_sorted']}, K2 {launches['paint_windowed']}; "
        f"C_ell/halofit below ell {LC_ELL_MAX:.0f} bands "
        f"{np.round(ratio, 3).tolist()}, bands 1-4 mean {band:.3f} (over "
        f"the whole map {bands['whole_map']['band_1_4_mean']:.3f}); "
        f"{int(cat.n)} peaks above 2 sigma, highest "
        f"{float(cat.values[0]):.4f}; rays end {ray_shift_pix:.2f} pixels "
        f"(rms) from their Born lines; ray trace vs Born correlation "
        f"{corr[1]:.5f} at the pixel, {corr[LC_BLOCK]:.5f} on {LC_BLOCK} x "
        f"{LC_BLOCK} block means, {corr_weak:.6f} at the pixel with the "
        f"planes x {LC_WEAK} (max err {weak_err:.2e} of max), "
        f"{corr_smooth:.5f} at the pixel with the planes smoothed over "
        f"{LC_SMOOTH:.0f} pixels; omega rms {omega_share:.4f} of kappa rms; "
        f"one plane through K1 vs the scan "
        f"max err {scan_err:.3e} on counts up to {scan_max:.1f}")
    return {"whole_s": whole_s,
            "evolve_s": evolve_s,
            "planes_s": spans["lightcone.plane"]["ms"] / 1e3,
            "per_plane_ms": per_plane, "limber_s": limber_s,
            "raytrace_s": raytrace_s, "peak_mem_gb": peak_gb,
            "launches": launches, "cl_bands": bands,
            "kappa_rms": float(kappa.std()), "peaks_2sigma": int(cat.n),
            "raytrace_born_corr_by_block": corr,
            "ray_shift_rms_pixels": ray_shift_pix,
            "raytrace_born_corr_weak_planes": corr_weak,
            "raytrace_born_weak_max_err": weak_err,
            "raytrace_born_corr_smoothed_planes": corr_smooth,
            "omega_rms_over_kappa_rms": omega_share,
            "plane_vs_scan_max_err": scan_err, "plane_count_max": scan_max,
            "k1_plane_timing_ms": k1_timing, "kappa_map": kappa}


def lightcone_shells(dev, seed: int, out_gr) -> dict:
    """HEALPix shells of the GR z=0 snapshot through K1 under the profiler
    and their checks."""
    from torch.profiler import ProfilerActivity, profile

    from astrild_tpu_torch.ops import lightcone_sphere, paint_cuda

    n = out_gr[0].shape[0]
    edges = np.linspace(*LC_EDGES)
    nshell = len(edges) - 1
    npix = 12 * LC_NSIDE ** 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the launch counts cover exactly the shell call
    paint_cuda.LAUNCHES.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        delta, chis, dchis = lightcone_sphere.density_shells_healpix(
            out_gr, edges, LC_NSIDE, BOX)
        torch.cuda.synchronize()
        shells_s = time.perf_counter() - t0
    launches = dict(paint_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = prof.key_averages()
    spans = _span_ms(rows, ("shells.keys", "shells.flush"))
    k1_ms = _kernel_ms(rows, K1_KERNELS)
    radix_ms = _kernel_ms(rows, ("RadixSort",))
    del prof, rows
    flushes = spans["shells.flush"]["count"]
    if launches.get("deposit_sorted", 0) != flushes or flushes < 1:
        raise AssertionError(f"shells launched K1 {launches} times in "
                             f"{flushes} flushes")
    if spans["shells.keys"]["count"] != 27:
        raise AssertionError(f"shells painted {spans['shells.keys']} box "
                             f"images, not 27")
    kappa = lightcone_sphere.born_convergence_healpix(
        delta, chis, dchis, LC_SHELL_SOURCE, 0.3)
    means = delta.mean(dim=1)
    if tuple(delta.shape) != (nshell, npix) \
            or not bool(torch.isfinite(kappa).all()) \
            or bool((means.abs() > 0.05).any()):
        raise AssertionError(f"shells: shape {tuple(delta.shape)}, kappa "
                             f"finite {bool(torch.isfinite(kappa).all())}, "
                             f"shell means {means.tolist()}")
    # the counts back from delta = counts / expected - 1: float32 leaves
    # them within ~1e-5 of their integers, far from a half
    expected = (n / BOX ** 3) * (4.0 * math.pi / npix) \
        * np.diff(edges ** 3) / 3.0
    counts = (delta.double() + 1.0) \
        * torch.as_tensor(expected, device=dev)[:, None]
    if float((counts - counts.round()).abs().max()) > 1e-2:
        raise AssertionError("shells: delta does not give back whole counts")
    total = int(counts.round().sum())
    del delta, kappa, counts

    # they hold every (particle, image) pair inside the radial range,
    # counted by a plain pass with the key pass's own float32 distance
    e32 = edges.astype(np.float32)
    x, y, z = out_gr
    obs = BOX / 2.0
    pairs = 0
    for kx in (-1, 0, 1):
        for ky in (-1, 0, 1):
            for kz in (-1, 0, 1):
                dx = x + (kx * BOX - obs)
                dy = y + (ky * BOX - obs)
                dz = z + (kz * BOX - obs)
                chi = torch.sqrt(dx * dx + dy * dy + dz * dz)
                pairs += int(((chi >= float(e32[0])) & (chi < float(e32[-1]))
                              & (chi > 0)).sum())
    if total != pairs:
        raise AssertionError(f"shells hold {total} counts, and {pairs} "
                             f"(particle, image) pairs lie in range")

    # the central box image through K1 against index_add_: equal counts
    edges_dev = torch.as_tensor(e32, device=dev)
    keys, _ = lightcone_sphere._shell_keys(x - obs, y - obs, z - obs,
                                           edges_dev, None, LC_NSIDE, nshell)
    got = paint_cuda.deposit_flat(keys, None, nshell * npix)
    want = torch.zeros(nshell * npix, device=dev).index_add_(
        0, keys, torch.ones(keys.shape[0], device=dev))
    if not torch.equal(got, want):
        raise AssertionError("shells: one box image through K1 differs "
                             "from index_add_")
    del got, want
    k1_timing = _time_k1(keys, None, nshell * npix)
    del keys

    # a weighted call against the scatter deposit of the same keys
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    sub = tuple(c[:LC_WEIGHTED_N] for c in out_gr)
    w = torch.rand(LC_WEIGHTED_N, generator=gen, device=dev) + 0.5
    got = lightcone_sphere.shell_counts_healpix(sub, edges, LC_NSIDE, BOX,
                                                weights=w)
    want = lightcone_sphere.shell_counts_healpix(sub, edges, LC_NSIDE, BOX,
                                                 weights=w,
                                                 deposit="scatter")
    w_err, w_max = float((got - want).abs().max()), float(want.max())
    if w_err > WEIGHTED_TOL * w_max:
        raise AssertionError(f"shells: weighted K1 differs from index_add_: "
                             f"max err {w_err} > {WEIGHTED_TOL} * {w_max}")
    del got, want
    log(f"# phase lightcone: shells: K1 launches "
        f"{launches['deposit_sorted']} in {flushes} flushes; {total} counts "
        f"= the (particle, image) pairs in range ({total / (27 * n):.4f} of "
        f"all); shell means {np.round(means.tolist(), 4).tolist()}; one "
        f"image equal to index_add_; weighted max err {w_err:.3e} on "
        f"counts up to {w_max:.1f}")
    return {"shells_s": shells_s,
            "shells_key_pass_s": spans["shells.keys"]["ms"] / 1e3,
            "shells_flush_s": spans["shells.flush"]["ms"] / 1e3,
            "shells_k1_s": k1_ms / 1e3,
            "shells_radix_sort_s": radix_ms / 1e3, "shells_flushes": flushes,
            "shells_launches": launches, "shells_keys": total,
            "shells_peak_mem_gb": peak_gb,
            "shell_means": means.tolist(), "shells_weighted_max_err": w_err,
            "k1_shell_timing_ms": k1_timing}


def phase_lightcone(dev, seed: int, out_gr) -> tuple:
    """The lane's numbers, and its Born kappa map (for phase 12)."""
    planes = lightcone_planes(dev, seed, out_gr)
    kappa = planes.pop("kappa_map")
    result = {**planes, **lightcone_shells(dev, seed, out_gr)}
    log("# lightcone " + json.dumps(result))
    return result, kappa


# ------------------------------------------------------ clustering lane
def _mean_in(x, y, lo: float, hi: float) -> float:
    """Mean of y over the entries whose x lies in [lo, hi] (NaN left out)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    sel = (x >= lo) & (x <= hi) & np.isfinite(y)
    if not sel.any():
        raise AssertionError(f"no finite entry in [{lo}, {hi}]")
    return float(y[sel].mean())


def _direct_pdf_total(pos, vel, dist_bin: int, vel_bin: int,
                      rows: int = 1024) -> int:
    """Pairs i < j with |r_ij| < dist_bin and 0 <= floor(v12 + vel_bin // 2)
    < vel_bin, v12 the radial pairwise velocity: each block of rows against
    every later row, with the estimator's float32 pair formula."""
    n = pos.shape[0]
    offset = vel_bin // 2
    idx = torch.arange(n, device=pos.device)
    total = 0
    for a in range(0, n, rows):
        rij = pos[None, a:, :] - pos[a:a + rows, None, :]
        dv = vel[None, a:, :] - vel[a:a + rows, None, :]
        dist = torch.sqrt(rij[..., 0] * rij[..., 0] + rij[..., 1] * rij[..., 1]
                          + rij[..., 2] * rij[..., 2])
        v12 = (dv[..., 0] * rij[..., 0] + dv[..., 1] * rij[..., 1]
               + dv[..., 2] * rij[..., 2]) / dist.clamp_min(1e-12)
        vfl = torch.floor(v12 + offset)
        later = idx[None, a:] > idx[a:a + rows, None]
        total += int((later & (dist < dist_bin) & (vfl >= 0)
                      & (vfl < vel_bin)).sum())
    return total


def _stage_runner(seconds: dict, launches: dict):
    """stage(name, fn): fn() on the host clock, synchronized, into
    seconds[name], and the kernel launches it made into launches[name]."""
    from astrild_tpu_torch.ops import paint_cuda, pairwise_cuda

    def stage(name, fn):
        torch.cuda.synchronize()
        before = {**paint_cuda.LAUNCHES, **pairwise_cuda.LAUNCHES}
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        after = {**paint_cuda.LAUNCHES, **pairwise_cuda.LAUNCHES}
        launches[name] = {k: after[k] - before.get(k, 0) for k in after
                          if after[k] != before.get(k, 0)}
        return res

    return stage


def _stage_runner_cpu(seconds: dict):
    """stage(name, fn): fn() on the host clock into seconds[name] (the CPU
    runs of a path, which launch no kernel)."""
    def stage(name, fn):
        t0 = time.perf_counter()
        res = fn()
        seconds[name] = time.perf_counter() - t0
        return res

    return stage


def _held_launches(lane: str, predicted: dict, launches: dict) -> dict:
    """Each stage's launches against the count it predicts, and the lane's
    (the counts cleared at its start) against their sum; raises on a
    difference, returns the sum."""
    from astrild_tpu_torch.ops import paint_cuda, pairwise_cuda

    total = {}
    for name, want in predicted.items():
        if launches[name] != want:
            raise AssertionError(f"{lane}: stage {name} launched "
                                 f"{launches[name]}, predicted {want}")
        for kname, v in want.items():
            total[kname] = total.get(kname, 0) + v
    lane_total = {**paint_cuda.LAUNCHES, **pairwise_cuda.LAUNCHES}
    if {k: v for k, v in lane_total.items() if v} != total:
        raise AssertionError(f"{lane} launched {dict(lane_total)}, "
                             f"predicted {total}")
    return total


def _k2_lane_timing(pf, w, ngrid: int, box: float = BOX,
                    order: int = 2) -> dict:
    """K2 of pf onto ngrid^3 in a box of side `box` (CIC, or TSC with
    order 3; weighted by w, a signed velocity component or masses, or
    counts where w is None) against its plain version and the bound, in
    turns (plain, kernel, kernel, plain), outside the lane's counts; with
    the per-tile particle counts (the deposit's load balance).
    (A profiler trace here, after phase 9's, records none of K2's
    kernels.)"""
    from astrild_tpu_torch.ops import paint_cuda

    weighted = w is not None
    err = compare_k2(pf, w, ngrid, box, order)
    err_counts = compare_k2(pf, None, ngrid, box, order) if weighted \
        else err
    counts = paint_cuda.windowed_bins(pf, ngrid, box, order)[1]
    tiles = {"tile_particles_max": int(counts.max()),
             "tile_particles_mean": float(counts.double().mean()),
             "tiles_empty": int((counts == 0).sum()), "tiles": counts.numel()}
    del counts
    fns = {
        "plain": lambda: paint_cuda.paint_windowed_reference(pf, w, ngrid,
                                                             box, order),
        "kernel": lambda: paint_cuda.paint_windowed(pf, w, ngrid, box,
                                                    order),
    }
    ms = {k: [] for k in fns}
    for turn in (["plain", "kernel"], ["kernel", "plain"]):
        for name in turn:
            ms[name].append(_event_ms(fns[name], 3))
    n = pf.shape[0] // 3
    # 12 B of positions a particle, 4 more of weight where weighted
    bound = bound_ms((16 if weighted else 12) * n + 4 * ngrid ** 3,
                     K2_OPS[order] * n)
    return {"n": n, "ngrid": ngrid, "weighted": weighted, "order": order,
            "max_abs_err": err, "max_abs_err_counts": err_counts,
            **tiles,
            "mean": {k: sum(v) / len(v) for k, v in ms.items()},
            "turns": ms, "bound_ms": bound[0], "bound_by": bound[1]}


def phase_clustering(dev, seed: int, out_gr, mom_gr, tracers) -> dict:
    """The clustering lane on the GR z=0 snapshot (all 2^27 particles on
    256^3 grids) and on the 2^17 v12 tracers: each stage on the host clock,
    its K2 / K3 launches against the count the stage predicts, its checks;
    then K2 at this shape against its plain version and timed."""
    from astrild_tpu_torch.ops import (bao, density_split, fftlog,
                                       linear_power, mocks, nbody, paint_cuda,
                                       pairwise, pairwise_cuda, power, recon,
                                       tpcf, velocity)
    from astrild_tpu_torch.ops.paint import paint
    from astrild_tpu_torch.utils import geometry
    from astrild_tpu_torch.utils.cosmology import Cosmology

    gr = Cosmology(Om0=0.3, h=0.7)
    amp = linear_power.normalization(gr)

    def pk_fn(k):
        return linear_power.linear_power(k, gr, 0.0, amplitude=amp)

    n, ng = PM_SIDE ** 3, CL_NGRID
    vel_gr = nbody.velocities_kms(mom_gr, 1.0)
    tpos, tvel = tracers
    bins = np.linspace(*V12_BINS)
    seconds, launches = {}, {}
    # the K2 / K3 launches each stage makes (paints: velocity_field paints
    # the counts and three weighted components per spectrum, plus the
    # counts grid the lane shares; marked_power paints twice per call;
    # the reconstruction paints the tracers, the initial field, and the
    # shifted data and randoms)
    predicted = {"velocity": {"paint_windowed": 9},
                 "marked": {"paint_windowed": 4}, "cic": {}, "split": {},
                 "recon": {"paint_windowed": 4}, "tpcf": {},
                 "pairs": {"pairwise_accumulate": 1}, "bao_fit": {}}
    out = {}

    stage = _stage_runner(seconds, launches)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the launch counts cover exactly the lane's stages
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()

    # ---- velocity spectra, and the counts grid the lane shares
    def velocity_stage():
        tt = velocity.velocity_divergence_power(out_gr, vel_gr, ng, BOX,
                                                nbins=CL_BINS)
        dt = velocity.delta_theta_cross_power(out_gr, vel_gr, ng, BOX,
                                              nbins=CL_BINS)
        counts = paint(out_gr, ng, BOX)
        dd = power.auto_power(counts, BOX, nbins=CL_BINS, window="cic")
        return tt, dt, counts, dd

    tt, dt, counts, dd = stage("velocity", velocity_stage)
    k = dd.k.cpu().numpy()
    ahf = 100.0 * float(gr.growth_rate(0.0))
    has = dd.nmodes.cpu().numpy() > 0
    for name, res in (("P_thetatheta", tt), ("P_deltatheta", dt)):
        if not bool(torch.isfinite(res.power[dd.nmodes > 0]).all()):
            raise AssertionError(f"{name} is not finite")
    low = has & (k < 0.1)
    p_dt = dt.power.cpu().numpy()
    if not np.all(p_dt[low] < 0):
        raise AssertionError(f"P_deltatheta is not negative below k = 0.1: "
                             f"{p_dt[low].tolist()}")
    vel_ratio = -p_dt / (ahf * dd.power.cpu().numpy())
    out["velocity"] = {"k": k[low].tolist(),
                       "ratio": vel_ratio[low].tolist(),
                       "ratio_mean": float(vel_ratio[low].mean()),
                       "ptt_over_ahf2_pdd": (tt.power.cpu().numpy()[low] / (
                           ahf ** 2 * dd.power.cpu().numpy()[low])).tolist()}
    if not 0.5 < out["velocity"]["ratio_mean"] < 1.5:
        raise AssertionError(f"-P_dtheta / (aHf P_d) below k = 0.1: "
                             f"{vel_ratio[low].tolist()}")

    # ---- marked P(k); p = 0 is the plain P(k) with shot noise V/N
    def marked_stage():
        res, marks = density_split.marked_power(out_gr, ng, BOX, CL_MARK_R,
                                                mark_p=1.0, nbins=CL_BINS)
        res0, _ = density_split.marked_power(out_gr, ng, BOX, CL_MARK_R,
                                             mark_p=0.0, nbins=CL_BINS)
        return res, marks, res0

    res_m, marks, res_m0 = stage("marked", marked_stage)
    if not bool(torch.isfinite(res_m.power[dd.nmodes > 0]).all()):
        raise AssertionError("the marked P(k) is not finite")
    plain = power.auto_power(counts, BOX, nbins=CL_BINS, window="cic",
                             shotnoise=BOX ** 3 / n)
    sel = dd.nmodes > 0
    mark0_rel = float(((res_m0.power - plain.power).abs()
                       / plain.power.abs())[sel].max())
    if mark0_rel > 1e-5:
        raise AssertionError(f"marked P(k) with p = 0 differs from the plain "
                             f"P(k): max rel {mark0_rel}")
    out["marked"] = {"ratio_first8": (res_m.power / plain.power)[sel][:8]
                     .tolist(), "p0_max_rel": mark0_rel,
                     "marks_min_max": [float(marks.min()),
                                       float(marks.max())]}
    del marks

    # ---- counts in cells
    pdf, cc = stage("cic", lambda: density_split.counts_in_cells(
        out_gr, BOX, CL_CIC_CELLS, max_count=CL_CIC_MAX))
    mu, var, skew = density_split.counts_in_cells_moments(cc)
    pdf_sum = float(pdf.double().sum())
    cc_total = float(cc.double().sum())
    if pdf_sum != 1.0 or cc_total != float(n) or not float(var) > float(mu):
        raise AssertionError(f"counts in cells: pdf sums to {pdf_sum}, counts "
                             f"to {cc_total} (not {n}), var {float(var)} vs "
                             f"mean {float(mu)}")
    out["cic"] = {"mean_exact": cc_total / CL_CIC_CELLS ** 3,
                  "mean": float(mu), "var": float(var), "skew": float(skew)}
    del cc, pdf

    # ---- density split around the v12 tracers
    delta = counts / counts.mean() - 1.0
    r_ds, prof = stage("split", lambda: density_split.density_split_profiles(
        delta, BOX, tpos, CL_SPLIT_R, n_quantiles=5, n_query=CL_QUERY,
        r_min=CL_SPLIT_RMIN, r_max=CL_SPLIT_RMAX))
    inner = prof[:, 0].cpu().numpy()
    if not (inner[0] < 0 < inner[-1] and np.all(np.diff(inner) > 0)):
        raise AssertionError(f"density split: innermost bins by quantile "
                             f"{inner.tolist()}")
    out["split"] = {"r": r_ds.tolist(), "inner": inner.tolist(),
                    "profiles": prof.tolist()}

    # ---- BAO reconstruction against the painted 2LPT initial field
    def recon_stage():
        x = (torch.arange(ng, dtype=torch.float32, device=dev) + 0.25) * (
            BOX / ng)
        randoms = torch.stack(torch.meshgrid(x, x, x, indexing="ij"),
                              dim=-1).reshape(-1, 3)
        pos_rec, rand_rec = recon.reconstruct_catalog(out_gr, randoms, ng,
                                                      BOX, smooth=CL_RECON_R)
        del randoms
        # phase 7's initial conditions, from the same seed
        gen = torch.Generator(device=dev).manual_seed(seed)
        comps0, mom0 = nbody.lpt_catalog(gen, PM_SIDE, BOX, pk_fn, gr,
                                         Z_INIT)
        del mom0
        g0 = paint(comps0, ng, BOX)
        del comps0
        g_rec = paint(pos_rec, ng, BOX)
        del pos_rec
        g_rand = paint(rand_rec, ng, BOX)
        del rand_rec
        return (g0 / g0.mean() - 1.0,
                g_rec / g_rec.mean() - g_rand / g_rand.mean())

    delta_l, delta_rec = stage("recon", recon_stage)

    def corr(dg):
        pcc = power.cross_power(dg + 1.0, delta_l + 1.0, BOX, nbins=CL_BINS)
        paa = power.auto_power(dg + 1.0, BOX, nbins=CL_BINS)
        pbb = power.auto_power(delta_l + 1.0, BOX, nbins=CL_BINS)
        return (pcc.power / torch.sqrt(paa.power * pbb.power)).cpu().numpy()

    r_pre, r_post = corr(delta), corr(delta_rec)
    pre, post = _mean_in(k, r_pre, 0.1, 0.3), _mean_in(k, r_post, 0.1, 0.3)
    if not post > pre:
        raise AssertionError(f"reconstruction did not raise the propagator "
                             f"over 0.1-0.3 h/Mpc: {pre} -> {post}")
    out["recon"] = {"k": k[has].tolist(), "r_pre": r_pre[has].tolist(),
                    "r_post": r_post[has].tolist(),
                    "mean_0.1_0.3": [pre, post]}
    del delta_l, delta_rec, delta, counts

    # ---- correlation functions of the v12 tracers
    s_edges = np.linspace(*CL_S_EDGES)
    rp_edges = np.linspace(*CL_RP_EDGES)

    def tpcf_stage():
        r, xi_r = tpcf.tpcf_real(tpos, BOX, s_edges, block=CL_BLOCK)
        pos_s = tpcf.to_redshift_space(tpos, tvel, BOX)
        _, _, xi_smu = tpcf.tpcf_s_mu(pos_s, BOX, s_edges, nmu=CL_NMU,
                                      block=CL_BLOCK)
        rp, wp, _ = tpcf.projected_tpcf(tpos, BOX, rp_edges, CL_PI_MAX,
                                        n_pi=CL_N_PI, block=CL_BLOCK)
        return r, xi_r, xi_smu, rp, wp

    r, xi_r, xi_smu, rp, wp = stage("tpcf", tpcf_stage)
    xi0 = tpcf.tpcf_multipoles(xi_smu, 0).cpu().numpy()
    xi2 = tpcf.tpcf_multipoles(xi_smu, 2).cpu().numpy()
    r = r.cpu().numpy()
    xi_r = xi_r.cpu().numpy()
    boost = _mean_in(r, xi0 / xi_r, 10.0, 40.0)
    quad = _mean_in(r, xi2, 20.0, 60.0)
    k_tab = np.geomspace(1e-3, 30.0, 512)
    wp_th = fftlog.wp_from_pk(k_tab, linear_power.nonlinear_power(
        k_tab, gr, 0.0, amplitude=amp, device=dev), rp, CL_PI_MAX)
    rp, wp_ratio = rp.cpu().numpy(), (wp / wp_th).cpu().numpy()
    wp_mean = _mean_in(rp, wp_ratio, 8.0, 40.0)
    if not (boost > 1.0 and quad < 0.0 and 0.5 < wp_mean < 1.5):
        raise AssertionError(f"tpcf: xi0/xi(r) over 10-40 {boost}, xi2 over "
                             f"20-60 {quad}, wp/theory over 8-40 {wp_mean}")
    out["tpcf"] = {"r": r.tolist(), "xi_r": xi_r.tolist(),
                   "xi0": xi0.tolist(), "xi2": xi2.tolist(),
                   "xi0_over_xi_r_10_40": boost, "xi2_20_60": quad,
                   "rp": rp.tolist(), "wp": wp.tolist(),
                   "wp_over_halofit": wp_ratio.tolist(),
                   "wp_ratio_8_40": wp_mean}

    # ---- pair estimators: the PDF, kSZ and v12 from transverse velocities
    p15, v15 = tpos[:CL_PAIR_N].contiguous(), tvel[:CL_PAIR_N].contiguous()
    pos_lc = geometry.transform_box_to_lc_cart_coords(tpos, BOX, CL_LC_DIST)
    rhat = pos_lc / torch.linalg.vector_norm(pos_lc, dim=1, keepdim=True)
    d_t = -(tvel * rhat).sum(dim=1)
    t1, t2 = geometry.angular_coordinate_in_lc(pos_lc, unit="rad")
    t1, t2 = t1 + 10.0 * math.pi / 180.0, t2 + 10.0 * math.pi / 180.0
    vel_ang = geometry.convert_vec_cart_to_sph(t2, t1, tvel)[:, 1:]

    def pairs_stage():
        pdf2 = pairwise.pairwise_velocity_pdf(p15, v15, 50, 2000,
                                              block=CL_BLOCK)
        r_k, p_k = pairwise.pairwise_ksz_momentum(
            pos_lc[:CL_PAIR_N], d_t[:CL_PAIR_N], bins, block=CL_BLOCK)
        r_v, v12 = pairwise.mean_pv_from_tv(pos_lc, vel_ang, bins)
        return pdf2, r_k, p_k, r_v, v12

    pdf2, r_k, p_k, r_v, v12 = stage("pairs", pairs_stage)
    pdf_total = int(pdf2.double().sum())
    direct = _direct_pdf_total(p15, v15, 50, 2000)
    vc = torch.arange(2000, device=dev, dtype=torch.float64) - 1000 + 0.5
    near = pdf2[:20].double()
    v12_pdf_mean = float((near * vc).sum() / near.sum())
    p_k, v12 = p_k.cpu().numpy(), v12.cpu().numpy()
    ksz_mean = _mean_in(r_k.cpu().numpy(), p_k, 5.0, 40.0)
    tv_mean = _mean_in(r_v.cpu().numpy(), v12, 5.0, 40.0)
    if not (pdf_total == direct and v12_pdf_mean < 0 and ksz_mean > 0
            and tv_mean < 0):
        raise AssertionError(f"pair estimators: PDF total {pdf_total} vs "
                             f"direct {direct}, mean v12 below 20 "
                             f"{v12_pdf_mean}, kSZ over 5-40 {ksz_mean}, "
                             f"transverse v12 over 5-40 {tv_mean}")
    out["pairs"] = {"pdf_total": pdf_total, "direct_total": direct,
                    "pdf_mean_v12_below_20": v12_pdf_mean,
                    "ksz": p_k.tolist(), "ksz_5_40": ksz_mean,
                    "v12_transverse": v12.tolist(), "v12_5_40": tv_mean}
    del pdf2

    # ---- BAO scale of an EH98 Gaussian field
    def bao_stage():
        gen = torch.Generator(device=dev).manual_seed(seed + 7)
        wig = mocks.gaussian_field(gen, ng, BOX, pk_fn)
        res = power.auto_power(wig + 1.0, BOX, nbins=CL_BAO_BINS,
                               kmax=CL_BAO_BINS + 0.5)
        pk = res.power.cpu().numpy().astype(np.float64)
        nm = res.nmodes.cpu().numpy()
        sig = pk * np.sqrt(2.0 / np.maximum(nm, 1))
        return bao.fit_bao_scale(res.k.cpu().numpy(), pk, gr, sigma=sig,
                                 sigma_nl=1.0, kmin=0.04, kmax=0.30,
                                 alphas=np.linspace(*CL_ALPHAS), device=dev)

    fit = stage("bao_fit", bao_stage)
    if not abs(fit.alpha - 1.0) < 3.0 * fit.alpha_err:
        raise AssertionError(f"BAO alpha {fit.alpha} +- {fit.alpha_err}")
    out["bao_fit"] = {"alpha": fit.alpha, "alpha_err": fit.alpha_err,
                      "chi2": fit.chi2, "dof": fit.dof}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    total = _held_launches("clustering lane", predicted, launches)

    # ---- K2 at the lane's shape, outside the counts
    k2 = _k2_lane_timing(torch.cat(out_gr), vel_gr[0].contiguous(), ng)
    del vel_gr
    log(f"# phase clustering: launches {total}; -P_dtheta/(aHf P_d) below "
        f"k=0.1 {out['velocity']['ratio_mean']:.4f}; marked p=0 vs plain max "
        f"rel {mark0_rel:.2e}; CIC mean {out['cic']['mean_exact']} var "
        f"{float(var):.3f}; split inner {inner.round(4).tolist()}; "
        f"propagator 0.1-0.3 {pre:.4f} -> {post:.4f}; xi0/xi_r "
        f"{boost:.4f}, xi2 {quad:.4f}, wp/halofit {wp_mean:.4f}; PDF total "
        f"{pdf_total} = direct {direct}; kSZ {ksz_mean:.4f}; transverse v12 "
        f"{tv_mean:.4f}; BAO alpha {fit.alpha:.4f} +- "
        f"{fit.alpha_err:.4f}; K2 signed vs plain max err "
        f"{k2['max_abs_err']:.3e}, counts {k2['max_abs_err_counts']:.3e}; "
        f"peak {peak_gb:.2f} GB")
    result = {"seconds": seconds, "launches": launches,
              "launches_total": total, "peak_mem_gb": peak_gb, **out,
              "k2_timing_ms": k2}
    log("# clustering " + json.dumps(result))
    return result


# ------------------------------------------------------ galaxy mocks
def _tunnel_forms_timing(pcat) -> dict:
    """find_tunnels' two overlap forms (the K x K matrix, one row a step)
    on the kappa map's candidates at capacities 2^13 and 2^14, with
    find_tunnels_auto's defaults: host seconds (synchronized), the card's
    peak memory above what was held before, and the accepted sets, which
    must be equal."""
    from astrild_tpu_torch.ops import voids

    out = {}
    for cap in (1 << 13, 1 << 14):
        cpos, crad, cvalid, _ = voids._tunnel_candidates(
            pcat.pos.to(torch.float32), pcat.values > float("-inf"),
            LC_NPIX, cap, 1.0)
        res, acc = {"steps": int(cvalid.sum())}, {}
        for form in ("matrix", "per_step"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            acc[form] = voids._greedy_accept(cpos, crad, cvalid, 0.2,
                                             matrix=form == "matrix")
            torch.cuda.synchronize()
            res[form + "_s"] = time.perf_counter() - t0
            res[form + "_peak_gb"] = (torch.cuda.max_memory_allocated()
                                      - base) / 1e9
        if not torch.equal(acc["matrix"], acc["per_step"]):
            raise AssertionError(f"find_tunnels at capacity {cap}: the "
                                 "matrix and per-step forms accept "
                                 "different candidates")
        out[str(cap)] = res
    return out


def _poisson_band(expect: float, lo: float, hi: float) -> tuple:
    """Counts a run may show where theory expects `expect` and the measured
    ratio may lie in [lo, hi]: Poisson's central 99.8% of lo * expect and
    of hi * expect."""
    from scipy.stats import poisson

    return (int(poisson.ppf(0.001, lo * expect)),
            int(poisson.ppf(0.999, hi * expect)))


def phase_galaxy_mocks(dev, seed: int, out_gr, kappa) -> tuple:
    """examples/galaxy_mocks_voids.py at twice its side (a 128^3 Zel'dovich
    halo mock in 500 Mpc/h, HOD galaxies, xi(s, mu) of 2^17 of them in
    redshift space, SVF and 3D watershed voids of their 128^3 CIC grid,
    void profiles), the 2D watershed and find_tunnels_auto on phase 9's
    Born kappa map, and SO halos of the GR z=0 snapshot painted onto
    768^3 against the Tinker08 mass function. Each stage on the host
    clock, its K2 launches against its own count (one galaxy paint, one
    snapshot paint), its checks; then K2 at both new shapes against its
    plain version and timed. Returns the numbers printed in
    `# galaxy_mocks` and the SO catalog (host columns, for phase 15)."""
    from astrild_tpu_torch.ops import (halo_stats, hod, mocks, paint_cuda,
                                       pairwise_cuda, peaks, profiles3d,
                                       so_halos, tpcf, voids, voids3d)
    from astrild_tpu_torch.ops.paint import paint
    from astrild_tpu_torch.utils.constants import RHO_CRIT0
    from astrild_tpu_torch.utils.cosmology import Cosmology

    seconds, launches, out = {}, {}, {}
    predicted = {"halo_mock": {}, "hod": {}, "clustering": {},
                 "voids": {"paint_windowed": 1}, "voids_2d": {},
                 "profiles": {}, "so_paint": {"paint_windowed": 1},
                 "so_halos": {}, "so_stats": {}}

    stage = _stage_runner(seconds, launches)

    def finite(name, *tensors):
        for t in tensors:
            if not bool(torch.isfinite(torch.as_tensor(t)).all()):
                raise AssertionError(f"galaxy mocks: {name} is not finite")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the launch counts cover exactly the path's stages
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()

    # ---- halo mock: the example's toy P(k) and masses
    def halo_stage():
        gen = torch.Generator(device=dev).manual_seed(seed + 12)
        pos, vel = mocks.zeldovich_catalog_with_velocities(
            gen, GM_SIDE, BOX, lambda k: 1.5e5 * k / (1.0 + (k / 0.025) ** 3),
            growth_rate=0.53, device=dev)
        nh = pos.shape[0]
        rng = np.random.default_rng(0)
        m = 10.0 ** rng.uniform(12.2, 14.5, nh)     # toy mass function
        rvir = 0.78 * (m / 1e13) ** (1.0 / 3.0)     # ~ virial scaling
        conc = 9.0 * (m / 1e13) ** (-0.1)
        return pos, vel, [torch.from_numpy(a.astype(np.float32)).to(dev)
                          for a in (m, rvir, conc)]

    hpos, hvel, (hm, hrvir, hconc) = stage("halo_mock", halo_stage)
    finite("halo mock", hpos, hvel)

    # ---- HOD (Zheng+07), compacted on the host
    def hod_stage():
        gen = torch.Generator(device=dev).manual_seed(seed + 13)
        cat = hod.hod_populate(
            gen, hm, hpos[:, 0], hpos[:, 1], hpos[:, 2], hvel[:, 0],
            hvel[:, 1], hvel[:, 2], hrvir, hconc, BOX,
            params=hod.HODParams(*GM_HOD), max_sat=GM_MAX_SAT)
        return hod.compact_catalog(cat), int(cat["overflow"])

    gal, overflow = stage("hod", hod_stage)
    del hpos, hvel, hm, hrvir, hconc
    n_gal = gal["gx"].shape[0]
    gpos = torch.from_numpy(np.stack([gal["gx"], gal["gy"], gal["gz"]],
                                     axis=-1)).to(dev)
    gvel = torch.from_numpy(np.stack([gal["gvx"], gal["gvy"], gal["gvz"]],
                                     axis=-1)).to(dev)
    finite("galaxies", gpos, gvel)
    cen_share = float(gal["is_central"].mean())
    out["hod"] = {"halos": GM_SIDE ** 3, "n_gal": n_gal,
                  "central_share": cen_share, "overflow": overflow}
    if not 1.0 < n_gal / GM_SIDE ** 3 < 4.0 or not 0.2 < cen_share < 0.8:
        raise AssertionError(f"HOD: {out['hod']}")
    del gal

    # ---- xi(s, mu) of a 2^17 subsample in redshift and in real space
    def clustering_stage():
        sub = np.random.default_rng(1).choice(n_gal, GM_SUB, replace=False)
        sub = torch.from_numpy(sub).to(dev)
        pos_s = tpcf.to_redshift_space(gpos[sub], gvel[sub], BOX)
        res = {}
        for name, p in (("rsd", pos_s), ("real", gpos[sub])):
            s_mid, _, xi = tpcf.tpcf_s_mu(p, BOX, np.linspace(*GM_S_EDGES),
                                          nmu=GM_NMU, block=CL_BLOCK)
            res[name] = (tpcf.tpcf_multipoles(xi, 0),
                         tpcf.tpcf_multipoles(xi, 2))
        return s_mid, res

    s_mid, xis = stage("clustering", clustering_stage)
    finite("xi multipoles", *xis["rsd"], *xis["real"])
    s_mid = s_mid.cpu().numpy()
    xi0, xi2 = (t.cpu().numpy() for t in xis["rsd"])
    xi2_real = xis["real"][1].cpu().numpy()
    # The halos are a Zel'dovich lattice of 3.9 Mpc/h spacing, smeared by
    # ~1.3 Mpc/h: below ~3 spacings its pair shells dominate xi, and
    # redshift space smears them along the line of sight only (xi_2 of
    # +0.14 ... -0.07 there). Beyond, Kaiser infall squashes the pairs
    # along the line of sight: xi_2 < 0, and below its real-space value
    # (on the CPU, two seeds: -0.0023 and -0.0040; the shift -0.0039 and
    # -0.0042)
    far = s_mid >= GM_KAISER_S
    xi2_far = float(xi2[far].mean())
    xi2_shift = float((xi2 - xi2_real)[far].mean())
    out["clustering"] = {"s": s_mid.tolist(), "xi0": xi0.tolist(),
                         "xi2": xi2.tolist(),
                         "xi0_real": xis["real"][0].cpu().numpy().tolist(),
                         "xi2_real": xi2_real.tolist(),
                         "xi2_mean_far": xi2_far,
                         "xi2_rsd_minus_real_far": xi2_shift}
    if not xi0[0] > 0 or not xi2_far < 0 or not xi2_shift < 0:
        raise AssertionError(f"xi0 at s={s_mid[0]:.1f} {xi0[0]}; mean xi2 "
                             f"at s >= {GM_KAISER_S} {xi2_far} (real space "
                             f"{xi2_far - xi2_shift})")

    # ---- the galaxies' CIC grid (K2) and the 3D void finders
    def voids_stage():
        grid = paint(tuple(gpos[:, a] for a in range(3)), GM_VGRID, BOX,
                     window="cic")
        delta = grid / torch.mean(grid) - 1.0
        svf = voids3d.svf_voids(delta, BOX, delta_threshold=-0.6,
                                max_voids=256)
        wvf = voids3d.watershed_voids_3d(delta, BOX, max_voids=256,
                                         core_delta=-0.25)
        return grid, svf, wvf

    grid, svf, wvf = stage("voids", voids_stage)
    finite("galaxy grid", grid)
    finite("void catalogs", svf.pos, svf.radius, svf.min_delta, wvf.pos,
           wvf.radius, wvf.min_delta)
    mass_err = abs(float(grid.double().sum()) - n_gal)
    if mass_err > MASS_RTOL * n_gal:
        raise AssertionError(f"galaxy grid holds {float(grid.sum())} of "
                             f"{n_gal}")
    del grid
    n_svf, n_wvf = int(svf.n), int(wvf.n)
    rad = svf.radius[:n_svf]
    if n_svf < 1 or not bool((rad[1:] <= rad[:-1]).all()):
        raise AssertionError(f"SVF: {n_svf} voids, radii not sorted")
    ov = voids3d.sphere_overlap_fraction(svf.pos[:n_svf, None, :],
                                         rad[:, None], svf.pos[None, :n_svf],
                                         rad[None, :], BOX)
    ov.fill_diagonal_(0.0)
    # a void is accepted while the voids accepted before it cover at most
    # half of it
    covered = float(torch.triu(ov.T, diagonal=1).amax()) if n_svf > 1 \
        else 0.0
    if covered > 0.5 + 1e-6:
        raise AssertionError(f"SVF: a void is {covered} covered")
    if n_wvf < 1:
        raise AssertionError("3D watershed: no void")
    out["voids"] = {"svf_n": n_svf, "svf_candidates": int(svf.n_candidates),
                    "svf_r_max": float(rad[0]), "svf_max_covered": covered,
                    "watershed_n": n_wvf,
                    "watershed_candidates": int(wvf.n_candidates),
                    "watershed_r_max": float(wvf.radius[0])}

    # ---- the 2D twins on phase 9's Born kappa map (LC_NPIX^2)
    def voids_2d_stage():
        cat = peaks.find_peaks(kappa, threshold=kappa.std(correction=0),
                               max_peaks=2048, edge_pix=8)
        tun = voids.find_tunnels_auto(cat.pos.to(torch.float32),
                                      cat.values > float("-inf"), LC_NPIX,
                                      max_voids=256)
        f = _mode_numbers_1d(LC_NPIX, dev)
        gauss = torch.exp(-0.5 * (2.0 * math.pi * LC_SMOOTH / LC_NPIX) ** 2
                          * (f[:, None] ** 2
                             + f[None, :LC_NPIX // 2 + 1] ** 2))
        smooth = torch.fft.irfft2(torch.fft.rfft2(kappa) * gauss,
                                  s=(LC_NPIX, LC_NPIX))
        return cat, tun, voids.watershed_voids(smooth, max_voids=256)

    pcat, tun, ws2 = stage("voids_2d", voids_2d_stage)
    finite("2D voids", tun.radius, ws2.radius)
    cap = tun.radius.shape[0]
    if not int(tun.n_candidates) <= cap or int(tun.n) < 1 \
            or int(ws2.n) < 1:
        raise AssertionError(f"find_tunnels_auto: {int(tun.n_candidates)} "
                             f"candidates, capacity {cap}, {int(tun.n)} "
                             f"voids; watershed {int(ws2.n)}")
    out["voids_2d"] = {"peaks": int(pcat.n), "tunnels_n": int(tun.n),
                       "tunnels_candidates": int(tun.n_candidates),
                       "tunnels_capacity": cap,
                       "watershed_n": int(ws2.n),
                       "watershed_r_max_pix": float(ws2.radius[0])}

    # ---- void-centric profiles of all galaxies around the largest voids,
    # the centers in chunks (each is independent: the same result, a
    # bounded (chunk, n_gal, 3) temporary)
    def profiles_stage():
        nv = min(n_svf, GM_NVOIDS)
        centers = svf.pos[:nv]
        ones = torch.ones(n_gal, device=dev)
        rho, vr, cnt = [], [], []
        for a in range(0, nv, GM_CENTRE_CHUNK):
            c = centers[a:a + GM_CENTRE_CHUNK]
            r, rho_c = profiles3d.radial_density_profiles(
                gpos, ones, c, *GM_PROFILE[:2], nbins=GM_PROFILE[2],
                boxsize=BOX)
            _, vr_c, cnt_c = profiles3d.radial_velocity_profiles(
                gpos, gvel, c, *GM_PROFILE[:2], nbins=GM_PROFILE[2],
                boxsize=BOX)
            rho.append(rho_c)
            vr.append(vr_c)
            cnt.append(cnt_c)
        vr, cnt = torch.cat(vr), torch.cat(cnt)
        return r, torch.cat(rho), profiles3d.stacked_profile(vr, cnt), nv

    r, rho, stacked_vr, nv = stage("profiles", profiles_stage)
    finite("density profiles", rho)
    r = r.cpu().numpy()
    dens = (rho.mean(dim=0) / (n_gal / BOX ** 3) - 1.0).cpu().numpy()
    vr = stacked_vr.cpu().numpy()
    r_void = float(svf.radius[:nv].mean())
    # shells inside the mean void radius that hold galaxies (the innermost
    # may hold none: NaN)
    inside = (r < r_void) & np.isfinite(vr)
    if not dens[0] < 0 or not dens[-1] > dens[0] or inside.sum() < 2 \
            or not float(vr[inside].mean()) > 0:
        raise AssertionError(f"void profiles: delta {dens.tolist()}, v_r "
                             f"{vr.tolist()} (inside {r_void:.1f} Mpc/h)")
    out["profiles"] = {"voids": nv, "r": r.tolist(), "delta": dens.tolist(),
                       "v_r": [float(v) if np.isfinite(v) else None
                               for v in vr],
                       "mean_void_radius": r_void,
                       "v_r_inside_mean": float(vr[inside].mean())}
    del gvel, rho

    # ---- SO halos of the GR z=0 snapshot painted onto SO_NGRID^3
    gr = Cosmology(Om0=0.3, h=0.7)
    delta = stage("so_paint",
                  lambda: paint(out_gr, SO_NGRID, BOX, window="cic"))
    delta = delta / torch.mean(delta) - 1.0
    so = stage("so_halos", lambda: so_halos.so_halos(
        delta, BOX, gr.Om0, delta_mean=200.0, n_radii=SO_RADII,
        max_halos=SO_MAX))
    del delta
    finite("SO catalog", so.pos, so.radius, so.mass)
    n_so, n_cand = int(so.n), int(so.n_candidates)
    m_p = gr.Om0 * RHO_CRIT0 * BOX ** 3 / PM_SIDE ** 3
    floor = (4.0 / 3.0 * math.pi * (1.5 * BOX / SO_NGRID) ** 3 * 200.0
             * gr.Om0 * RHO_CRIT0)

    def so_stats_stage():
        d = so_halos.so_catalog_dict(so)
        centers, cum = halo_stats.halo_mass_function(d["mass"], device=dev)

        def n_above(m_lo):
            lnm = np.linspace(np.log(m_lo), np.log(3e15), 64)
            dn = halo_stats.theory_hmf(np.exp(lnm), gr, 0.0,
                                       model="tinker08", device=dev)
            return (int((d["mass"] > m_lo).sum()),
                    float(np.trapezoid(dn.cpu().numpy(), lnm)) * BOX ** 3)

        # a truncated candidate list is complete only above the smallest
        # mass kept
        m_lo = 1.5 * floor
        if n_cand > SO_MAX:
            m_lo = max(m_lo, 1.01 * float(d["mass"].min()))
        bands = {name: (m,) + n_above(m) for name, m in
                 (("low", m_lo), ("3e14", 3e14), ("1e15", 1e15))}
        # the most massive halo's particles within its R200m: its shape
        c = so.pos[0]
        offs = []
        for comp, cc in zip(out_gr, c):
            dd = comp - cc
            offs.append(dd - BOX * torch.round(dd / torch.tensor(
                BOX, device=dev)))
        inside = (offs[0] ** 2 + offs[1] ** 2 + offs[2] ** 2
                  < so.radius[0] ** 2)
        lengths, _ = halo_stats.point_cloud_shape(
            tuple(o[inside] for o in offs))
        return d, centers, cum, bands, lengths, int(inside.sum())

    d, m_centers, cum, bands, lengths, n_in = stage("so_stats",
                                                    so_stats_stage)
    finite("SO mass function", cum, lengths)
    ratios = {k: v[1] / v[2] for k, v in bands.items()}
    lo_band = (0.25, 1.5)
    if not lo_band[0] < ratios["low"] < lo_band[1] \
            or not lo_band[0] < ratios["3e14"] < lo_band[1]:
        raise AssertionError(f"SO n(>M) / Tinker08: {bands}")
    pb = _poisson_band(bands["1e15"][2], *lo_band)
    if not pb[0] <= bands["1e15"][1] <= pb[1]:
        raise AssertionError(f"SO n(>1e15) {bands['1e15'][1]} outside "
                             f"{pb} (Tinker08 {bands['1e15'][2]:.1f})")
    ax = lengths.cpu().numpy()
    if not (ax[0] >= ax[1] >= ax[2] > 0):
        raise AssertionError(f"halo axes {ax.tolist()}")
    out["so_halos"] = {
        "ngrid": SO_NGRID, "n": n_so, "n_candidates": n_cand,
        "max_halos": SO_MAX, "mass_floor": floor,
        "particles_at_floor": floor / m_p,
        "m_max": float(d["mass"][0]) if n_so else 0.0,
        "n_above": {k: {"m": v[0], "measured": v[1], "tinker08": v[2],
                        "ratio": ratios[k]} for k, v in bands.items()},
        "poisson_band_1e15": pb,
        "hmf_cumulative": cum.cpu().numpy().tolist(),
        "hmf_centers": m_centers.cpu().numpy().tolist(),
        "top_halo_particles": n_in,
        "top_halo_axis_ratios": [float(ax[1] / ax[0]), float(ax[2] / ax[0])]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    total = _held_launches("galaxy mocks", predicted, launches)

    # ---- K2 at the two new shapes, outside the counts
    k2 = {"galaxies": _k2_lane_timing(
        torch.cat([gpos[:, a] for a in range(3)]), None, GM_VGRID),
        "snapshot": _k2_lane_timing(torch.cat(out_gr), None, SO_NGRID)}
    del gpos
    tunnel_forms = _tunnel_forms_timing(pcat)
    log(f"# phase galaxy mocks: launches {total}; {n_gal} galaxies "
        f"({cen_share:.3f} centrals, overflow {overflow}); xi0(s="
        f"{s_mid[0]:.1f}) {xi0[0]:.3f}, mean xi2 at s >= {GM_KAISER_S} "
        f"{xi2_far:.4f} (real space {xi2_far - xi2_shift:.4f}); SVF "
        f"{n_svf} voids (R max {out['voids']['svf_r_max']:.2f}), "
        f"watershed {n_wvf}; kappa map: {int(tun.n)} tunnels of "
        f"{int(tun.n_candidates)} candidates (capacity {cap}), watershed "
        f"{int(ws2.n)}; stacked delta {dens[0]:.3f} -> {dens[-1]:.3f}, "
        f"v_r inside {out['profiles']['v_r_inside_mean']:.2f} km/s; SO "
        f"{n_so} halos of {n_cand} candidates, n(>M)/Tinker08 "
        + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items())
        + f"; K2 vs plain max err {k2['galaxies']['max_abs_err']:.3e} "
        f"({GM_VGRID}^3), {k2['snapshot']['max_abs_err']:.3e} "
        f"({SO_NGRID}^3); find_tunnels matrix / per-step s "
        + ", ".join(f"{c}: {v['matrix_s']:.3f} / {v['per_step_s']:.3f}"
                    for c, v in tunnel_forms.items())
        + f"; peak {peak_gb:.2f} GB")
    result = {"seconds": seconds, "launches": launches,
              "launches_total": total, "peak_mem_gb": peak_gb, **out,
              "k2_timing_ms": k2, "tunnel_forms": tunnel_forms}
    log("# galaxy_mocks " + json.dumps(result))
    return result, d


# ------------------------------------------------------- shear-survey path
def _shear_placement_checks(dev) -> list:
    """Each new entry point of the shear path given numpy input and no
    device: its result must lie on the card. Returns the names checked."""
    from astrild_tpu_torch.models import SkyArray
    from astrild_tpu_torch.ops import angular_power, shear_2pt

    rng = np.random.default_rng(13)
    g = rng.normal(size=(32, 32)).astype(np.float32)
    ells = np.geomspace(2.0, 2e4, 64)
    cl = 1e-8 / (1.0 + (ells / 800.0) ** 2) ** 1.5
    edges = np.array([0.1, 1.0, 3.0])
    calls = {
        "cl_to_flat_map_from_white": lambda:
            angular_power.cl_to_flat_map_from_white(g, g, ells, cl, 32, 1.0),
        "kappa_to_shear_maps": lambda:
            angular_power.kappa_to_shear_maps(g)[0],
        "shear_eb_maps": lambda: angular_power.shear_eb_maps(g, g)[0],
        "cl_shear_eb": lambda: angular_power.cl_shear_eb(g, g, 1.0,
                                                         nbins=4)[1],
        "xi_pm_flat_sky": lambda: shear_2pt.xi_pm_flat_sky(g, g, 1.0,
                                                           nbins=4)[1],
        "tangential_shear_stack": lambda: shear_2pt.tangential_shear_stack(
            g, g, np.array([[3, 4]]), np.array([1.0, 4.0, 8.0], np.float32),
            8, 2)[1],
        "xi_pm_catalog": lambda: shear_2pt.xi_pm_catalog(
            g[0], g[1], g[2], g[3], edges, block=32)[0],
        "gamma_t_catalog": lambda: shear_2pt.gamma_t_catalog(
            g[0], g[1], g[2], g[3], g[4], g[5], edges, block=32)[0],
        "xi_pm_from_cl": lambda: shear_2pt.xi_pm_from_cl(ells, cl,
                                                         n=256)[1],
        "xi_pm_from_cl_grid": lambda: shear_2pt.xi_pm_from_cl_grid(
            ells, cl.astype(np.float32))[1],
        "gamma_t_from_cl": lambda: shear_2pt.gamma_t_from_cl(ells, cl,
                                                             n=256)[1],
        "w_theta_from_cl": lambda: shear_2pt.w_theta_from_cl(ells, cl,
                                                             n=256)[1],
        "delta_sigma_from_pk": lambda: shear_2pt.delta_sigma_from_pk(
            ells / 1e3, cl * 1e12, [1.0], 0.3),
        "cosebis_from_xipm": lambda: shear_2pt.cosebis_from_xipm(
            np.geomspace(1.0, 10.0, 8), np.ones(8), np.ones(8), 2, 1.0,
            10.0, ntheta=64)[0],
        "xi_pm_sample_covariance_from_white": lambda:
            shear_2pt.xi_pm_sample_covariance_from_white(
                rng.normal(size=(2, 2, 16, 16)), ells, cl, 16, 1.0, 3)[2],
        "tomographic_xi_pm_sample_covariance_from_white": lambda:
            shear_2pt.tomographic_xi_pm_sample_covariance_from_white(
                rng.normal(size=(2, 16, 16, 1)),
                rng.normal(size=(2, 16, 16, 1)), ells, cl[None, None], 16,
                1.0, 3)[3],
        "SkyArray.from_array": lambda: SkyArray.from_array(g, 1.0).data[
            "orig"],
    }
    for name, fn in calls.items():
        if fn().device.type != "cuda":
            raise AssertionError(f"shear survey: {name} given numpy input "
                                 "did not run on the card")
    return sorted(calls)


def phase_shear_survey(dev, seed: int, kappa_born) -> dict:
    """examples/shear_survey.py stages 1-6 at twice its side (1024^2 over
    10 deg, its 0.59' pixel) and phase 9's 2048^2 Born kappa map: each
    stage on the host clock, synchronized, with K1-K4 held at 0 launches;
    its checks raise. Returns the numbers printed in `# shear_survey`."""
    from astrild_tpu_torch.models import SkyArray
    from astrild_tpu_torch.ops import (angular_power, paint_cuda,
                                       pairwise_cuda, peaks, shear_2pt)
    from astrild_tpu_torch.utils.cosmology import Cosmology

    seconds, launches, out = {}, {}, {}
    stage = _stage_runner(seconds, launches)
    arcmin = math.pi / 180.0 / 60.0

    def finite(name, *arrays):
        for a in arrays:
            a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
            if not np.isfinite(a).all():
                raise AssertionError(f"shear survey: {name} is not finite")

    def theory_at(th_arcmin, tt, xt):
        return np.interp(np.log(np.asarray(th_arcmin) * arcmin),
                         np.log(tt.cpu().numpy()),
                         xt.double().cpu().numpy())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the launch counts cover exactly the path's stages: none of K1-K4
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()
    n, oa = SS_NPIX, SS_OA
    nbins, tmin, tmax = SS_XI
    nmax, cmin, cmax = SS_COSEBIS

    # ---- A1. the example's halofit Limber table -> Gaussian kappa ->
    # periodic spin-2 shear -> SkyArray
    def synthesis_stage():
        ell_tab, cl_tab = _halofit_cl_table(dev, n, oa)
        gen = torch.Generator(device=dev).manual_seed(seed + 42)
        kappa = angular_power.cl_to_flat_map(gen, ell_tab, cl_tab, n, oa)
        g1, g2 = angular_power.kappa_to_shear_maps(kappa)
        sky = SkyArray.from_array(kappa.cpu().numpy(), oa, "kappa_2")
        sky.data["shearx"], sky.data["sheary"] = g1, g2
        return ell_tab, cl_tab, kappa, g1, g2, sky

    ell_tab, cl_tab, kappa, g1, g2, sky = stage("synthesis", synthesis_stage)
    finite("synthesis", cl_tab, kappa, g1, g2)
    if sky.device.type != dev.type:
        raise AssertionError("shear survey: SkyArray of a numpy map is not "
                             "on the card")
    out["kappa_rms"] = float(kappa.std())

    # ---- A2. xi_pm map estimator against the FFTLog theory
    def xi_stage():
        meas = sky.shear_xi_pm(nbins=nbins, theta_min_arcmin=tmin,
                               theta_max_arcmin=tmax)
        return meas, shear_2pt.xi_pm_from_cl(ell_tab, cl_tab)

    (th, xip, xim, npair), (tt, xp_t, xm_t) = stage("xi_pm", xi_stage)
    th, xip, xim, npair = (t.double().cpu().numpy()
                           for t in (th, xip, xim, npair))
    full = npair > 0
    finite("xi_pm", th, xip[full], xim[full], xp_t, xm_t)
    xp_i = theory_at(th, tt, xp_t)
    xm_i = theory_at(th, tt, xm_t)

    # ---- A3. COSEBIs
    e_n, b_n = stage("cosebis", lambda: sky.cosebis(nmax, cmin, cmax))
    e_n, b_n = e_n.double().cpu().numpy(), b_n.double().cpu().numpy()
    finite("COSEBIs", e_n, b_n)

    # ---- A4. exact Gaussian covariance (host float64), with shape noise
    # and without, and the COSEBIs covariances
    noise_cl = SS_SIGMA_E ** 2 / (2.0 * SS_NGAL / arcmin ** 2)

    def covariance_stage():
        kw = dict(theta_min_arcmin=tmin, theta_max_arcmin=tmax)
        th_c, cov = shear_2pt.xi_pm_gaussian_covariance(
            n, oa, ell_tab, cl_tab, nbins, noise_cl=noise_cl, **kw)
        _, cov0 = shear_2pt.xi_pm_gaussian_covariance(
            n, oa, ell_tab, cl_tab, nbins, **kw)
        cb = (shear_2pt.cosebis_covariance(th_c, cov, nmax, cmin, cmax),
              shear_2pt.cosebis_covariance(th_c, cov0, nmax, cmin, cmax))
        return th_c, cov, cov0, cb

    th_c, cov, cov0, ((cov_e, cov_b), (cov_e0, cov_b0)) = stage(
        "covariance", covariance_stage)
    finite("covariances", cov, cov0, cov_e, cov_b, cov_e0, cov_b0)
    sig0 = np.sqrt(np.diag(cov0))
    sig = np.sqrt(np.diag(cov))

    # ---- A5. stacked tangential shear around the kappa peaks
    def stack_stage():
        cat = peaks.find_peaks(kappa, threshold=2.0 * float(
            kappa.std(correction=0)), max_peaks=SS_PEAKS,
            edge_pix=SS_EDGE_PIX)
        nkeep = int(cat.n)
        centers = cat.pos[:max(nkeep, 1)]
        edges = np.linspace(*SS_R_EDGES).astype(np.float32)
        return nkeep, shear_2pt.tangential_shear_stack(
            g1, g2, centers, edges, SS_PATCH, SS_R_EDGES[2] - 1)

    n_peaks, (r_st, gt, gx, cnt_st) = stage("peaks_stack", stack_stage)
    r_st, gt, gx = (t.double().cpu().numpy() for t in (r_st, gt, gx))
    finite("stack", r_st, gt, gx)

    # ---- A6. catalog estimator on the example's galaxy density at 4x its
    # area (periodic), and a full-grid catalog of a periodic 128^2 map
    # against the map estimator (the JAX test's check at a larger size)
    def catalog_stage():
        rng = np.random.default_rng(1)
        idx = rng.integers(0, n, (SS_NCAT, 2))
        pixscale = oa * 60.0 / n
        xq = (idx[:, 0] * pixscale).astype(np.float32)
        yq = (idx[:, 1] * pixscale).astype(np.float32)
        it = torch.from_numpy(idx).to(dev)
        e1 = g1[it[:, 0], it[:, 1]]
        e2 = g2[it[:, 0], it[:, 1]]
        return shear_2pt.xi_pm_catalog(
            xq, yq, e1, e2, np.geomspace(*SS_CAT_EDGES), boxsize=oa * 60.0,
            block=SS_CAT_BLOCK)

    cxp, cxm, ccnt = stage("catalog", catalog_stage)
    cxp, cxm, ccnt = (t.double().cpu().numpy() for t in (cxp, cxm, ccnt))
    finite("catalog xi", cxp, cxm)

    def grid_catalog_stage():
        m = SS_GRID_CAT
        gen = torch.Generator(device=dev).manual_seed(seed + 7)
        k_small = angular_power.cl_to_flat_map(gen, ell_tab, cl_tab, m,
                                               oa * m / n)
        s1, s2 = angular_power.kappa_to_shear_maps(k_small)
        # the JAX test's geometry: 5 bins over 1-11.5 pixels, 1' pixels
        _, xp_map, xm_map, _ = shear_2pt.xi_pm_flat_sky(
            s1, s2, m / 60.0, nbins=5, theta_min_arcmin=1.0,
            theta_max_arcmin=11.5)
        ar = torch.arange(m, device=dev, dtype=torch.float32)
        rr, cc = torch.meshgrid(ar, ar, indexing="ij")
        xp_cat, xm_cat, pairs = shear_2pt.xi_pm_catalog(
            rr.reshape(-1), cc.reshape(-1), s1.reshape(-1), s2.reshape(-1),
            np.geomspace(1.0, 11.5, 6), boxsize=float(m),
            block=SS_CAT_BLOCK)
        var = float((s1 * s1 + s2 * s2).double().mean())
        return xp_map, xm_map, xp_cat, xm_cat, pairs, var

    xp_map, xm_map, xp_cat, xm_cat, grid_pairs, var = stage(
        "grid_catalog", grid_catalog_stage)
    # the JAX test's bar, atol 1e-5 on unit-variance maps: here 1e-5 of
    # <|gamma|^2>
    grid_err = max(float((xp_cat - xp_map).abs().max()),
                   float((xm_cat - xm_map).abs().max()))

    # ---- A7. Monte-Carlo covariance over map realizations (no noise)
    def mc_stage():
        gen = torch.Generator(device=dev).manual_seed(seed + 77)
        return shear_2pt.xi_pm_sample_covariance(
            gen, ell_tab, cl_tab, n, oa, nbins, n_real=SS_NREAL,
            theta_min_arcmin=tmin, theta_max_arcmin=tmax)

    _, mean_mc, cov_mc, samples = stage("sample_covariance", mc_stage)
    cov_mc = cov_mc.double().cpu().numpy()
    # the realizations' mean over the continuum theory: a periodic map
    # lacks the modes below the fundamental (its xi integrates to zero
    # over the box), so the mean falls below theory with theta
    mc_mean_ratio = mean_mc[:nbins].double().cpu().numpy() / xp_i
    both = np.concatenate([full, full])
    finite("Monte-Carlo covariance", cov_mc[both][:, both])
    mc_ratio = np.diag(cov_mc)[both] / np.diag(cov0)[both]
    del samples

    # ---- A8. numpy input to every new entry point lands on the card
    placed = stage("placement", lambda: _shear_placement_checks(dev))

    # ---- B. phase 9's ray-traced (Born) kappa map, 2048^2 over 0.2 rad
    oa_b = math.degrees(LC_FOV)

    def born_stage():
        sky_b = SkyArray.from_array(kappa_born, oa_b, "kappa_2")
        res = {"padded": sky_b.convert_convergence_to_shear()}
        res["periodic"] = angular_power.kappa_to_shear_maps(kappa_born)
        xi = {}
        for name, (s1, s2) in res.items():
            sky_b.data["shearx"], sky_b.data["sheary"] = s1, s2
            xi[name] = sky_b.shear_xi_pm(nbins=nbins, theta_min_arcmin=tmin,
                                         theta_max_arcmin=tmax)
        eb = sky_b.cosebis(nmax, cmin, cmax)  # of the periodic shear
        ell_b = np.geomspace(2.0, 1e5, 1024)
        cl_b = angular_power.cl_kappa_limber(
            ell_b, Cosmology(Om0=0.3, h=0.7), LC_Z_SOURCE, nonlinear=True,
            device=dev)
        return xi, eb, ell_b, cl_b, shear_2pt.xi_pm_from_cl(ell_b, cl_b)

    xi_b, (e_b, b_b), ell_b, cl_b, (tt_b, xp_tb, _) = stage("born",
                                                           born_stage)
    e_b, b_b = e_b.double().cpu().numpy(), b_b.double().cpu().numpy()
    finite("Born COSEBIs", e_b, b_b)
    born = {}
    for name, (thb, xpb, xmb, npb) in xi_b.items():
        thb, xpb, xmb, npb = (t.double().cpu().numpy()
                              for t in (thb, xpb, xmb, npb))
        ok = npb > 0
        finite(f"Born xi ({name})", xpb[ok], xmb[ok])
        ratio = xpb / theory_at(thb, tt_b, xp_tb)
        picks = [int(np.argmin(np.abs(thb - t))) for t in (2.0, 10.0, 50.0)]
        born[name] = {"theta": thb.tolist(), "xi_plus": xpb.tolist(),
                      "xi_minus": xmb.tolist(),
                      "ratio_to_halofit": {f"{thb[i]:.2f}": float(ratio[i])
                                           for i in picks}}
        low = ok & (thb < 10.0)
        if not (xpb[low] > 0).all():
            raise AssertionError(f"Born map ({name} shear): xi+ <= 0 below "
                                 f"10': {xpb[low].tolist()}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # ---- checks of A (each raises)
    sel = full & (th > 2.0) & (th < 30.0)
    pull = (xip - xp_i) / sig0[:nbins]
    if not (np.abs(pull[sel]) < 4.0).all():
        raise AssertionError(f"xi+ against theory (sigma units, 2-30'): "
                             f"{pull[sel].tolist()}")
    b_pull = np.abs(b_n) / np.sqrt(np.diag(cov_b0))
    if not (b_pull < 4.0).all():
        raise AssertionError(f"|B_n| / sigma_B: {b_pull.tolist()}")
    if not (np.abs(mc_ratio - 1.0) < 0.3).all():
        raise AssertionError(f"Monte-Carlo / analytic variance: "
                             f"{mc_ratio.tolist()}")
    if n_peaks < 1 or not (gt[:3] > 0).all() \
            or not np.abs(gx).max() < 0.25 * gt.max():
        raise AssertionError(f"stack of {n_peaks} peaks: gamma_t "
                             f"{gt.tolist()}, gamma_x {gx.tolist()}")
    if not ccnt.sum() > 0:
        raise AssertionError("catalog: no pair in range")
    if not grid_err <= 1e-5 * var:
        raise AssertionError(f"full-grid catalog against the map estimator:"
                             f" {grid_err} > 1e-5 * {var}")
    total = _held_launches("shear survey", {k: {} for k in seconds},
                           launches)

    picks = [int(np.argmin(np.abs(th - t))) for t in (2.0, 10.0, 30.0)]
    out.update({
        "xi": {"theta": th.tolist(), "xi_plus": xip.tolist(),
               "xi_minus": xim.tolist(), "npairs": npair.tolist(),
               "theory_plus": xp_i.tolist(), "theory_minus": xm_i.tolist(),
               "sigma_plus_no_noise": sig0[:nbins].tolist(),
               "sigma_plus_noise": sig[:nbins].tolist(),
               "pull_2_30": pull[sel].tolist(),
               "ratio_at": {f"{th[i]:.2f}": float(xip[i] / xp_i[i])
                            for i in picks}},
        "cosebis": {"E": e_n.tolist(), "B": b_n.tolist(),
                    "sigma_E_noise": np.sqrt(np.diag(cov_e)).tolist(),
                    "sigma_B_noise": np.sqrt(np.diag(cov_b)).tolist(),
                    "sigma_B_no_noise": np.sqrt(np.diag(cov_b0)).tolist(),
                    "B_over_sigma_B": b_pull.tolist(),
                    "max_B_over_max_E": float(np.abs(b_n).max()
                                              / np.abs(e_n).max())},
        "snr_xi_plus_4": float(xip[4] / sig[4]),
        "stack": {"peaks": n_peaks, "r": r_st.tolist(), "gamma_t":
                  gt.tolist(), "gamma_x_max": float(np.abs(gx).max())},
        "catalog": {"galaxies": SS_NCAT, "pairs_in_range": int(ccnt.sum()),
                    "block": SS_CAT_BLOCK, "xi_plus": cxp.tolist(),
                    "xi_minus": cxm.tolist(), "pairs": ccnt.tolist()},
        "grid_catalog": {"side": SS_GRID_CAT, "max_err": grid_err,
                         "variance": var,
                         "pairs": float(grid_pairs.sum())},
        "monte_carlo": {"realizations": SS_NREAL,
                        "var_ratio": mc_ratio.tolist(),
                        "var_ratio_min": float(mc_ratio.min()),
                        "var_ratio_max": float(mc_ratio.max()),
                        "mean_over_theory": mc_mean_ratio.tolist()},
        "born": {**born, "cosebis_E": e_b.tolist(), "cosebis_B": b_b.tolist()},
        "placement": placed,
    })
    result = {"seconds": seconds, "seconds_total": sum(seconds.values()),
              "launches": launches, "launches_total": total,
              "peak_mem_gb": peak_gb, **out}
    log(f"# phase shear survey: {sum(seconds.values()):.2f} s; launches "
        f"{total}; xi+/theory at "
        + ", ".join(f"{k}' {v:.3f}" for k, v in out["xi"]["ratio_at"].items())
        + f"; E_1 {e_n[0]:.3e}, max|B|/max|E| "
        f"{out['cosebis']['max_B_over_max_E']:.4f}, max |B|/sigma_B "
        f"{b_pull.max():.2f}; MC/analytic variance {mc_ratio.min():.3f}-"
        f"{mc_ratio.max():.3f}; {n_peaks} peaks, gamma_t[0] {gt[0]:.3e}; "
        f"catalog {int(ccnt.sum())} pairs; Born xi+/halofit "
        + ", ".join(f"{k}' {v:.3f}" for k, v in
                    born["periodic"]["ratio_to_halofit"].items())
        + f"; peak {peak_gb:.2f} GB")
    log("# shear_survey " + json.dumps(result))
    return result


# --------------------------------------------------- theory and forecasts
def _theory_placement_checks() -> list:
    """Each new theory entry point given numpy input and no device: its
    result must lie on the card. Returns the names checked."""
    from astrild_tpu_torch.ops import (angular_power, covariance,
                                       halo_model, linear_power)
    from astrild_tpu_torch.utils.cosmology import Cosmology

    cosmo = Cosmology()
    k = np.geomspace(1e-2, 1.0, 8)
    ells = np.geomspace(50.0, 500.0, 4)
    zt = np.linspace(0.01, 2.0, 32)
    nz = angular_power.smail_nz(zt, z0=0.64)
    calls = {
        "smail_nz": lambda: nz,
        "halo_model_power": lambda: halo_model.halo_model_power(
            k, cosmo, nm=16)[2],
        "hod_galaxy_power": lambda: halo_model.hod_galaxy_power(
            k, cosmo, nm=16)[2],
        "nfw_u": lambda: halo_model.nfw_u(k, np.array([5.0]),
                                          np.array([1.0])),
        "nfw_delta_sigma": lambda: halo_model.nfw_delta_sigma(
            np.array([0.5, 1.0]), 1e14, 5.0),
        "cl_kappa_limber_nz": lambda: angular_power.cl_kappa_limber_nz(
            ells, cosmo, zt, nz, nchi=16, nz_quad=32),
        "cl_galaxy_limber_nz": lambda: angular_power.cl_galaxy_limber_nz(
            ells, cosmo, zt, nz, nchi=16, nz_quad=32),
        "gaussian_pk_covariance": lambda: covariance.gaussian_pk_covariance(
            k, np.full(8, 10.0)),
        "gaussian_cl_covariance": lambda: covariance.gaussian_cl_covariance(
            k, ells.repeat(2)),
        "gaussian_multipole_covariance": lambda:
            covariance.gaussian_multipole_covariance(
                8, 100.0, 4, lambda q: 1e3 * torch.exp(-q))[1],
        "kaiser_multipoles": lambda: linear_power.kaiser_multipoles(
            k, cosmo)[0],
    }
    for name, fn in calls.items():
        if fn().device.type != "cuda":
            raise AssertionError(f"theory: {name} given numpy input did "
                                 "not run on the card")
    return sorted(calls)


def phase_theory(dev, seed: int) -> dict:
    """examples/theory_and_rsd.py whole and examples/shear_survey.py
    stages 7-8, at the examples' own parameters, each stage on the host
    clock, synchronized, with its K2 launches against its own count (one
    paint in each RSD stage, none elsewhere): the linear, halofit and
    halo-model P(k); the Kaiser multipoles through FFTLog and the BAO
    peak of s^2 xi_0; the Zel'dovich RSD closure at the example's 64^3 in
    1000 Mpc/h and at 256^3 in 4000 Mpc/h (2^24 particles, 64 bins)
    against Kaiser with the Gaussian multipole covariance; Born and
    ray-traced maps of 8 planes of 256^2, the ray trace again with TF32
    allowed; the three Fisher forecasts from numpy input, each against
    its CPU run and its Jacobian against central differences of the port
    in float64 on the CPU. Then K2 at the two RSD shapes against its plain
    version and timed. Returns the numbers printed in `# theory`."""
    from astrild_tpu_torch import Cosmology
    from astrild_tpu_torch.models import SkyArray
    from astrild_tpu_torch.ops import (angular_power, covariance, fftlog,
                                       forecast, halo_model, linear_power,
                                       mocks, paint_cuda, pairwise_cuda,
                                       power, tpcf)
    from astrild_tpu_torch.ops.paint import paint

    seconds, launches, out = {}, {}, {}
    predicted = {"pk": {}, "xi_ell": {}, "rsd_64": {"paint_windowed": 1},
                 "rsd_256": {"paint_windowed": 1}, "raytrace": {},
                 "shear_fisher": {}, "xipm_fisher": {}, "threex2pt": {},
                 "placement": {}}
    stage = _stage_runner(seconds, launches)
    cosmo = Cosmology()

    def finite(name, *arrays):
        for a in arrays:
            a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
            if not np.isfinite(a).all():
                raise AssertionError(f"theory: {name} is not finite")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the launch counts cover exactly the path's stages
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()

    # ---- 1. linear, halofit and halo-model P(k)
    def pk_stage():
        k = np.logspace(-3, 1, 64)
        return (k, linear_power.linear_power(k, cosmo),
                linear_power.nonlinear_power(k, cosmo),
                halo_model.halo_model_power(k, cosmo)[2])

    k, p_lin, p_hf, p_hm = stage("pk", pk_stage)
    finite("P(k)", p_lin, p_hf, p_hm)
    p_lin = p_lin.double().cpu().numpy()
    r_hf = p_hf.double().cpu().numpy() / p_lin
    r_hm = p_hm.double().cpu().numpy() / p_lin
    for name, r in (("halofit", r_hf), ("halo model", r_hm)):
        if r.min() < 1.0 - THEORY_LIN_DROP or not (r[k > 1.0] > 1.0).all():
            raise AssertionError(f"theory: {name} / linear {r.tolist()}")
    out["pk"] = {"halofit_over_linear_min": float(r_hf.min()),
                 "halofit_min_at_k": float(k[np.argmin(r_hf)]),
                 "halo_model_over_linear_min": float(r_hm.min()),
                 "halofit_over_linear_at_k10": float(r_hf[-1]),
                 "halo_model_over_linear_at_k10": float(r_hm[-1])}

    # ---- 2. Kaiser multipoles -> FFTLog -> the BAO peak of s^2 xi_0
    def xi_stage():
        kk = np.logspace(-4, 2, 1024)
        p0, p2, p4 = linear_power.kaiser_multipoles(kk, cosmo)
        return fftlog.xi_multipoles_from_pk(kk, torch.stack([p0, p2, p4]))

    s, xi = stage("xi_ell", xi_stage)
    finite("xi_ell", xi)
    s = s.double().cpu().numpy()
    v = xi[0].double().cpu().numpy() * s ** 2
    sel = (s > 90) & (s < 115)
    s_peak = float(s[sel][np.argmax(v[sel])])
    if not THEORY_BAO[0] <= s_peak <= THEORY_BAO[1]:
        raise AssertionError(f"theory: BAO peak at s = {s_peak}")
    out["xi_ell"] = {"bao_peak_s": s_peak, "s2xi0_peak": float(v[sel].max())}

    # ---- 3. the Zel'dovich RSD closure at two sizes (K2 paints each)
    f = float(cosmo.growth_rate(0.0))
    kaiser = ((4 * f / 3 + 4 * f ** 2 / 7) / (1 + 2 * f / 3 + f ** 2 / 5))

    def pk_fn(q):
        return 2e4 * torch.exp(-((q / 0.08) ** 2))

    rsd_pos = {}
    for ngrid, box, nbins in THEORY_RSD:
        def rsd_stage():
            gen = torch.Generator(device=dev).manual_seed(seed + 14)
            pos, vel = mocks.zeldovich_catalog_with_velocities(
                gen, ngrid, box, pk_fn, f, device=dev)
            pos_s = tpcf.to_redshift_space(pos, vel, box)
            grid = paint(pos_s, ngrid, box, window="cic")
            res = power.auto_power_multipoles(grid, box, nbins=nbins,
                                              window="cic")
            _, cov, _ = covariance.gaussian_multipole_covariance(
                ngrid, box, nbins, pk_fn, beta=f, device=dev)
            return pos_s, res, cov

        pos_s, res, cov = stage(f"rsd_{ngrid}", rsd_stage)
        finite(f"P_ell at {ngrid}^3", res.p_ell, cov)
        kb = res.k.double().cpu().numpy()
        b = int(np.argmin(np.abs(kb - THEORY_RSD_K)))
        p0, p2 = float(res.p_ell[0][b]), float(res.p_ell[1][b])
        sig = math.sqrt(float(cov[1, 1, b])) / p0
        pull = (p2 / p0 - kaiser) / sig
        if abs(pull) > THEORY_RSD_PULL:
            raise AssertionError(f"theory: P2/P0 at {ngrid}^3 pull {pull}")
        out[f"rsd_{ngrid}"] = {"ngrid": ngrid, "box": box, "nbins": nbins,
                               "bin": b, "k": float(kb[b]),
                               "p2_over_p0": p2 / p0, "sigma": sig,
                               "kaiser": kaiser, "pull": pull}
        rsd_pos[ngrid] = (torch.cat([pos_s[:, a] for a in range(3)]), box)
        del pos_s, res, cov

    # ---- 4. Born and ray-traced maps of the example's planes; the ray
    # trace again with TF32 allowed for float32 matmuls
    def raytrace_stage():
        rng = np.random.default_rng(1)
        planes = rng.normal(0, 0.3, (8, 256, 256)).astype(np.float32)
        chis = np.linspace(300.0, 2400.0, 8)
        dchis = np.full(8, 300.0)
        args = (planes, chis, dchis, 2700.0, cosmo.Om0, 5.0)
        born = SkyArray.from_density_planes(*args, method="born")
        rt = SkyArray.from_density_planes(*args, method="raytrace")
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            rt32 = SkyArray.from_density_planes(*args, method="raytrace")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return born, rt, rt32

    born, rt, rt32 = stage("raytrace", raytrace_stage)
    kb_, kr = born.data["orig"], rt.data["orig"]
    finite("ray trace", kb_, kr, rt.data["omega"])
    if kr.device.type != dev.type:
        raise AssertionError("theory: the ray trace of numpy planes is not "
                             "on the card")
    omega_rms = float(rt.data["omega"].std())
    tf32_err = float((rt32.data["orig"] - kr).abs().max()
                     / kr.abs().max())
    if omega_rms == 0.0 or tf32_err > THEORY_TF32_TOL:
        raise AssertionError(f"theory: omega rms {omega_rms}, kappa with "
                             f"TF32 off by {tf32_err} of its max")
    out["raytrace"] = {"kappa_rms": float(kb_.std()),
                       "post_born_rms": float((kr - kb_).std()),
                       "omega_rms": omega_rms, "tf32_rel_err": tf32_err}

    # ---- 5 and shear_survey.py 7-8: the three Fisher forecasts
    zt = np.linspace(0.01, 3.0, 120)
    nz = (zt, angular_power.smail_nz(zt, z0=0.64).cpu().numpy())
    rp = np.array([2.0, 5.0, 10.0, 20.0])
    cov_wp = np.diag((np.array([40.0, 15.0, 8.0, 4.0]) * 0.05) ** 2)
    cov_ds = np.diag((np.array([2.0, 1.0, 0.5, 0.2]) * 0.08) ** 2)
    hod_fixed = {"sigma_logm": 0.3, "log_m0": 12.0, "log_m1": 13.5,
                 "alpha": 1.0}
    shear_kw = dict(z_sources=[0.6, 1.0, 1.6], fsky=0.36, nchi=128)
    xipm_kw = dict(npix=512, opening_angle_deg=5.0, nbins=12,
                   theta_min_arcmin=2.0, z_source=1.0, n_fields=40)
    x2_kw = dict(npix=512, opening_angle_deg=5.0, nz=nz, nbins_xi=10,
                 theta_min_arcmin=2.0, n_fields=40, hod_fixed=hod_fixed)
    ells = np.geomspace(100, 2000, 10)
    forecasts = {
        "shear_fisher": (
            {"Om0": cosmo.Om0, "sigma8": cosmo.sigma8},
            lambda p, **d: forecast.shear_fisher(ells, p, **shear_kw, **d)),
        "xipm_fisher": (
            {"Om0": cosmo.Om0, "sigma8": 0.8159},
            lambda p, **d: forecast.xipm_survey_fisher(p, **xipm_kw, **d)),
        "threex2pt": (
            {"Om0": cosmo.Om0, "sigma8": 0.8159, "log_mmin": 12.5,
             "A_IA": 1.0},
            lambda p, **d: forecast.threex2pt_fisher(
                p, rp, rp, cov_wp, cov_ds, **x2_kw, **d)),
    }
    for name, (params, run) in forecasts.items():
        res = stage(name, lambda: run(params))
        # the same call again: the first one pays the card's one-time costs
        # (kernels loaded on first use, solver handles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(params)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res_cpu = run(params, device="cpu")
        cpu_s = time.perf_counter() - t0
        fish = res["fisher"]
        scale = np.abs(fish).max()
        sym = float(np.abs(fish - fish.T).max() / scale)
        evals = np.linalg.eigvalsh(0.5 * (fish + fish.T))
        marg = res["marginalized"]
        cpu_rel = float(np.abs(fish - res_cpu["fisher"]).max() / scale)
        # the Jacobian of the very mean model the card's forecast
        # differentiated, against central differences of the CPU run's
        jac, _ = forecast._jacobian(res["mean_fn"], params, dev)
        jac = jac.double().cpu().numpy()
        fd = forecast.held_root_differences(res_cpu["mean_fn"], params)
        col = (np.abs(jac - fd).reshape(-1, len(params)).max(0)
               / np.abs(fd).reshape(-1, len(params)).max(0))
        if (sym > THEORY_SYM_TOL or evals.min() <= 0.0
                or not (np.isfinite(marg).all() and (marg > 0).all())
                or cpu_rel > THEORY_CPU_TOL or col.max() > THEORY_FD_TOL):
            raise AssertionError(
                f"theory: {name} asymmetry {sym}, eigenvalues "
                f"{evals.tolist()}, marginalized {marg.tolist()}, card/CPU "
                f"{cpu_rel}, Jacobian/central differences {col.tolist()}")
        out[name] = {"names": res["names"],
                     "marginalized": marg.tolist(),
                     "fisher": fish.tolist(), "asymmetry": sym,
                     "eigenvalue_min": float(evals.min()),
                     "card_vs_cpu": cpu_rel, "warm_seconds": warm_s,
                     "cpu_seconds": cpu_s,
                     "jacobian_vs_fd": col.tolist()}

    out["placement"] = stage("placement", _theory_placement_checks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total = _held_launches("theory", predicted, launches)

    # ---- K2 at the two RSD shapes, outside the counts
    k2 = {f"rsd_{ng}": _k2_lane_timing(pf, None, ng, box)
          for ng, (pf, box) in rsd_pos.items()}
    del rsd_pos
    log(f"# phase theory: {sum(seconds.values()):.2f} s; launches {total}; "
        f"halofit / linear min {r_hf.min():.3f}, halo model / linear min "
        f"{r_hm.min():.3f}; BAO peak {s_peak:.1f} Mpc/h; P2/P0 pulls "
        + ", ".join(f"{ng}^3 {out[f'rsd_{ng}']['pull']:.2f}"
                    for ng, _, _ in THEORY_RSD)
        + f"; omega rms {omega_rms:.2e}, TF32 kappa {tf32_err:.1e}; "
        + "; ".join(f"{n} sigma " + ", ".join(
            f"{p} {e:.5f}" for p, e in zip(out[n]["names"],
                                           out[n]["marginalized"]))
            + f" in {seconds[n]:.2f} s (again {out[n]['warm_seconds']:.2f},"
            f" CPU {out[n]['cpu_seconds']:.2f})"
            for n in forecasts)
        + f"; peak {peak_gb:.2f} GB")
    result = {"seconds": seconds, "seconds_total": sum(seconds.values()),
              "launches": launches, "launches_total": total,
              "peak_mem_gb": peak_gb, **out, "k2_timing_ms": k2}
    log("# theory " + json.dumps(result))
    return result


# ------------------------------------------ map analysis and catalog facades
def _synthetic_particles(gen, n: int, box: float, dev):
    """examples/full_pipeline.py's clumpy particles from a torch
    generator: half Gaussian-smeared (2 Mpc/h) around 64 uniform centres,
    half uniform, wrapped into the box."""
    n_halo = n // 2
    centers = torch.rand((64, 3), generator=gen, device=dev) * box
    which = torch.randint(0, 64, (n_halo,), generator=gen, device=dev)
    halo = centers[which] + 2.0 * torch.randn((n_halo, 3), generator=gen,
                                              device=dev)
    field = torch.rand((n - n_halo, 3), generator=gen, device=dev) * box
    return torch.remainder(torch.cat([halo, field]), box)


def _full_pipeline_stages(pos_batch, stage, cosmo):
    """examples/full_pipeline.py stages 1-4 on a (sims, n, 3) batch of
    positions, on its device: the TSC P(k) of each realization, the CIC
    bispectrum and the Born kappa of the first 32 z-slabs of realization
    0's grid, and the void pipeline on that map. `stage(name, fn)` runs
    each. Returns the stages' outputs as tensors and numpy."""
    from astrild_tpu_torch.models import (Bispectrum3D, SkyArray,
                                          TunnelsFinder, Voids)
    from astrild_tpu_torch.ops import lensing, power
    from astrild_tpu_torch.ops.paint import paint

    dev = pos_batch.device
    n_part = pos_batch.shape[1]

    def pk_one(pos):
        g = paint(pos, FP_NGRID, FP_BOX, window="tsc")
        return power.auto_power(g, FP_BOX, nbins=FP_PK_BINS, window="tsc",
                                shotnoise=FP_BOX ** 3 / n_part)

    res = stage("collection", lambda: [pk_one(p) for p in pos_batch])
    pk = torch.stack([r.power for r in res])

    def bispectrum_stage():
        g = paint(pos_batch[0], FP_NGRID, FP_BOX, window="cic")
        return g, Bispectrum3D.compute(g, FP_BOX, nbins=FP_BS_BINS)

    g, bs = stage("bispectrum", bispectrum_stage)

    def born_stage():
        delta = g / torch.mean(g) - 1.0
        planes = delta.permute(2, 0, 1)[:FP_SLABS]
        chis = torch.linspace(100.0, 1500.0, FP_SLABS, device=dev)
        dchis = torch.full((FP_SLABS,), FP_BOX / FP_NGRID, device=dev)
        return lensing.born_convergence(planes, chis, dchis, 2000.0,
                                        cosmo.Om0)

    kappa = stage("born", born_stage)

    def voids_stage():
        sky = SkyArray.from_array(kappa, opening_angle=5.0,
                                  quantity="kappa_2")
        sky.smoothing(FP_SMOOTH)
        finder = TunnelsFinder(sky)
        finder.find_peaks(on="orig_smooth")
        finder.find_voids(sigmas=[0.0])
        voids = Voids.from_finder(finder, {"npix": sky.npix})
        voids.trim_edges(sky.npix)
        voids.get_profiles(FP_REACH, FP_PROFILE_BINS,
                           skymap=sky.data["orig"])
        return voids, voids.get_profile_stats(n_boot=FP_BOOT)

    voids, ds = stage("voids", voids_stage)
    return {"k": res[0].k, "pk": pk, "bs": bs, "kappa": kappa,
            "voids": voids.data, "profiles": voids.profiles["values"],
            "mean": ds["mean"], "lowerr": ds["lowerr"],
            "higherr": ds["higherr"]}


def _rel_err(got, want) -> float:
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want.cpu() if isinstance(want, torch.Tensor) else want,
                      np.float64)
    fin = np.isfinite(want)
    if not np.array_equal(np.isfinite(got), fin):
        return math.inf
    if not fin.any():
        return 0.0
    return float(np.abs(got[fin] - want[fin]).max()
                 / max(np.abs(want[fin]).max(), 1e-300))


def _halofit_cl_table(dev, npix: int, oa_deg: float):
    """The shear survey's halofit Limber C_ell table for an npix^2 map
    over oa_deg: log-spaced to 1.4 x the axis Nyquist multipole, then 0
    (an explicit band limit; the synthesis clamps the table's ends)."""
    from astrild_tpu_torch.ops import angular_power
    from astrild_tpu_torch.utils.cosmology import Cosmology

    lf = 2.0 * np.pi / np.deg2rad(oa_deg)
    ell_tab = np.concatenate([np.geomspace(2.0, 1.4 * lf * npix / 2, 512),
                              [1.42 * lf * npix / 2, 1e6]])
    cl_tab = angular_power.cl_kappa_limber(
        ell_tab, Cosmology(), z_source=1.0, nonlinear=True,
        device=dev).double().cpu().numpy()
    cl_tab[-2:] = 0.0
    return ell_tab, cl_tab


def _k3_shape_timing(pos, vel, binw: float, nbins: int) -> dict:
    """K3 against its plain version on a catalog (compare_k3's bars) and
    timed in turns, outside the counts; the bound from its in-range
    pairs."""
    from astrild_tpu_torch.ops import pairwise_cuda

    n = pos.shape[0]
    err, _, _, counts = compare_k3(pos, vel, n, binw, nbins)
    fns = {
        "kernel": lambda: pairwise_cuda.pairwise_accumulate(pos, vel, n,
                                                            binw, nbins),
        "plain": lambda: pairwise_cuda.pairwise_accumulate_reference(
            pos, vel, n, binw, nbins, block=K3_PLAIN_BLOCK),
    }
    ms = {k: [] for k in fns}
    for turn in (["plain", "kernel"], ["kernel", "plain"]):
        for name in turn:
            ms[name].append(_event_ms(fns[name], 5))
    in_range = int(counts.sum())
    bound = bound_ms(24 * n + 8 * nbins, K3_OPS_PER_IN_RANGE_PAIR * in_range)
    return {"n": n, "nbins": nbins, "max_abs_err": err,
            "in_range_pairs": in_range,
            "mean": {k: sum(v) / len(v) for k, v in ms.items()},
            "turns": ms, "bound_ms": bound[0], "bound_by": bound[1]}


def _map_analysis_placement_checks() -> list:
    """Each new map-analysis entry point that returns a tensor, given
    numpy input and no device: its result must lie on the card (those that
    return numpy place their input by the same `_device` rule). Returns
    the names checked."""
    from astrild_tpu_torch.models import Peaks, SkyArray, Voids
    from astrild_tpu_torch.models.voids import (SphericalVoidFinder3D,
                                                WatershedFinder3D)
    from astrild_tpu_torch.ops import (aperture_mass, filters,
                                       map_transform, minkowski, profiles,
                                       troughs)

    rng = np.random.default_rng(15)
    img = rng.normal(size=(64, 64)).astype(np.float32)
    cen = rng.integers(8, 56, (6, 2)).astype(np.int32)
    rad = rng.uniform(2.0, 6.0, 6).astype(np.float32)
    prof = rng.normal(size=(6, 5)).astype(np.float32)
    pos = rng.uniform(0, 50.0, (500, 3)).astype(np.float32)
    delta = rng.normal(0, 0.3, (16, 16, 16)).astype(np.float32)
    cat = {"x_pix": cen[:, 1], "y_pix": cen[:, 0], "rad_pix": rad}
    calls = {
        "filters.gaussian": lambda: filters.gaussian(img, 2.0,
                                                     sigma_arcmin=3.0),
        "filters.gaussian_high_pass": lambda: filters.gaussian_high_pass(
            img, 2.0, sigma_arcmin=3.0),
        "filters.gaussian_derivative": lambda:
            filters.gaussian_derivative(img, 2.0, 3.0, (1, 0)),
        "filters.dgd3": lambda: filters.dgd3(img, 2.0, 3.0),
        "filters.dgd3_window": lambda: filters.dgd3_window(32, 2.0, 3.0),
        "filters.gaussian_compensated": lambda:
            filters.gaussian_compensated(img, 2.0, 3.0, 9.0),
        "filters.aperture_photometry": lambda:
            filters.aperture_photometry(img, 2.0, 10.0),
        "filters.apodization": lambda: filters.apodization(img),
        "filters.tophat_compensated": lambda:
            filters.tophat_compensated(img, 2.0, 10.0),
        "filters.pca_foreground_separation": lambda:
            filters.pca_foreground_separation(img, 4, 2),
        "profiles.object_profiles": lambda: profiles.object_profiles(
            img, cen, rad, 12, 5, 2.0)[1],
        "profiles.mean_and_interpolate": lambda:
            profiles.mean_and_interpolate(prof),
        "profiles.bootstrap_profiles_from_draws": lambda:
            profiles.bootstrap_profiles_from_draws(
                prof, cen, rng.integers(0, 4, (8, 4)), 32, 64)[0],
        "profiles.tangential_shear": lambda: profiles.tangential_shear(
            np.linspace(0.1, 1.0, 5), prof[0]),
        "troughs.find_troughs_from_draws": lambda:
            troughs.find_troughs_from_draws(img, cen, 0.5, 0.1, 2.0)[0],
        "troughs.trough_profiles": lambda: troughs.trough_profiles(
            img, cen[:2] * 2.0 / 64, 0.2, 4, 2.0)[1],
        "minkowski.map_moments": lambda: minkowski.map_moments(
            img)["sigma1"],
        "minkowski.gaussian_minkowski": lambda:
            minkowski.gaussian_minkowski(np.linspace(-2, 2, 5), 1.0,
                                         0.5)[0],
        "aperture_mass.aperture_mass_map": lambda:
            aperture_mass.aperture_mass_map(img, 5.0, 4.0),
        "aperture_mass.aperture_mass_from_shear": lambda:
            aperture_mass.aperture_mass_from_shear(img, img.T, 5.0, 4.0),
        "map_transform.gradient_3d": lambda: map_transform.gradient_3d(
            delta),
        "map_transform.scatter_points_to_grid": lambda:
            map_transform.scatter_points_to_grid(pos, pos[:, 0], 8, 50.0),
        "map_transform.slice_map": lambda: map_transform.slice_map(
            pos, pos[:, 0], 8, 50.0),
        "map_transform.object_cutouts": lambda:
            map_transform.object_cutouts(img, cen, 3),
        "map_transform.paint_objects_on_map": lambda:
            map_transform.paint_objects_on_map(32, cen / 2.0, rad),
        "SkyArray.smoothing": lambda: SkyArray.from_array(
            img, 2.0).smoothing(3.0),
        "SphericalVoidFinder3D": lambda: SphericalVoidFinder3D(
            delta, 50.0).delta,
        "WatershedFinder3D": lambda: WatershedFinder3D(delta, 50.0).delta,
    }
    for name, fn in calls.items():
        if fn().device.type != "cuda":
            raise AssertionError(f"map analysis: {name} given numpy input "
                                 "did not run on the card")
    # the catalog managers measure numpy maps where numpy goes
    for cls in (Voids, Peaks):
        obj = cls(dict(cat))
        obj.get_profiles(1.0, 4, skymap=img)
        if obj.device.type != "cuda":
            raise AssertionError(f"map analysis: {cls.__name__} profiles "
                                 "of a numpy map did not run on the card")
    return sorted(calls) + ["Voids.get_profiles", "Peaks.get_profiles"]


def phase_map_analysis(dev, seed: int, kappa_born, so_cat, out_gr,
                       mom_gr) -> dict:
    """The map-analysis and catalog facades, each stage on the host clock,
    synchronized, with its K2 / K3 launches against its own count; the
    checks raise. (a) examples/full_pipeline.py stages 1-4 at the
    example's parameters (4 realizations of 64^3 clumpy particles from a
    torch generator, TSC P(k) on 128^3 in 250 Mpc/h, the CIC bispectrum,
    Born kappa of 32 slabs, the void pipeline): the batch against four
    separate calls, and the whole against the same port on the CPU with
    the same particles. (b) The void stage at full width on phase 9's
    2048^2 Born map: smoothing, TunnelsFinder, Voids profiles and their
    bootstrap, Peaks, WatershedFinder, troughs; a seeded Gaussian map of
    the halofit C_ell (AngularPowerSpectrum.to_flat_map): Minkowski
    functionals against the Gaussian prediction and <M_ap^2> against its
    theory integral. (c) The halo facades on phase 12's SO catalog
    (velocities sampled from the snapshot's CIC velocity grids): Rockstar
    HMF, xi and v12 (K3), SubFind P(k) at 256^3 (K2), Halos.populate_hod,
    and SphericalVoidFinder3D.from_particles of the 2^27 particles onto
    256^3 (K2). Then K2 and K3 at the new shapes against their plain
    versions and timed. Returns the numbers printed in `# map_analysis`."""
    from astrild_tpu_torch import Cosmology
    from astrild_tpu_torch.models import (AngularPowerSpectrum, Halos,
                                          Peaks, Rockstar, SkyArray, SubFind,
                                          TunnelsFinder, Voids,
                                          WatershedFinder)
    from astrild_tpu_torch.models.voids import SphericalVoidFinder3D
    from astrild_tpu_torch.ops import (aperture_mass, filters, minkowski,
                                       nbody, paint_cuda, pairwise_cuda,
                                       troughs, velocity)

    seconds, launches, out = {}, {}, {}
    predicted = {"collection": {"paint_windowed": FP_SIMS},
                 "bispectrum": {"paint_windowed": 1}, "born": {},
                 "voids": {}, "collection_separate": {
                     "paint_windowed": FP_SIMS},
                 "tunnels": {}, "void_profiles": {}, "peaks": {},
                 "watershed": {}, "troughs": {}, "gaussian_map": {},
                 "minkowski": {}, "aperture_mass": {},
                 "halo_velocities": {"paint_windowed": 4},
                 "rockstar": {"pairwise_accumulate": 1},
                 "subfind_pk": {"paint_windowed": 1}, "hod": {},
                 "svf_particles": {"paint_windowed": 1}, "placement": {}}
    stage = _stage_runner(seconds, launches)
    cosmo = Cosmology()

    def finite(name, *arrays):
        for a in arrays:
            a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
            if not np.isfinite(a).all():
                raise AssertionError(f"map analysis: {name} is not finite")

    def on_card(name, t):
        if t.device.type != dev.type:
            raise AssertionError(f"map analysis: {name} is on {t.device}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the launch counts cover exactly the path's stages
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()

    # ---- (a) examples/full_pipeline.py stages 1-4
    n_part = FP_SIDE ** 3
    gens = [torch.Generator(device=dev).manual_seed(seed + 150 + i)
            for i in range(FP_SIMS)]
    pos_batch = torch.stack([_synthetic_particles(g, n_part, FP_BOX, dev)
                             for g in gens])
    card = _full_pipeline_stages(pos_batch, stage, cosmo)
    finite("full pipeline", card["pk"], card["kappa"], card["profiles"][
        np.isfinite(card["profiles"])], card["mean"], card["lowerr"],
        card["higherr"])
    finite("bispectrum", *[v[np.isfinite(v)] for v in card["bs"].values()])

    def separate_stage():
        from astrild_tpu_torch.ops import power
        from astrild_tpu_torch.ops.paint import paint

        out_pk = []
        for i in range(FP_SIMS):
            p = _synthetic_particles(torch.Generator(device=dev).manual_seed(
                seed + 150 + i), n_part, FP_BOX, dev)
            g = paint(p, FP_NGRID, FP_BOX, window="tsc")
            out_pk.append(power.auto_power(
                g, FP_BOX, nbins=FP_PK_BINS, window="tsc",
                shotnoise=FP_BOX ** 3 / n_part).power)
        return torch.stack(out_pk)

    pk_sep = stage("collection_separate", separate_stage)
    batch_err = _rel_err(card["pk"], pk_sep)
    n_voids_ex = len(card["voids"]["rad_pix"])
    # the same port on the CPU, with the same particles
    cpu_seconds = {}
    cpu = _full_pipeline_stages(pos_batch.cpu(), _stage_runner_cpu(
        cpu_seconds), cosmo)
    if len(cpu["voids"]["rad_pix"]) != n_voids_ex or n_voids_ex < 1:
        raise AssertionError(f"full pipeline: {n_voids_ex} voids on the "
                             f"card, {len(cpu['voids']['rad_pix'])} on the "
                             "CPU")
    cpu_err = {
        "pk": _rel_err(card["pk"], cpu["pk"]),
        "bispectrum": max(_rel_err(card["bs"][k], cpu["bs"][k])
                          for k in cpu["bs"]),
        "kappa": _rel_err(card["kappa"], cpu["kappa"]),
        "void_radii": _rel_err(card["voids"]["rad_pix"],
                               cpu["voids"]["rad_pix"]),
        "profiles": _rel_err(card["profiles"], cpu["profiles"]),
        "mean_profile": _rel_err(card["mean"], cpu["mean"])}
    out["full_pipeline"] = {
        "k": card["k"].cpu().numpy().tolist(),
        "pk0": card["pk"][0].cpu().numpy().tolist(),
        "batch_vs_separate": batch_err, "n_voids": n_voids_ex,
        "mean_profile": card["mean"][0].tolist(),
        "card_vs_cpu": cpu_err, "cpu_seconds": cpu_seconds}
    if batch_err > 1e-5 or max(cpu_err.values()) > FP_CPU_TOL:
        raise AssertionError(f"full pipeline: batch / separate {batch_err}, "
                             f"card / CPU {cpu_err}")
    del pos_batch, card, cpu, pk_sep

    # ---- (b) the void stage at full width on phase 9's Born map
    npix = kappa_born.shape[-1]
    oa = math.degrees(LC_FOV)

    def tunnels_stage():
        sky = SkyArray.from_array(kappa_born, oa, "kappa_2")
        sky.smoothing(FP_SMOOTH)
        finder = TunnelsFinder(sky)
        finder.find_peaks(on="orig_smooth")
        finder.find_voids(sigmas=[0.0])
        return sky, finder

    sky, finder = stage("tunnels", tunnels_stage)
    if not torch.equal(sky.data["orig_smooth"], filters.gaussian(
            sky.data["orig"], oa, sigma_arcmin=FP_SMOOTH)):
        raise AssertionError("map analysis: the smoothed layer is not "
                             "filters.gaussian of the map")

    def void_profiles_stage():
        voids = Voids.from_finder(finder, {"npix": npix})
        voids.trim_edges(npix)
        voids.get_profiles(FP_REACH, FP_PROFILE_BINS,
                           skymap=sky.data["orig"])
        return voids, voids.get_profile_stats(n_boot=MA_BOOT)

    voids, ds = stage("void_profiles", void_profiles_stage)
    mean, lo, hi = ds["mean"][0], ds["lowerr"][0], ds["higherr"][0]
    finite("void profile statistics", mean, lo, hi)
    bracket = bool(np.all((lo <= mean) & (mean <= hi)))
    out["voids"] = {"peaks": len(finder.peaks["snr"]),
                    "voids": len(finder.voids["rad_pix"]),
                    "voids_trimmed": len(voids.data["rad_pix"]),
                    "radii": ds["radius"].tolist(),
                    "mean": mean.tolist(), "lowerr": lo.tolist(),
                    "higherr": hi.tolist(), "bracketed": bracket}
    if not mean[0] < 0 or not bracket:
        raise AssertionError(f"void profiles: mean {mean.tolist()}, "
                             f"envelope {lo.tolist()} .. {hi.tolist()}")

    def peaks_stage():
        peaks = Peaks.from_tunnels_finder(finder)
        keep = peaks.data["rad_pix"] >= 2
        peaks = Peaks({k: v[keep] for k, v in peaks.data.items()},
                      peaks.skymap_dsc, device=peaks.device)
        peaks.get_profiles(1.0, 8, skymap=sky.data["orig"])
        return peaks, peaks.get_profile_stats(n_boot=MA_BOOT)

    peaks, pds = stage("peaks", peaks_stage)
    finite("peak profile", pds["mean"])
    out["peaks"] = {"n": len(peaks.data["x_pix"]),
                    "mean": pds["mean"].tolist()}
    if not pds["mean"][0] > pds["mean"][-1]:
        raise AssertionError(f"peak profile {pds['mean'].tolist()}")

    ws = stage("watershed", lambda: WatershedFinder(sky).find_voids())
    finite("watershed voids", ws["rad_pix"])
    if len(ws["rad_pix"]) < 1:
        raise AssertionError("map analysis: no watershed void")
    out["watershed_voids"] = len(ws["rad_pix"])

    def troughs_stage():
        gen = torch.Generator(device=dev).manual_seed(seed + 15)
        rad_deg = MA_TROUGH_ARCMIN / 60.0
        pos, means = troughs.find_troughs(kappa_born, gen, MA_TROUGHS,
                                          MA_TROUGH_FRAC, rad_deg, oa)
        return means, troughs.trough_profiles(kappa_born, pos, rad_deg, 8,
                                              oa)

    t_means, (t_r, t_prof) = stage("troughs", troughs_stage)
    finite("troughs", t_means, t_prof)
    k_mean = float(kappa_born.mean())
    out["troughs"] = {"n": int(t_means.shape[0]),
                      "mean_of_means": float(t_means.mean()),
                      "profile": t_prof.cpu().numpy().tolist()}
    if not float(t_means.max()) < k_mean or not float(t_prof[0]) < k_mean:
        raise AssertionError(f"troughs: means up to {float(t_means.max())},"
                             f" profile {t_prof.tolist()}, map mean "
                             f"{k_mean}")

    # ---- a seeded Gaussian map of the halofit C_ell
    def gaussian_stage():
        ell_tab, cl_tab = _halofit_cl_table(dev, npix, oa)
        g = AngularPowerSpectrum.to_flat_map(ell_tab, cl_tab, npix, oa,
                                             rnd_seed=seed + 15)
        return ell_tab, cl_tab, SkyArray.from_array(g, oa, "kappa_2")

    ell_tab, cl_tab, gsky = stage("gaussian_map", gaussian_stage)
    on_card("the Gaussian map (numpy input)", gsky.data["orig"])
    pix_arcmin = oa * 60.0 / npix

    def minkowski_stage():
        sm = gsky.smoothing(MA_MF_SMOOTH_PIX * pix_arcmin)
        mom = {k: float(v) for k, v in minkowski.map_moments(sm).items()}
        f = (sm - mom["mean"]) / mom["sigma0"]
        res = minkowski.minkowski_functionals(f, nbins=MA_MF_BINS,
                                              limits=(-3.0, 3.0))
        m1 = {k: float(v) for k, v in minkowski.map_moments(f).items()}
        res["nu"] = res["nu"] / m1["sigma0"]
        theory = minkowski.gaussian_minkowski(res["nu"], m1["sigma0"],
                                              m1["sigma1"])
        facade = gsky.minkowski_functionals(nbins=MA_MF_BINS,
                                            of="orig_smooth")
        return res, [t.cpu().numpy() for t in theory], facade

    mf, mf_theory, mf_facade = stage("minkowski", minkowski_stage)
    finite("Minkowski functionals", mf["V0"], mf["V1"], mf["V2"],
           *mf_facade.values())
    core = np.abs(mf["nu"]) < 2.0
    mf_rel = {k: float(np.max(np.abs(mf[k][core] / t[core] - 1.0)))
              for k, t in zip(("V0", "V1"), mf_theory)}
    v2_ok = np.all(np.abs(mf["V2"][core] - mf_theory[2][core])
                   <= 0.2 * np.abs(mf_theory[2][core]) + 2e-5)
    out["minkowski"] = {"nu": mf["nu"].tolist(),
                        **{k: mf[k].tolist() for k in ("V0", "V1", "V2")},
                        "theory": [t.tolist() for t in mf_theory],
                        "max_rel_core": mf_rel, "v2_within": bool(v2_ok)}
    if mf_rel["V0"] > 0.06 or mf_rel["V1"] > 0.08 or not v2_ok:
        raise AssertionError(f"Minkowski functionals against the Gaussian "
                             f"prediction: {mf_rel}, V2 within {v2_ok}")

    ap = stage("aperture_mass", lambda: gsky.aperture_mass_moments(
        list(MA_AP_SCALES)))
    finite("aperture mass", ap["map2"], ap["map3"])
    ratio = [float(ap["map2"][i] / aperture_mass.map2_theory(
        ell_tab, cl_tab, th)) for i, th in enumerate(MA_AP_SCALES)]
    out["aperture_mass"] = {"theta_ap_arcmin": list(MA_AP_SCALES),
                            "map2": ap["map2"].tolist(),
                            "map2_over_theory": ratio,
                            "skewness": ap["skewness"].tolist()}
    if (max(abs(r - 1.0) for r in ratio) > 0.12
            or np.abs(ap["skewness"]).max() > 0.05):
        raise AssertionError(f"<M_ap^2> / theory {ratio}, skewness "
                             f"{ap['skewness'].tolist()}")
    del sky, finder, voids, gsky

    # ---- (c) the halo facades on phase 12's SO catalog
    n_h = len(so_cat["mass"])
    hpos = np.stack([so_cat["x"], so_cat["y"], so_cat["z"]], axis=-1)

    def velocities_stage():
        vel = nbody.velocities_kms(mom_gr, 1.0)
        vgrid, _ = velocity.velocity_field(out_gr, vel, MA_VEL_NGRID, BOX)
        cell = np.floor(hpos / (BOX / MA_VEL_NGRID)).astype(np.int64) \
            % MA_VEL_NGRID
        idx = torch.from_numpy(cell).to(dev)
        return vgrid[:, idx[:, 0], idx[:, 1], idx[:, 2]].T.cpu().numpy()

    hvel = stage("halo_velocities", velocities_stage)
    finite("halo velocities", hvel)
    r200c = so_cat["radius"] * 1e3                       # kpc/h
    conc = 9.0 * (so_cat["mass"] / 1e13) ** -0.1        # toy c-M
    snap = {"x": hpos[:, 0], "y": hpos[:, 1], "z": hpos[:, 2],
            "vx": hvel[:, 0], "vy": hvel[:, 1], "vz": hvel[:, 2],
            "m200c": so_cat["mass"], "r200c": r200c, "Rs": r200c / conc}

    def rockstar_stage():
        return (Rockstar.halo_mass_fct(snap),
                Rockstar.two_point_corr_fct(snap, boxsize=BOX),
                Rockstar.mean_pairwise_velocity(snap, boxsize=BOX))

    (m_bins, hmf), (r_xi, xi), (r12, v12) = stage("rockstar", rockstar_stage)
    finite("Rockstar statistics", hmf, xi)
    # the pairs of each uniform v12 bin (the len(bins) bins of width
    # 50/24 of the default edges)
    binw = 50.0 / 24
    hpos_t = torch.from_numpy(hpos.astype(np.float32)).to(dev)
    pairs = _pair_counts(hpos_t, n_h, binw, len(v12)).cpu().numpy()
    full = np.nonzero(pairs >= MA_V12_MIN_PAIRS)[0]
    inner = int(full[0]) if full.size else -1
    out["rockstar"] = {"n_halos": n_h, "hmf_bins": m_bins.tolist(),
                       "hmf": hmf.tolist(), "r_xi": r_xi.tolist(),
                       "xi": xi.tolist(), "r_v12": r12.tolist(),
                       "v12": [float(v) if np.isfinite(v) else None
                               for v in v12],
                       "pairs": pairs.tolist(), "inner_bin": inner}
    if (not np.all(np.diff(hmf) <= 0) or inner < 0
            or not np.isfinite(v12[inner]) or not v12[inner] < 0):
        raise AssertionError(f"Rockstar: HMF {hmf.tolist()}, v12 "
                             f"{v12.tolist()} with pairs {pairs.tolist()}")

    sf = {"GroupPos": hpos, "Group_M_Crit200": so_cat["mass"]}
    k_sf, p_sf = stage("subfind_pk", lambda: SubFind.power_spectrum(
        sf, boxsize=BOX, ngrid=MA_PK_NGRID))
    finite("SubFind P(k)", k_sf, p_sf)
    out["subfind_pk"] = {"k": k_sf[:8].tolist(), "p": p_sf[:8].tolist()}

    gal = stage("hod", lambda: Halos(snap).populate_hod(
        boxsize=BOX, key=seed + 15, max_sat=GM_MAX_SAT))
    n_gal = int(gal["gx"].shape[0])
    finite("HOD galaxies", gal["gx"], gal["gvx"])
    out["hod"] = {"n_gal": n_gal, "overflow": int(gal["overflow"]),
                  "central_share": float(gal["is_central"].mean())}
    if n_gal < n_h // 2 or not ((gal["gx"] >= 0) & (gal["gx"] < BOX)).all():
        raise AssertionError(f"HOD on the SO catalog: {out['hod']}")

    def svf_stage():
        svf = SphericalVoidFinder3D.from_particles(out_gr, MA_SVF_NGRID, BOX)
        return svf, svf.find_voids()

    svf, svf_voids = stage("svf_particles", svf_stage)
    on_card("the SVF grid", svf.delta)
    finite("SVF voids", svf_voids["radius"])
    out["svf"] = {"n": len(svf_voids["radius"]),
                  "r_max": float(svf_voids["radius"][0])
                  if len(svf_voids["radius"]) else None}
    if len(svf_voids["radius"]) < 1:
        raise AssertionError("map analysis: SVF found no void in the "
                             "snapshot")
    del svf
    out["placement"] = stage("placement", _map_analysis_placement_checks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total = _held_launches("map analysis", predicted, launches)

    # ---- K2 and K3 at the new shapes, outside the counts
    gen = torch.Generator(device=dev).manual_seed(seed + 150)
    p0 = _synthetic_particles(gen, n_part, FP_BOX, dev)
    pf0 = torch.cat([p0[:, a] for a in range(3)])
    hpf = torch.cat([hpos_t[:, a] for a in range(3)])
    hm = torch.from_numpy(so_cat["mass"].astype(np.float32)).to(dev)
    k2 = {"example_tsc": _k2_lane_timing(pf0, None, FP_NGRID, FP_BOX, 3),
          "example_cic": _k2_lane_timing(pf0, None, FP_NGRID, FP_BOX, 2),
          "subfind_tsc": _k2_lane_timing(hpf, hm, MA_PK_NGRID, BOX, 3),
          "snapshot_cic": _k2_lane_timing(torch.cat(out_gr), None,
                                          MA_SVF_NGRID, BOX, 2)}
    vel_t = torch.from_numpy(hvel.astype(np.float32)).to(dev)
    k3 = _k3_shape_timing(hpos_t, vel_t, binw, len(v12))
    log(f"# phase map analysis: {sum(seconds.values()):.2f} s; launches "
        f"{total}; full pipeline: {n_voids_ex} voids, mean profile at r/R=0 "
        f"{out['full_pipeline']['mean_profile'][0]:.3e}, card / CPU "
        f"{max(cpu_err.values()):.1e}; Born map: {out['voids']['voids']} "
        f"voids of {out['voids']['peaks']} peaks, mean profile {mean[0]:.3e}"
        f" (envelope {lo[0]:.3e} .. {hi[0]:.3e}), {out['peaks']['n']} peaks,"
        f" {out['watershed_voids']} watershed voids, troughs "
        f"{out['troughs']['mean_of_means']:.3e}; Gaussian map: MF core "
        f"max |rel| V0 {mf_rel['V0']:.3f} V1 {mf_rel['V1']:.3f}, <M_ap^2> / "
        f"theory " + ", ".join(f"{r:.3f}" for r in ratio)
        + f"; {n_h} SO halos: v12 {v12[inner]:.1f} km/s in bin {inner}, "
        f"{n_gal} HOD galaxies, {out['svf']['n']} SVF voids; peak "
        f"{peak_gb:.2f} GB")
    result = {"seconds": seconds, "seconds_total": sum(seconds.values()),
              "launches": launches, "launches_total": total,
              "peak_mem_gb": peak_gb, **out, "k2_timing_ms": k2,
              "k3_timing_ms": k3}
    log("# map_analysis " + json.dumps(result))
    # the halos' velocities go on to phase 16 (not in the printed line)
    result["halo_velocities"] = hvel
    return result


def _moving_lens_catalog(so_cat, hvel, cosmo, npix: int, oa: float) -> dict:
    """Phase 12's SO halos (M200m, comoving R200m) with phase 15's
    velocities in a halo lightcone of ML_REPLICAS box replicas along the
    line of sight, on an (npix, npix) canvas over oa degrees, with the
    columns the facades read in the physical units the NFW and SZ
    functions document: z, Dc (angular-diameter distance [Mpc]), m200
    [Msun], c_NFW (Duffy), v_los [km/s], m500 [Msun], r500 [Mpc], e_z."""
    from astrild_tpu_torch.models import (halo_lightcone_catalog,
                                          merge_lightcone_catalogs)
    from astrild_tpu_torch.ops.halo_model import duffy_concentration
    from astrild_tpu_torch.ops.sz import m500c_from_m200m

    pos = np.stack([so_cat["x"], so_cat["y"], so_cat["z"]], axis=-1)
    cat = merge_lightcone_catalogs([
        halo_lightcone_catalog(pos, hvel, so_cat["mass"], so_cat["radius"],
                               BOX, r * BOX,
                               (max(r * BOX, ML_CHI_MIN), (r + 1) * BOX),
                               oa, npix, box_nr=r)
        for r in range(ML_REPLICAS)])
    h = cosmo.h
    z = np.asarray(cosmo.redshift_at_comoving_distance(cat["rad_dist"]))
    m_h = cat["m200"]                                   # Msun/h, 200 mean
    m500, r500 = (t.cpu().numpy().astype(np.float64)
                  for t in m500c_from_m200m(m_h, z, cosmo))
    cat.update(
        z=z, m200_h=m_h, m200=m_h / h,
        Dc=np.asarray(cosmo.angular_diameter_distance(z)) / h,
        c_NFW=duffy_concentration(m_h, z=z),
        v_los=(cat["x_vel"] * cat["x"] + cat["y_vel"] * cat["y"]
               + cat["z_vel"] * cat["z"]) / cat["rad_dist"],
        m500=m500 / h, r500=r500 / h,
        e_z=np.asarray(cosmo.efunc(z)))
    return cat


def _sub_catalog(cat: dict, npix: int, oa: float) -> dict:
    """The halos inside the central oa degrees of the full field, with
    their angles and pixels on an (npix, npix) canvas over that field."""
    lo = ML_OA / 2.0 - oa / 2.0
    t1, t2 = cat["theta1_deg"] - lo, cat["theta2_deg"] - lo
    sel = (t1 >= 0) & (t1 < oa) & (t2 >= 0) & (t2 < oa)
    out = {k: v[sel] for k, v in cat.items()}
    out["theta1_deg"], out["theta2_deg"] = t1[sel], t2[sel]
    out["theta1_pix"] = np.rint(t1[sel] * npix / oa).astype(int)
    out["theta2_pix"] = np.rint(t2[sel] * npix / oa).astype(int)
    return out


ML_SIGNALS = (("dT", "dT", (0, 1)), ("alpha_x", "alpha", (0,)),
              ("alpha_y", "alpha", (1,)), ("ksz", "ksz", (0,)),
              ("y", "y", (0,)))


def _moving_lens_map(cat: dict, to: str, direction, npix: int, oa: float,
                     device=None):
    """One halo map of `cat` through SkyArray.from_halo_dataframe (numpy
    columns: on the card unless `device` says otherwise)."""
    from astrild_tpu_torch.models import SkyArray

    return SkyArray.from_halo_dataframe(
        cat, npix, ML_EXTENT, direction, False, 1.0, to=to,
        opening_angle=oa, patch_npix=ML_PATCH, device=device).data["orig"]


def _moving_lens_maps(cat: dict, npix: int, oa: float, device=None) -> dict:
    """The five halo maps of `cat`."""
    return {name: _moving_lens_map(cat, to, direction, npix, oa, device)
            for name, to, direction in ML_SIGNALS}


def _dipole_velocities(maps: dict, cat: dict, oa: float):
    """DGD3-filtered dT -> Dipoles.from_sky -> find_nearest -> both vt
    estimators; returns the dipole catalog's columns."""
    from astrild_tpu_torch.models import Dipoles, SkyArray

    sky = SkyArray.from_array(maps["dT"], oa, "isw_rs")
    # the DGD3 scale: the patches' R200 (ML_PATCH // 2 canvas pixels)
    theta_i = (ML_PATCH // 2) * oa * 60.0 / sky.npix
    sky.filter({"gaussian_third_derivative": {
        "abbrev": "dgd3", "theta_i_arcmin": theta_i, "axis": 1}})
    dips = Dipoles.from_sky(sky, on="orig_dgd3", snr_threshold=ML_SNR,
                            edge_pix=ML_EDGE)
    dips.find_nearest(cat)
    args = (maps["dT"], maps["alpha_x"], maps["alpha_y"], oa)
    dips.get_transverse_velocities_from_sky(*args, patch_pix=ML_CROP)
    dips.get_transverse_velocities_reference_mode(*args, patch_pix=ML_CROP)
    return dips.data


def _isolated(d: dict, cat: dict) -> np.ndarray:
    """Dipoles matched to a halo whose crop holds no other halo's patch,
    with a matched-filter velocity."""
    idx = np.asarray(d["halo_idx"])
    ok = (idx >= 0) & (np.asarray(d["theta1_mtvel"]) > -99999)
    reach = ML_CROP + ML_PATCH // 2
    t1, t2 = cat["theta1_pix"], cat["theta2_pix"]
    for i in np.nonzero(ok)[0]:
        j = idx[i]
        near = np.maximum(np.abs(t1 - t1[j]), np.abs(t2 - t2[j])) <= reach
        ok[i] = near.sum() == 1
    return ok


def _vt_errors(d: dict, ok: np.ndarray, suffix: str = "") -> dict:
    """Median |v_rec - v_true| / |v_true| of each component over `ok`."""
    out = {}
    for comp in ("theta1", "theta2"):
        v = np.asarray(d[f"{comp}_mtvel{suffix}"])[ok]
        t = np.asarray(d[f"{comp}_tv"])[ok]
        good = v > -99999
        out[comp] = (float(np.median(np.abs(v[good] - t[good])
                                     / np.abs(t[good])))
                     if good.any() else None)
    return out


def _moving_lens_placement_checks() -> list:
    """Each new public entry point of the path given numpy input and no
    device: its result must lie on the card. Returns the names checked."""
    from astrild_tpu_torch import Cosmology
    from astrild_tpu_torch.models import (Bispectrum2D, Dipoles,
                                          LinearAngularPowerSpectrum,
                                          LinearPowerSpectrum, SkyArray)
    from astrild_tpu_torch.ops import (angular_power, bispectrum, filters,
                                       lensing, linear_power, strong_lensing,
                                       sz)

    rng = np.random.default_rng(16)
    img = rng.normal(size=(64, 64)).astype(np.float32)
    pos = rng.uniform(0, 10.0, (500, 2)).astype(np.float32)
    w = rng.uniform(1, 2, 500).astype(np.float32)
    c = np.linspace(-1, 1, 33).astype(np.float32)
    x1, x2 = np.meshgrid(c, c, indexing="ij")
    cosmo = Cosmology()
    halo = {"r200_deg": 0.1, "m200": 5e14, "c_NFW": 6.0, "Dc": 1200.0,
            "theta1_tv": 300.0, "theta2_tv": -200.0, "v_los": 400.0}
    cat = {k: np.full(3, v) for k, v in halo.items()}
    cat.update(theta1_pix=np.array([10, 30, 50]),
               theta2_pix=np.array([12, 40, 20]), r200_pix=np.full(3, 4.0),
               m500=np.full(3, 4e14), r500=np.full(3, 1.0),
               e_z=np.full(3, 1.1))
    calls = {
        "lensing.nfw_deflection_angle_map": lambda:
            lensing.nfw_deflection_angle_map(0.08, 3e14, 4.0, 900.0,
                                             npix=33),
        "lensing.nfw_temperature_perturbation_map": lambda:
            lensing.nfw_temperature_perturbation_map(
                0.08, 3e14, 4.0, np.array([300.0, -100.0]), 900.0, npix=33),
        "lensing.nfw_dipole_patch": lambda: lensing.nfw_dipole_patch(
            1e15, [1000.0, 0.0], 0.3, npix=32),
        "sz.nfw_sigma_map": lambda: sz.nfw_sigma_map(1e15, 5.0, 2.0,
                                                     npix=32),
        "sz.nfw_tau_map": lambda: sz.nfw_tau_map(1e15, 5.0, 2.0, npix=32),
        "sz.ksz_patch_from_halo": lambda: sz.ksz_patch_from_halo(
            3e14, 6.0, 1.2, 300.0, npix=32),
        "sz.compton_y_patch": lambda: sz.compton_y_patch(5e14, 1.3, 1.0,
                                                         npix=32),
        "sz.stacked_aperture_photometry": lambda:
            sz.stacked_aperture_photometry(img, np.array([[20, 30]]), 2.0,
                                           4.0, 8)[0],
        "sz.m500c_from_m200m": lambda: sz.m500c_from_m200m(
            np.array([1e14, 1e15]), 0.3, cosmo)[0],
        "sz.y_ell": lambda: sz.y_ell(np.array([100.0, 1000.0]), 5e14, 1.3,
                                     1.0, 1000.0),
        "sz.cl_yy": lambda: sz.cl_yy(np.array([300.0, 3000.0]), cosmo,
                                     nz=4, nm=8),
        "strong_lensing.sph_surface_density": lambda:
            strong_lensing.sph_surface_density(pos, w, w, 32, 10.0),
        "strong_lensing.remap_image": lambda: strong_lensing.remap_image(
            img, x1 * 20 + 30, x2 * 20 + 30),
        "strong_lensing.shear_from_potential": lambda:
            strong_lensing.shear_from_potential(img, 1.0)[0],
        "strong_lensing.mapping_triangles": lambda:
            strong_lensing.mapping_triangles(
                np.array([0.1, -0.2], np.float32), x1, x2, x1, x2)[0],
        "strong_lensing.fermat_potential": lambda:
            strong_lensing.fermat_potential(img, 1e-4,
                                            np.array([5e-5, 5e-5])),
        "strong_lensing.time_delay_days": lambda:
            strong_lensing.time_delay_days(img[0], 0.5, 1e3, 1.6e3, 900.0),
        "linear_power.p_dpdp": lambda: linear_power.p_dpdp(
            np.logspace(-2, 0, 8), 0.5, cosmo),
        "angular_power.cl_isw_limber": lambda:
            angular_power.cl_isw_limber(np.array([10.0, 100.0]), cosmo),
        "bispectrum.bispectrum_2d_equilateral": lambda:
            bispectrum.bispectrum_2d_equilateral(img, 5.0, nbins=4)[1],
        "filters.dgd3_window (tensor scales)": lambda: filters.dgd3_window(
            32, 2.0, torch.tensor([3.0, 5.0], device="cuda")),
        "SkyArray.from_halo_series": lambda: SkyArray.from_halo_series(
            halo, 33, 1.0, (0, 1), False, 1.0).data["orig"],
        "SkyArray.from_halo_dataframe": lambda:
            SkyArray.from_halo_dataframe(cat, 64, 1.0, (0, 1), False, 1.0,
                                         to="y", opening_angle=2.0,
                                         patch_npix=9).data["orig"],
        "SkyArray.from_halo_catalogue_to_temperature_perturbation_map":
            lambda: SkyArray.
            from_halo_catalogue_to_temperature_perturbation_map(
                cat, npix=64, opening_angle=2.0, patch_npix=9).data["orig"],
        "Dipoles.get_single_transverse_velocity_from_sky": lambda:
            Dipoles.get_single_transverse_velocity_from_sky(
                img, img, img + 3.0, img + 3.0)[0],
    }
    for name, fn in calls.items():
        if fn().device.type != "cuda":
            raise AssertionError(f"moving lens: {name} given numpy input "
                                 "did not run on the card")
    # the numpy-out facades compute on the card by the same rule
    from astrild_tpu_torch import _device
    seen = []
    orig = _device.default_device

    def spy(device=None):
        dev = orig(device)
        seen.append(dev.type)
        return dev

    _device.default_device = spy
    try:
        LinearPowerSpectrum(cosmo).P_dpdp(0.5, np.logspace(-2, 0, 8))
        LinearAngularPowerSpectrum(np.array([10.0, 100.0]), [0.1, 0.9],
                                   cosmo).compute_C_tt()
        Bispectrum2D.compute(img, 5.0, nbins=4)
        d = Dipoles({"theta1_pix": np.array([32]),
                     "theta2_pix": np.array([32]),
                     "r200_deg": np.array([0.2])})
        d.get_transverse_velocities_from_sky(img, img + 3.0, img + 3.0,
                                             2.0, patch_pix=16)
    finally:
        _device.default_device = orig
    if not seen or set(seen) != {"cuda"}:
        raise AssertionError(f"moving lens: the numpy-out facades placed "
                             f"their input on {sorted(set(seen))}")
    return sorted(calls) + ["LinearPowerSpectrum", "LinearAngularPower"
                            "Spectrum", "Bispectrum2D",
                            "Dipoles.get_transverse_velocities_from_sky"]


def phase_moving_lens(dev, seed: int, so_cat, hvel, kappa_born,
                      out_gr) -> dict:
    """The moving-lens, SZ and ISW path, each stage on the host clock,
    synchronized, with K1-K4 held to 0 launches; the checks raise. (a) A
    halo lightcone from phase 12's SO halos with phase 15's velocities over
    ML_REPLICAS box replicas, and its columns (z, D_A, Duffy c, v_los,
    M500c / r500c / E(z)) in physical units. (b) dT/T, alpha_x, alpha_y,
    kSZ and Compton-y on the 8192^2, 20 deg canvas through
    SkyArray.from_halo_dataframe (patches of 101 pixels). (c) DGD3 ->
    Dipoles.from_sky -> find_nearest -> both vt estimators: on the matched
    halos whose crop holds no other halo's patch, the matched filter's
    median |v_rec - v_true| / |v_true| under 0.35 for each component; the
    reference mode's printed. (d) stacked aperture photometry of the kSZ
    map split by the sign of v_los (opposite signs); Cl_yy beside the y
    map's flat-sky C_ell (printed). (e) sph_surface_density of the 2^27
    snapshot particles onto 2048^2 (mass to 1e-5), kappa_to_phi of phase
    9's Born map -> shear_from_potential and fermat_potential, the image
    finder behind the most massive halo's 1024^2 deflection patch, and the
    Born map remapped by that deflection. (f) LinearAngularPowerSpectrum's
    C_TT at ell 2-2000, P_dpdp, and Bispectrum2D of the Born map. (g) (b)
    and (c) on a 2048^2 / 5 deg canvas, (e)'s image finder and remap, and
    (f), on the card against the same port on the CPU. (h) numpy input to
    each new entry point on the card. Returns the numbers printed in
    `# moving_lens`."""
    from astrild_tpu_torch import Cosmology
    from astrild_tpu_torch.models import (Bispectrum2D,
                                          LinearAngularPowerSpectrum,
                                          LinearPowerSpectrum)
    from astrild_tpu_torch.ops import (angular_power, lensing, paint_cuda,
                                       pairwise_cuda, strong_lensing, sz)

    seconds, launches, out = {}, {}, {}
    stage = _stage_runner(seconds, launches)
    cosmo = Cosmology()

    def finite(name, *arrays):
        for a in arrays:
            a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)
            if not np.isfinite(a).all():
                raise AssertionError(f"moving lens: {name} is not finite")

    def rel(got, want, noise=None) -> float:
        got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
            else np.asarray(got)
        want = want.detach().cpu().numpy() if isinstance(
            want, torch.Tensor) else np.asarray(want)
        keep = np.ones(want.shape, bool) if noise is None else ~noise
        return float(np.abs(got - want)[keep].max()
                     / max(np.abs(want[keep]).max(), 1e-300))

    def centres(cat, npix):
        # each halo's centre pixel: the NFW centre's float32 noise (g(x)
        # below the rounding of ln 2), left out of the map comparisons
        m = np.zeros((npix, npix), bool)
        r, c = cat["theta2_pix"], cat["theta1_pix"]
        ins = (r >= 0) & (r < npix) & (c >= 0) & (c < npix)
        m[r[ins], c[ins]] = True
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()

    # ---- (a) the halo lightcone
    cat = stage("lightcone", lambda: _moving_lens_catalog(
        so_cat, hvel, cosmo, ML_NPIX, ML_OA))
    n_h = len(cat["m200"])
    finite("the lightcone columns", *[cat[k] for k in (
        "z", "Dc", "c_NFW", "v_los", "m500", "r500", "e_z", "r200_deg")])
    if n_h < 500 or not (cat["m500"] < cat["m200"]).all():
        raise AssertionError(f"moving lens: {n_h} halos in the lightcone, "
                             f"M500c below M200m: "
                             f"{bool((cat['m500'] < cat['m200']).all())}")
    out["lightcone"] = {"halos": n_h, "z_max": float(cat["z"].max()),
                        "m200_max": float(cat["m200"].max())}

    # ---- (b) the maps at full width
    maps = {}
    for name, to, direction in ML_SIGNALS:
        maps[name] = stage(f"map_{name}", lambda to=to, d=direction:
                           _moving_lens_map(cat, to, d, ML_NPIX, ML_OA))
        finite(f"the {name} map", maps[name])
        if maps[name].device.type != dev.type or not float(
                maps[name].abs().max()) > 0:
            raise AssertionError(f"moving lens: the {name} map is empty or "
                                 f"off the card")

    # ---- (c) dipoles
    dips = stage("dipoles", lambda: _dipole_velocities(maps, cat, ML_OA))
    iso = _isolated(dips, cat)
    mt, ref = _vt_errors(dips, iso), _vt_errors(dips, iso, "_ref")
    out["dipoles"] = {"n": len(dips["snr"]),
                      "matched": int((dips["halo_idx"] >= 0).sum()),
                      "isolated": int(iso.sum()),
                      "matched_filter_median_rel_err": mt,
                      "reference_mode_median_rel_err": ref}
    if iso.sum() < 10 or any(v is None or v >= ML_VT_BAR for v in
                             mt.values()):
        raise AssertionError(f"moving lens: matched filter {mt} on "
                             f"{int(iso.sum())} isolated halos")

    # ---- (d) SZ
    def ksz_stage():
        margin = 40
        t1, t2 = cat["theta1_pix"], cat["theta2_pix"]
        ins = ((t1 >= margin) & (t1 < ML_NPIX - margin) & (t2 >= margin)
               & (t2 < ML_NPIX - margin))
        centers = np.stack([t2[ins], t1[ins]], axis=-1)
        alpha_pix = ML_AP_ARCMIN / 60.0 * ML_NPIX / ML_OA
        ap, _ = sz.stacked_aperture_photometry(
            maps["ksz"], centers, ML_OA, ML_AP_ARCMIN,
            int(math.ceil(math.sqrt(2.0) * alpha_pix)) + 2)
        v = torch.from_numpy(cat["v_los"][ins]).to(dev)
        return ap[v > 0].mean(), ap[v < 0].mean()

    away, toward = stage("ksz_stack", ksz_stage)
    out["ksz_stack"] = {"receding": float(away),
                        "approaching": float(toward)}
    if not float(away) < 0 < float(toward):
        raise AssertionError(f"moving lens: kSZ stacks {out['ksz_stack']}")

    def cl_yy_stage():
        ells = np.geomspace(*ML_YY_ELLS)
        theory = sz.cl_yy(ells, cosmo)
        ell_m, cl_m = angular_power.cl_flat_sky(
            maps["y"], ML_OA, nbins=ML_YY_ELLS[2], ell_min=ML_YY_ELLS[0],
            ell_max=ML_YY_ELLS[1])
        return ells, theory, ell_m, cl_m

    ells_y, cl_t, ell_m, cl_m = stage("cl_yy", cl_yy_stage)
    finite("Cl_yy", cl_t, cl_m)
    out["cl_yy"] = {"ell": ells_y.tolist(),
                    "theory": cl_t.cpu().numpy().tolist(),
                    "ell_map": ell_m.cpu().numpy().tolist(),
                    "map": cl_m.cpu().numpy().tolist()}

    # ---- (e) strong lensing
    def sph_stage():
        gen = torch.Generator(device=dev).manual_seed(seed + 16)
        n = out_gr[0].shape[0]
        lo, hi = math.log(ML_HSML[0]), math.log(ML_HSML[1])
        hsml = torch.exp(lo + (hi - lo) * torch.rand(n, generator=gen,
                                                     device=dev))
        pos2d = torch.stack([out_gr[0], out_gr[1]], dim=-1)
        sd = strong_lensing.sph_surface_density(
            pos2d, torch.ones(n, device=dev), hsml, ML_SPH_NPIX, BOX,
            n_buckets=ML_SPH_BUCKETS)
        return sd, n

    sd, n_part = stage("sph", sph_stage)
    finite("the SPH map", sd)
    mass = float(sd.double().sum()) * (BOX / ML_SPH_NPIX) ** 2
    out["sph"] = {"particles": n_part, "mass_rel_err": mass / n_part - 1.0}
    if abs(mass / n_part - 1.0) > 1e-5:
        raise AssertionError(f"moving lens: SPH mass {mass} of {n_part}")
    del sd

    def potential_stage():
        phi = lensing.kappa_to_phi(kappa_born, LC_FOV)
        k, g1, g2 = strong_lensing.shear_from_potential(phi, LC_FOV)
        tau = strong_lensing.fermat_potential(
            kappa_born, LC_FOV, torch.tensor([LC_FOV / 2, LC_FOV / 2],
                                             device=dev))
        return phi, k, g1, g2, tau

    phi, k_phi, g1, g2, tau = stage("potential", potential_stage)
    finite("the potential and its derivatives", phi, k_phi, g1, g2, tau)
    # (phi_11 + phi_22) / 2 by second differences returns kappa but for
    # the stencil's damping of pixel-scale modes: held on 8 x 8 block means
    inner = np.s_[16:-16, 16:-16]
    corr = _corr(k_phi[inner], kappa_born[inner])
    corr_blocks = _corr(_block_mean(k_phi[inner], 8),
                        _block_mean(kappa_born[inner], 8))
    out["potential"] = {"kappa_corr": corr, "kappa_corr_8x8": corr_blocks}
    if corr_blocks < 0.95:
        raise AssertionError(f"moving lens: kappa from the potential "
                             f"correlates {corr_blocks} with the Born map "
                             f"on block means ({corr} at the pixel)")
    del phi, k_phi, g1, g2, tau

    top = int(np.argmax(cat["m200"]))
    sl_args = (cat["r200_deg"][top], cat["m200"][top], cat["c_NFW"][top],
               cat["Dc"][top])

    def lens_inputs(device=None):
        ax = lensing.nfw_deflection_angle_map(
            *sl_args, npix=ML_SL_NPIX, extent=ML_SL_EXTENT, directions=(0,),
            device=device)
        ay = lensing.nfw_deflection_angle_map(
            *sl_args, npix=ML_SL_NPIX, extent=ML_SL_EXTENT, directions=(1,),
            device=device)
        r200 = math.tan(math.radians(sl_args[0])) * sl_args[3]
        t = np.linspace(-1.0, 1.0, ML_SL_NPIX) * ML_SL_EXTENT * r200 \
            / sl_args[3]                                   # [rad]
        x1 = torch.tensor(t[None, :] * np.ones((ML_SL_NPIX, 1)),
                          dtype=torch.float32, device=ax.device)
        x2 = x1.T.contiguous()
        return ax, ay, x1, x2, t

    def images_stage(device=None):
        ax, ay, x1, x2, t = lens_inputs(device)
        mid = ML_SL_NPIX // 2
        y1, y2 = x1 - ax, x2 - ay
        # the Einstein radius: where alpha falls below theta on the axis
        cross = np.nonzero((t > 0) & (y1[mid].cpu().numpy() > 0))[0]
        theta_e = float(t[cross[0]]) if cross.size else float(t[-1]) / 2
        col = int(np.argmin(np.abs(t - min(ML_SL_IMAGE * theta_e,
                                           0.8 * t[-1]))))
        src = torch.stack([y1[mid, col], y2[mid, col]])
        found = strong_lensing.mapping_triangles(src, x1, x2, y1, y2)
        return found, theta_e, bool(cross.size)

    (i1, i2, mags, nf), theta_e, ring = stage("images", images_stage)
    nf = int(nf)
    out["images"] = {"n_found": nf, "theta_e_rad": theta_e,
                     "einstein_radius_on_patch": ring,
                     "mag_signs": np.sign(mags[:nf].cpu().numpy()).tolist()}
    if nf < 1:
        raise AssertionError("moving lens: the image finder found no image")

    def remap_stage(kappa, device=None):
        ax, ay = lens_inputs(device)[:2]
        off = (LC_NPIX - ML_SL_NPIX) // 2
        crop = kappa[off:off + ML_SL_NPIX, off:off + ML_SL_NPIX]
        ii = torch.arange(ML_SL_NPIX, device=crop.device,
                          dtype=torch.float32)
        ds = LC_FOV / LC_NPIX
        return strong_lensing.remap_image(crop, ii[:, None] + ay / ds,
                                          ii[None, :] + ax / ds)

    lensed = stage("remap", lambda: remap_stage(kappa_born))
    finite("the remapped Born map", lensed)

    # ---- (f) ISW theory and the 2D bispectrum
    isw_ells = np.arange(ML_ISW_ELLS[0], ML_ISW_ELLS[1] + 1, dtype=float)
    k_isw = np.geomspace(1e-3, 1.0, 32)

    def isw_stage(device=None):
        cl = LinearAngularPowerSpectrum(isw_ells, ML_ISW_Z, cosmo,
                                        device=device).Cl
        pdp = LinearPowerSpectrum(cosmo, device=device).P_dpdp(0.5, k_isw)
        return cl, pdp

    cl_tt, pdpdp = stage("isw", isw_stage)
    finite("C_TT and P_dpdp", cl_tt, pdpdp)
    if not (cl_tt > 0).all() or not (pdpdp > 0).all():
        raise AssertionError("moving lens: C_TT or P_dpdp not positive")
    oa_born = math.degrees(LC_FOV)
    ell_b, b_born, ntri = stage("bispectrum_2d", lambda: Bispectrum2D.compute(
        kappa_born, oa_born, nbins=ML_BS_BINS))
    finite("the Born bispectrum", b_born[np.isfinite(b_born)], ell_b)
    out["isw"] = {"ell": isw_ells[::200].tolist(),
                  "cl_tt": cl_tt[::200].tolist(), "k": k_isw.tolist(),
                  "p_dpdp_z0.5": pdpdp.tolist()}
    out["bispectrum_2d"] = {"ell": ell_b.tolist(), "b": b_born.tolist()}

    out["placement"] = stage("placement", _moving_lens_placement_checks)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    total = _held_launches("moving lens", {name: {} for name in seconds},
                           launches)

    # ---- (g) the card against the port on the CPU, on the same inputs
    small = _sub_catalog(cat, ML_SMALL_NPIX, ML_SMALL_OA)
    cpu_seconds = {}
    cpu_stage = _stage_runner_cpu(cpu_seconds)
    card_maps = _moving_lens_maps(small, ML_SMALL_NPIX, ML_SMALL_OA)
    cpu_maps = cpu_stage("maps", lambda: _moving_lens_maps(
        small, ML_SMALL_NPIX, ML_SMALL_OA, device="cpu"))
    noise = centres(small, ML_SMALL_NPIX)
    card_cpu = {f"map_{n}": rel(card_maps[n], cpu_maps[n],
                                noise if n in ("dT", "alpha_x", "alpha_y")
                                else None) for n in card_maps}
    d_card = _dipole_velocities(card_maps, small, ML_SMALL_OA)
    d_cpu = cpu_stage("dipoles", lambda: _dipole_velocities(
        cpu_maps, small, ML_SMALL_OA))
    # the velocities of halos matched in both runs: held on the isolated
    # ones, where <W, alpha> is the halo's own (where patches overlap it
    # may nearly cancel, and the maps' float32 differences grow there);
    # the largest difference over all of them printed beside it
    both = {}
    for d in (d_card, d_cpu):
        iso_d = _isolated(d, small)
        both[id(d)] = {int(j): (i, bool(iso_d[i]))
                       for i, j in enumerate(d["halo_idx"])
                       if j >= 0 and d["theta1_mtvel"][i] > -99999}
    common = sorted(set(both[id(d_card)]) & set(both[id(d_cpu)]))
    vt_rel = {"isolated": 0.0, "all": 0.0}
    n_iso_common = 0
    for j in common:
        (a, iso_a), (b, _) = both[id(d_card)][j], both[id(d_cpu)][j]
        n_iso_common += iso_a
        for col in ("theta1_mtvel", "theta2_mtvel"):
            r = abs(d_card[col][a] - d_cpu[col][b]) / max(abs(d_cpu[col][b]),
                                                           1.0)
            vt_rel["all"] = max(vt_rel["all"], r)
            if iso_a:
                vt_rel["isolated"] = max(vt_rel["isolated"], r)
    card_cpu["velocities"] = vt_rel["isolated"]
    card_cpu_all_velocities = vt_rel["all"]
    img_cpu = cpu_stage("images", lambda: images_stage("cpu"))
    if int(img_cpu[0][3]) != nf:
        raise AssertionError(f"moving lens: {nf} images on the card, "
                             f"{int(img_cpu[0][3])} on the CPU")
    card_cpu["images"] = float(np.abs(i1[:nf].cpu().numpy()
                                      - img_cpu[0][0][:nf].numpy()).max()
                               / max(abs(theta_e), 1e-30)) if nf else 0.0
    card_cpu["remap"] = rel(lensed, cpu_stage(
        "remap", lambda: remap_stage(kappa_born.cpu(), "cpu")))
    cl_cpu, pdp_cpu = cpu_stage("isw", lambda: isw_stage("cpu"))
    card_cpu["cl_tt"] = rel(cl_tt, cl_cpu)
    card_cpu["p_dpdp"] = rel(pdpdp, pdp_cpu)
    b_cpu = cpu_stage("bispectrum_2d", lambda: Bispectrum2D.compute(
        kappa_born.cpu(), oa_born, nbins=ML_BS_BINS)[1])
    fin = np.isfinite(b_cpu)
    card_cpu["bispectrum_2d"] = rel(b_born[fin], b_cpu[fin])
    out["card_vs_cpu"] = {"halos": len(small["m200"]),
                          "common_matched": len(common),
                          "common_isolated": n_iso_common, **card_cpu,
                          "velocities_all_matched": card_cpu_all_velocities,
                          "cpu_seconds": cpu_seconds}
    bars = {**{f"map_{n}": ML_MAP_TOL for n in card_maps},
            "velocities": ML_VT_TOL, "images": ML_VT_TOL,
            "remap": ML_CPU_TOL, "cl_tt": ML_CPU_TOL, "p_dpdp": ML_CPU_TOL,
            "bispectrum_2d": ML_CPU_TOL}
    over = {k: card_cpu[k] for k, bar in bars.items() if card_cpu[k] > bar}
    if over or n_iso_common < 3:
        raise AssertionError(f"moving lens: card against CPU over the bars "
                             f"{over}, {len(common)} halos matched in both, "
                             f"{n_iso_common} of them isolated")

    log(f"# phase moving lens: {sum(seconds.values()):.2f} s; launches "
        f"{total}; {n_h} halos; maps " + ", ".join(
            f"{n} {seconds['map_' + n]:.3f} s" for n, _, _ in ML_SIGNALS)
        + f"; {out['dipoles']['n']} dipoles, {int(iso.sum())} isolated "
        f"matched: matched filter median rel err {mt}, reference mode "
        f"{ref}; kSZ stacks {float(away):.3e} / {float(toward):.3e} K; SPH "
        f"mass {out['sph']['mass_rel_err']:.1e}; {nf} images; card / CPU "
        f"max {max(card_cpu.values()):.1e}; peak {peak_gb:.2f} GB")
    result = {"seconds": seconds, "seconds_total": sum(seconds.values()),
              "launches": launches, "launches_total": total,
              "peak_mem_gb": peak_gb, **out}
    log("# moving_lens " + json.dumps(result))
    return result


# ------------------------- MG growth, flat-sky MASTER, HMC, the toolbox
def _kernel_launches(fn) -> tuple:
    """(fn(), the CUDA kernels it launched): every kernel, of the port's
    own and of torch, counted from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return out, n


def _master_mask(npix: int, seed: int) -> np.ndarray:
    """examples/distributed_and_masked.py's edge mask at width npix (the
    columns below MA_EDGE of it) with MA_HOLES seeded circular holes of
    MA_HOLE_ARCMIN radius."""
    rng = np.random.default_rng(seed)
    mask = np.ones((npix, npix), np.float32)
    mask[:, : int(round(MA_EDGE * npix))] = 0.0
    r_pix = MA_HOLE_ARCMIN / 60.0 / MA_FOV * npix
    yy, xx = np.meshgrid(np.arange(npix), np.arange(npix), indexing="ij")
    for cy, cx in rng.uniform(0, npix, (MA_HOLES, 2)):
        y0, y1 = int(max(cy - r_pix - 1, 0)), int(min(cy + r_pix + 2, npix))
        x0, x1 = int(max(cx - r_pix - 1, 0)), int(min(cx + r_pix + 2, npix))
        sub = ((yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2
               < r_pix ** 2)
        mask[y0:y1, x0:x1][sub] = 0.0
    return mask


def _example_cl_table():
    """examples/distributed_and_masked.py's C_ell = 1/(l(l+1)) table."""
    ell = np.linspace(1.0, 40000.0, 1024)
    return ell, 1.0 / (ell * (ell + 1.0))


def phase_mg_master_inference(dev, seed: int) -> dict:
    """The modified-gravity growth, flat-sky MASTER, HMC and the analysis
    toolbox, each stage on the host clock, synchronized, with its K1-K4
    launches held to its own count and its peak memory; the checks
    raise. (a) GR and fR0 = 1e-4 KDK evolutions (16 steps from 2LPT at z
    = 9) of the same 512^3 particles on 512^3 in 6400 Mpc/h under a flat
    P(k) = 20, both painted through K2: P_fR/P_GR on bins 1-8 within 3% of
    fofr_pk_enhancement(k, 0) / fofr_pk_enhancement(k, 9), which exceeds
    1.1 there; K2 2 x 17 + 2 launches. (b) the mu0 = 1/3 growth tables
    ('const', 'lambda') and growth_factor_k / fofr_pk_enhancement at 256
    k for fR0 in {1e-4, 1e-5, 1e-6}, n in {1, 2}, z in {0, 1}: the float
    route on the card equal to its CPU placement, the traced route
    (tensor fields on the card) within 1e-6 of it; F4 / F5 at k = 0.1 in
    the published window, monotonic in k, GR within 1e-6 of 1; the traced
    jacfwd in fR0 (seconds and CUDA kernel launches printed); the
    full_pipeline theory anchors on the card against the CPU. (c) a
    2048^2, 10 deg map of the example's C_ell table under its edge mask
    with 256 holes: MASTER within 5% of the unmasked map's C_ell on bands
    of >= 10^4 modes and under half the <w^2> pseudo-Cl's largest bias
    there (printed); its E-only shear: MASTER
    BB/EE summed < 1e-2, EE within 5% of the unmasked; couplings and
    spectra on the card against the CPU at 512^2; SkyNamaster on the
    example's stages 3 and 6 and at 2048^2 (the cached second call
    timed). (d) HMC: the correlated Gaussian, the shear posterior of
    tests/test_inference.py with its checks, a 3-bin (Om0, sigma8)
    posterior against shear_fisher, the 3x2pt posterior at the truth.
    (e) lognormal_map at 2048^2. (f) bootstrap_statistic of 10^6 values,
    nonlinear_least_squares of an NFW profile, pca,
    covariance_from_realizations, snapshot_info_table for F5; (e) and
    (f) on the card against the CPU. Returns the numbers printed in
    `# mg_master_inference`."""
    from astrild_tpu_torch import Cosmology
    from astrild_tpu_torch.models import SkyNamaster, siminfo
    from astrild_tpu_torch.ops import (angular_power, halo_stats, inference,
                                       linear_power, mocks, nbody,
                                       paint_cuda, pairwise_cuda, power)
    from astrild_tpu_torch.ops.forecast import (shear_fisher,
                                                threex2pt_mean_builder,
                                                tomographic_shear_cls)
    from astrild_tpu_torch.ops.paint import paint
    from astrild_tpu_torch.utils import analysis

    seconds, launches, peaks, out = {}, {}, {}, {}
    run = _stage_runner(seconds, launches)

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = run(name, fn)
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        log(f"#   mg/master/inference stage {name}: {seconds[name]:.3f} s, "
            f"launches {launches[name]}, peak {peaks[name]:.2f} GB")
        return res

    def host(x) -> np.ndarray:
        return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x))

    def rel(got, want) -> float:
        got, want = host(got).astype(np.float64), host(want).astype(
            np.float64)
        return float(np.abs(got - want).max()
                     / max(np.abs(want).max(), 1e-300))

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"mg/master/inference: {msg}")

    torch.cuda.synchronize()
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()

    # ---- (a) f(R) PM against linear theory
    gr = Cosmology(Om0=0.3, h=0.7)
    fr = Cosmology(Om0=0.3, h=0.7, fR0=MG_FR0)
    a0 = 1.0 / (1.0 + Z_INIT)

    def pk_flat(k):
        return MG_PK * torch.ones_like(k)

    def fofr_pm():
        gen = torch.Generator(device=dev).manual_seed(seed)
        comps, mom = nbody.lpt_catalog(gen, MG_SIDE, MG_BOX, pk_flat, gr,
                                       Z_INIT)
        res = {}
        for name, cosmo in (("gr", gr), ("fr", fr)):
            snap, _ = nbody.pm_evolve(comps, mom, cosmo, MG_SIDE, MG_BOX,
                                      a0, 1.0, MG_STEPS)
            res[name] = power.auto_power(paint(snap, MG_SIDE, MG_BOX,
                                               window="cic"), MG_BOX,
                                         nbins=MG_BINS)
            del snap
        return res

    pm = stage("fofr_pm", fofr_pm)
    k = pm["gr"].k
    measured = host(pm["fr"].power / pm["gr"].power)
    theory = host(fr.fofr_pk_enhancement(k, 0.0)
                  / fr.fofr_pk_enhancement(k, Z_INIT))
    sel = slice(1, 9)
    err = np.abs(measured[sel] / theory[sel] - 1.0)
    check(np.isfinite(measured).all(), "P_fR/P_GR is not finite")
    check(theory[sel].max() > MG_TEETH,
          f"linear theory {theory[sel].max()} not above {MG_TEETH}")
    check(err.max() < MG_RATIO_TOL, f"P_fR/P_GR {measured[sel].tolist()} "
          f"against linear theory {theory[sel].tolist()}")
    out["fofr_pm"] = {"k": host(k).tolist(), "measured": measured.tolist(),
                      "theory": theory.tolist(),
                      "max_rel_err_bins_1_8": float(err.max())}
    del pm

    # ---- (b) growth tables on the card against the CPU
    kk = np.geomspace(*MG_K).astype(np.float32)

    def growth_grid(device):
        res = {}
        for fr0 in MG_FR0S:
            for n in MG_NS:
                c = Cosmology(fR0=fr0, fR_n=n)
                for z in MG_ZS:
                    res[(fr0, n, z)] = (
                        c.growth_factor_k(kk, z, device=device),
                        c.fofr_pk_enhancement(kk, z, device=device))
        return res

    grid_card = stage("growth_float_route", lambda: growth_grid(dev))

    def traced_grid():
        res = {}
        for fr0 in MG_FR0S:
            for n in MG_NS:
                c = Cosmology(fR0=torch.tensor(fr0, dtype=torch.float64,
                                               device=dev), fR_n=n)
                for z in MG_ZS:
                    res[(fr0, n, z)] = (c.growth_factor_k(kk, z),
                                        c.fofr_pk_enhancement(kk, z))
        return res

    grid_traced = stage("growth_traced_route", traced_grid)
    mu0_models = ({"mu0": 1.0 / 3.0},
                  {"mu0": 1.0 / 3.0, "mu_model": "lambda"})
    tables_card = stage("mu0_tables", lambda: [
        Cosmology(**{**m, "mu0": torch.tensor(
            m["mu0"], dtype=torch.float64, device=dev)})
        for m in mu0_models])
    t_cpu = time.perf_counter()
    grid_cpu = growth_grid("cpu")
    tables_cpu = [Cosmology(**m) for m in mu0_models]
    seconds["growth_cpu"] = time.perf_counter() - t_cpu
    diffs = {"float_card_vs_cpu": 0.0, "traced_card_vs_cpu": 0.0,
             "mu0_tables": 0.0}
    for key, (g_card, e_card) in grid_card.items():
        g_cpu, e_cpu = grid_cpu[key]
        check(g_card.device.type == dev.type
              and e_card.dtype == torch.float32,
              f"growth {key} not float32 on the card")
        diffs["float_card_vs_cpu"] = max(diffs["float_card_vs_cpu"],
                                         rel(g_card, g_cpu),
                                         rel(e_card, e_cpu))
        g_tr, e_tr = grid_traced[key]
        diffs["traced_card_vs_cpu"] = max(diffs["traced_card_vs_cpu"],
                                          rel(g_tr, g_cpu), rel(e_tr, e_cpu))
        check(bool((torch.diff(e_tr[kk >= MG_MONO_K]) > 0).all()),
              f"enhancement {key} not rising in k")
    for tc, tg in zip(tables_cpu, tables_card):
        diffs["mu0_tables"] = max(diffs["mu0_tables"],
                                  rel(tg._lnD_tab, tc._lnD_tab),
                                  rel(tg._f_tab, tc._f_tab))
    check(diffs["float_card_vs_cpu"] == 0.0,
          f"float route on the card differs from the CPU: {diffs}")
    check(diffs["traced_card_vs_cpu"] < MG_TRACED_TOL,
          f"traced route on the card against the CPU: {diffs}")
    check(diffs["mu0_tables"] < MG_TABLE_TOL, f"mu0 tables: {diffs}")
    k01 = np.array([0.1], np.float32)
    f4 = float(Cosmology(fR0=1e-4).fofr_pk_enhancement(k01)[0])
    f5 = float(Cosmology(fR0=1e-5).fofr_pk_enhancement(k01)[0])
    check(1.15 < f4 < 1.32 and 1.03 < f5 < 1.12,
          f"F4 {f4}, F5 {f5} at k = 0.1 outside the published window")
    gr_enh = host(Cosmology(fR0=0.0).fofr_pk_enhancement(kk))
    check(np.abs(gr_enh - 1.0).max() <= 1e-6, "GR enhancement is not 1")

    def traced_one(x):
        return Cosmology(fR0=x).fofr_pk_enhancement(kk)

    x0 = torch.tensor(1e-5, dtype=torch.float64, device=dev)
    _, n_value = _kernel_launches(lambda: traced_one(x0))
    jac, n_jac = stage("growth_jacfwd", lambda: _kernel_launches(
        lambda: torch.func.jacfwd(traced_one)(x0)))
    check(bool(torch.isfinite(jac).all()) and float(jac[-1]) > 0,
          "the fR0 Jacobian is not finite and positive at high k")

    def anchors(device):
        cosmo = Cosmology()
        k2 = torch.tensor([0.1, 1.0], device=device)
        boost = (linear_power.nonlinear_power(k2, cosmo)
                 / linear_power.linear_power(k2, cosmo))
        clk = angular_power.cl_kappa_limber(
            torch.tensor([500.0], device=device), cosmo, z_source=1.0)
        fr5 = Cosmology(fR0=1e-5).fofr_pk_enhancement(host(k2),
                                                      device=device)
        hmf = halo_stats.theory_hmf(np.asarray([1e13]), cosmo,
                                    model="tinker08", device=device)
        return [boost, clk, fr5, hmf]

    anc = stage("theory_anchors", lambda: anchors(dev))
    t_cpu = time.perf_counter()
    anc_cpu = anchors("cpu")
    seconds["theory_anchors_cpu"] = time.perf_counter() - t_cpu
    diffs["theory_anchors"] = max(rel(a, b) for a, b in zip(anc, anc_cpu))
    check(all(a.device.type == dev.type for a in anc),
          "a theory anchor did not run on the card")
    check(diffs["theory_anchors"] < MG_ANCHOR_TOL,
          f"theory anchors card vs CPU {diffs['theory_anchors']}")
    out["growth"] = {"f4_k01": f4, "f5_k01": f5, "card_vs_cpu": diffs,
                     "traced_value_launches": n_value,
                     "traced_jacfwd_launches": n_jac,
                     "anchors": [host(a).tolist() for a in anc]}

    # ---- (c) flat-sky MASTER at survey size
    ell_tab, cl_tab = _example_cl_table()
    ell_fine = np.linspace(1.0, 40000.0, 40000)
    cl_fine = 1.0 / (ell_fine * (ell_fine + 1.0))
    mask = _master_mask(MA_NPIX, seed)
    w = torch.from_numpy(mask).to(dev)
    _, nmodes = angular_power.flat_sky_mode_counts(MA_NPIX, MA_FOV,
                                                   MA_NBINS, device=dev)
    full = host(nmodes) >= MA_MIN_MODES
    coupling = stage("master_coupling", lambda: angular_power
                     .flat_sky_coupling_matrix(w.double(), MA_FOV,
                                               MA_NBINS))
    coupling2 = stage("master_spin2_coupling", lambda: angular_power
                      .flat_sky_spin2_coupling_matrices(w.double(), MA_FOV,
                                                        MA_NBINS))

    def realizations():
        gen = torch.Generator(device=dev).manual_seed(seed + 17)
        acc = {}
        for _ in range(MA_REALIZATIONS):
            img = angular_power.cl_to_flat_map(gen, ell_fine, cl_fine,
                                               MA_NPIX, MA_FOV)
            g1, g2 = angular_power.kappa_to_shear_maps(img)
            _, ee_ms, bb_ms = angular_power.cl_flat_sky_shear_master(
                g1, g2, w, MA_FOV, nbins=MA_NBINS, coupling=coupling2)
            _, pee, pbb = angular_power.cl_shear_eb(g1 * w, g2 * w, MA_FOV,
                                                    nbins=MA_NBINS)
            spectra = {
                "true": angular_power.cl_flat_sky(img, MA_FOV,
                                                  nbins=MA_NBINS)[1],
                "master": angular_power.cl_flat_sky_master(
                    img, w, MA_FOV, nbins=MA_NBINS, coupling=coupling)[1],
                "w2": angular_power.cl_flat_sky_masked(img, w, MA_FOV,
                                                       nbins=MA_NBINS)[1],
                "ee_true": angular_power.cl_shear_eb(g1, g2, MA_FOV,
                                                     nbins=MA_NBINS)[1],
                "ee": ee_ms, "bb": bb_ms, "pee": pee, "pbb": pbb}
            for name, v in spectra.items():
                acc.setdefault(name, []).append(host(v).astype(np.float64))
        return img, {name: np.mean(v, 0) for name, v in acc.items()}, \
            np.abs(np.array(acc["master"]) / np.array(acc["true"]) - 1.0)

    img, mean, single = stage("master_realizations", realizations)
    master_err = np.abs(mean["master"] / mean["true"] - 1.0)[full]
    w2_bias = (mean["w2"] / mean["true"] - 1.0)[full]
    ee_err = np.abs(mean["ee"] / mean["ee_true"] - 1.0)[full]
    bb_ee = float(mean["bb"][full].sum() / mean["ee"][full].sum())
    raw_bb_ee = float(mean["pbb"][full].sum() / mean["pee"][full].sum())
    check(full.sum() >= 4, f"only {int(full.sum())} bands of >= "
          f"{MA_MIN_MODES} modes")
    # under the bar, and well under the plain <w^2> pseudo-Cl's own bias on
    # the same bands, so that a coupling which reduced to <w^2> fails here
    check(master_err.max() < MA_TOL
          and master_err.max() < 0.5 * np.abs(w2_bias).max(),
          f"MASTER against the unmasked C_ell: {master_err.tolist()}, "
          f"<w^2> bias {w2_bias.tolist()}")
    check(abs(bb_ee) < MA_BB and ee_err.max() < MA_TOL,
          f"spin-2 MASTER BB/EE {bb_ee}, EE err {ee_err.tolist()}")
    # the card against the CPU at MA_CPU_NPIX
    small = _master_mask(MA_CPU_NPIX, seed + 1)
    gen_s = torch.Generator(device=dev).manual_seed(seed + 18)
    img_s = angular_power.cl_to_flat_map(gen_s, ell_tab, cl_tab,
                                         MA_CPU_NPIX, MA_FOV)
    ws = torch.from_numpy(small).to(dev)

    def small_run(im, mk, coupling_mask):
        gg1, gg2 = angular_power.kappa_to_shear_maps(im)
        return ([angular_power.flat_sky_coupling_matrix(
                    coupling_mask, MA_FOV, MA_NBINS)]
                + list(angular_power.flat_sky_spin2_coupling_matrices(
                    coupling_mask, MA_FOV, MA_NBINS)),
                [angular_power.cl_flat_sky_masked(im, mk, MA_FOV,
                                                  nbins=MA_NBINS)[1],
                 angular_power.cl_flat_sky_master(im, mk, MA_FOV,
                                                  nbins=MA_NBINS)[1],
                 *angular_power.cl_flat_sky_shear_master(
                     gg1, gg2, mk, MA_FOV, nbins=MA_NBINS)[1:]])

    small_card = stage("master_512", lambda: small_run(img_s, ws,
                                                       ws.double()))
    t_cpu = time.perf_counter()
    small_cpu = small_run(img_s.cpu(), small, small)
    seconds["master_512_cpu"] = time.perf_counter() - t_cpu
    coup_err = max(float(np.abs(a - b).max() / np.abs(small_cpu[0][0]).max())
                   for a, b in zip(small_card[0], small_cpu[0]))
    spec_err = max(rel(a, b) for a, b in zip(small_card[1], small_cpu[1]))
    check(coup_err < MA_COUP_TOL and spec_err < MA_SPEC_TOL,
          f"MASTER at {MA_CPU_NPIX}^2 card vs CPU: couplings {coup_err}, "
          f"spectra {spec_err}")
    # SkyNamaster on the example's stages 3 and 6, then at 2048^2
    ex_n = 128
    ex_img = angular_power.cl_to_flat_map(
        torch.Generator(device=dev).manual_seed(seed + 1), ell_tab, cl_tab,
        ex_n, MA_FOV)
    ex_mask = np.ones((ex_n, ex_n), np.float32)
    ex_mask[:, :30] = 0.0
    rng = np.random.default_rng(seed)
    g1m = rng.standard_normal((ex_n, ex_n)).astype(np.float32)
    g2m = rng.standard_normal((ex_n, ex_n)).astype(np.float32)

    def example():
        sn = SkyNamaster.from_array(host(ex_img), opening_angle=MA_FOV)
        sn.set_mask(ex_mask)
        res = [sn.compute_cl(nbins=8, decouple=False),
               sn.compute_cl(nbins=8), sn.compute_cl_spin2(g1m, g2m,
                                                           nbins=8)]
        return sn, res

    sn_ex, ex_res = stage("skynamaster_example", example)
    for part in ex_res:
        check(all(bool(torch.isfinite(t).all()) and t.device.type == dev.type
                  for t in part), "SkyNamaster example not finite on card")
    sn_big = SkyNamaster.from_array(host(img), opening_angle=MA_FOV)
    sn_big.set_mask(mask)
    big1 = stage("skynamaster_2048_first", lambda: sn_big.compute_cl(
        nbins=MA_NBINS))
    big2 = stage("skynamaster_2048_cached", lambda: sn_big.compute_cl(
        nbins=MA_NBINS))
    big_direct = angular_power.cl_flat_sky_master(img, w, MA_FOV,
                                                  nbins=MA_NBINS,
                                                  coupling=coupling)[1]
    # the pseudo-Cl's band sums are float32 atomics over ~2^18 modes a band
    # on the card: a second call agrees to their rounding (~sqrt(2^18)
    # ulps), not bit for bit
    check(sn_big._workspace.get(("flat", MA_NBINS)) is not None
          and rel(big2[1], big1[1]) < MA_REPEAT_TOL
          and rel(big1[1], big_direct) < MA_REPEAT_TOL,
          f"SkyNamaster's cached call differs: {rel(big2[1], big1[1])}, "
          f"{rel(big1[1], big_direct)}")
    out["master"] = {
        "realizations": MA_REALIZATIONS,
        "bands_ge_1e4_modes": int(full.sum()),
        "master_max_rel_err": float(master_err.max()),
        "master_per_map_max_rel_err_median": float(np.median(
            single.max(1))),
        "w2_bias": w2_bias.tolist(),
        "w2": float(np.mean(mask.astype(np.float64) ** 2)),
        "shear_ee_max_rel_err": float(ee_err.max()),
        "shear_master_bb_over_ee": bb_ee, "raw_pseudo_bb_over_ee": raw_bb_ee,
        "card_vs_cpu_512": {"couplings": coup_err, "spectra": spec_err},
        "example_cl_w2": host(ex_res[0][1])[:4].tolist(),
        "example_cl_master": host(ex_res[1][1])[:4].tolist()}
    del img, w, sn_big

    # ---- (d) HMC
    icov = torch.linalg.inv(torch.tensor([[1.0, 0.6], [0.6, 1.0]],
                                         device=dev))

    def gauss():
        return inference.hmc_sample(
            torch.Generator(device=dev).manual_seed(seed),
            lambda x: -0.5 * torch.sum(x * (icov * x[None, :]).sum(1)),
            torch.zeros(2, device=dev), n_samples=HMC_GAUSS[0],
            n_warmup=HMC_GAUSS[1], n_leapfrog=HMC_GAUSS[2],
            step_size=HMC_GAUSS[3])

    g = stage("hmc_gaussian", gauss)
    s = host(g.samples)
    check(0.6 < float(g.accept_rate) <= 1.0
          and np.abs(s.mean(0)).max() < 0.1
          and np.abs(np.cov(s.T) - [[1.0, 0.6], [0.6, 1.0]]).max() < 0.12,
          f"HMC on the correlated Gaussian: rate {float(g.accept_rate)}, "
          f"mean {s.mean(0)}, cov {np.cov(s.T).tolist()}")

    def posterior_run(ells, zs, names, truth, hmc, x0, step, nchi):
        stack = tomographic_shear_cls(ells, Cosmology(**truth), zs,
                                      nchi=nchi, device=dev)
        logp, _ = inference.shear_log_posterior(
            ells, stack, zs, names, fsky=HMC_FSKY, nchi=nchi,
            prior_bounds=HMC_BOUNDS)
        fish = shear_fisher(ells, {k: truth[k] for k in names}, zs,
                            fsky=HMC_FSKY, nchi=nchi,
                            fixed={k: v for k, v in truth.items()
                                   if k not in names})
        sig = fish["marginalized"]
        xt = torch.tensor([truth[k] for k in names], device=dev)
        _, n_grad = _kernel_launches(lambda: inference._value_and_grad(
            logp, xt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            inference._value_and_grad(logp, xt)
        torch.cuda.synchronize()
        ms_grad = (time.perf_counter() - t0) / 5 * 1e3
        res = inference.hmc_sample(
            torch.Generator(device=dev).manual_seed(seed + 2), logp,
            torch.tensor(x0, device=dev), n_samples=hmc[0],
            n_warmup=hmc[1], n_leapfrog=hmc[2], step_size=step,
            inv_mass=torch.tensor(sig ** 2, dtype=torch.float32,
                                  device=dev))
        return logp, sig, res, ms_grad, n_grad

    shear_ells = np.geomspace(100, 800, 5).astype(np.float32)
    truth = {"Om0": 0.3089, "sigma8": 0.8159}
    logp1, sig1, res1, ms1, n1 = stage("hmc_shear", lambda: posterior_run(
        shear_ells, [1.0], ["sigma8"], truth, HMC_SHEAR, [0.79],
        HMC_SHEAR[3], 48))
    s1 = host(res1.samples)[:, 0]
    check(float(logp1(torch.tensor([0.8159], device=dev)))
          > float(logp1(torch.tensor([0.9], device=dev))),
          "the shear posterior does not peak at the truth")
    check(abs(s1.mean() - 0.8159) < 3 * sig1[0]
          and 0.5 < s1.std() / sig1[0] < 2.0,
          f"shear HMC: mean {s1.mean()}, std {s1.std()}, sigma_F {sig1}")
    wide_ells = np.geomspace(*HMC_WIDE_ELLS).astype(np.float32)
    logp2, sig2, res2, ms2, n2 = stage("hmc_wide", lambda: posterior_run(
        wide_ells, list(HMC_WIDE_Z), ["Om0", "sigma8"], truth, HMC_WIDE,
        [0.3089, 0.8159], 0.01, HMC_WIDE_NCHI))
    s2 = host(res2.samples)
    tv = np.array([truth["Om0"], truth["sigma8"]])
    ratio = s2.std(0) / sig2
    check(np.all(np.abs(s2.mean(0) - tv) < 3 * sig2)
          and np.all((ratio > 0.5) & (ratio < 2.0))
          and float(res2.accept_rate) > 0.5,
          f"wide HMC: mean {s2.mean(0)}, std/sigma_F {ratio}, rate "
          f"{float(res2.accept_rate)}")
    zt = np.linspace(0.01, 3.0, 100)
    nz = (zt, host(angular_power.smail_nz(zt, z0=0.64, device="cpu")))
    rp = np.array([2.0, 5.0, 10.0])
    hod_fixed = {"sigma_logm": 0.3, "log_m0": 12.0, "log_m1": 13.5,
                 "alpha": 1.0}
    t3 = {"Om0": 0.3, "sigma8": 0.8, "log_mmin": 12.5}

    def threex2pt():
        mean_fn, _, _ = threex2pt_mean_builder(
            rp, rp, 128, 5.0, nz, 60.0, 6, 3.0, 100.0, 0.0, 128, 32, True,
            {}, hod_fixed)
        data = mean_fn({k: torch.tensor(v, dtype=torch.float64, device=dev)
                        for k, v in t3.items()})
        cov = np.diag((0.05 * np.abs(host(data)) + 1e-8) ** 2)
        logp, _ = inference.threex2pt_log_posterior(
            data, cov, list(t3), rp, rp, 128, 5.0, nz, nbins_xi=6,
            theta_min_arcmin=3.0, theta_max_arcmin=100.0, nell=128, nchi=32,
            hod_fixed=hod_fixed, prior_bounds={"Om0": (0.1, 0.6)})
        at = float(logp(torch.tensor([0.3, 0.8, 12.5], dtype=torch.float64,
                                     device=dev)))
        _, grad = inference._value_and_grad(
            logp, torch.tensor([0.31, 0.81, 12.55], device=dev))
        barrier = float(logp(torch.tensor([0.05, 0.8, 12.5], device=dev)))
        return at, host(grad), barrier

    at3, grad3, bar3 = stage("threex2pt_posterior", threex2pt)
    check(abs(at3) < 1e-6 and np.isfinite(grad3).all() and bar3 < -1e3,
          f"3x2pt posterior: logp(truth) {at3}, grad {grad3}, barrier {bar3}")
    out["hmc"] = {
        "gaussian": {"accept_rate": float(g.accept_rate),
                     "step_size": float(g.step_size),
                     "mean": s.mean(0).tolist(),
                     "cov": np.cov(s.T).tolist()},
        "shear": {"mean": float(s1.mean()), "std": float(s1.std()),
                  "sigma_fisher": sig1.tolist(),
                  "accept_rate": float(res1.accept_rate),
                  "step_size": float(res1.step_size), "ms_per_grad": ms1,
                  "launches_per_grad": n1, "settings": HMC_SHEAR},
        "wide": {"mean": s2.mean(0).tolist(), "std": s2.std(0).tolist(),
                 "sigma_fisher": sig2.tolist(),
                 "accept_rate": float(res2.accept_rate),
                 "step_size": float(res2.step_size), "ms_per_grad": ms2,
                 "launches_per_grad": n2, "settings": HMC_WIDE},
        "threex2pt": {"logp_truth": at3, "grad": grad3.tolist(),
                      "barrier": bar3}}

    # ---- (e) lognormal map
    ln_ell = np.geomspace(30.0, 20000.0, 256)
    ln_cl = 1e-6 * (ln_ell / 1000.0) ** -2
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    re = torch.randn((LN_NPIX, LN_NPIX), generator=gen, device=dev)
    im = torch.randn((LN_NPIX, LN_NPIX), generator=gen, device=dev)
    ln = stage("lognormal_map", lambda: mocks.lognormal_map_from_white(
        re, im, LN_NPIX, 10.0, ln_ell, ln_cl))
    ln_gen = mocks.lognormal_map(torch.Generator(device=dev).manual_seed(
        seed + 3), LN_NPIX, 10.0, ln_ell, ln_cl)
    ln_cpu = mocks.lognormal_map_from_white(re.cpu(), im.cpu(), LN_NPIX,
                                            10.0, ln_ell, ln_cl)
    check(float(ln.min()) >= -1.0 - 1e-5 and abs(float(ln.mean())) < 0.2,
          f"lognormal map min {float(ln.min())}, mean {float(ln.mean())}")
    check(torch.equal(ln, ln_gen), "lognormal_map differs from its draws")
    diffs["lognormal"] = rel(ln, ln_cpu)
    check(diffs["lognormal"] < LN_TOL, f"lognormal card vs CPU "
          f"{diffs['lognormal']}")

    # ---- (f) the analysis toolbox and snapshot_info_table
    rng = np.random.default_rng(seed)
    vals = torch.from_numpy(rng.normal(5.0, 1.0, BOOT_N).astype(
        np.float32)).to(dev)
    boot = stage("bootstrap", lambda: analysis.bootstrap_statistic(
        vals, torch.Generator(device=dev).manual_seed(seed), n_boot=BOOT_NB))
    # the band of the mean brackets the sample mean, 2 sigma / sqrt(n)
    # wide (the 16th to 84th percentile of the resampled means) to 20%
    width = (float(boot[2]) - float(boot[0])) / (2.0 / math.sqrt(BOOT_N))
    check(all(bool(torch.isfinite(b).all()) for b in boot)
          and float(boot[0]) < float(vals.double().mean()) < float(boot[2])
          and abs(width - 1.0) < 0.2,
          f"bootstrap band {[float(b) for b in boot]}, width / (2 / sqrt "
          f"n) {width}")
    idx = torch.randint(0, BOOT_N, (BOOT_CPU_NB, BOOT_N), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    b_card = analysis.bootstrap_statistic_from_draws(vals, idx, "median")
    b_cpu = analysis.bootstrap_statistic_from_draws(vals.cpu(), idx.cpu(),
                                                    "median")
    diffs["bootstrap"] = max(rel(a, b) for a, b in zip(b_card, b_cpu))
    del idx
    r = np.geomspace(0.05, 3.0, 64).astype(np.float32)
    prof = (np.log(2.5) - np.log(r / 0.4) - 2 * np.log(1 + r / 0.4)
            + rng.normal(0, 0.01, r.size))

    def nfw(rr, p):
        xx = rr / p[1]
        return torch.log(p[0]) - torch.log(xx) - 2.0 * torch.log(1.0 + xx)

    fit = stage("nonlinear_least_squares", lambda: analysis
                .nonlinear_least_squares(nfw, r, prof, [1.0, 1.0],
                                         device=dev))
    fit_cpu = analysis.nonlinear_least_squares(nfw, r, prof, [1.0, 1.0],
                                               device="cpu")
    check(fit[2] and np.abs(fit[0] / [2.5, 0.4] - 1).max() < 0.05,
          f"NFW fit {fit}")
    diffs["nfw_fit"] = rel(fit[0], fit_cpu[0])
    d = rng.normal(size=(PCA_N, 1)) * np.linspace(3.0, 0.5, PCA_F)[None, :] \
        + rng.normal(size=(PCA_N, PCA_F)) * 0.1
    d = d.astype(np.float32)
    reals = rng.normal(size=COV_SHAPE).astype(np.float32)
    pc = stage("pca_covariance", lambda: (
        analysis.pca(d, 4, device=dev),
        analysis.covariance_from_realizations(reals, device=dev),
        analysis.covariance_from_realizations(reals, True, device=dev)))
    pc_cpu = (analysis.pca(d, 4, device="cpu"),
              analysis.covariance_from_realizations(reals, device="cpu"),
              analysis.covariance_from_realizations(reals, True,
                                                    device="cpu"))
    diffs["pca"] = max(rel(pc[0][1], pc_cpu[0][1]),
                       rel(pc[0][0][0].abs(), pc_cpu[0][0][0].abs()))
    diffs["covariance"] = max(rel(pc[1], pc_cpu[1]), rel(pc[2], pc_cpu[2]))
    cosmo_f5 = Cosmology(fR0=1e-5)
    boxes = {1: [3.0, 2.0, 1.0, 0.5, 0.0], 2: [1.0, 0.0]}
    tab = stage("snapshot_info", lambda: siminfo.snapshot_info_table(
        boxes, cosmo_f5.with_tensor_fields(dev)))
    tab_cpu = siminfo.snapshot_info_table(boxes, cosmo_f5)
    diffs["snapshot_info"] = max(rel(tab[c], tab_cpu[c])
                                 for c in ("Hz", "lookback_time", "Dc"))
    for name in ("bootstrap", "nfw_fit", "pca", "covariance",
                 "snapshot_info"):
        check(diffs[name] < TOOLBOX_TOL, f"{name} card vs CPU {diffs[name]}")
    out["toolbox"] = {"bootstrap_band": [float(b) for b in boot],
                      "nfw_fit": fit[0].tolist(),
                      "pca_var": host(pc[0][1]).tolist()}
    out["card_vs_cpu"] = diffs

    predicted = {name: {} for name in seconds if not name.endswith("_cpu")}
    predicted["fofr_pm"] = {"paint_windowed": 2 * (MG_STEPS + 1) + 2}
    total = _held_launches("mg/master/inference", predicted, {
        k: v for k, v in launches.items() if k in predicted})
    card_s = sum(v for k, v in seconds.items() if not k.endswith("_cpu"))
    log(f"# phase mg/master/inference: {card_s:.2f} s of card stages "
        f"({sum(seconds.values()):.2f} s with the CPU runs); launches "
        f"{total}; P_fR/P_GR / linear theory bins 1-8 max err "
        f"{err.max():.4f} (theory up to {theory[sel].max():.3f}); F4 {f4:.4f}"
        f", F5 {f5:.4f} at k = 0.1; traced fofr {n_value} kernels, its "
        f"jacfwd {n_jac} in {seconds['growth_jacfwd']:.3f} s; MASTER max "
        f"err {master_err.max():.4f} (<w^2> bias {np.abs(w2_bias).max():.4f}"
        f"), spin-2 BB/EE {bb_ee:.2e} (raw {raw_bb_ee:.2e}); coupling "
        f"{seconds['master_coupling']:.3f} s, cached SkyNamaster "
        f"{seconds['skynamaster_2048_cached']:.3f} s; HMC grads "
        f"{ms1:.1f} / {ms2:.1f} ms ({n1} / {n2} kernels); card vs CPU max "
        f"{max(diffs.values()):.1e}; peak {max(peaks.values()):.2f} GB")
    result = {"seconds": seconds, "seconds_card": card_s,
              "launches": launches, "launches_total": total,
              "peak_mem_gb": peaks, **out}
    log("# mg_master_inference " + json.dumps(result))
    return result


# ------------------------------------------------------------ full sky
def _log_bands(lo: int, hi: int, n: int) -> np.ndarray:
    """n + 1 integer band edges spaced evenly in log between lo and hi + 1
    (band b holds lo_b <= ell < hi_b)."""
    edges = np.unique(np.round(np.geomspace(lo, hi + 1, n + 1)).astype(int))
    if edges.size != n + 1:
        raise ValueError(f"{n} log bands over [{lo}, {hi}] are not distinct")
    return edges


def _band_sums(x, edges) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return np.array([x[a:b].sum() for a, b in zip(edges[:-1], edges[1:])])


def _host_peak_gb(fn):
    """(fn(), the process's peak resident memory in GB): the kernel's
    high-water mark, reset before fn where /proc allows it; else the
    process's peak so far (getrusage), flagged by reset False."""
    import resource

    reset = True
    try:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")
    except OSError:
        reset = False
    res = fn()
    peak = None
    if reset:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) * 1024 / 1e9
    if peak is None:
        reset = False
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    return res, {"gb": peak, "reset": reset}


def _tensor_gb(tables) -> float:
    return sum(t.numel() * t.element_size() for t in tables
               if isinstance(t, torch.Tensor)) / 1e9


def _galactic_mask(nside: int, dev, rng) -> torch.Tensor:
    """1 off a galactic cut |theta - pi/2| < FS_MASK_CUT_DEG and off
    FS_MASK_HOLES holes of FS_MASK_HOLE_DEG radius around centres uniform
    on the sphere (numpy-seeded), float32 on `dev`."""
    from astrild_tpu_torch.utils import healpix as hpx

    theta, phi = hpx.pix2ang_ring(nside, np.arange(hpx.nside2npix(nside)))
    vec = torch.from_numpy(hpx.ang2vec(theta, phi).astype(np.float32)).to(dev)
    mask = (torch.from_numpy(np.abs(theta - np.pi / 2)).to(dev)
            >= np.deg2rad(FS_MASK_CUT_DEG)).to(torch.float32)
    centres = hpx.ang2vec(np.arccos(rng.uniform(-1, 1, FS_MASK_HOLES)),
                          rng.uniform(0, 2 * np.pi, FS_MASK_HOLES))
    cos_r = float(np.cos(np.deg2rad(FS_MASK_HOLE_DEG)))
    for c in centres.astype(np.float32):
        inside = (vec[:, 0] * float(c[0]) + vec[:, 1] * float(c[1])
                  + vec[:, 2] * float(c[2])) > cos_r
        mask[inside] = 0.0
    return mask


def _sht_profile(fn) -> dict:
    """One call of fn on the host clock, synchronized, then one under
    torch.profiler: its CUDA kernel launches, device time and the shares
    of the sht.legendre / sht.caps / sht.belt_fft spans in it; and the
    call's peak memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    spans = ("sht.legendre", "sht.caps", "sht.belt_fft")
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA
               and e.key not in spans]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    span_ms = {k: v["ms"] for k, v in _span_ms(rows, spans).items()}
    # the shares of the spans' device time and the rest's (a graph
    # replay's kernels are attributed to its span, not always listed)
    whole = max(sum(span_ms.values()), busy, 1e-9)
    return {"seconds": seconds, "peak_gb": peak,
            "kernels": int(sum(e.count for e in kernels)),
            "device_ms": busy, "span_ms": span_ms,
            "span_share": {k: v / whole for k, v in span_ms.items()}}


def phase_full_sky(dev, seed: int, out_gr, shell_flushes: int) -> dict:
    """The spherical-harmonic stack at full width, each stage on the host
    clock, synchronized, with its K1-K4 launches held to its own count
    and its peak memory; the checks raise. (a) phase 9's HEALPix shells of
    the GR z=0 snapshot through K1 (its flushes' launches) ->
    SkyHealpix.from_density_shells; (b) on that map at nside 1024, lmax
    2048 (the scan path): anafast, shear_from_kappa, shear_eb_spectra
    (C_EE / C_kk (l+2)(l-1)/(l(l+1)) within 2% in 32 log bands over 10 <=
    l <= 1536, sum BB / sum EE < 1e-3) and shear_xi_pm's transform of
    them at 16 angles (the facade itself in (e)); a
    synfast_large / anafast_large round trip of examples/full_pipeline.py's
    C_l = 2e-9 / max(l(l+1), 1) (every band within 5 sigma); at lmax 3071
    CG against Jacobi (niter 3) on one realization: CG's mean bias over
    2048 < l <= 3071 under 2% and under Jacobi's; (c) table against scan
    path at nside 256, lmax 512, scalar and spin-2 (synthesis within 5e-4
    of the map's max, analysis within 1e-4 of the largest alm), the host
    tables' seconds, GB and host peak; every transform at nside 64, lmax
    128 on the card against the CPU within 1e-5; (d) full-sky MASTER at
    nside 512, lmax 1024 under a galactic cut and 128 holes: 8 scalar and
    4 E-only spin-2 realizations (their mean within 4 sigma of the input
    in 16 bands, sigma each multipole's 2 C_l^2 / ((2l + 1) f_sky)
    through the binning, over the maps (their means from the maps' pseudo
    spectra, the estimators being linear in them; anafast_master,
    anafast_masked and anafast_spin2_master on the first map against the
    same);
    the worst band against the unmasked maps' (niter 0, unbiased at lmax
    = 2 nside) within half the largest <w^2> bias; MASTER BB/EE < 1e-2),
    SkyNamaster with its cached second call; (e)
    examples/full_pipeline.py's full-sky SHT stage at its own parameters
    on the card against the CPU, AngularPowerSpectrum.from_healpix /
    to_skyhealpix, SkyHealpix.from_columns of 10^7 ray samples at nside
    1024, rotate at nside 256 against the CPU, to_skyarray onto 2048^2
    over 10 deg, a 10' smoothing of (b)'s round-trip map (C_l ratio within
    5% of b_l^2 where b_l^2 > 0.1); (f) one synthesize_large,
    analyze_large(niter=0) and their spin-2 twins at nside 1024, lmax
    2048: seconds, CUDA kernels, the span shares and peak memory.
    Returns the numbers printed in `# full_sky`."""
    from astrild_tpu_torch.models import (AngularPowerSpectrum, SkyHealpix,
                                          SkyNamaster)
    from astrild_tpu_torch.ops import (lightcone_sphere, paint_cuda,
                                       pairwise_cuda, sht, sht_large,
                                       sht_spin, sht_spin_large)
    from astrild_tpu_torch.ops.shear_2pt import xi_pm_from_cl_curved
    from astrild_tpu_torch.utils.constants import C_LIGHT_KMS

    seconds, launches, peaks, out = {}, {}, {}, {}
    run = _stage_runner(seconds, launches)

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = run(name, fn)
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        log(f"#   full_sky stage {name}: {seconds[name]:.3f} s, launches "
            f"{launches[name]}, peak {peaks[name]:.2f} GB")
        return res

    def host(x) -> np.ndarray:
        return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x))

    def rel(got, want) -> float:
        got, want = host(got).astype(np.float64), host(want).astype(
            np.float64)
        return float(np.abs(got - want).max()
                     / max(np.abs(want).max(), 1e-300))

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"full_sky: {msg}")

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    nside, lmax = FS_NSIDE, FS_LMAX

    # ---- (a) Born kappa on the sphere through K1
    edges = np.linspace(*LC_EDGES)

    def born():
        delta, chis, dchis = lightcone_sphere.density_shells_healpix(
            out_gr, edges, LC_NSIDE, BOX)
        sky = SkyHealpix.from_density_shells(delta, chis, dchis,
                                             LC_SHELL_SOURCE, 0.3)
        chis, dchis = host(chis).astype(np.float64), host(dchis).astype(
            np.float64)
        w = (1.5 * 0.3 * (100.0 / C_LIGHT_KMS) ** 2
             * np.clip(LC_SHELL_SOURCE - chis, 0.0, None) * chis
             / LC_SHELL_SOURCE * dchis)
        return sky, float((w * host(delta.double().mean(dim=1))).sum())

    sky, weighted_mean = stage("born_shells", born)
    kmap = sky.data["orig"]
    map_mean = float(kmap.double().mean())
    check(tuple(kmap.shape) == (12 * nside ** 2,)
          and bool(torch.isfinite(kmap).all()), "Born map not finite")
    check(abs(map_mean - weighted_mean) <= 1e-3 * abs(weighted_mean),
          f"Born map mean {map_mean} against the shells' weighted mean "
          f"{weighted_mean}")
    out["born"] = {"mean": map_mean, "shells_weighted_mean": weighted_mean,
                   "rms": float(kmap.double().std()),
                   "k1_flushes": shell_flushes}

    # ---- (b) the scan path at nside 1024, lmax 2048
    bands = _log_bands(*FS_ELL_RANGE, FS_BANDS)
    ell = np.arange(FS_LMAX_HI + 1, dtype=np.float64)
    cl_in = 2e-9 / np.maximum(ell * (ell + 1.0), 1.0)
    cl_kk = stage("anafast_2048", lambda: sky.anafast(lmax))
    stage("shear_from_kappa_2048", lambda: sky.shear_from_kappa(lmax=lmax))
    ee, bb, eb = stage("shear_eb_2048",
                       lambda: sky.shear_eb_spectra(lmax=lmax))
    e = ell[: lmax + 1]
    fac = np.where(e >= 2, (e + 2) * (e - 1) / np.maximum(e * (e + 1), 1),
                   0.0)
    ee_ratio = _band_sums(ee, bands) / _band_sums(cl_kk * fac, bands)
    bb_ee = float(bb[2:].sum() / ee[2:].sum())
    check(bool(np.all(np.abs(ee_ratio - 1.0) < FS_EE_TOL)),
          f"C_EE / C_kk fac off by {np.abs(ee_ratio - 1).max():.4f}")
    check(bb_ee < FS_BB_TOL, f"BB/EE {bb_ee}")
    # shear_xi_pm's transform of these spectra (its own spin-2 analysis
    # again is (e)'s, at the example's size)
    theta = np.geomspace(*FS_XI_ARCMIN)
    xi_p, xi_m = stage("shear_xi_pm_2048", lambda: xi_pm_from_cl_curved(
        ee, theta * np.pi / 180.0 / 60.0, cl_b=bb))
    check(bool(np.all(np.isfinite(xi_p)) and np.all(np.isfinite(xi_m))),
          "xi_pm not finite")
    out["lensing"] = {"ee_over_kk_max_dev": float(
        np.abs(ee_ratio - 1).max()), "bb_over_ee": bb_ee,
        "eb_over_ee": float(np.abs(eb[2:]).sum() / ee[2:].sum()),
        "theta_arcmin": theta.tolist(), "xi_plus": xi_p.tolist(),
        "xi_minus": xi_m.tolist()}
    del ee, bb, eb

    m_rt = stage("synfast_large_2048", lambda: sht_large.synfast_large(
        gen, cl_in[: lmax + 1], nside, lmax))
    c_rt = host(stage("anafast_large_2048",
                      lambda: sht_large.anafast_large(m_rt, lmax)))
    nmodes = _band_sums(2 * e + 1, bands)
    c_b = _band_sums((2 * e + 1) * cl_in[: lmax + 1], bands) / nmodes
    pulls = ((_band_sums((2 * e + 1) * c_rt, bands) / nmodes - c_b)
             / (c_b * np.sqrt(2.0 / nmodes)))
    check(bool(np.all(np.abs(pulls) < FS_PULL)),
          f"round trip pulls {np.abs(pulls).max():.2f} sigma")
    out["round_trip_max_pull"] = float(np.abs(pulls).max())

    L = FS_LMAX_HI
    white = tuple(torch.randn((L + 1, L + 1), generator=gen, device=dev)
                  for _ in range(2))
    a_re, a_im = sht._gaussian_alms(*white, torch.as_tensor(
        cl_in[: L + 1], dtype=torch.float32, device=dev), L)
    cl_real = host(sht.alm2cl(a_re, a_im)).astype(np.float64)
    m_hi = stage("synthesize_large_3071", lambda: sht_large.synthesize_large(
        a_re, a_im, nside, L))
    del white, a_re, a_im
    hi = ell > 2 * nside
    bias = {}
    for method in ("cg", "jacobi"):
        c = host(stage(f"anafast_large_3071_{method}",
                       lambda: sht_large.anafast_large(m_hi, L,
                                                       method=method)))
        bias[method] = float(c[hi].mean() / cl_real[hi].mean() - 1.0)
    check(abs(bias["cg"]) < FS_CG_BIAS and abs(bias["cg"])
          < abs(bias["jacobi"]), f"above 2 nside: bias {bias}")
    out["above_2nside_bias"] = bias
    del m_hi

    # ---- (c) table against scan, card against CPU
    nt, lt = FS_TABLE_NSIDE, FS_TABLE_LMAX
    rng = np.random.default_rng(seed + 18)
    tables = {}
    tables["scalar"], peak_s = _host_peak_gb(lambda: stage(
        "tables_scalar_256", lambda: sht.sht_tables(nt, lt, dev)))
    tables["spin2"], peak_p = _host_peak_gb(lambda: stage(
        "tables_spin2_256", lambda: sht_spin.spin2_tables(nt, lt, dev)))
    out["tables"] = {
        "scalar": {"seconds": seconds["tables_scalar_256"],
                   "gb": _tensor_gb(tables["scalar"]), "host_peak": peak_s},
        "spin2": {"seconds": seconds["tables_spin2_256"],
                  "gb": _tensor_gb(tables["spin2"][:2]),
                  "host_peak": peak_p}}
    lg, mg = np.arange(lt + 1)[:, None], np.arange(lt + 1)[None, :]

    def alms(lmin):
        valid = (mg <= lg) & (lg >= lmin)
        return (torch.from_numpy((rng.standard_normal((lt + 1,) * 2)
                                  * valid).astype(np.float32)).to(dev),
                torch.from_numpy((rng.standard_normal((lt + 1,) * 2) * valid
                                  * (mg > 0)).astype(np.float32)).to(dev))

    s_alm, e_alm, b_alm = alms(0), alms(2), alms(2)
    qu = tuple(torch.randn(12 * nt * nt, generator=gen, device=dev)
               for _ in range(2))
    m_tab = stage("synthesize_table_512", lambda: sht.synthesize(
        *s_alm, nt, lt, tables=tables["scalar"]))
    m_scan = stage("synthesize_large_512", lambda: sht_large.synthesize_large(
        *s_alm, nt, lt))
    g_tab = stage("synthesize_spin2_table_512", lambda: sht_spin
                  .synthesize_spin2(*e_alm, *b_alm, nt, lt,
                                    tables=tables["spin2"]))
    g_scan = stage("synthesize_spin2_large_512", lambda: sht_spin_large
                   .synthesize_spin2_large(*e_alm, *b_alm, nt, lt))
    a_tab = stage("analyze_table_512", lambda: sht.analyze(
        qu[0], nt, lt, tables=tables["scalar"]))
    a_scan = stage("analyze_large_512", lambda: sht_large.analyze_large(
        qu[0], nt, lt))
    p_tab = stage("analyze_spin2_table_512", lambda: sht_spin.analyze_spin2(
        *qu, nt, lt, tables=tables["spin2"]))
    p_scan = stage("analyze_spin2_large_512", lambda: sht_spin_large
                   .analyze_spin2_large(*qu, nt, lt))
    synth_err = max(rel(m_scan, m_tab),
                    *(rel(a, b) for a, b in zip(g_scan, g_tab)))
    alm_scale = max(float(a.abs().max()) for a in (*a_tab, *p_tab))
    ana_err = max(float((a - b).abs().max()) for a, b in
                  zip((*a_scan, *p_scan), (*a_tab, *p_tab))) / alm_scale
    check(synth_err < FS_SYNTH_TOL, f"table vs scan synthesis {synth_err}")
    check(ana_err < FS_ANA_TOL, f"table vs scan analysis {ana_err}")
    out["table_vs_scan"] = {"synthesis": synth_err, "analysis": ana_err}
    rot_map = m_scan
    del tables, m_tab, g_tab, g_scan, a_tab, a_scan, p_tab, p_scan, qu
    sht._sht_tables.cache_clear()
    sht_spin._spin2_tables.cache_clear()
    torch.cuda.empty_cache()

    nc, lc = FS_CPU_NSIDE, FS_CPU_LMAX
    crng = np.random.default_rng(seed + 19)
    c_lg, c_mg = np.arange(lc + 1)[:, None], np.arange(lc + 1)[None, :]

    def c_alms(lmin):
        valid = (c_mg <= c_lg) & (c_lg >= lmin)
        return ((crng.standard_normal((lc + 1,) * 2) * valid).astype(
            np.float32), (crng.standard_normal((lc + 1,) * 2) * valid
                          * (c_mg > 0)).astype(np.float32))

    cs, ce, cb = c_alms(0), c_alms(2), c_alms(2)
    cmaps = tuple(crng.standard_normal(12 * nc * nc).astype(np.float32)
                  for _ in range(2))
    cmask = (crng.uniform(size=12 * nc * nc) > 0.3).astype(np.float32)

    def every_transform(d):
        res = [sht.synthesize(*cs, nc, lc, device=d),
               *sht.analyze(cmaps[0], nc, lc, device=d),
               sht.smoothing(cmaps[0], 0.05, lc, device=d),
               sht.anafast_masked(cmaps[0], cmask, lc, device=d),
               *sht.anafast_master(cmaps[0], cmask, lc, device=d),
               sht_large.synthesize_large(*cs, nc, lc, device=d),
               *sht_large.analyze_large(cmaps[0], nc, lc, device=d),
               *sht_large.analyze_large(cmaps[0], nc, lc, method="cg",
                                        device=d),
               sht_large.smoothing_large(cmaps[0], 0.05, lc, device=d),
               *sht_spin.synthesize_spin2(*ce, *cb, nc, lc, device=d),
               *sht_spin.analyze_spin2(*cmaps, nc, lc, device=d),
               *sht_spin.anafast_spin2_master(*cmaps, cmask, lc, device=d),
               *sht_spin_large.synthesize_spin2_large(*ce, *cb, nc, lc,
                                                      device=d),
               *sht_spin_large.analyze_spin2_large(*cmaps, nc, lc,
                                                   device=d),
               *sht_spin_large.analyze_spin2_large(*cmaps, nc, lc,
                                                   method="cg", device=d)]
        return [host(r) for r in res]

    card = stage("transforms_64_card", lambda: every_transform(dev))
    cpu = stage("transforms_64_cpu", lambda: every_transform("cpu"))
    card_cpu = max(rel(a, b) for a, b in zip(card, cpu))
    check(card_cpu < FS_CPU_TOL, f"nside 64 card vs CPU {card_cpu}")
    out["card_vs_cpu_64"] = {"transforms": len(card), "max_rel": card_cpu}

    # ---- (d) full-sky MASTER at nside 512, lmax 1024
    nm, lm = FS_MASTER_NSIDE, FS_MASTER_LMAX
    mask = stage("master_mask", lambda: _galactic_mask(nm, dev, rng))
    fsky = float(mask.mean())
    w2 = float((mask ** 2).mean())
    wl = stage("master_mask_cl", lambda: sht_large.anafast_large(
        mask, min(2 * lm, 2 * nm)))
    M = stage("master_coupling", lambda: sht.coupling_matrix_from_mask_cl(
        host(wl), lm))
    M_s = stage("master_coupling_spin2", lambda: sht_spin
                .spin2_coupling_matrices_from_mask_cl(host(wl), lm))
    B = sht._bin_operator(lm, FS_MASTER_NBINS, lmin=2)
    em = ell[: lm + 1]
    # (b)'s spectrum without its monopole and dipole, which the mask would
    # couple into every band below the bins' lmin = 2 (the JAX package's
    # MASTER tests zero them too)
    cl_m = np.where(em >= 2, cl_in[: lm + 1], 0.0)
    c_in_b = B @ cl_m

    def band_sigma(n_maps):
        """The Gaussian error of a band power (a flat band average of C_l)
        over n_maps realizations: each multipole's 2 C_l^2 / ((2l + 1)
        f_sky) through the binning (for a steep spectrum a band's lowest
        multipoles carry most of it)."""
        var_l = 2.0 * cl_m ** 2 / ((2.0 * em + 1.0) * fsky)
        return np.sqrt((B ** 2) @ var_l / n_maps)


    _, Qs, _ = sht._binned_shape_ops(lm, FS_MASTER_NBINS, 2)
    Mb = B @ M @ Qs
    Mb_s = np.block([[B @ M_s[0] @ Qs, B @ M_s[1] @ Qs],
                     [B @ M_s[1] @ Qs, B @ M_s[0] @ Qs]])

    def master_maps():
        """Each map's pseudo-Cl and unmasked C_l; MASTER and <w^2> of
        their mean (both linear in the pseudo-Cl), and anafast_master /
        anafast_masked themselves on the first map against the same."""
        pcl, truth, first = [], [], None
        for i in range(FS_MASTER_MAPS):
            m = sht_large.synfast_large(gen, cl_m, nm, lm)
            pcl.append(host(sht_large.anafast_large(m * mask, lm)))
            truth.append(B @ host(sht_large.anafast_large(m, lm,
                                                          niter=0)))
            if first is None:
                first = (host(m), host(sht.anafast_master(
                    m, mask, lm, nbins=FS_MASTER_NBINS, coupling=M)[1]),
                    host(sht.anafast_masked(m, mask, lm)))
        pcl = np.array(pcl, np.float64)
        ms = np.linalg.solve(Mb, (B @ pcl.T)).T
        check(rel(first[1], ms[0]) < FS_REPEAT_TOL
              and rel(first[2], pcl[0] / w2) < FS_REPEAT_TOL,
              f"anafast_master / anafast_masked against the pseudo-Cl's "
              f"solve: {rel(first[1], ms[0])}, {rel(first[2], pcl[0] / w2)}")
        return ms, (B @ pcl.T).T / w2, np.array(truth), first[0]

    ms, w2s, truth, map0 = stage("master_scalar_maps", master_maps)
    pull_s = (ms.mean(0) - c_in_b) / band_sigma(len(ms))
    t_b = truth.mean(0)
    err_s = np.abs(ms.mean(0) / t_b - 1.0)
    w2_bias = np.abs(w2s.mean(0) / t_b - 1.0)
    check(bool(np.all(np.abs(pull_s) < FS_MASTER_PULL)),
          f"scalar MASTER pulls {np.abs(pull_s).max():.2f} sigma")
    check(err_s.max() < 0.5 * w2_bias.max(),
          f"scalar MASTER worst band {err_s.max():.4f} against half the "
          f"<w^2> bias {w2_bias.max():.4f}")
    zeros = np.zeros(lm + 1)

    def master_spin2():
        """As master_maps for E-only spin-2 maps: the 2x2-block solve of
        the pseudo EE / BB, anafast_spin2_master on the first map."""
        raw_ee, raw_bb, ee_t, first = [], [], [], None
        for i in range(FS_MASTER_SPIN_MAPS):
            w4 = tuple(torch.randn((lm + 1, lm + 1), generator=gen,
                                   device=dev) for _ in range(4))
            alms = sht_spin._spin2_alms_from_white(
                w4, torch.as_tensor(cl_m, dtype=torch.float32, device=dev),
                torch.as_tensor(zeros, dtype=torch.float32, device=dev), lm)
            q, u = sht_spin_large.synthesize_spin2_large(*alms, nm, lm)
            pe, pb, _ = sht_spin_large.anafast_spin2_large(q * mask,
                                                           u * mask, lm)
            raw_ee.append(B @ host(pe))
            raw_bb.append(B @ host(pb))
            ee_t.append(B @ host(sht_spin_large.anafast_spin2_large(
                q, u, lm, niter=0)[0]))
            if first is None:
                first = (host(q), host(u), [host(c) for c in
                                            sht_spin.anafast_spin2_master(
                    q, u, mask, lm, nbins=FS_MASTER_NBINS,
                    coupling=M_s)[1:]])
        raw_ee, raw_bb = np.array(raw_ee), np.array(raw_bb)
        sol = np.linalg.solve(Mb_s, np.concatenate([raw_ee, raw_bb], 1).T).T
        ee, bb = sol[:, :FS_MASTER_NBINS], sol[:, FS_MASTER_NBINS:]
        check(max(rel(first[2][0], ee[0]), rel(first[2][1], bb[0]))
              < FS_REPEAT_TOL, "anafast_spin2_master against the pseudo "
              "spectra's solve")
        return ee, bb, np.array(ee_t), raw_ee, raw_bb, first[:2]

    ee_m, bb_m, ee_t, raw_ee, raw_bb, qu0 = stage("master_spin2_maps",
                                                  master_spin2)
    pull_e = (ee_m.mean(0) - c_in_b) / band_sigma(len(ee_m))
    te_b = ee_t.mean(0)
    err_e = np.abs(ee_m.mean(0) / te_b - 1.0)
    w2_bias_e = np.abs(raw_ee.mean(0) / w2 / te_b - 1.0)
    bb_ee_m = float(bb_m.mean(0).sum() / ee_m.mean(0).sum())
    raw_bb_ee = float(raw_bb.mean(0).sum() / raw_ee.mean(0).sum())
    check(bool(np.all(np.abs(pull_e) < FS_MASTER_PULL)),
          f"spin-2 MASTER EE pulls {np.abs(pull_e).max():.2f} sigma")
    check(err_e.max() < 0.5 * w2_bias_e.max(),
          f"spin-2 MASTER EE worst band {err_e.max():.4f} against half "
          f"the <w^2> bias {w2_bias_e.max():.4f}")
    check(abs(bb_ee_m) < FS_MASTER_BB, f"spin-2 MASTER BB/EE {bb_ee_m}")

    mask_h = host(mask).astype(np.float64)
    sn = SkyNamaster.from_array(map0)
    sn.set_mask(mask_h)
    sn1 = stage("skynamaster_cl", lambda: sn.compute_cl(
        lmax=lm, nbins=FS_MASTER_NBINS))
    sn2 = stage("skynamaster_cl_cached", lambda: sn.compute_cl(
        lmax=lm, nbins=FS_MASTER_NBINS))
    sn3 = stage("skynamaster_cl_spin2", lambda: sn.compute_cl_spin2(
        *qu0, lmax=lm, nbins=FS_MASTER_NBINS))
    sn4 = stage("skynamaster_cl_spin2_cached", lambda: sn.compute_cl_spin2(
        *qu0, lmax=lm, nbins=FS_MASTER_NBINS))
    sn_err = max(rel(sn1[1], ms[0]), rel(sn2[1], sn1[1]),
                 rel(sn3[1], ee_m[0]), rel(sn4[1], sn3[1]),
                 rel(sn4[2], sn3[2]))
    check(sn_err < FS_REPEAT_TOL, f"SkyNamaster against the estimators "
          f"{sn_err}")
    out["master"] = {
        "fsky": fsky, "w2": w2, "scalar_max_pull": float(
            np.abs(pull_s).max()), "scalar_max_err": float(err_s.max()),
        "w2_bias": w2_bias.tolist(), "ee_max_pull": float(
            np.abs(pull_e).max()), "ee_max_err": float(err_e.max()),
        "ee_w2_bias": w2_bias_e.tolist(), "bb_over_ee": bb_ee_m,
        "raw_bb_over_ee": raw_bb_ee, "skynamaster_max_rel": sn_err}
    del mask, map0, qu0

    # ---- (e) the example's full-sky SHT stage and the facades
    n_ex, l_ex, fwhm_ex = FS_EXAMPLE
    ell_ex = np.arange(l_ex + 1, dtype=float)
    cl_tt = 2e-9 / np.maximum(ell_ex * (ell_ex + 1.0), 1.0)
    white_ex = tuple(torch.randn((l_ex + 1, l_ex + 1),
                                 generator=torch.Generator().manual_seed(
                                     seed + 42 + i)) for i in range(2))

    def example(d):
        cmb = sht.synfast_from_white(*(w.to(d) for w in white_ex), cl_tt,
                                     n_ex, device=d)
        cl_meas = sht.anafast(cmb, lmax=l_ex)
        smooth = sht.smoothing(cmb, fwhm_rad=fwhm_ex, lmax=l_ex)
        return [host(cmb), host(cl_meas), host(smooth)]

    ex_card = stage("example_sht", lambda: example(dev))
    ex_cpu = stage("example_sht_cpu", lambda: example("cpu"))
    ex_err = max(rel(a, b) for a, b in zip(ex_card, ex_cpu))
    check(ex_err < FS_CPU_TOL, f"example stage card vs CPU {ex_err}")
    ex_line = (int(ex_card[0].shape[0]), float(cl_tt[10]),
               float(ex_card[1][10]),
               float(ex_card[2].std() / ex_card[0].std()))
    log(f"#   full-sky CMB: npix={ex_line[0]}, Cl(10) in/out "
        f"{ex_line[1]:.2e}/{ex_line[2]:.2e}, smoothed std ratio "
        f"{ex_line[3]:.3f}")

    def healpix_facades():
        sky_a = AngularPowerSpectrum.to_skyhealpix(cl_tt, n_ex,
                                                   rnd_seed=seed)
        sky_b = SkyHealpix.from_Cl_array(cl_tt, "kappa_2", n_ex,
                                         rnd_seed=seed)
        ell_a, cl_a = AngularPowerSpectrum.from_healpix(sky_a, l_ex)
        return (sky_a, bool(torch.equal(sky_a.data["orig"],
                                        sky_b.data["orig"])),
                ell_a, cl_a, sky_a.anafast(l_ex))

    sky_a, same_sky, ell_a, cl_a, cl_direct = stage("angular_power_healpix",
                                                    healpix_facades)
    check(same_sky and sky_a.device == kmap.device
          and np.array_equal(ell_a, np.arange(l_ex + 1))
          and np.array_equal(cl_a, cl_direct),
          "AngularPowerSpectrum.to_skyhealpix / from_healpix")

    def xi_facade():
        sky_a.shear_from_kappa(lmax=l_ex)
        ce, cb, _ = sky_a.shear_eb_spectra(lmax=l_ex)
        got = sky_a.shear_xi_pm(theta, lmax=l_ex)
        return got, xi_pm_from_cl_curved(ce, theta * np.pi / 180.0 / 60.0,
                                         cl_b=cb)

    xi_got, xi_want = stage("shear_xi_pm_example", xi_facade)
    check(max(rel(a, b) for a, b in zip(xi_got, xi_want)) < FS_REPEAT_TOL,
          "SkyHealpix.shear_xi_pm against its spectra's transform")

    crng = np.random.default_rng(seed + 20)
    cols = {"the_co": np.arccos(crng.uniform(-1, 1, FS_COLUMNS)),
            "phi_co": crng.uniform(0, 2 * np.pi, FS_COLUMNS),
            "kappa_2": crng.normal(0, 0.01, FS_COLUMNS)}
    sky_c = stage("from_columns_1e7", lambda: SkyHealpix.from_columns(
        cols, "kappa_2", nside))
    empty = float((sky_c.data["orig"] == float(np.float32(-1.6375e30)))
                  .double().mean())
    expect_empty = float(np.exp(-FS_COLUMNS / (12 * nside ** 2)))
    check(sky_c.device == kmap.device
          and abs(empty - expect_empty) < 0.01,
          f"from_columns empty share {empty} against {expect_empty}")
    del sky_c, cols

    rot = (20.0, 35.0, -10.0)
    r_card = stage("rotate_256", lambda: SkyHealpix(rot_map).rotate(rot))
    r_cpu = stage("rotate_256_cpu", lambda: SkyHealpix(
        rot_map.cpu()).rotate(rot))
    rot_err = rel(r_card, r_cpu)
    check(rot_err < FS_CPU_TOL, f"rotate card vs CPU {rot_err}")
    proj = stage("to_skyarray_2048", lambda: sky.to_skyarray(
        FS_PROJ[1], FS_PROJ[0]))
    pimg = proj.data["orig"]
    check(tuple(pimg.shape) == (FS_PROJ[0],) * 2
          and pimg.device == kmap.device
          and bool(torch.isfinite(pimg).all()), "to_skyarray")
    del proj, pimg

    sky_rt = SkyHealpix(m_rt)
    fwhm = np.deg2rad(FS_BEAM_ARCMIN / 60.0)
    stage("smoothing_2048", lambda: sky_rt.smoothing(fwhm, lmax=lmax))
    c_sm = host(stage("anafast_smoothed_2048", lambda: sky_rt.anafast(
        lmax, of="orig_smooth")))
    b2 = host(sht._beam_window(fwhm, lmax, "cpu"))[:, 0].astype(
        np.float64) ** 2
    sel = (b2 > 0.1) & (e >= 2)
    beam_dev = float(np.abs(c_sm[sel] / c_rt[sel] / b2[sel] - 1.0).max())
    check(beam_dev < FS_BEAM_TOL, f"smoothing C_l ratio off b_l^2 by "
          f"{beam_dev}")
    out["facades"] = {"example_card_vs_cpu": ex_err,
                      "example_log_line": ex_line,
                      "from_columns_empty_share": empty,
                      "from_columns_expected_empty": expect_empty,
                      "rotate_card_vs_cpu": rot_err,
                      "smoothing_max_dev": beam_dev}
    del sky_rt, m_rt, rot_map

    # ---- (f) where the time goes at nside 1024, lmax 2048
    alm2 = tuple(torch.randn((lmax + 1, lmax + 1), generator=gen,
                             device=dev).tril() for _ in range(4))
    g1, g2 = sky.data["gamma1"], sky.data["gamma2"]
    profiles = {
        "synthesize_large": _sht_profile(lambda: sht_large.synthesize_large(
            alm2[0], alm2[1], nside, lmax)),
        "analyze_large_niter0": _sht_profile(
            lambda: sht_large.analyze_large(kmap, nside, lmax, niter=0)),
        "synthesize_spin2_large": _sht_profile(
            lambda: sht_spin_large.synthesize_spin2_large(*alm2, nside,
                                                          lmax)),
        "analyze_spin2_large_niter0": _sht_profile(
            lambda: sht_spin_large.analyze_spin2_large(g1, g2, nside, lmax,
                                                       niter=0))}
    for name, p in profiles.items():
        log(f"#   full_sky profile {name}: {p['seconds']:.3f} s, "
            f"{p['kernels']} CUDA kernels, device {p['device_ms']:.1f} ms, "
            f"shares " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   p["span_share"].items())
            + f", peak {p['peak_gb']:.2f} GB")
    out["profiles"] = profiles
    del alm2, g1, g2, sky, kmap

    predicted = {name: {} for name in seconds if not name.endswith("_cpu")}
    predicted["born_shells"] = {"deposit_sorted": shell_flushes}
    total = _held_launches("full_sky", predicted, {
        k: v for k, v in launches.items() if k in predicted})
    phase_s = time.perf_counter() - t_phase
    log(f"# phase full_sky: {phase_s:.1f} s; launches {total}; C_EE/C_kk "
        f"max dev {out['lensing']['ee_over_kk_max_dev']:.2e}, BB/EE "
        f"{bb_ee:.1e}; round trip max pull {out['round_trip_max_pull']:.2f}"
        f"; l > 2 nside bias CG {bias['cg']:+.4f}, Jacobi "
        f"{bias['jacobi']:+.4f}; table vs scan {synth_err:.1e} / "
        f"{ana_err:.1e}; card vs CPU {card_cpu:.1e}; MASTER worst band "
        f"{err_s.max():.4f} (<w^2> {w2_bias.max():.4f}), EE "
        f"{err_e.max():.4f}, BB/EE {bb_ee_m:.1e} (raw {raw_bb_ee:.1e}); "
        f"cached SkyNamaster {seconds['skynamaster_cl_cached']:.3f} s; "
        f"peak {max(peaks.values()):.2f} GB")
    result = {"phase_seconds": phase_s, "seconds": seconds,
              "launches": launches, "launches_total": total,
              "peak_mem_gb": peaks, **out}
    log("# full_sky " + json.dumps(result))
    return result


# ---------------------------------------------------------- CMB lensing
def _cross_cl(ar, ai, br, bi) -> np.ndarray:
    """Cross C_l of two alm sets [l, m]: (ab_l0 + 2 sum_{m>0} Re(a b*)) /
    (2l+1), float64 on the host."""
    ar, ai, br, bi = (x.double() for x in (ar, ai, br, bi))
    L = ar.shape[0] - 1
    w = torch.full((L + 1,), 2.0, dtype=torch.float64, device=ar.device)
    w[0] = 1.0
    p = torch.tril(ar * br + ai * bi) * w[None, :]
    ell = torch.arange(L + 1, dtype=torch.float64, device=ar.device)
    return (p.sum(1) / (2 * ell + 1)).cpu().numpy()


def _band_ratios(a, b, edges) -> np.ndarray:
    return _band_sums(a, edges) / _band_sums(b, edges)


def _flat_grf(gen, cl: np.ndarray, n: int, fov: float, dev):
    """A Gaussian flat patch of spectrum cl (n^2 over fov [rad]) from a
    torch generator: the JAX tests' numpy recipe on the card."""
    lf = 2 * np.pi / fov
    f = np.fft.fftfreq(n) * n * lf
    lm = np.hypot(f[:, None], f[None, :])
    amp = torch.from_numpy(np.sqrt(np.interp(
        lm, np.arange(cl.size), cl, left=0, right=0)).astype(
            np.float32)).to(dev)
    w = torch.randn((n, n), generator=gen, device=dev)
    return torch.fft.ifft2(torch.fft.fft2(w) * amp).real / (fov / n)


def _pure_e(gen, cl: np.ndarray, n: int, fov: float, dev):
    """Pure-E Stokes patches (B identically zero) of spectrum cl."""
    lf = 2 * np.pi / fov
    f = np.fft.fftfreq(n) * n * lf
    lx, ly = f[:, None], f[None, :]
    l2 = lx ** 2 + ly ** 2
    safe = np.where(l2 == 0, 1, l2)
    c2 = np.where(l2 == 0, 1, (lx ** 2 - ly ** 2) / safe)
    s2 = np.where(l2 == 0, 0, 2 * lx * ly / safe)
    amp = np.sqrt(np.interp(np.sqrt(l2), np.arange(cl.size), cl, left=0,
                            right=0))
    ek = torch.fft.fft2(torch.randn((n, n), generator=gen, device=dev)) \
        * torch.from_numpy((amp / (fov / n)).astype(np.float32)).to(dev)
    return tuple(torch.fft.ifft2(ek * torch.from_numpy(
        t.astype(np.float32)).to(dev)).real for t in (c2, s2))


def _cmb_loop_stages(dev, stage, inputs):
    """examples/cmb_lensing_loop.py at its own parameters on `dev`, each
    stage from `inputs` (the previous stage's card output where given, so
    that the CPU run compares stage by stage): (1) the Born kappa of its
    HEALPix shells, (2) the CMB of given white draws lensed by a kappa, (3)
    the flat-patch QE over 8 patches with its cross ratio, (4) the
    curved-sky QE of a lensed map."""
    from astrild_tpu_torch.models import SkyHealpix
    from astrild_tpu_torch.ops import cmb_lensing as cml
    from astrild_tpu_torch.ops import lightcone_sphere as lcs
    from astrild_tpu_torch.ops import sht

    box, nside = 400.0, 32
    lmax = 2 * nside
    out = {}

    def born():
        pos = tuple(torch.from_numpy(c).to(dev) for c in inputs["pos"])
        delta, chis, dchis = lcs.density_shells_healpix(
            pos, np.linspace(150.0, 550.0, 6), nside, box)
        return delta, lcs.born_convergence_healpix(delta, chis, dchis, 700.0,
                                                   0.31)

    out["delta"], out["kappa"] = stage("loop_born", born)
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl_tt = np.zeros(lmax + 1)
    cl_tt[2:] = 1e-10 / (ell[2:] * (ell[2:] + 1.0))

    def lens():
        cmb = sht.synfast_from_white(*inputs["white"], cl_tt, nside, lmax,
                                     device=dev)
        kap = inputs.get("kappa", out["kappa"]).to(dev)
        sky = SkyHealpix(torch.zeros_like(cmb))
        return cmb, sky.lens_cmb_from_kappa(cmb, kap, lmax=lmax)

    out["cmb"], out["lensed"] = stage("loop_lens_cmb", lens)
    n, fov, lmax_flat = 128, np.deg2rad(10.0), 2000
    ellf = np.arange(lmax_flat + 1, dtype=np.float64)
    cl_f = np.zeros(lmax_flat + 1)
    cl_f[2:] = 1e-10 / (ellf[2:] * (ellf[2:] + 1.0)) \
        * np.exp(-(ellf[2:] / 1500.0) ** 2)
    pix = fov / n
    f = np.fft.fftfreq(n) * n * 2 * np.pi / fov
    lm = np.hypot(f[:, None], f[None, :])
    band = (lm > 100) & (lm < 500)

    def flat():
        R = cml.qe_tt_response(n, fov, cl_f, lmin=40, lmax_filter=1200,
                               device=dev)
        cx = ca = 0.0
        khats = []
        for t, kap in inputs["patches"]:
            t, kap = torch.from_numpy(t).to(dev), torch.from_numpy(kap).to(
                dev)
            tl = cml.lens_cmb_map_flat(t, kap, fov)
            khat = cml.qe_tt_kappa(tl, fov, cl_f, lmin=40, lmax_filter=1200,
                                   response=R)[0].cpu().numpy()
            khats.append(np.fft.fft2(khat))
            fa = pix ** 2 * np.fft.fft2(khat)
            fb = pix ** 2 * np.fft.fft2(kap.cpu().numpy())
            cx += np.real(fa * np.conj(fb))[band].mean()
            ca += (np.abs(fb) ** 2)[band].mean()
        return np.stack(khats), cx / ca, R.cpu().numpy()

    out["khat_modes"], out["flat_ratio"], out["R"] = stage("loop_flat_qe",
                                                           flat)
    lensed = inputs.get("lensed", out["lensed"])
    out["qe"] = stage("loop_curved_qe", lambda: cml.qe_tt_kappa_healpix(
        torch.from_numpy(np.asarray(lensed, np.float32)).to(dev), cl_tt,
        lmin=8, lmax_filter=lmax, lmax_out=lmax // 2))
    return out


def _full_sky_lightcone_stage(dev, stage, pos, delta=None):
    """examples/full_pipeline.py's full-sky lightcone stage at its own
    parameters on `dev` (shells at nside 32 over 150-650 Mpc/h ->
    SkyHealpix.from_multiplane_shells -> Born -> shear E/B spectra), the
    transforms from `delta` where given."""
    from astrild_tpu_torch.models import SkyHealpix
    from astrild_tpu_torch.ops import lightcone_sphere as lcs

    nside, chi_s = 32, 700.0
    edges = np.linspace(150.0, 650.0, 6)

    def run():
        if delta is None:
            p = pos.to(dev)
            d, _, _ = lcs.density_shells_healpix(
                (p[:, 0], p[:, 1], p[:, 2]), edges, nside, 250.0)
        else:
            d = delta.to(dev)
        chis = (0.5 * (edges[1:] + edges[:-1])).astype(np.float32)
        dchis = np.diff(edges).astype(np.float32)
        sky = SkyHealpix.from_multiplane_shells(d, chis, dchis, chi_s, 0.31,
                                                lmax=2 * nside)
        born = lcs.born_convergence_healpix(d, chis, dchis, chi_s, 0.31)
        ee, bb, _ = sky.shear_eb_spectra(lmax=2 * nside)
        return {"delta": d, "kappa": sky.data["orig"],
                "omega": sky.data["omega"], "born": born, "ee": ee,
                "bb": bb}

    return stage("full_pipeline_lightcone", run)


def _spin1_card_vs_cpu(dev, gen) -> dict:
    """Every spin-1 transform at nside CL_CPU_NSIDE, lmax CL_CPU_LMAX on
    the card against the CPU from the same inputs (relative to each
    output's max), the stencil's pixel share and weights, and the
    remap."""
    from astrild_tpu_torch.ops import sht_spin, sht_spin_large
    from astrild_tpu_torch.utils import healpix_torch as hpt

    nside, lmax = CL_CPU_NSIDE, CL_CPU_LMAX
    npix = 12 * nside ** 2
    alms = tuple(torch.randn((lmax + 1, lmax + 1), generator=gen,
                             device=dev).tril() for _ in range(4))
    maps = tuple(torch.randn(npix, generator=gen, device=dev)
                 for _ in range(2))
    calls = {
        "synthesize_spin1": lambda a, m: sht_spin.synthesize_spin1(
            *a, nside, lmax),
        "analyze_spin1": lambda a, m: sht_spin.analyze_spin1(
            *m, nside, lmax, niter=3),
        "deflection_from_kappa_alm": lambda a, m:
            sht_spin.deflection_from_kappa_alm(a[0], a[1], nside, lmax),
        "kappa_omega_alm_from_deflection": lambda a, m:
            sht_spin.kappa_omega_alm_from_deflection(*m, nside, lmax),
        "synthesize_spin1_large": lambda a, m:
            sht_spin_large.synthesize_spin1_large(*a, nside, lmax),
        "analyze_spin1_large_jacobi": lambda a, m:
            sht_spin_large.analyze_spin1_large(*m, nside, lmax, niter=3,
                                               method="jacobi"),
        "analyze_spin1_large_cg": lambda a, m:
            sht_spin_large.analyze_spin1_large(*m, nside, 3 * nside - 1,
                                               niter=3, method="cg"),
        "deflection_from_kappa_alm_large": lambda a, m:
            sht_spin_large.deflection_from_kappa_alm_large(a[0], a[1],
                                                           nside, lmax),
    }
    errs = {}
    for name, fn in calls.items():
        card = fn(alms, maps)
        cpu = fn(tuple(a.cpu() for a in alms), tuple(m.cpu() for m in maps))
        errs[name] = max(float((c.cpu() - h).abs().max()
                               / max(float(h.abs().max()), 1e-30))
                         for c, h in zip(card, cpu))
    theta = torch.arccos(2 * torch.rand(1 << 20, generator=gen, device=dev)
                         - 1)
    phi = 2 * np.pi * torch.rand(1 << 20, generator=gen, device=dev)
    pix, wgt = hpt.get_interp_weights(nside, theta, phi)
    hpix, hwgt = hpt.get_interp_weights(nside, theta.cpu(), phi.cpu())
    same = (pix.cpu() == hpix).all(0)
    share = float(same.double().mean())
    w_err = float((wgt.cpu() - hwgt)[:, same].abs().max())
    a_t, a_p = (1e-3 * m for m in maps)
    hmap = maps[0]
    rc = hpt.remap_by_deflection(hmap, a_t, a_p, nside)
    rh = hpt.remap_by_deflection(hmap.cpu(), a_t.cpu(), a_p.cpu(), nside)
    remap_share = float(((rc.cpu() - rh).abs()
                         < 2e-3 * float(hmap.abs().max())).double().mean())
    return {"transforms": errs, "stencil_share": share,
            "stencil_weight_err": w_err, "remap_share": remap_share}


def phase_cmb_lensing(dev, seed: int, snapshot: list,
                      shell_flushes: int) -> dict:
    """CMB lensing at full width, each stage on the host clock,
    synchronized, with its K1-K4 launches held to its own count and its
    peak memory; the checks raise. (a) the HEALPix shells of phase 7's GR
    z=0 snapshot at nside 1024 through K1 (phase 9's flushes), then the
    snapshot freed; (b) multiplane_raytrace_healpix at nside 1024, lmax
    2048 ('auto': the scan path) for chi_s = 700 and the tomographic pair
    (450, 700): the traced kappa against the band-limited Born map (pixel
    correlation, C_l ratio in 8 log bands over 10 <= l <= 1536) and that
    gap split into the tracer's 0.02-pixel nudge (the Born map read at the
    nudged ray grid) and the post-Born rest, which at a tenth of the
    shells must keep within a tenth of the bars; omega's
    power over kappa's, the traced shear's BB/EE, the near source against
    SkyHealpix.from_multiplane_shells' own run of it, the far one against
    the scalar run, the farthest shell alone against w kap_bl (smoothed
    over 16.5': within 2% of its max; raw: within 3.7%); (c)
    SkyHealpix.lens_cmb_from_kappa of a synthesize_large CMB (C_l =
    1e-10 / (l(l+1)) exp(-(l / 1500)^2)) by (b)'s kappa: a zero
    kappa returns the map within the nudge's shift, lensed - unlensed
    against alpha . grad T from the spin-1 synthesis of g_l T_lm, the
    nudge's C_l bias against an un-nudged remap built from pix2ang_ring +
    get_interp_weights; (d) qe_tt_kappa_healpix of the lensed and the
    unlensed map (lmax_filter 2048, lmax_out 1024, 'auto': the scan path):
    the cross spectrum of their difference with the input kappa over its
    auto spectrum in 6 log bands over 30 <= L <= 1000, N0 finite and
    positive there; (e) the flat sky on 8 patches of 1024^2 over 10 deg:
    lens_cmb_map_flat, qe_tt_kappa with its response (cross ratio in 4
    bands over 100 <= L <= 1000, the unlensed auto against N0), qe_eb_kappa
    (the unlensed null, the pure-mode response); (f)
    examples/cmb_lensing_loop.py whole and full_pipeline.py's full-sky
    lightcone stage at their own parameters on the card against the port
    on the CPU, stage by stage, and at nside 64 every spin-1 transform,
    the stencil's pixel share and weights and the remap against the CPU;
    (g) one
    synthesize_spin1_large and one analyze_spin1_large(niter=0) at nside
    1024, lmax 2048 under the profiler (seconds, CUDA kernels, the shares
    of sht.legendre / sht.caps / sht.belt_fft, peak memory), and the
    tracer's split between its shells' fields and its transport on the
    host clock. The CL_* bars come from tools/cmb_lensing_jax_bars.py
    (the JAX package on the CPU at nside 128 and 256 with the same
    ratios; PERF.md). Returns the numbers printed in `# cmb_lensing`.
    """
    from astrild_tpu_torch.models import SkyHealpix
    from astrild_tpu_torch.ops import (cmb_lensing as cml, lightcone_sphere
                                       as lcs, paint_cuda, pairwise_cuda,
                                       sht, sht_large, sht_spin_large)
    from astrild_tpu_torch.ops.raytrace import effective_plane_kappa
    from astrild_tpu_torch.utils import healpix as hpx
    from astrild_tpu_torch.utils import healpix_torch as hpt

    seconds, launches, peaks, out = {}, {}, {}, {}
    run = _stage_runner(seconds, launches)

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = run(name, fn)
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        log(f"#   cmb_lensing stage {name}: {seconds[name]:.3f} s, launches "
            f"{launches[name]}, peak {peaks[name]:.2f} GB")
        return res

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"cmb_lensing: {msg}")

    def rel(got, want) -> float:
        got = got.double() if isinstance(got, torch.Tensor) else \
            torch.from_numpy(np.asarray(got, np.float64))
        want = want.double() if isinstance(want, torch.Tensor) else \
            torch.from_numpy(np.asarray(want, np.float64))
        got, want = got.cpu(), want.cpu()
        return float((got - want).abs().max()
                     / max(float(want.abs().max()), 1e-300))

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    nside, lmax = LC_NSIDE, 2 * LC_NSIDE

    # ---- (a) the shells through K1, then the snapshot freed
    pos = snapshot.pop()
    delta, chis, dchis = stage("shells", lambda: lcs.density_shells_healpix(
        pos, np.linspace(*LC_EDGES), nside, BOX))
    del pos
    check(launches["shells"] == {"deposit_sorted": shell_flushes},
          f"shells launched {launches['shells']}, expected "
          f"{shell_flushes} K1 flushes")
    check(bool(torch.isfinite(delta).all()), "shells not finite")

    # ---- (b) the multiplane tracer at nside 1024, lmax 2048
    traced = stage("multiplane_700", lambda: lcs.multiplane_raytrace_healpix(
        delta, chis, dchis, CL_CHI_S, 0.3, lmax=lmax))
    kappa = traced["kappa"]

    def born_bl():
        born = lcs.born_convergence_healpix(delta, chis, dchis, CL_CHI_S,
                                            0.3)
        br, bi = sht_large.analyze_large(born, nside, lmax, niter=0)
        return sht_large.synthesize_large(br, bi, nside, lmax)

    bl = stage("born_band_limited", born_bl)
    corr = _corr(kappa, bl)
    bands = _log_bands(*FS_ELL_RANGE, CL_BANDS)
    c_k, c_b, c_w = (sht_large.anafast_large(m, lmax, niter=0).cpu().numpy()
                     for m in (kappa, bl, traced["omega"]))
    ratio = _band_ratios(c_k, c_b, bands)
    omega_power = float(c_w[2:].sum() / c_k[2:].sum())

    def born_read():
        nudge = CL_NUDGE * math.sqrt(math.pi / 3.0) / nside
        t0, p0 = (torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                  for a in hpx.pix2ang_ring(nside, np.arange(12 * nside ** 2)))
        return hpt.get_interp_val(bl, torch.clamp(t0 + nudge, 0.0, math.pi),
                                  p0 + nudge)

    bl_read = stage("born_read_at_nudge", born_read)
    c_r = sht_large.anafast_large(bl_read, lmax, niter=0).cpu().numpy()
    weak = stage("multiplane_700_weak", lambda:
                 lcs.multiplane_raytrace_healpix(
                     CL_WEAK * delta, chis, dchis, CL_CHI_S, 0.3,
                     lmax=lmax))["kappa"]
    weak_corr = _corr(weak, bl_read)
    weak_ratio = _band_ratios(sht_large.anafast_large(
        weak, lmax, niter=0).cpu().numpy(), CL_WEAK ** 2 * c_r, bands)
    del weak
    split = {"nudge_cl_ratio_bands": _band_ratios(c_r, c_b, bands).tolist(),
             "post_born_cl_ratio_bands": _band_ratios(c_k, c_r,
                                                      bands).tolist(),
             "post_born_corr": _corr(kappa, bl_read),
             "weak_cl_ratio_bands": weak_ratio.tolist(),
             "weak_corr": weak_corr}
    del bl_read
    sky_t = SkyHealpix(kappa)
    sky_t.data["gamma1"], sky_t.data["gamma2"] = (traced["gamma1"],
                                                  traced["gamma2"])
    ee, bb, _ = stage("traced_shear_eb", lambda: sky_t.shear_eb_spectra(
        lmax=lmax, niter=0))
    bb_ee = float(bb[2:].sum() / ee[2:].sum())
    tomo = stage("multiplane_tomographic", lambda:
                 lcs.multiplane_raytrace_healpix(delta, chis, dchis,
                                                 np.array(CL_TOMO), 0.3,
                                                 lmax=lmax))
    near = stage("skyhealpix_multiplane_near", lambda:
                 SkyHealpix.from_multiplane_shells(delta, chis, dchis,
                                                   CL_TOMO[0], 0.3,
                                                   lmax=lmax))
    kmax = float(kappa.abs().max())
    near_err = float((tomo["kappa"][0] - near.data["orig"]).abs().max()
                     ) / kmax
    far_err = float((tomo["kappa"][1] - kappa).abs().max()) / kmax
    del tomo, near, sky_t

    def one_shell(shell):
        return lambda: lcs.multiplane_raytrace_healpix(
            shell[None], chis[-1:], dchis[-1:], CL_CHI_S, 0.3, lmax=lmax)

    def one_shell_err(shell, name):
        one = stage(name, one_shell(shell))
        ke = effective_plane_kappa(shell, chis[-1], dchis[-1], 1.0, 0.3)
        r, i = sht_large.analyze_large(ke, nside, lmax, niter=0)
        w_bl = (1 - chis[-1] / CL_CHI_S) * sht_large.synthesize_large(
            r, i, nside, lmax)
        return rel(one["kappa"], w_bl)

    smooth = sht_large.smoothing_large(
        delta[-1], np.deg2rad(CL_SMOOTH_ARCMIN / 60.0), lmax, niter=0)
    one_err = one_shell_err(smooth, "multiplane_one_shell")
    raw_err = one_shell_err(delta[-1], "multiplane_one_raw_shell")
    check(corr > CL_CORR, f"traced / Born-bl correlation {corr}")
    check(bool(np.all(np.abs(ratio - 1) < CL_RATIO_TOL)),
          f"traced / Born-bl C_l off by {np.abs(ratio - 1).max():.4f}")
    check(bool(np.all(np.abs(weak_ratio - 1) < CL_WEAK * CL_RATIO_TOL))
          and 1 - weak_corr < CL_WEAK * (1 - CL_CORR),
          f"at {CL_WEAK} of the shells, traced / read Born-bl {split}")
    check(omega_power < CL_OMEGA, f"omega / kappa power {omega_power}")
    check(bb_ee < CL_BB, f"traced shear BB/EE {bb_ee}")
    check(near_err <= CL_SOURCE_TOL and far_err <= CL_SOURCE_TOL,
          f"tomographic sources off their own runs by {near_err}, "
          f"{far_err}")
    check(one_err < CL_ONE_SHELL_TOL and raw_err < CL_RAW_SHELL_TOL,
          f"one shell vs w kap_bl: smoothed {one_err}, raw {raw_err}")
    out["tracer"] = {"corr_traced_born_bl": corr,
                     "cl_ratio_bands": ratio.tolist(),
                     "gap_split": split,
                     "omega_over_kappa_power": omega_power,
                     "shear_bb_over_ee": bb_ee,
                     "near_source_vs_own_run": near_err,
                     "far_source_vs_scalar_run": far_err,
                     "one_shell_vs_w_kap_bl": one_err,
                     "one_raw_shell_vs_w_kap_bl": raw_err,
                     "kappa_rms": float(kappa.double().std())}

    # ---- (c) a CMB lensed by the traced kappa
    ell = np.arange(lmax + 1, dtype=np.float64)
    cl_tt = np.zeros(lmax + 1)
    cl_tt[2:] = 1e-10 / (ell[2:] * (ell[2:] + 1.0)) \
        * np.exp(-(ell[2:] / CL_ELL_D) ** 2)
    t_re, t_im = sht._gaussian_alms(
        *(torch.randn((lmax + 1, lmax + 1), generator=gen, device=dev)
          for _ in range(2)), torch.from_numpy(cl_tt.astype(
              np.float32)).to(dev), lmax)
    cmb = stage("cmb_synthesis", lambda: sht_large.synthesize_large(
        t_re, t_im, nside, lmax))
    sky = SkyHealpix(torch.zeros_like(cmb))
    stage("lens_cmb_from_kappa", lambda: sky.lens_cmb_from_kappa(
        cmb, kappa, lmax=lmax))
    lensed = sky.data["cmb_lensed"]
    stage("lens_cmb_zero_kappa", lambda: sky.lens_cmb_from_kappa(
        cmb, torch.zeros_like(kappa), lmax=lmax))
    still = sky.data["cmb_lensed"]
    cmax = float(cmb.abs().max())
    shift = float((still - cmb.double()).abs().max()) / cmax
    del still

    def first_order():
        kr, ki = sht_large.analyze_large(kappa, nside, lmax, niter=0)
        a_t, a_p = sht_spin_large.deflection_from_kappa_alm_large(
            kr, ki, nside, lmax)
        g = torch.sqrt(torch.from_numpy(ell * (ell + 1.0)).to(dev)).to(
            torch.float32)[:, None]
        z = torch.zeros_like(t_re)
        g_t, g_p = sht_spin_large.synthesize_spin1_large(
            t_re * g, t_im * g, z, z, nside, lmax)
        return a_t, a_p, a_t.double() * g_t + a_p.double() * g_p

    a_t, a_p, first = stage("alpha_grad_t", first_order)
    diff = lensed - cmb.double()
    first_corr = _corr(diff, first)
    first_rms = float(diff.std() / first.std())
    del first, diff

    def un_nudged():
        theta, phi = hpt.pix2ang_ring(nside, torch.arange(
            12 * nside ** 2, dtype=torch.int32, device=dev))
        ts = torch.clamp(theta + a_t, 0.0, math.pi)
        ps = phi + a_p / torch.clamp_min(torch.sin(theta), 1e-6)
        pix, wgt = hpt.get_interp_weights(nside, ts, ps)
        mono = cmb.double().mean()
        flat = (cmb.double() - mono).to(torch.float32)
        return mono + (flat[pix.long()] * wgt).sum(0).double()

    un = stage("un_nudged_remap", un_nudged)
    c_n, c_u = (sht_large.anafast_large(m.float(), lmax, niter=0).cpu()
                .numpy() for m in (lensed, un))
    nudge_bias = float(np.abs(_band_ratios(c_n, c_u, bands) - 1).max())
    del un, a_t, a_p
    check(shift < CL_SHIFT_TOL, f"zero-kappa remap shift {shift}")
    check(first_corr > CL_FIRST_CORR and abs(first_rms - 1) < CL_FIRST_RMS,
          f"lensed - unlensed against alpha.grad T: corr {first_corr}, rms "
          f"ratio {first_rms}")
    check(nudge_bias < CL_NUDGE_TOL, f"nudge C_l bias {nudge_bias}")
    out["lens_cmb"] = {"zero_kappa_shift_over_max": shift,
                       "first_order_corr": first_corr,
                       "first_order_rms_ratio": first_rms,
                       "nudge_cl_bias_max": nudge_bias,
                       "imprint_over_cmb_rms": float(
                           (lensed - cmb.double()).std()
                           / cmb.double().std())}

    # ---- (d) the curved-sky TT QE
    q1 = stage("qe_healpix_lensed", lambda: cml.qe_tt_kappa_healpix(
        lensed.float(), cl_tt, lmin=2, lmax_filter=lmax,
        lmax_out=CL_QE_LMAX_OUT))
    q0 = stage("qe_healpix_unlensed", lambda: cml.qe_tt_kappa_healpix(
        cmb, cl_tt, lmin=2, lmax_filter=lmax, lmax_out=CL_QE_LMAX_OUT))
    kr_o, ki_o = sht_large.analyze_large(kappa, nside, CL_QE_LMAX_OUT,
                                         niter=0)
    qbands = _log_bands(*CL_QE_RANGE, CL_QE_BANDS)
    cx = _cross_cl(q1[0] - q0[0], q1[1] - q0[1], kr_o, ki_o)
    ca = _cross_cl(kr_o, ki_o, kr_o, ki_o)
    qe_ratio = _band_ratios(cx, ca, qbands)
    n0 = q1[2].cpu().numpy()[qbands[0]:qbands[-1]]
    check(bool(np.all(np.abs(qe_ratio - 1) < CL_QE_TOL)),
          f"curved QE cross ratio off by {np.abs(qe_ratio - 1).max():.3f}")
    check(bool(np.all(np.isfinite(n0)) and np.all(n0 > 0)), "QE N0")
    out["qe_healpix"] = {"cross_ratio_bands": qe_ratio.tolist(),
                         "n0_range": [float(n0.min()), float(n0.max())]}
    del q1, q0, lensed, sky

    # ---- (e) the flat sky on 1024^2 patches over 10 deg
    n, fov_deg, npatch = CL_FLAT
    fov = np.deg2rad(fov_deg)
    lf = 2 * np.pi / fov
    lmax_flat = 9000
    ellf = np.arange(lmax_flat + 1, dtype=np.float64)
    cl_f = np.zeros(lmax_flat + 1)
    cl_f[2:] = 1e-10 / (ellf[2:] * (ellf[2:] + 1.0)) \
        * np.exp(-(ellf[2:] / 2000.0) ** 2)
    cl_kk = np.zeros(lmax_flat + 1)
    cl_kk[2:] = 3e-7 / (1 + ellf[2:] / 300.0) ** 2
    lo, hi = CL_FLAT_BAND
    f = np.fft.fftfreq(n) * n * lf
    lm = np.hypot(f[:, None], f[None, :])
    fedges = np.linspace(100, 1000, 5)
    fidx = torch.from_numpy(np.digitize(lm.ravel(), fedges) - 1).to(dev)
    auto_band = torch.from_numpy(((lm > 4 * lf) & (lm < 18 * lf)).ravel()
                                 ).to(dev)

    def flat_tt():
        R = cml.qe_tt_response(n, fov, cl_f, lmin=lo, lmax_filter=hi,
                               device=dev)
        n0 = cml.qe_tt_n0_kappa(n, fov, cl_f, lmin=lo, lmax_filter=hi,
                                device=dev).reshape(-1)
        cx = torch.zeros(4, dtype=torch.float64, device=dev)
        ca = torch.zeros_like(cx)
        auto = 0.0
        for _ in range(npatch):
            t = _flat_grf(gen, cl_f, n, fov, dev)
            kf = _flat_grf(gen, cl_kk, n, fov, dev)
            tl = cml.lens_cmb_map_flat(t, kf, fov)
            kh = cml.qe_tt_kappa(tl, fov, cl_f, lmin=lo, lmax_filter=hi,
                                 response=R)[0]
            k0 = cml.qe_tt_kappa(t, fov, cl_f, lmin=lo, lmax_filter=hi,
                                 response=R)[0]
            fa = torch.fft.fft2(kh.double()).reshape(-1)
            fk = torch.fft.fft2(kf.double()).reshape(-1)
            for b in range(4):
                sel = fidx == b
                cx[b] += (fa[sel] * fk[sel].conj()).real.mean()
                ca[b] += (fk[sel].abs() ** 2).mean()
            p0 = (torch.fft.fft2(k0.double()).reshape(-1).abs() ** 2
                  * (fov / n) ** 4 / fov ** 2)
            auto += float(p0[auto_band].mean())
        return (cx / ca).cpu().numpy(), auto / npatch / float(
            n0[auto_band].double().mean())

    flat_ratio, auto_n0 = stage("flat_tt_qe", flat_tt)
    cl_ee = 0.4 * cl_f
    elo, ehi = CL_FLAT_EB_BAND
    x = torch.arange(n, dtype=torch.float32, device=dev) * (fov / n)
    A, L0 = 3e-3, 6 * lf
    kap_mode = (A * torch.cos(L0 * x))[:, None].expand(n, n).contiguous()

    def flat_eb():
        acc = torch.zeros((n, n), dtype=torch.float64, device=dev)
        nulls, lens_std = [], []
        for _ in range(npatch):
            q, u = _pure_e(gen, cl_ee, n, fov, dev)
            ql = cml.lens_cmb_map_flat(q, kap_mode, fov)
            ul = cml.lens_cmb_map_flat(u, kap_mode, fov)
            k1 = cml.qe_eb_kappa(ql, ul, fov, cl_ee, lmin=elo,
                                 lmax_filter=ehi)[0]
            k0 = cml.qe_eb_kappa(q, u, fov, cl_ee, lmin=elo,
                                 lmax_filter=ehi)[0]
            acc += (k1 - k0).double()
            nulls.append(float(k0.std()))
            lens_std.append(float(k1.std()))
        proj = float(2 * (acc / npatch * torch.cos(L0 * x.double())[:, None]
                          ).mean() / A)
        return float(np.mean(nulls) / np.mean(lens_std)), proj

    eb_null, eb_proj = stage("flat_eb_qe", flat_eb)
    check(bool(np.all(np.abs(flat_ratio - 1) < CL_FLAT_TOL)),
          f"flat TT cross ratio {flat_ratio}")
    check(abs(auto_n0 - 1) < CL_N0_TOL, f"flat unlensed auto / N0 {auto_n0}")
    check(eb_null < CL_EB_NULL, f"EB null / lensed {eb_null}")
    check(abs(eb_proj - 1) < CL_EB_TOL, f"EB pure-mode response {eb_proj}")
    out["flat"] = {"tt_cross_ratio_bands": flat_ratio.tolist(),
                   "tt_unlensed_auto_over_n0": auto_n0,
                   "eb_null_over_lensed": eb_null,
                   "eb_pure_mode_response": eb_proj}

    # ---- (f) the examples on the card against the CPU; nside-64 transforms
    rng = np.random.default_rng(5)
    loop_in = {"pos": tuple(rng.uniform(0, 400.0, 400_000).astype(
        np.float32) for _ in range(3)),
               "white": tuple(rng.standard_normal((65, 65)).astype(
                   np.float32) for _ in range(2))}
    lf_ex = 2 * np.pi / np.deg2rad(10.0)
    ellf = np.arange(2001, dtype=np.float64)
    cl_fe = np.zeros(2001)
    cl_fe[2:] = 1e-10 / (ellf[2:] * (ellf[2:] + 1.0)) \
        * np.exp(-(ellf[2:] / 1500.0) ** 2)
    cl_ke = np.zeros(2001)
    cl_ke[2:] = 3e-7 / (1 + ellf[2:] / 300.0) ** 2

    def grf(seed_, cl):
        w = np.random.default_rng(seed_).standard_normal((128, 128))
        f_ = np.fft.fftfreq(128) * 128 * lf_ex
        c = np.interp(np.hypot(f_[:, None], f_[None, :]), np.arange(cl.size),
                      cl, left=0, right=0)
        return (np.real(np.fft.ifft2(np.fft.fft2(w) * np.sqrt(c)))
                / (np.deg2rad(10.0) / 128)).astype(np.float32)

    loop_in["patches"] = [(grf(10 + r, cl_fe), grf(90 + r, cl_ke))
                          for r in range(8)]
    card = _cmb_loop_stages(dev, stage, loop_in)
    cpu_in = dict(loop_in, kappa=card["kappa"].cpu(),
                  lensed=card["lensed"])
    cpu_seconds = {}
    cpu = _cmb_loop_stages(torch.device("cpu"),
                           _stage_runner_cpu(cpu_seconds), cpu_in)
    # the card's float32 pixel decisions can move a particle between
    # neighbours: half the summed |delta| difference over the expected
    # count bounds the particles moved
    moved = float((card["delta"].cpu() - cpu["delta"]).abs().sum()
                  / card["delta"].numel())
    qe_scale = float(cpu["qe"][0].abs().max())
    # the flat estimator on the modes its response supports (R above 1e-3
    # of its max; the rest divide float32 roundoff by a response near 0)
    ok = cpu["R"] > 1e-3 * cpu["R"].max()
    loop_err = {
        "delta_mean_abs_diff": moved,
        "lensed": float(np.abs(card["lensed"] - cpu["lensed"]).max()
                        / np.abs(cpu["cmb"].numpy()).max()),
        "flat_khat_modes": float(
            np.abs(card["khat_modes"] - cpu["khat_modes"])[:, ok].max()
            / np.abs(cpu["khat_modes"][:, ok]).max()),
        "flat_ratio": abs(card["flat_ratio"] - cpu["flat_ratio"]),
        "curved_qe": max(float((c.cpu() - h).abs().max()) / qe_scale
                         for c, h in zip(card["qe"][:2], cpu["qe"][:2]))}
    gen_ex = torch.Generator(device=dev).manual_seed(9)
    pos_ex = _synthetic_particles(gen_ex, 64 ** 3, 250.0, dev)
    fp_card = _full_sky_lightcone_stage(dev, stage, pos_ex)
    fp_cpu = _full_sky_lightcone_stage(
        torch.device("cpu"), _stage_runner_cpu(cpu_seconds), pos_ex.cpu(),
        delta=fp_card["delta"].cpu())
    # the traced maps are differences of float32 distortions near 1: held
    # in absolute terms (4 ulp of 1), the rest relative to their max
    fp_err = {k: rel(fp_card[k], fp_cpu[k]) for k in ("born", "ee")}
    for k in ("kappa", "omega"):
        fp_err[f"{k}_abs"] = float((fp_card[k].cpu() - fp_cpu[k]).abs().max())
    fp_err["bb_over_ee_max"] = float(np.abs(np.asarray(fp_card["bb"])
                                            - np.asarray(fp_cpu["bb"])).max()
                                     / np.abs(np.asarray(fp_cpu["ee"])).max())
    spin1 = stage("spin1_card_vs_cpu", lambda: _spin1_card_vs_cpu(dev, gen))
    # a moved particle changes two pixels' delta by 1/expected: the mean
    # |delta| difference is twice the share of particles moved (<= 0.1%)
    check(moved < 2e-3, f"loop shells moved {moved}")
    check(max(v for k, v in loop_err.items() if k != "delta_mean_abs_diff")
          < CL_CPU_TOL * 5, f"cmb_lensing_loop card vs CPU {loop_err}")
    check(fp_err["kappa_abs"] < 5e-7 and fp_err["omega_abs"] < 5e-7
          and fp_err["born"] < CL_CPU_TOL and fp_err["ee"] < CL_CPU_TOL * 5
          and fp_err["bb_over_ee_max"] < CL_CPU_TOL * 5,
          f"full_pipeline lightcone card vs CPU {fp_err}")
    check(max(spin1["transforms"].values()) < CL_CPU_TOL,
          f"spin-1 transforms card vs CPU {spin1['transforms']}")
    check(spin1["stencil_share"] >= CL_STENCIL_SHARE
          and spin1["stencil_weight_err"] < CL_STENCIL_WEIGHT_TOL
          and spin1["remap_share"] >= CL_STENCIL_SHARE,
          f"stencil / remap card vs CPU {spin1}")
    out["card_vs_cpu"] = {"cmb_lensing_loop": loop_err,
                          "full_pipeline_lightcone": fp_err,
                          "spin1_nside64": spin1,
                          "cpu_seconds": cpu_seconds,
                          "loop_flat_ratio": card["flat_ratio"]}
    del card, cpu, fp_card, fp_cpu

    # ---- (g) where the time goes at nside 1024, lmax 2048
    alm2 = tuple(torch.randn((lmax + 1, lmax + 1), generator=gen,
                             device=dev).tril() for _ in range(4))
    g_t, g_p = traced["gamma1"], traced["gamma2"]
    profiles = {
        "synthesize_spin1_large": _sht_profile(
            lambda: sht_spin_large.synthesize_spin1_large(*alm2, nside,
                                                          lmax)),
        "analyze_spin1_large_niter0": _sht_profile(
            lambda: sht_spin_large.analyze_spin1_large(g_t, g_p, nside, lmax,
                                                       niter=0)),
    }
    for name, p in profiles.items():
        log(f"#   cmb_lensing profile {name}: {p['seconds']:.3f} s, "
            f"{p['kernels']} CUDA kernels, device {p['device_ms']:.1f} ms, "
            f"shares " + ", ".join(f"{k} {v:.3f}" for k, v in
                                   p["span_share"].items())
            + f", peak {p['peak_gb']:.2f} GB")
    # the tracer's split for one shell (both halves are linear in the
    # shells) on the host clock, synchronized: the shell's fields (one
    # analysis and three syntheses) and the ray transport
    kaps = effective_plane_kappa(smooth[None], chis[-1:, None],
                                 dchis[-1:, None], 1.0, 0.3)
    tabs, _ = lcs._multiplane_tabs(nside, lmax, "scan", dev)
    t_pix = hpt.pix2ang_ring(nside, torch.arange(
        12 * nside ** 2, dtype=torch.int32, device=dev))
    # one untimed run first: the recursions' CUDA graphs of this shape may
    # have left the graph cache since the tracer ran, and a capture runs
    # the steps eagerly
    lcs._plane_fields_healpix_scan(kaps, tabs, nside, lmax)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fields = lcs._plane_fields_healpix_scan(kaps, tabs, nside, lmax)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lcs._trace_multiplane(fields, chis[-1:], chis.new_tensor(CL_CHI_S),
                          *t_pix, nside)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    profiles["multiplane_split_one_shell"] = {
        "fields_s": t1 - t0, "transport_s": t2 - t1,
        "fields_share": (t1 - t0) / (t2 - t0)}
    log(f"#   cmb_lensing profile multiplane_split_one_shell: fields "
        f"{t1 - t0:.3f} s, transport {t2 - t1:.3f} s")
    out["profiles"] = profiles
    del alm2, g_t, g_p, traced, kappa, delta, smooth, kaps, fields, t_pix

    # K1 deposits the phase's shells in phase 9's flushes, and the two
    # examples' shells in one flush each (all their images' keys fit the
    # card's room at once)
    predicted = {name: {} for name in seconds}
    predicted["shells"] = {"deposit_sorted": shell_flushes}
    predicted["loop_born"] = {"deposit_sorted": 1}
    predicted["full_pipeline_lightcone"] = {"deposit_sorted": 1}
    total = _held_launches("cmb_lensing", predicted, launches)
    phase_s = time.perf_counter() - t_phase
    log(f"# phase cmb_lensing: {phase_s:.1f} s; launches {total}; traced / "
        f"Born-bl corr {corr:.5f}, C_l max dev "
        f"{np.abs(ratio - 1).max():.4f}; omega/kappa {omega_power:.1e}; "
        f"BB/EE {bb_ee:.1e}; one shell {one_err:.1e}; zero-kappa shift "
        f"{shift:.1e}; first order corr {first_corr:.4f} rms "
        f"{first_rms:.4f}; nudge bias {nudge_bias:.1e}; curved QE max dev "
        f"{np.abs(qe_ratio - 1).max():.3f}; flat TT max dev "
        f"{np.abs(flat_ratio - 1).max():.3f}, auto/N0 {auto_n0:.3f}, EB "
        f"null {eb_null:.1e} response {eb_proj:.3f}; peak "
        f"{max(peaks.values()):.2f} GB")
    result = {"phase_seconds": phase_s, "seconds": seconds,
              "launches": launches, "launches_total": total,
              "peak_mem_gb": peaks, **out}
    log("# cmb_lensing " + json.dumps(result))
    return result


class _Interrupted(Exception):
    """The simulated crash of phase 20's checkpoint runs."""


def _periodic_gap(a, b, box: float) -> tuple[float, float]:
    """(max, mean) periodic distance between two position components."""
    d = (a - b).abs()
    d = torch.minimum(d, box - d)
    return float(d.max()), float(d.double().mean())


def _checkpoint_spy(ckpt, stats: dict):
    """Replace ckpt.save_state / restore_state by timed versions (host
    clock, synchronized; the npz's bytes after each save); a save raises
    _Interrupted after writing while stats["arm"] is set (once). Returns
    the originals, to be put back."""
    real = (ckpt.save_state, ckpt.restore_state)

    def save(path, state, step=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real[0](path, state, step=step)
        stats["save_s"].append(time.perf_counter() - t0)
        stats["bytes"].append((Path(path) / "state.npz").stat().st_size)
        if stats["arm"]:
            stats["arm"] = False
            raise _Interrupted(f"after the save of step {step}")

    def restore(path, template, with_step=False):
        t0 = time.perf_counter()
        out = real[1](path, template, with_step=with_step)
        torch.cuda.synchronize()
        stats["restore_s"].append(time.perf_counter() - t0)
        return out

    ckpt.save_state, ckpt.restore_state = save, restore
    return real


def _pair(v) -> str:
    return f"{v[0]:.1e} / {v[1]:.1e}"


def _adjoint_timing(pf, ngrid: int, box: float, gen) -> dict:
    """K2's adjoint of pf (CIC, unit weights) onto ngrid^3 against its plain
    version (autograd through paint_windowed_reference), in turns, on a
    normal gradient grid, raising if the two differ by more than
    K2_ADJ_TOL of the max; the byte bound of the function (positions read,
    position gradient written: 24 B a particle, the grid read once: 4 B a
    cell), and the bound with the kernel's 8 cell reads a particle."""
    from astrild_tpu_torch.ops import paint_cuda

    g = torch.randn((ngrid,) * 3, generator=gen, device=pf.device)
    fns = {
        "kernel": lambda: paint_cuda.paint_windowed_adjoint(pf, None, g,
                                                            ngrid, box, 2),
        "plain": lambda: paint_cuda.paint_windowed_adjoint_reference(
            pf, None, g, ngrid, box, 2),
    }
    got, want = fns["kernel"]()[0], fns["plain"]()[0]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    del got, want
    if err > K2_ADJ_TOL * scale:
        raise AssertionError(f"K2's adjoint at {pf.shape[0] // 3} "
                             f"particles onto {ngrid}^3 is off its plain "
                             f"version by {err} > {K2_ADJ_TOL} * {scale}")
    reps = {"kernel": 10, "plain": 3}
    ms = {k: [] for k in fns}
    for turn in (["plain", "kernel"], ["kernel", "plain"]):
        for name in turn:
            ms[name].append(_event_ms(fns[name], reps[name]))
    n = pf.shape[0] // 3
    bound = bound_ms(24 * n + 4 * ngrid ** 3, K2_ADJ_OPS[2] * n)
    return {"n": n, "ngrid": ngrid, "order": 2, "weighted": False,
            "max_abs_err": err, "rel_err": err / scale,
            "mean": {k: sum(v) / len(v) for k, v in ms.items()}, "turns": ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "bound_cell_reads_ms": bound_ms(24 * n + 4 * 8 * n, 0)[0]}


def phase_field_inference(dev, seed: int) -> dict:
    """Field-level inference through the PM simulator and the
    checkpointed N-body, each stage on the host clock, synchronized, with
    its K1-K4 and adjoint launches held to its own count and its peak
    memory; the checks raise. (a) examples/field_level_inference.py at its
    own size: 32^3 in 400 Mpc/h, 4 KDK steps from z = 9, mock data with
    noise variance 1e-2, Adam 200 iterations at lr 0.1 from the prior mean
    and 200 at 0.02 warm-started (the example's 400 and 400, cut in depth
    to keep the script inside its time limit: launch-bound at 32^3, they
    took 80 s on a slow host), HMC 24 + 24 samples of 6 leapfrogs from
    the MAP: the recovered linear field's correlation with the truth's
    (above the prior mean's 0), its four band correlations, the chain's
    high-k / low-k width ratio (above 1: the data pin the low-k modes) and
    accept rate (above 0); the same port on the CPU for 12 Adam iterations
    at lr 0.02 from a prior draw (the prior mean puts the particles on the
    CIC kinks, where the gradient's side is a rounding decision) against
    the card's: the first loss (the same start) within FI_CPU_TOL, the
    rest within FI_GAP_FACTOR of the CPU's own gap from a start moved by
    1e-7 (Adam's first step is near sign(g), so coordinates whose gradient
    is near 0 take either sign, and a trajectory through the kinks parts
    by float32 rounding: at lr 0.1 a 1e-7 nudge grows to 3.2% in 20
    iterations, at 0.02 to 1e-4, tools/field_sensitivity.py); (b) full
    width: 256^3
    particles on a 256^3 mesh in 500 Mpc/h, 10 steps: one value and
    gradient of field_nll through K2 and its adjoint (nsteps + 2 K2 and
    nsteps + 1 adjoint launches: the last force only kicks the momenta,
    which the density does not read); the same at 4 steps against the
    scatter route (whose autograd keeps its 8 offsets' keys and weights a
    paint, and at 10 steps needs more than the card's 80 GB): the gap,
    relative to the max and to the mean, within FI_GRAD_TOL (the kinks:
    two routes' float32 positions differ by rounding, which the gradient
    amplifies), printed beside the scatter route's own gap from a start
    moved by 1e-7 and K2's against itself; K2's against the scatter route
    with its positions divided by a card tensor h (as K2 divides) within
    FI_GRAD_DIV_TOL; two broken gradients that fail both routes' bars (the
    force paints detached, the fault this slice repairs, and the adjoint's
    position gradient scaled by 1 + FI_CTL_SCALE); CUDA kernels and ms a
    gradient; 50 Adam iterations, whose loss must fall; peak memory;
    (c) pm_evolve_checkpointed on phase 7's GR ICs at the pm_catalog
    defaults (512^3, 20 steps, segments of 8), stopped by a save that
    raises after its first write and resumed: positions (periodic) within
    FI_GAP_FACTOR times the gap of two plain pm_evolve runs (K2's float
    atomics), P(k) within FI_PK_TOL; the save and restore seconds and the
    checkpoint's bytes, under build/ and removed after; (d)
    pm_lightcone_planes(ckpt_dir=, ckpt_every=4) at a depth cut (256^3
    particles, 8 planes of 1024^2) stopped after its first save and
    resumed, against
    the same call without ckpt_dir by the same rule; the generator left in
    its entry state; another schedule refused. Then K2's adjoint at (b)'s
    shape against its plain version, outside the counts. Returns the
    numbers printed in `# field_inference`."""
    from astrild_tpu_torch.core import checkpoint as ckpt
    from astrild_tpu_torch.ops import (field_infer, linear_power, mocks,
                                       nbody, paint_cuda, pairwise_cuda,
                                       power)
    from astrild_tpu_torch.ops.paint import paint
    from astrild_tpu_torch.utils.cosmology import Cosmology

    seconds, launches, peaks, out = {}, {}, {}, {}
    run = _stage_runner(seconds, launches)

    def stage(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = run(name, fn)
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        log(f"#   field_inference stage {name}: {seconds[name]:.3f} s, "
            f"launches {launches[name]}, peak {peaks[name]:.2f} GB")
        return res

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"field_inference: {msg}")

    def corr(a, b) -> float:
        return float(np.corrcoef(a, b)[0, 1])

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()
    predicted = {}

    # a gradient paints nsteps + 1 force grids and the density, and runs
    # the adjoint of all but the last force paint: that force's kick moves
    # only the momenta, which the density does not read, so autograd
    # skips its backward
    def per_grad(nsteps: int, grads: int) -> dict:
        return {"paint_windowed": grads * (nsteps + 2),
                "paint_windowed_adjoint": grads * (nsteps + 1)}

    # ---- (a) examples/field_level_inference.py at its own size
    n, box, nsteps, z_init, noise = FI_EX
    kw = dict(z_init=z_init, nsteps=nsteps, window="cic")
    cosmo = Cosmology(Om0=0.3089, h=0.6774, sigma8=0.8159)
    amp = linear_power.normalization(cosmo)

    def pk(k):
        return linear_power.linear_power(torch.clamp_min(k, 1e-4), cosmo,
                                         0.0, amplitude=amp)

    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    truth = torch.randn((n,) * 3, generator=gen, device=dev)

    def mock_data():
        d = field_infer.simulate_density(truth, pk, cosmo, ngrid=n,
                                         boxsize=box, **kw)
        return d + math.sqrt(noise) * torch.randn(
            d.shape, generator=gen, device=dev)

    data = stage("example_data", mock_data)
    predicted["example_data"] = {"paint_windowed": nsteps + 2}

    def adam():
        first = field_infer.infer_initial_field(
            data, noise, pk, cosmo, boxsize=box, n_iter=FI_ADAM[0][0],
            lr=FI_ADAM[0][1], **kw)
        return first, field_infer.infer_initial_field(
            data, noise, pk, cosmo, boxsize=box, n_iter=FI_ADAM[1][0],
            lr=FI_ADAM[1][1], white0=first["white"], **kw)

    first, res = stage("example_adam", adam)
    predicted["example_adam"] = per_grad(nsteps, sum(i for i, _ in FI_ADAM))

    def lin_field(w):
        dk = mocks.modes_from_white(w, n, box, pk)
        return torch.fft.ifftn(dk).real.double().cpu().numpy().ravel()

    lin_truth = lin_field(truth)
    r_first, r = corr(lin_field(first["white"]), lin_truth), corr(
        lin_field(res["white"]), lin_truth)
    # the prior mean's linear field is zero: it carries no correlation
    check(r > 0.0, f"the recovered field's r = {r} does not improve on "
          "the prior mean's 0")
    losses = res["loss"].cpu().numpy()
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"the final Adam stage's loss {losses[0]} -> {losses[-1]}")
    dk_r = np.fft.fftn(res["white"].cpu().numpy())
    dk_t = np.fft.fftn(truth.cpu().numpy())
    f = np.fft.fftfreq(n) * n
    m = np.sqrt(f[:, None, None] ** 2 + f[None, :, None] ** 2
                + f[None, None, :] ** 2)
    bands = []
    for lo, hi in FI_BANDS:
        sel = (m >= lo) & (m < hi)
        num = np.real(np.sum(dk_r[sel] * np.conj(dk_t[sel])))
        bands.append(float(num / np.sqrt(np.sum(np.abs(dk_r[sel]) ** 2)
                                         * np.sum(np.abs(dk_t[sel]) ** 2))))

    samples, acc = stage("example_hmc", lambda: field_infer.sample_initial_field(
        torch.Generator(device=dev).manual_seed(seed + 21), data, noise, pk,
        cosmo, boxsize=box, n_samples=FI_HMC[0], n_warmup=FI_HMC[1],
        n_leapfrog=FI_HMC[2], white0=res["white"], **kw))
    predicted["example_hmc"] = per_grad(
        nsteps, 1 + (FI_HMC[0] + FI_HMC[1]) * FI_HMC[2])
    check(tuple(samples.shape) == (FI_HMC[0], n, n, n)
          and bool(torch.isfinite(samples).all()) and 0.0 < acc <= 1.0,
          f"HMC samples {tuple(samples.shape)}, accept {acc}")
    dks = np.fft.fftn(samples.cpu().numpy(), axes=(1, 2, 3))
    sd_rel = dks.real.std(axis=0) / np.sqrt(n ** 3 / 2.0)
    lowk = float(sd_rel[(m > 0) & (m < 4)].mean())
    highk = float(sd_rel[m > 12].mean())
    check(highk > lowk, f"the chain's high-k width {highk} is not above "
          f"its low-k width {lowk}")
    del samples, dks

    # the same port on the CPU from a prior draw, at the second stage's
    # rate, and again from that draw moved by 1e-7 of itself: the
    # trajectory's own sensitivity to float32 rounding, which bounds the
    # card's gap
    w_start = torch.randn((n,) * 3, generator=torch.Generator().manual_seed(
        seed + 22))
    nudged = w_start * (1.0 + 1e-7 * torch.randn(
        (n,) * 3, generator=torch.Generator().manual_seed(seed + 25)))

    def adam_cpu(w):
        return field_infer.infer_initial_field(
            data.cpu(), noise, pk, cosmo, boxsize=box, n_iter=FI_CPU_ITERS,
            lr=FI_ADAM[1][1], white0=w, **kw)["loss"].double()

    l_cpu = stage("example_cpu", lambda: adam_cpu(w_start))
    l_nudged = stage("example_cpu_nudged", lambda: adam_cpu(nudged))
    predicted["example_cpu"] = predicted["example_cpu_nudged"] = {}
    l_card = stage("example_card", lambda: field_infer.infer_initial_field(
        data, noise, pk, cosmo, boxsize=box, n_iter=FI_CPU_ITERS,
        lr=FI_ADAM[1][1], white0=w_start.to(dev), **kw)["loss"])
    predicted["example_card"] = per_grad(nsteps, FI_CPU_ITERS)
    card_rel = ((l_card.double().cpu() - l_cpu).abs() / l_cpu.abs()).numpy()
    self_rel = ((l_nudged - l_cpu).abs() / l_cpu.abs()).numpy()
    check(card_rel[0] <= FI_CPU_TOL
          and card_rel.max() <= FI_GAP_FACTOR * self_rel.max() + FI_CPU_TOL,
          f"the card's Adam losses {card_rel.tolist()} off the CPU's "
          f"(the CPU's own from a start moved by 1e-7: "
          f"{self_rel.tolist()})")
    out["example"] = {
        "r_first_stage": r_first, "r": r, "band_corr": bands,
        "loss_first_stage": [float(first["loss"][0]),
                             float(first["loss"][-1])],
        "loss_final_stage": [float(losses[0]), float(losses[-1])],
        "hmc_accept": acc, "width_low_k": lowk, "width_high_k": highk,
        "width_ratio": highk / lowk, "cpu_loss_rel": card_rel.tolist(),
        "cpu_nudged_loss_rel": self_rel.tolist(),
        "adam_ms_per_iteration": seconds["example_adam"]
        / sum(i for i, _ in FI_ADAM) * 1e3,
        "hmc_ms_per_gradient": seconds["example_hmc"] / (
            1 + (FI_HMC[0] + FI_HMC[1]) * FI_HMC[2]) * 1e3}
    del data, truth, first, res

    # ---- (b) full width
    n2, box2, nsteps2, noise2 = FI_FULL
    kw2 = dict(z_init=Z_INIT, nsteps=nsteps2, window="cic")
    gr = Cosmology(Om0=0.3, h=0.7)
    amp_gr = linear_power.normalization(gr)

    def pk_gr(k):
        return linear_power.linear_power(k, gr, 0.0, amplitude=amp_gr)

    gen2 = torch.Generator(device=dev).manual_seed(seed + 23)
    truth2 = torch.randn((n2,) * 3, generator=gen2, device=dev)

    def full_data():
        with torch.no_grad():
            d = field_infer.simulate_density(truth2, pk_gr, gr, ngrid=n2,
                                             boxsize=box2, **kw2)
        return d + math.sqrt(noise2) * torch.randn(
            d.shape, generator=gen2, device=dev)

    data2 = stage("full_data", full_data)
    predicted["full_data"] = {"paint_windowed": nsteps2 + 2}
    # off the lattice (see (a)): the gradients of both routes take the
    # same side of every kink
    w0 = 0.7 * truth2 + 0.3 * torch.randn((n2,) * 3, generator=gen2,
                                          device=dev)

    def value_and_grad(deposit, steps=nsteps2, start=None):
        w = (w0 if start is None else start).clone().requires_grad_(True)
        loss = field_infer.field_nll(w, data2, noise2, pk_gr, gr,
                                     boxsize=box2, deposit=deposit,
                                     **{**kw2, "nsteps": steps})
        (g,) = torch.autograd.grad(loss, w)
        return float(loss.detach()), g

    loss_k = stage("full_grad_kernel", lambda: value_and_grad(None))[0]
    predicted["full_grad_kernel"] = per_grad(nsteps2, 1)
    # the scatter route's autograd keeps each paint's 8 offsets' keys and
    # weights: at 10 steps its gradient needs more than the card's 80 GB,
    # so the two routes are held against each other at FI_CMP_STEPS
    loss_k4, g_k = stage("full_cmp_kernel",
                         lambda: value_and_grad(None, FI_CMP_STEPS))
    predicted["full_cmp_kernel"] = per_grad(FI_CMP_STEPS, 1)
    loss_s, g_s = stage("full_cmp_scatter",
                        lambda: value_and_grad("scatter", FI_CMP_STEPS))
    predicted["full_cmp_scatter"] = {}
    # the gradient's own sensitivity to float32 rounding, printed beside
    # the bar: through the CIC kinks of 6 paints and gathers of 2^24
    # particles whose positions differ by rounding between any two runs,
    # the gradient parts by 5.3e-4 of its max already at 64^3 on the CPU
    # (tools/field_sensitivity.py --part gradient).
    # Two references: the scatter route from a start moved by 1e-7 of
    # itself, and K2 again (its float atomics sum each cell in another
    # order). The two routes differ by more: the scatter painter
    # multiplies by 1/h where K2 divides, an ulp in every fraction of
    # every paint
    nudged = w0 * (1.0 + 1e-7 * torch.randn((n2,) * 3, generator=gen2,
                                            device=dev))
    _, g_n = stage("full_cmp_scatter_nudged", lambda: value_and_grad(
        "scatter", FI_CMP_STEPS, nudged))
    predicted["full_cmp_scatter_nudged"] = {}
    _, g_k2 = stage("full_cmp_kernel_again",
                    lambda: value_and_grad(None, FI_CMP_STEPS))
    predicted["full_cmp_kernel_again"] = per_grad(FI_CMP_STEPS, 1)

    def grad_gap(a, b):
        d = (a - b).abs()
        return (float(d.max() / b.abs().max()),
                float(d.double().mean() / b.abs().double().mean()))

    grad_rel = grad_gap(g_k, g_s)
    out_cmp = {"scatter_nudged": grad_gap(g_n, g_s),
               "kernel_again": grad_gap(g_k2, g_k)}
    loss_rel = abs(loss_k4 - loss_s) / abs(loss_s)
    check(all(k <= tol for k, tol in zip(grad_rel, FI_GRAD_TOL))
          and loss_rel <= 1e-5,
          f"K2's gradient {grad_rel} (max, mean) off the scatter route's "
          f"(bars {FI_GRAD_TOL}; the scatter route's own from a start "
          f"moved by 1e-7 and K2's against itself: {out_cmp}), loss "
          f"{loss_rel}")
    # the bar has to fail a broken adjoint: (1) the fault this slice
    # repairs, the force paints' gradient dropped (each force paint
    # detached, the density paint's kept); (2) the adjoint's position
    # gradient scaled by 1 + FI_CTL_SCALE in every paint. And the routes'
    # gap itself: the scatter route with its positions divided by h as a
    # card tensor, as K2 divides, where a Python float h turns PyTorch's
    # CUDA division into a multiply by its float32 reciprocal
    from astrild_tpu_torch.ops import paint as paint_mod

    def with_patch(obj, name, value, fn):
        real = getattr(obj, name)
        setattr(obj, name, value)
        try:
            return fn()
        finally:
            setattr(obj, name, real)

    _, g_c1 = stage("full_ctl_force_detached", lambda: with_patch(
        nbody, "paint", lambda *a, **k: paint(*a, **k).detach(),
        lambda: value_and_grad(None, FI_CMP_STEPS)))
    predicted["full_ctl_force_detached"] = {
        "paint_windowed": FI_CMP_STEPS + 2, "paint_windowed_adjoint": 1}
    adjoint = paint_cuda._launch_adjoint

    def scaled_adjoint(*a, **k):
        gp, gw = adjoint(*a, **k)
        return (None if gp is None else gp * (1.0 + FI_CTL_SCALE)), gw

    _, g_c2 = stage("full_ctl_adjoint_scaled", lambda: with_patch(
        paint_cuda, "_launch_adjoint", scaled_adjoint,
        lambda: value_and_grad(None, FI_CMP_STEPS)))
    predicted["full_ctl_adjoint_scaled"] = per_grad(FI_CMP_STEPS, 1)
    cic = paint_mod.paint_cic
    _, g_d = stage("full_cmp_scatter_dividing", lambda: with_patch(
        paint_mod, "_PAINTERS", {**paint_mod._PAINTERS, "cic": (
            lambda pos, ngrid, box, w=None: cic(
                pos, ngrid, torch.tensor(float(box), device=pos.device), w))},
        lambda: value_and_grad("scatter", FI_CMP_STEPS)))
    predicted["full_cmp_scatter_dividing"] = {}
    out_cmp["scatter_dividing"] = grad_gap(g_k, g_d)
    check(all(k <= tol for k, tol in zip(out_cmp["scatter_dividing"],
                                         FI_GRAD_DIV_TOL)),
          f"K2's gradient {out_cmp['scatter_dividing']} (max, mean) off the "
          f"scatter route's that divides by h (bars {FI_GRAD_DIV_TOL})")
    # each broken gradient against each route, under that route's bars
    controls = {}
    for name, g_c in (("force_detached", g_c1), ("adjoint_scaled", g_c2)):
        for route, ref, tol in (("scatter", g_s, FI_GRAD_TOL),
                                ("scatter_dividing", g_d, FI_GRAD_DIV_TOL)):
            gap = controls[f"{name}_vs_{route}"] = grad_gap(g_c, ref)
            check(any(a > t for a, t in zip(gap, tol)),
                  f"the broken gradient {name} passes the bars {tol} "
                  f"against the {route} route: {gap}")
    del g_k, g_s, g_n, g_k2, nudged, g_c1, g_c2, g_d
    _, kernels_per_grad = stage("full_grad_profile", lambda: _kernel_launches(
        lambda: value_and_grad(None)))
    predicted["full_grad_profile"] = per_grad(nsteps2, 1)
    stage("full_grad_timing", lambda: [value_and_grad(None)
                                       for _ in range(3)])
    predicted["full_grad_timing"] = per_grad(nsteps2, 3)
    full = stage("full_adam", lambda: field_infer.infer_initial_field(
        data2, noise2, pk_gr, gr, boxsize=box2, n_iter=FI_FULL_ADAM[0],
        lr=FI_FULL_ADAM[1], white0=w0, **kw2))
    predicted["full_adam"] = per_grad(nsteps2, FI_FULL_ADAM[0])
    full_loss = full["loss"].cpu().numpy()
    check(bool(np.isfinite(full_loss).all())
          and full_loss[-1] < full_loss[0],
          f"the full-width Adam loss {full_loss[0]} -> {full_loss[-1]}")
    out["full"] = {
        "particles": n2 ** 3, "ngrid": n2, "nsteps": nsteps2,
        "grad_rel_err_vs_scatter": grad_rel,
        "grad_rel_references": out_cmp, "grad_rel_controls": controls,
        "control_scale": FI_CTL_SCALE, "loss_rel_vs_scatter": loss_rel,
        "loss": loss_k, "cuda_kernels_per_gradient": kernels_per_grad,
        "ms_per_gradient": seconds["full_grad_timing"] / 3 * 1e3,
        "compare_nsteps": FI_CMP_STEPS,
        "ms_per_gradient_compare": {
            "kernel": seconds["full_cmp_kernel"] * 1e3,
            "scatter": seconds["full_cmp_scatter"] * 1e3},
        "peak_gb_compare": {"kernel": peaks["full_cmp_kernel"],
                            "scatter": peaks["full_cmp_scatter"]},
        "adam_ms_per_iteration": seconds["full_adam"] / FI_FULL_ADAM[0] * 1e3,
        "adam_loss": [float(full_loss[0]), float(full_loss[9]),
                      float(full_loss[-1])],
        "peak_gb_gradient": peaks["full_grad_kernel"],
        "peak_gb_adam": peaks["full_adam"]}
    del data2, w0, full
    torch.cuda.empty_cache()

    # ---- (c) pm_evolve_checkpointed on phase 7's GR ICs
    stats = {"save_s": [], "restore_s": [], "bytes": [], "arm": False}
    ck_root = (Path(__file__).resolve().parent / "build"
               / f"field_inference_{os.getpid()}")
    ck_root.mkdir(parents=True, exist_ok=False)
    real = _checkpoint_spy(ckpt, stats)
    try:
        comps, mom = stage("evolve_ics", lambda: nbody.lpt_catalog(
            torch.Generator(device=dev).manual_seed(seed), PM_SIDE, BOX,
            pk_gr, gr, Z_INIT))
        predicted["evolve_ics"] = {}
        a0 = 1.0 / (1.0 + Z_INIT)
        ref = stage("evolve_plain", lambda: nbody.pm_evolve(
            comps, mom, gr, PM_SIDE, BOX, a0, 1.0, PM_STEPS)[0])
        again = stage("evolve_plain_again", lambda: nbody.pm_evolve(
            comps, mom, gr, PM_SIDE, BOX, a0, 1.0, PM_STEPS)[0])
        predicted["evolve_plain"] = {"paint_windowed": PM_STEPS + 1}
        predicted["evolve_plain_again"] = {"paint_windowed": PM_STEPS + 1}

        def interrupted(call):
            stats["arm"] = True
            try:
                call()
            except _Interrupted:
                return True
            return False

        def evolve_ckpt():
            return nbody.pm_evolve_checkpointed(
                comps, mom, gr, PM_SIDE, BOX, a0, 1.0, PM_STEPS,
                ck_root / "evolve", segment_steps=FI_SEGMENT)

        check(stage("evolve_interrupted", lambda: interrupted(evolve_ckpt)),
              "the checkpointed evolution did not stop at its first save")
        predicted["evolve_interrupted"] = {"paint_windowed": FI_SEGMENT + 1}
        resumed = stage("evolve_resumed", evolve_ckpt)[0]
        rest = [min(FI_SEGMENT, PM_STEPS - s)
                for s in range(FI_SEGMENT, PM_STEPS, FI_SEGMENT)]
        predicted["evolve_resumed"] = {"paint_windowed": sum(
            k + 1 for k in rest)}
        del comps, mom
        gap_plain = [_periodic_gap(a, b, BOX) for a, b in zip(again, ref)]
        gap_ckpt = [_periodic_gap(a, b, BOX) for a, b in zip(resumed, ref)]
        pk_of = {}

        def spectra():
            for name, pos in (("plain", ref), ("plain_again", again),
                              ("resumed", resumed)):
                res = power.auto_power(paint(pos, PM_SIDE, BOX,
                                             window="cic"), BOX,
                                       window="cic")
                pk_of[name] = res.power[res.nmodes > 0]

        stage("evolve_pk", spectra)
        predicted["evolve_pk"] = {"paint_windowed": 3}
        del ref, again, resumed
        pk_rel = {name: float(((pk_of[name] - pk_of["plain"]).abs()
                               / pk_of["plain"].abs()).max())
                  for name in ("plain_again", "resumed")}
        max_plain = max(g[0] for g in gap_plain)
        max_ckpt = max(g[0] for g in gap_ckpt)
        mean_plain = max(g[1] for g in gap_plain)
        mean_ckpt = max(g[1] for g in gap_ckpt)
        check(max_ckpt <= FI_GAP_FACTOR * max_plain + FI_GAP_FLOOR
              and mean_ckpt <= FI_GAP_FACTOR * mean_plain + FI_GAP_FLOOR
              and pk_rel["resumed"] <= FI_PK_TOL,
              f"the resumed evolution: max / mean gap {max_ckpt} / "
              f"{mean_ckpt} Mpc/h (two plain runs {max_plain} / "
              f"{mean_plain}), P(k) {pk_rel['resumed']}")
        out["evolve"] = {
            "particles": PM_SIDE ** 3, "nsteps": PM_STEPS,
            "segment_steps": FI_SEGMENT, "saves_s": list(stats["save_s"]),
            "restores_s": list(stats["restore_s"]),
            "checkpoint_bytes": stats["bytes"][0],
            "gap_max_mpc": {"plain_vs_plain": max_plain,
                            "resumed_vs_plain": max_ckpt},
            "gap_mean_mpc": {"plain_vs_plain": mean_plain,
                             "resumed_vs_plain": mean_ckpt},
            "pk_rel": pk_rel}
        for key in ("save_s", "restore_s", "bytes"):
            stats[key].clear()

        # ---- (d) pm_lightcone_planes(ckpt_dir=) at a depth cut
        side, nplanes, npix = FI_LC
        lc_args = (gr, pk_gr, side, BOX, LC_FOV, npix, nplanes)
        lc_kw = dict(z_source=LC_Z_SOURCE, z_init=Z_INIT,
                     nsteps_init=LC_STEPS_INIT,
                     steps_per_plane=LC_STEPS_PLANE)
        first = min(FI_LC_EVERY, nplanes)  # planes before the first save

        def lc_gen():
            return torch.Generator(device=dev).manual_seed(seed + 24)

        def lightcone(**extra):
            return nbody.pm_lightcone_planes(lc_gen(), *lc_args, **lc_kw,
                                             **extra)[0]

        whole = {"paint_windowed": LC_STEPS_INIT + 1
                 + (nplanes - 1) * (LC_STEPS_PLANE + 1),
                 "deposit_sorted": nplanes}
        planes_ref = stage("lightcone_plain", lightcone)
        planes_again = stage("lightcone_plain_again", lightcone)
        predicted["lightcone_plain"] = whole
        predicted["lightcone_plain_again"] = whole
        lc_dir = ck_root / "lightcone"
        check(stage("lightcone_interrupted", lambda: interrupted(
            lambda: lightcone(ckpt_dir=lc_dir, ckpt_every=FI_LC_EVERY))),
              "the checkpointed lightcone did not stop at its first save")
        predicted["lightcone_interrupted"] = {
            "paint_windowed": LC_STEPS_INIT + 1
            + (first - 1) * (LC_STEPS_PLANE + 1), "deposit_sorted": first}
        g_resume = lc_gen()
        entry = g_resume.get_state()
        planes = stage("lightcone_resumed", lambda: nbody.pm_lightcone_planes(
            g_resume, *lc_args, ckpt_dir=lc_dir, ckpt_every=FI_LC_EVERY,
            **lc_kw)[0])
        predicted["lightcone_resumed"] = {
            "paint_windowed": (nplanes - first) * (LC_STEPS_PLANE + 1),
            "deposit_sorted": nplanes - first}
        check(torch.equal(g_resume.get_state(), entry),
              "the resumed lightcone drew from its generator")

        def refused():
            try:
                nbody.pm_lightcone_planes(
                    lc_gen(), gr, pk_gr, side, BOX, LC_FOV, npix,
                    nplanes + 1, ckpt_dir=lc_dir, ckpt_every=FI_LC_EVERY,
                    **lc_kw)
            except ValueError as err:
                return "different schedule" in str(err)
            return False

        check(stage("lightcone_other_schedule", refused),
              "a lightcone of another schedule resumed the checkpoint")
        predicted["lightcone_other_schedule"] = {}
        scale = float(planes_ref.abs().max())
        lc_plain = float((planes_again - planes_ref).abs().max()) / scale
        lc_ckpt = float((planes - planes_ref).abs().max()) / scale
        check(lc_ckpt <= FI_GAP_FACTOR * lc_plain + FI_GAP_FLOOR,
              f"the resumed lightcone's planes {lc_ckpt} of the max off "
              f"the plain run's (two plain runs {lc_plain})")
        out["lightcone"] = {
            "particles": side ** 3, "nplanes": nplanes, "npix": npix,
            "planes_rel_gap": {"plain_vs_plain": lc_plain,
                               "resumed_vs_plain": lc_ckpt},
            "saves_s": list(stats["save_s"]),
            "restores_s": list(stats["restore_s"]),
            "checkpoint_bytes": stats["bytes"][0]}
        del planes, planes_ref, planes_again
    finally:
        ckpt.save_state, ckpt.restore_state = real
        shutil.rmtree(ck_root, ignore_errors=True)

    total = _held_launches("field_inference", predicted, launches)
    phase_s = time.perf_counter() - t_phase

    # ---- K2's adjoint at (b)'s shape, outside the counts: the z = 0
    # positions of the full-width truth
    with torch.no_grad():
        dk = mocks.modes_from_white(truth2, n2, box2, pk_gr)
        c, p = nbody.lpt_catalog_from_modes(dk, n2, box2, gr, Z_INIT)
        c, _ = nbody.pm_evolve(c, p, gr, n2, box2, 1.0 / (1.0 + Z_INIT),
                               1.0, nsteps2)
        pf = torch.cat(c)
    del dk, c, p, truth2
    out["adjoint_timing_ms"] = _adjoint_timing(pf, n2, box2, gen2)
    del pf
    result = {"phase_seconds": phase_s, "seconds": seconds,
              "launches": launches, "launches_total": total,
              "peak_mem_gb": peaks, **out}
    ex, fl, ev, lc = out["example"], out["full"], out["evolve"], out[
        "lightcone"]
    log(f"# phase field_inference: {phase_s:.1f} s; launches {total}; "
        f"example r {ex['r']:.4f} (bands "
        f"{', '.join(f'{b:.3f}' for b in ex['band_corr'])}), HMC accept "
        f"{ex['hmc_accept']:.2f}, width ratio {ex['width_ratio']:.2f}, card "
        f"/ CPU losses {max(ex['cpu_loss_rel']):.1e} (the CPU's own "
        f"{max(ex['cpu_nudged_loss_rel']):.1e}); full width: gradient "
        f"{fl['ms_per_gradient']:.1f} ms / {fl['cuda_kernels_per_gradient']}"
        f" kernels, K2 vs scatter (max, mean) "
        f"{_pair(fl['grad_rel_err_vs_scatter'])} (nudged scatter "
        f"{_pair(fl['grad_rel_references']['scatter_nudged'])}, K2 again "
        f"{_pair(fl['grad_rel_references']['kernel_again'])}, K2 vs the "
        f"dividing scatter "
        f"{_pair(fl['grad_rel_references']['scatter_dividing'])}; controls "
        f"force detached "
        f"{_pair(fl['grad_rel_controls']['force_detached_vs_scatter'])}"
        f", adjoint x{1 + FI_CTL_SCALE:g} "
        f"{_pair(fl['grad_rel_controls']['adjoint_scaled_vs_scatter'])}), "
        f"peak {fl['peak_gb_adam']:.2f} GB; evolution resumed gap "
        f"{ev['gap_max_mpc']['resumed_vs_plain']:.2e} Mpc/h (plain "
        f"{ev['gap_max_mpc']['plain_vs_plain']:.2e}), save "
        f"{ev['saves_s'][0]:.2f} s of {ev['checkpoint_bytes'] / 1e9:.2f} GB;"
        f" lightcone resumed {lc['planes_rel_gap']['resumed_vs_plain']:.1e}"
        f" (plain {lc['planes_rel_gap']['plain_vs_plain']:.1e})")
    log("# field_inference " + json.dumps(result))
    return result


# the file path (phase 21), shapes: an ECOSMOG domain level of 2^FP_LEVEL
# cells a side over FP_CPUS per-CPU grav files in a FP_BOX Mpc/h box (the
# fields x, y, z, phi, f; each CPU also holds the first FP_GHOSTS octs of
# the next as ghost rows) painted onto FP_GRID^3 and its P(k) in FP_PK_BINS
# bins; FP_SNAPS Ray-Ramses snapshots of FP_NPIX^2 rays (the suite's map
# width) over FP_RAY_CPUS per-CPU ASCII dumps in code units, over FP_FOV
# deg, their kappa a Gaussian field smoothed over FP_RAY_SMOOTH pixels plus
# halos; peaks and C_ell bins of the ray map; the native oracle's K3
# tracers and bins and its kappa map (the central FP_ALPHA_NPIX^2 of the ray
# map). Bars: K3 against the oracle (tests/test_native.py's rtol and atol
# [km/s]), the deflections against the oracle's (its 3% of the largest),
# the observability stage clocks against the phase's own (share), the card
# sums and the translated map against the host's (relative to their max)
FP_LEVEL, FP_CPUS, FP_GHOSTS, FP_BOX = 8, 64, 512, 500.0
FP_GRID, FP_PK_BINS = 256, 64
FP_NPIX, FP_RAY_CPUS, FP_SNAPS, FP_FOV, FP_RAY_SMOOTH = 2048, 64, 2, 10.0, 4.0
FP_PEAKS, FP_CL_BINS = 512, 32
FP_K3_N, FP_K3_BINS, FP_ALPHA_NPIX = 1 << 15, (0.0, 50.0, 25), 1024
FP_K3_TOL, FP_ALPHA_TOL, FP_CLOCK_TOL, FP_MAP_TOL = (2e-3, 0.5), 0.03, 0.05, 1e-6
FP_FIELDS = ("x", "y", "z", "phi", "f")
FP_RAY_COLS = ("id", "kappa_2", "shear_x", "shear_y")
# digits of the ray dumps' integer columns (ids; code-unit values: kappa c^2
# is ~1e9 for kappa ~ 0.01, 1e12 would be kappa ~ 11, and one unit is
# 1.1e-11 of kappa)
FP_ID_DIGITS, FP_VALUE_DIGITS = 8, 12


def _write_grav_files(directory: Path, snap: int, rng) -> dict:
    """One ECOSMOG grav snapshot in the F77 layout of tests/test_io.py's
    fixture, split over FP_CPUS files `grav_<snap>.out<cpu>`: the header
    (ncpu, ndim, nlevelmax, nboundary), then for every CPU a (level,
    ncache) block, empty but the file's own, which holds 8 sub-grids of
    ncache float64 records a field. CPU c owns the octs of its slab of
    oct planes along x, in (x, y, z) order, and repeats the first
    FP_GHOSTS octs of CPU c + 1 as ghost rows. Returns the cell count and
    the sum of phi over the cells (without ghosts)."""
    n = 2 ** FP_LEVEL
    side = n // 2
    per = side ** 3 // FP_CPUS
    o = np.arange(side)
    ox, oy, oz = (a.ravel() for a in np.meshgrid(o, o, o, indexing="ij"))
    dims = np.array([[d & 1, (d >> 1) & 1, (d >> 2) & 1] for d in range(8)])
    # (field, sub-grid, oct): cell centres in box units, phi > 0, f
    vals = np.empty((5, 8, side ** 3))
    for a, oa in enumerate((ox, oy, oz)):
        vals[a] = (2 * oa[None, :] + dims[:, a, None] + 0.5) / n
    vals[3] = 1.0 + 0.1 * rng.standard_normal((8, side ** 3))
    vals[4] = rng.standard_normal((8, side ** 3))
    header = b"".join(struct.pack("iii", 4, v, 4)
                      for v in (FP_CPUS, 3, FP_LEVEL, 0))
    for c in range(FP_CPUS):
        nxt = ((c + 1) % FP_CPUS) * per
        idx = np.concatenate([np.arange(c * per, (c + 1) * per),
                              np.arange(nxt, nxt + FP_GHOSTS)])
        block = np.ascontiguousarray(vals[:, :, idx])
        marker = struct.pack("i", 8 * len(idx))
        parts = [header]
        for ib in range(FP_CPUS):
            parts.append(struct.pack("iii", 4, FP_LEVEL, 4))
            parts.append(struct.pack("iii", 4, len(idx) if ib == c else 0, 4))
        # this CPU's records after its block (ib = c): the blocks of the
        # CPUs after it follow them
        head = 12 * (4 + 2 * (c + 1))
        body = [marker + block[fi, d].tobytes() + marker
                for d in range(8) for fi in range(5)]
        data = b"".join(parts)
        with open(directory / f"grav_{snap:05d}.out{c + 1:05d}", "wb") as f:
            f.write(data[:head] + b"".join(body) + data[head:])
    return {"cells": n ** 3, "phi_sum": float(vals[3].sum())}


def _ascii_int_rows(cols, digits) -> bytes:
    """Integer columns as whitespace-separated ASCII rows, each value
    written as ' ' or '-' and zero-padded digits (a multiple of 4; np.
    loadtxt reads them back exactly), built with numpy four digits at a
    time rather than with a Python loop a row."""
    quads = np.frombuffer(b"".join(b"%04d" % q for q in range(10000)),
                          np.uint8).reshape(10000, 4)
    n = len(cols[0])
    width = sum(d + 2 for d in digits) + 1  # and the newline
    buf = np.full((n, width), ord(" "), np.uint8)
    at = 0
    for col, d in zip(cols, digits):
        col = np.asarray(col, np.int64)
        mag = np.abs(col)
        if d % 4 or mag.max(initial=0) >= 10 ** d:
            raise ValueError(f"{d} digits: not a multiple of 4, or short")
        buf[:, at + 1] = np.where(col < 0, ord("-"), ord(" "))
        for k in range(d // 4):
            group = (mag // 10 ** (d - 4 * (k + 1))) % 10000
            buf[:, at + 2 + 4 * k:at + 6 + 4 * k] = quads[group]
        at += d + 2
    buf[:, -1] = ord("\n")
    return buf.tobytes()


def _ray_fields(rng) -> dict:
    """kappa (a Gaussian field of rms 0.02 smoothed over FP_RAY_SMOOTH
    pixels, plus 64 Gaussian halos of 0.05-0.2) and its shear (Kaiser-
    Squires) on FP_NPIX^2 pixels, float64 on the host."""
    n = FP_NPIX
    k1 = np.fft.fftfreq(n)[:, None]
    k2 = np.fft.rfftfreq(n)[None, :]
    ksq = k1 ** 2 + k2 ** 2
    field = np.fft.irfft2(np.fft.rfft2(rng.standard_normal((n, n)))
                          * np.exp(-0.5 * ksq * (2 * np.pi * FP_RAY_SMOOTH)
                                   ** 2), s=(n, n))
    kappa = 0.02 * field / field.std()
    e = np.arange(n)
    for r, c, a, s in zip(rng.uniform(64, n - 64, 64), rng.uniform(
            64, n - 64, 64), rng.uniform(0.05, 0.2, 64), rng.uniform(
            3, 12, 64)):
        kappa += a * np.outer(np.exp(-0.5 * ((e - r) / s) ** 2),
                              np.exp(-0.5 * ((e - c) / s) ** 2))
    kft = np.fft.rfft2(kappa)
    ksq[0, 0] = 1.0
    return {"kappa_2": kappa,
            "shear_x": np.fft.irfft2((k1 ** 2 - k2 ** 2) / ksq * kft,
                                     s=(n, n)),
            "shear_y": np.fft.irfft2(2 * k1 * k2 / ksq * kft, s=(n, n))}


def _write_ray_files(directory: Path, rng) -> dict:
    """FP_SNAPS Ray-Ramses snapshots, each over FP_RAY_CPUS per-CPU ASCII
    dumps `Ray_maps_output<snap>.out<cpu>` with a header line and the
    columns id, kappa_2, shear_x, shear_y in code units (x c^2, as
    integers), the shear with the sign Ray-Ramses wrote (compress_snapshot
    flips it). The rays are dealt to the CPUs in one random order, the
    same in every snapshot. Returns {snap: {column: code-unit integers in
    ray-id order}} and the physical maps."""
    from astrild_tpu_torch.utils.constants import C_LIGHT_KMS

    n_rays = FP_NPIX ** 2
    order = rng.permutation(n_rays)
    chunks = np.array_split(order, FP_RAY_CPUS)
    header = ("# " + " ".join(FP_RAY_COLS) + "\n").encode()
    out = {}
    for snap in range(1, FP_SNAPS + 1):
        maps = _ray_fields(rng)
        code = {k: np.rint(v.ravel() * C_LIGHT_KMS ** 2).astype(np.int64)
                for k, v in maps.items()}
        dumped = {"kappa_2": code["kappa_2"], "shear_x": -code["shear_x"],
                  "shear_y": -code["shear_y"]}
        for c, ids in enumerate(chunks):
            rows = _ascii_int_rows(
                [ids] + [dumped[k][ids] for k in FP_RAY_COLS[1:]],
                [FP_ID_DIGITS] + [FP_VALUE_DIGITS] * 3)
            path = directory / f"Ray_maps_output{snap:05d}.out{c + 1:05d}"
            with open(path, "wb") as f:
                f.write(header + rows)
        out[snap] = {"code": code, "maps": maps}
    return out


def _k3_oracle_tracers(rng, n: int, side: float = 200.0, lo: float = 500.0):
    """n tracers in a cube of `side` Mpc/h at `lo` from the observer at the
    origin: half in 256 clumps (3 Mpc/h) falling in at 30 km/s per Mpc/h,
    half uniform, all with 100 km/s noise (tests/test_torch_cuda.py's
    K3-against-oracle tracers)."""
    nc = n // 2
    centres = lo + rng.uniform(0, side, (256, 3))
    off = rng.normal(0, 3.0, (nc, 3))
    pos = np.concatenate([centres[rng.integers(0, 256, nc)] + off,
                          lo + rng.uniform(0, side, (n - nc, 3))])
    vel = np.concatenate([-30.0 * off, np.zeros((n - nc, 3))]) \
        + rng.normal(0, 100.0, (n, 3))
    return pos, vel


def _rel_max(got, want) -> float:
    got = got.detach().cpu().double().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def phase_file_path(dev, seed: int, card: str) -> dict:
    """The file path (queue 1 item 8) on the card. The synthetic files
    are written first, under build/file_path_<pid>/ (removed after), and
    their seconds printed apart. Then three stages, each inside
    observability.stage with sync= its card output and on the phase's own
    synchronized host clock (the two within FP_CLOCK_TOL), with K1-K4
    launches held to each stage's count: (1) `grav`: Ecosmog.compress_
    snapshot(save=False) of the 64 grav files of a 256^3 domain level
    (np.unique's dedup must leave exactly 256^3 rows, the cell centres in
    lexicographic order, phi summing as written), the columns to the card
    as a Catalog, their positions painted through K2 weighted by phi into a
    Grid3D (its total the phi sum, rtol 1e-5), its density_contrast (mean
    0) and P(k) (finite); (2) `rays`: RayRamses.compress_snapshot(save=
    False) of two snapshots of 2048^2 rays over 64 ASCII dumps each (the
    shear signs flipped, the ray ids sorting to 0 .. 2048^2 - 1, every
    column equal to the integers written), rays_to_map (equal to the
    written map within one code unit), a SkyArray on the card, peaks.
    find_peaks and cl_flat_sky of both, the two snapshots' summed columns
    as one map on the card against the sum of the two card maps (within
    FP_MAP_TOL of the max), SimulationCollection._translate_redshift of
    the card map against its float64 host value (FP_MAP_TOL); (3)
    `native`: the native C++ oracle built with g++ (its seconds), K3 on
    2^15 clustered tracers against its float64 OpenMP pair sum (FP_K3_TOL
    where both are finite), lensing.kappa_to_alpha on the card against
    its kappa_to_alphas on the central 1024^2 of the first ray map
    (FP_ALPHA_TOL of the largest deflection). Then the card half of stage 2
    again under observability.trace: its Chrome trace must exist and name
    a cuFFT, K1 or K2 kernel; check_finite of every card output;
    stack_for_devices of the two card maps, one (2, 2048, 2048) card
    tensor. The stages of the JAX package's file path that read or write
    HDF5 (h5py) or draw figures (matplotlib) are not in this phase: those
    packages are not on the card's machine (PERF.md §4); the CPU tests
    hold them. Returns the numbers printed in `# file_path`."""
    from astrild_tpu_torch import native
    from astrild_tpu_torch.core import Catalog, Grid3D
    from astrild_tpu_torch.io.rays import rays_to_map
    from astrild_tpu_torch.models import (Ecosmog, RayRamses,
                                          SimulationCollection, SkyArray)
    from astrild_tpu_torch.ops import (angular_power, lensing, paint,
                                       paint_cuda, pairwise, pairwise_cuda,
                                       peaks, power)
    from astrild_tpu_torch.utils import observability as obs

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 21)
    root = Path(__file__).resolve().parent / "build" / \
        f"file_path_{os.getpid()}"
    grav_dir, ray_dir = root / "output_00001", root / "rays"
    grav_dir.mkdir(parents=True)
    ray_dir.mkdir()
    try:
        generation = {}
        t0 = time.perf_counter()
        written = _write_grav_files(grav_dir, 1, rng)
        generation["grav_files_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rays = _write_ray_files(ray_dir, rng)
        generation["ray_files_s"] = time.perf_counter() - t0
        generation["bytes"] = sum(p.stat().st_size for p in root.rglob("*")
                                  if p.is_file())
        log(f"#   file_path generation: grav {generation['grav_files_s']:.2f}"
            f" s, rays {generation['ray_files_s']:.2f} s, "
            f"{generation['bytes'] / 1e9:.2f} GB")

        paint_cuda.LAUNCHES.clear()
        pairwise_cuda.LAUNCHES.clear()
        times = obs.StageTimes()
        seconds, launches, clock_gap = {}, {}, {}

        def stage(name, fn):
            """fn() inside observability.stage (sync= its card outputs)
            and on the phase's synchronized host clock, with its kernel
            launches."""
            torch.cuda.synchronize()
            before = {**paint_cuda.LAUNCHES, **pairwise_cuda.LAUNCHES}
            t0 = time.perf_counter()
            with obs.stage(f"file_path.{name}", collector=times,
                           log=False) as holder:
                res, card_out = fn()
                holder["sync"] = card_out
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            staged = times.times[f"file_path.{name}"]
            clock_gap[name] = abs(staged - seconds[name]) / seconds[name]
            after = {**paint_cuda.LAUNCHES, **pairwise_cuda.LAUNCHES}
            launches[name] = {k: after[k] - before.get(k, 0) for k in after
                              if after[k] != before.get(k, 0)}
            log(f"#   file_path stage {name}: {seconds[name]:.3f} s "
                f"(observability.stage {staged:.3f} s), launches "
                f"{launches[name]}; {card}")
            return res

        out = {}

        # (1) ECOSMOG grav files -> Catalog -> K2 -> Grid3D -> P(k)
        def grav():
            t0 = time.perf_counter()
            eco = Ecosmog(dir_sim=str(root), dir_root="output",
                          boxsize=FP_BOX, domain_level=2 ** FP_LEVEL)
            data = eco.compress_snapshot([FP_LEVEL], FP_LEVEL,
                                         list(FP_FIELDS), save=False)[1]
            compress_s = time.perf_counter() - t0
            n = 2 ** FP_LEVEL
            if len(data["x"]) != written["cells"]:
                raise AssertionError(f"grav dedup left {len(data['x'])} "
                                     f"rows, not {written['cells']}")
            c = (np.arange(n) + 0.5) / n
            lattice = (np.array_equal(data["x"], np.repeat(c, n * n))
                       and np.array_equal(data["y"],
                                          np.tile(np.repeat(c, n), n))
                       and np.array_equal(data["z"], np.tile(c, n * n)))
            if not lattice:
                raise AssertionError("grav rows are not the cell centres "
                                     "in lexicographic order")
            if not math.isclose(float(data["phi"].sum()), written["phi_sum"],
                                rel_tol=1e-12):
                raise AssertionError("grav phi does not sum as written")
            t0 = time.perf_counter()
            cat = Catalog.from_dict(data, device=dev)
            pos = tuple(cat[k] * FP_BOX for k in ("x", "y", "z"))
            grid = Grid3D(paint.paint(pos, FP_GRID, FP_BOX,
                                      weights=cat["phi"], window="cic"),
                          FP_BOX)
            delta = grid.density_contrast()
            pk = power.auto_power(grid.values, FP_BOX, nbins=FP_PK_BINS,
                                  window="cic")
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            total = float(grid.values.double().sum())
            mass_rel = abs(total - written["phi_sum"]) / written["phi_sum"]
            if mass_rel > MASS_RTOL:
                raise AssertionError(f"grav paint total off by {mass_rel}")
            mean_delta = abs(float(delta.values.double().mean()))
            if mean_delta > 1e-5 or not bool(
                    torch.isfinite(pk.power).all()):
                raise AssertionError("grav contrast or P(k) wrong")
            out["grav"] = {"rows": len(data["x"]),
                           "compress_s": compress_s, "card_s": card_s,
                           "paint_total_rel": mass_rel,
                           "mean_delta": mean_delta,
                           "dtypes": sorted({str(v.dtype)
                                             for v in cat.columns.values()}),
                           "pk_low": float(pk.power[1])}
            return (cat, grid, delta, pk), (grid.values, delta.values,
                                            pk.power)

        grav_out = stage("grav", grav)

        # (2) Ray-Ramses dumps -> columns -> maps -> SkyArray -> statistics
        def rays_card(snaps):
            """The card half: each snapshot's map as a SkyArray, its
            peaks and C_ell, and the sum of the two snapshots."""
            skies = {s: SkyArray.from_array(m, FP_FOV, "kappa_2", device=dev)
                     for s, m in snaps["maps"].items()}
            stats = {}
            for s, sky in skies.items():
                img = sky.data["orig"]
                cat = peaks.find_peaks(img, threshold=0.1,
                                       max_peaks=FP_PEAKS, edge_pix=8)
                ell, cl = angular_power.cl_flat_sky(img, FP_FOV,
                                                    nbins=FP_CL_BINS)
                stats[s] = (cat, ell, cl)
            summed = SkyArray.from_array(snaps["summed"], FP_FOV, "kappa_2",
                                         device=dev)
            card_sum = sum(sky.data["orig"] for sky in skies.values())
            return skies, stats, summed, card_sum

        def rays_stage():
            t0 = time.perf_counter()
            rr = RayRamses(dir_sim=str(ray_dir),
                           file_dsc={"root": "Ray_maps",
                                     "extension": "out*"},
                           opening_angle=FP_FOV, npix=FP_NPIX)
            cols = rr.compress_snapshot(list(FP_RAY_COLS), save=False)
            compress_s = time.perf_counter() - t0
            if sorted(cols) != list(range(1, FP_SNAPS + 1)):
                raise AssertionError(f"ray snapshots {sorted(cols)}")
            maps, map_err = {}, 0.0
            for s, d in cols.items():
                ids = d["id"].astype(np.int64)
                order = np.argsort(ids)
                if not np.array_equal(ids[order], np.arange(FP_NPIX ** 2)):
                    raise AssertionError("ray ids do not sort to a square")
                for k in FP_RAY_COLS[1:]:
                    if not np.array_equal(d[k][order], rays[s]["code"][k]):
                        raise AssertionError(f"ray column {k} of snapshot "
                                             f"{s} differs from the dump "
                                             "(shear sign?)")
                maps[s] = rays_to_map(d["kappa_2"], d["id"], "kappa_2")
                map_err = max(map_err, float(np.abs(
                    maps[s] - rays[s]["maps"]["kappa_2"]).max()))
            if map_err > 1e-10:
                raise AssertionError(f"ray map off by {map_err}")
            same_ids = all(np.array_equal(cols[s]["id"], cols[1]["id"])
                           for s in cols)
            if not same_ids:
                raise AssertionError("ray snapshots deal their rays "
                                     "differently")
            summed_cols = {k: sum(cols[s][k] for s in cols)
                           for k in FP_RAY_COLS[1:]}
            snaps = {"maps": maps, "summed": rays_to_map(
                summed_cols["kappa_2"], cols[1]["id"], "kappa_2")}
            t0 = time.perf_counter()
            skies, stats, summed, card_sum = rays_card(snaps)
            coll = SimulationCollection({}, {})
            shifted = coll._translate_redshift(skies[1].data["orig"], 0.4,
                                               0.5, 1.0, 2.0)
            host_shifted = coll._translate_redshift(maps[1], 0.4, 0.5, 1.0,
                                                    2.0)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            sum_rel = (summed.data["orig"] - card_sum).abs().max().item() \
                / card_sum.abs().max().item()
            shift_rel = _rel_max(shifted, host_shifted)
            if sum_rel > FP_MAP_TOL or shift_rel > FP_MAP_TOL:
                raise AssertionError(f"ray sums {sum_rel}, shift "
                                     f"{shift_rel} above {FP_MAP_TOL}")
            n_peaks = {s: int(torch.isfinite(st[0].values).sum())
                       for s, st in stats.items()}
            if min(n_peaks.values()) < 16:
                raise AssertionError(f"too few peaks {n_peaks}")
            out["rays"] = {"rays": FP_NPIX ** 2, "compress_s": compress_s,
                           "card_s": card_s, "map_err": map_err,
                           "sum_rel": sum_rel, "shift_rel": shift_rel,
                           "peaks": n_peaks,
                           "cl_low": {s: float(st[2][1])
                                      for s, st in stats.items()}}
            card_outs = [summed.data["orig"], card_sum, shifted] + [
                t for st in stats.values() for t in (st[1], st[2])]
            return (snaps, skies, stats, summed, card_sum, shifted), card_outs

        ray_out = stage("rays", rays_stage)

        # (3) the native oracle against K3 and kappa_to_alpha on the card
        def native_stage():
            t0 = time.perf_counter()
            if not native.available():
                raise AssertionError(f"the native oracle did not build at "
                                     f"{native.library_path()}:\n"
                                     f"{native.build_log}")
            build_s = native.build_seconds
            pos, vel = _k3_oracle_tracers(rng, FP_K3_N)
            bins = np.linspace(*FP_K3_BINS)
            t1 = time.perf_counter()
            _, v_ref = native.pairwise_velocity(pos, vel, bins)
            oracle_k3_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            _, v12 = pairwise.mean_pairwise_velocity(
                torch.tensor(pos, dtype=torch.float32, device=dev),
                torch.tensor(vel, dtype=torch.float32, device=dev), bins)
            torch.cuda.synchronize()
            k3_s = time.perf_counter() - t1
            v12_h = v12.cpu().numpy()
            good = np.isfinite(v_ref) & np.isfinite(v12_h)
            rtol, atol = FP_K3_TOL
            k3_share = float(np.max(np.abs(v12_h[good] - v_ref[good])
                                    / (atol + rtol * np.abs(v_ref[good]))))
            if good.sum() < 20 or k3_share > 1.0:
                raise AssertionError(f"K3 against the native oracle: "
                                     f"{k3_share} of the bar in "
                                     f"{good.sum()} bins")
            lo = (FP_NPIX - FP_ALPHA_NPIX) // 2
            kappa = ray_out[0]["maps"][1][lo:lo + FP_ALPHA_NPIX,
                                          lo:lo + FP_ALPHA_NPIX]
            oa = math.radians(FP_FOV * FP_ALPHA_NPIX / FP_NPIX)
            t1 = time.perf_counter()
            a_ref = native.kappa_to_alphas(kappa, oa)
            oracle_alpha_s = time.perf_counter() - t1
            t1 = time.perf_counter()
            alpha = lensing.kappa_to_alpha(
                torch.tensor(kappa, dtype=torch.float32, device=dev), oa,
                padding_factor=4)
            torch.cuda.synchronize()
            alpha_s = time.perf_counter() - t1
            alpha_rel = max(_rel_max(a, r) for a, r in zip(alpha, a_ref))
            if alpha_rel > FP_ALPHA_TOL:
                raise AssertionError(f"kappa_to_alpha against the native "
                                     f"oracle: {alpha_rel} of the max")
            out["native"] = {"build_s": build_s,
                             "load_s": time.perf_counter() - t0,
                             "k3_n": FP_K3_N, "k3_bar_share": k3_share,
                             "k3_bins": int(good.sum()), "k3_s": k3_s,
                             "oracle_k3_s": oracle_k3_s,
                             "alpha_npix": FP_ALPHA_NPIX,
                             "alpha_rel": alpha_rel, "alpha_s": alpha_s,
                             "oracle_alpha_s": oracle_alpha_s}
            return (v12, alpha), [v12, *alpha]

        native_out = stage("native", native_stage)

        predicted = {"grav": {"paint_windowed": 1}, "rays": {},
                     "native": {"pairwise_accumulate": 1}}
        total = _held_launches("file_path", predicted, launches)
        gap = max(clock_gap.values())
        if gap > FP_CLOCK_TOL:
            raise AssertionError(f"observability.stage off the phase's "
                                 f"clock by {clock_gap}")

        # (4) plumbing: a trace of the card half of stage 2, check_finite,
        # the device batch
        trace_dir = root / "trace"
        t0 = time.perf_counter()
        with obs.trace(str(trace_dir)):
            traced = rays_card(ray_out[0])
        trace_s = time.perf_counter() - t0
        files = sorted(trace_dir.glob("*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"trace files {files}")
        names = {str(e.get("name", "")) for e in json.load(
            open(files[0]))["traceEvents"] if e.get("cat") == "kernel"}
        fft = sorted(n for n in names if "fft" in n.lower())
        ours = sorted(n for n in names
                      if "deposit_" in n or "paint_windowed_" in n)
        if not (fft or ours):
            raise AssertionError(f"the trace names no cuFFT, K1 or K2 "
                                 f"kernel among {len(names)} kernels")
        grid_t = grav_out[1].values
        obs.check_finite({"grav": (grid_t, grav_out[2].values,
                                   grav_out[3].power),
                          "rays": [s.data["orig"] for s in
                                   ray_out[1].values()] + [ray_out[5]],
                          "native": native_out,
                          "traced": traced[3]}, name="file_path")
        cards = {1: ray_out[1][1].data["orig"], 2: ray_out[1][2].data["orig"]}
        batch = SimulationCollection({}, {"snap1": 1, "snap2": 2}) \
            .stack_for_devices(lambda s: cards[s])
        if (tuple(batch.shape) != (2, FP_NPIX, FP_NPIX)
                or batch.device != cards[1].device
                or not torch.equal(batch[1], cards[2])):
            raise AssertionError("stack_for_devices of the card maps")
        out["plumbing"] = {"clock_gap": clock_gap, "trace_s": trace_s,
                           "trace_bytes": files[0].stat().st_size,
                           "trace_kernels": len(names), "trace_fft": fft[:4],
                           "trace_ours": ours, "batch": list(batch.shape),
                           "observability_stages": times.times}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    result = {"phase_s": phase_s, "generation": generation,
              "seconds": seconds, "launches": launches,
              "launches_total": total, "card": card, **out}
    g, r, nv = out["grav"], out["rays"], out["native"]
    log(f"# phase file_path: {phase_s:.1f} s (files {generation['grav_files_s'] + generation['ray_files_s']:.1f} s apart); "
        f"launches {total}; grav {g['rows']} rows, compress "
        f"{g['compress_s']:.2f} s, paint total {g['paint_total_rel']:.1e}; "
        f"rays compress {r['compress_s']:.2f} s for {FP_SNAPS} x "
        f"{FP_NPIX}^2, sums {r['sum_rel']:.1e}, shift {r['shift_rel']:.1e},"
        f" peaks {r['peaks']}; native build {nv['build_s']} s, K3 "
        f"{nv['k3_bar_share']:.3f} of the bar, alpha {nv['alpha_rel']:.4f} "
        f"of the max; stage clocks within {gap:.4f}; trace "
        f"{len(names)} kernels; {card}")
    log("# file_path " + json.dumps(result))
    return result


# the distributed phase (22), on a world of one over NCCL at phase 6's
# width: the suite's bars against the single-device path on the same
# particles. P(k) before its shot noise (the same V/N in both): rtol 1e-5
# on every bin but the last, which holds one mode fewer on the pencil (the
# single-device rfft storage counts the (0, 0, n/2) mode twice) and is held
# to rtol 1e-4. B: rtol 1e-4 on closed triangles (the same shells from the
# same coarse grid, c2c against r2c transforms); kappa and gamma: 1e-5 of
# their max (the same planes, the mean summed in float64 against float32);
# (b) CIC P(k) and multipoles through K2 within 1e-4 of the shot noise
# (K2's float sums in a different order each call); (c) the pencil FFT and
# (d) the sharded filter within 1e-5 of the max (three 1D passes against
# one nD transform); the void counts equal
DIST_PK_RTOL, DIST_PK_LAST_RTOL, DIST_BK_RTOL = 1e-5, 1e-4, 1e-4
DIST_MAP_TOL, DIST_SHOT_TOL, DIST_FFT_TOL = 1e-5, 1e-4, 1e-5
# the triangle counts: the same host tables at phase 6's shells (the
# truncated body); float32 sums in the full body (the JAX test's bar)
DIST_NTRI_RTOL = 1e-4
DIST_FILTER_SIGMA = 2.0  # arcmin, on phase 6's 2048^2 / 0.35 rad maps
# (g) the 4-rank gloo check on the host CPU: mesh, grid, particles, P(k)
# bins, bispectrum shells (m_max 10 takes the full body: per-shell pencil
# transposes), lens planes; bars of the 4-rank run against the world of one
# as (a)-(c)'s, but B to rtol 1e-4 and ntri to 1e-5 (the same host tables
# reached by other sums)
GLOO_MESH, GLOO_NGRID, GLOO_N, GLOO_PK_BINS = (1, 2, 2), 32, 1 << 18, 16
GLOO_BK, GLOO_PLANES, GLOO_TIMEOUT = (3, 2.0, 10.0), 8, 300


def _gloo_worker(rank: int, world: int, port: str, out: str,
                 seed: int) -> None:
    """(g)'s rank: the distributed suite, the CIC P(k) and multipoles and
    the pencil FFT at GLOO_NGRID on a gloo world of the host's CPU; rank
    r's replicated outputs and the gathered FFTs into out/rank_r.npz."""
    torch.set_num_threads(1)
    from astrild_tpu_torch.parallel import make_mesh, multihost
    from astrild_tpu_torch.parallel import power as dpower
    from astrild_tpu_torch.parallel.mesh import shard, unshard
    from astrild_tpu_torch.parallel.pfft import make_pfft3d
    from astrild_tpu_torch.parallel.suite import make_distributed_z0_suite

    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = make_mesh(*(GLOO_MESH if world > 1 else (1, 1, 1)),
                     device="cpu")
    rng = np.random.default_rng(seed + 22)
    pos = torch.from_numpy(rng.uniform(0, BOX, (GLOO_N, 3))
                           .astype(np.float32))
    field = torch.from_numpy(rng.standard_normal(
        (GLOO_NGRID,) * 3).astype(np.float32))
    rows = shard(pos, mesh, (("sim", "x", "y"), None))
    res = {}

    def put(key, value):
        for name, v in zip(value._fields, value):
            if isinstance(v, tuple):
                put(f"{key}.{name}", v)
            else:
                res[f"{key}.{name}"] = v.numpy()

    nb, mmin, mmax = GLOO_BK
    put("suite", make_distributed_z0_suite(
        mesh, GLOO_NGRID, BOX, nbins_pk=GLOO_PK_BINS, nbins_bk=nb,
        bk_m_min=mmin, bk_m_max=mmax, nplanes=GLOO_PLANES,
        max_peaks=256, max_voids=64)(rows))
    put("power", dpower.make_distributed_auto_power(
        mesh, GLOO_NGRID, BOX, GLOO_PK_BINS, window="cic")(tuple(rows.t())))
    put("multipoles", dpower.make_distributed_multipoles(
        mesh, GLOO_NGRID, BOX, GLOO_PK_BINS, window="cic")(rows))
    spec = make_pfft3d(mesh)(shard(field, mesh, ("x", "y", None)))
    back = make_pfft3d(mesh, inverse=True)(spec).real
    res["pfft"] = unshard(spec, mesh, (None, "x", "y")).numpy()
    res["pfft_back"] = unshard(back.contiguous(), mesh,
                               ("x", "y", None)).numpy()
    res["field"] = field.numpy()
    np.savez(os.path.join(out, f"rank_{rank}.npz"), **res)


def _gloo_worlds(sizes, root: Path, seed: int, part: str, timeout: float,
                 what: str) -> None:
    """Run a gloo world of each size in `sizes` at once, of this script's
    worker processes on the host CPU (no card visible to them), each rank
    running `part`'s worker (a: phase 22's, b: phase 23's) into
    root/world_<size>. Each world's port is held from before its ranks
    start until they end, by a socket bound with SO_REUSEADDR that never
    listens (rank 0's store, which sets it too, listens there; no other
    socket can take it). Raises, naming every rank's exit code beside its
    output's tail, unless every rank exits 0. No process outlives the
    call, and no world is retried."""
    import socket

    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONFAULTHANDLER": "1"}
    held, procs = [], []
    try:
        for world in sizes:
            s = socket.socket()
            held.append(s)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            out = root / f"world_{world}"
            out.mkdir(parents=True)
            procs += [(world, r, subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--gloo-worker", str(r), str(world),
                 str(s.getsockname()[1]), str(out), "--seed", str(seed),
                 "--gloo-part", part],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)) for r in range(world)]
        logs = [p.communicate(timeout=timeout)[0] for _, _, p in procs]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        for s in held:
            s.close()
    if any(p.returncode or "terminate called" in log_
           for (_, _, p), log_ in zip(procs, logs)):
        raise AssertionError(
            f"{what} (CPU check): a worker failed; exit codes "
            f"{[(w, r, p.returncode) for w, r, p in procs]}\n"
            + "\n---\n".join(
                f"world {w} rank {r}, exit code {p.returncode}:\n"
                f"{log_[-2000:]}" for (w, r, p), log_ in zip(procs, logs)))


def _gloo_check(seed: int) -> dict:
    """(g): a 4-rank gloo world (mesh GLOO_MESH) and a world of one on the
    host CPU through the suite, the CIC P(k), the multipoles and the pencil
    FFT; the 4 ranks' replicated outputs must be equal, and the 4-rank run
    hold to the world of one. A CPU check of the transposes and
    reduce-scatters under this machine's torch; no card time."""
    root = Path(__file__).resolve().parent / "build" / \
        f"distributed_gloo_{os.getpid()}"
    t0 = time.perf_counter()
    try:
        n4 = GLOO_MESH[0] * GLOO_MESH[1] * GLOO_MESH[2]
        _gloo_worlds((n4, 1), root, seed, "a", GLOO_TIMEOUT,
                     "distributed gloo")
        ranks = [dict(np.load(root / f"world_{n4}" / f"rank_{r}.npz"))
                 for r in range(n4)]
        one = dict(np.load(root / "world_1" / "rank_0.npz"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    for r in ranks[1:]:
        for k, v in r.items():
            if not np.array_equal(v, ranks[0][k], equal_nan=True):
                raise AssertionError(f"distributed gloo (CPU check): {k} "
                                     "differs between ranks")
    got = ranks[0]
    shot = BOX ** 3 / GLOO_N
    errs = {}

    def hold(name, key, bar, scale=None, rtol=False):
        a, b = got[key], one[key]
        if rtol:
            ok = np.isfinite(b)
            err = float(np.max(np.abs(a[ok] - b[ok])
                               / np.maximum(np.abs(b[ok]), 1e-30)))
        else:
            err = float(np.max(np.abs(a - b)) / scale)
        errs[name] = err
        if not err <= bar:
            raise AssertionError(f"distributed gloo (CPU check): {name} "
                                 f"4 ranks against 1: {err:.3e} > {bar}")

    for key in ("suite.pk.nmodes", "power.nmodes", "multipoles.nmodes",
                "suite.n_voids", "suite.n_void_candidates"):
        if not np.array_equal(got[key], one[key]):
            raise AssertionError(f"distributed gloo (CPU check): {key} "
                                 f"{got[key]} against {one[key]}")
    hold("suite P(k)", "suite.pk.power", DIST_SHOT_TOL, shot)
    hold("suite B", "suite.bk.b", DIST_BK_RTOL, rtol=True)
    hold("suite ntri", "suite.bk.ntri", 1e-5, rtol=True)
    for m in ("kappa", "gamma1", "gamma2"):
        hold(f"suite {m}", f"suite.{m}", DIST_MAP_TOL,
             float(np.abs(one[f"suite.{m}"]).max()))
    hold("CIC P(k)", "power.power", DIST_SHOT_TOL, shot)
    hold("multipoles", "multipoles.p_ell", DIST_SHOT_TOL, shot)
    hold("pfft", "pfft", DIST_FFT_TOL, float(np.abs(one["pfft"]).max()))
    rt = float(np.abs(got["pfft_back"] - got["field"]).max()
               / np.abs(got["field"]).max())
    errs["pfft round trip"] = rt
    if not rt <= DIST_FFT_TOL:
        raise AssertionError(f"distributed gloo (CPU check): round trip "
                             f"{rt:.3e}")
    log(f"#   distributed gloo (CPU check): torch {torch.__version__}, "
        f"mesh {GLOO_MESH} of gloo ranks on the host CPU against a world "
        f"of one, {GLOO_NGRID}^3, {GLOO_N} particles, {seconds:.1f} s; "
        f"voids {int(got['suite.n_voids'])}; "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return {"seconds": seconds, "errors": errs,
            "n_voids": int(got["suite.n_voids"])}


def phase_distributed(dev, seed: int, card: str) -> dict:
    """The distributed layer, part A, on a world of one over NCCL
    (`make_mesh(1, 1, 1, device="cuda")`) at phase 6's width: 512^3
    particles (phase 6's, from the same seed), a 256^3 grid over 2^27 fine
    cells, phase 6's P(k) bins, bispectrum shells and 64 lens planes.
    (a) `make_distributed_z0_suite` against the single-device path on the
    same particles: the fast body's coarse pencil grid equal bit for bit to
    `auto_power_fast(return_coarse_grid=True)`'s (both through K1), P(k),
    B(k) against `bispectrum_3d` on that grid, kappa / gamma / the voids
    against `born_convergence`, `kappa_to_alpha` / `alpha_to_gamma`,
    `find_peaks` / `find_tunnels` on the same contiguous-slab planes;
    (b) `make_distributed_auto_power` (CIC through K2) and
    `make_distributed_multipoles` against `auto_power` and
    `auto_power_multipoles` of `paint` on the card; (c) `make_pfft3d`
    forward against `torch.fft.fftn` of a 256^3 field and the inverse's
    round trip; (d) `make_sharded_gaussian_filter` against
    `filters.gaussian` on a 2048^2 map; (e) `PowerSpectrum3D().
    power_from_points(mesh=)` of the positions as numpy, no `device`: one
    K1 launch (so on the card), (a)'s P(k) bit for bit; (f) K1-K4 held to
    the distributed calls' counts (K1 3: the suite, the fast body, the
    facade; K2 2: (b)), each part's seconds, peak memory; (g) a 4-rank gloo
    world on the host CPU (`_gloo_check`). Returns the numbers printed in
    `# distributed`."""
    import torch.distributed as dist

    from astrild_tpu_torch import suite
    from astrild_tpu_torch.models.power import PowerSpectrum3D
    from astrild_tpu_torch.ops import (bispectrum, filters, lensing, paint,
                                       paint_cuda, pairwise_cuda, peaks,
                                       power, voids)
    from astrild_tpu_torch.ops.profiles3d import _linspace_f32
    from astrild_tpu_torch.parallel import make_mesh
    from astrild_tpu_torch.parallel import maps as dmaps
    from astrild_tpu_torch.parallel import power as dpower
    from astrild_tpu_torch.parallel.pfft import make_pfft3d
    from astrild_tpu_torch.parallel.suite import make_distributed_z0_suite

    t_phase = time.perf_counter()
    seconds, launches = {}, {}
    stage = _stage_runner(seconds, launches)
    mesh = make_mesh(1, 1, 1, device="cuda")
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        raise AssertionError(f"distributed: a {dist.get_backend()} world on "
                             f"{mesh.device_type}, not NCCL on the card")
    n = N_SIDE ** 3
    pos = suite.uniform_positions(N_SIDE, BOX, dev, seed=seed)
    xyz = (pos[:n], pos[n:2 * n], pos[2 * n:])
    shot = BOX ** 3 / n
    nb_pk, nb_bk = suite.PK_BINS, suite.BISPEC_BINS
    gen = torch.Generator(device=dev).manual_seed(seed + 22)
    field = torch.randn((NGRID,) * 3, generator=gen, device=dev)
    img = torch.randn((NPIX, NPIX), generator=gen, device=dev)
    theta = math.degrees(suite.OPENING_ANGLE_RAD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the single-device references on the same inputs, before the counts
    # are cleared (their launches are comparisons)
    t0 = time.perf_counter()
    res, grid = power.auto_power_fast(xyz, NGRID, BOX, nbins=nb_pk,
                                      return_coarse_grid=True)
    bk = bispectrum.bispectrum_3d(grid, BOX, nbins=nb_bk,
                                  m_min=suite.BISPEC_M_MIN,
                                  m_max=suite.BISPEC_M_MAX)
    delta = grid / grid.mean() - 1.0
    planes = delta.reshape(NGRID, NGRID, NPLANES,
                           NGRID // NPLANES).sum(3).movedim(-1, 0)
    del delta
    chis = _linspace_f32(suite.CHI_NEAR, suite.CHI_FAR, NPLANES, dev)
    dchis = torch.full((NPLANES,), BOX / NPLANES, device=dev)
    kappa = lensing.born_convergence(planes, chis, dchis, suite.CHI_SOURCE,
                                     suite.OMEGA_M)
    a1, a2 = lensing.kappa_to_alpha(kappa, suite.OPENING_ANGLE_RAD,
                                    padding_factor=2)
    g1, g2 = lensing.alpha_to_gamma(a1, a2, suite.OPENING_ANGLE_RAD)
    cat = peaks.find_peaks(kappa, threshold=kappa.std(correction=0),
                           max_peaks=512, edge_pix=4)
    vcat = voids.find_tunnels(cat.pos.to(torch.float32),
                              cat.values > float("-inf"), NGRID,
                              max_voids=128)
    g = paint.paint(xyz, NGRID, BOX, window="cic")
    cic_ref = power.auto_power(g, BOX, nbins=nb_pk, window="cic",
                               shotnoise=shot)
    mul_ref = power.auto_power_multipoles(g, BOX, nbins=nb_pk, window="cic",
                                          shotnoise=shot)
    del g, a1, a2, planes
    fft_ref = torch.fft.fftn(field.to(torch.complex64))
    filt_ref = filters.gaussian(img, theta, sigma_arcmin=DIST_FILTER_SIGMA)
    pos_np = torch.stack(xyz, dim=1).cpu().numpy()
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()
    checks = {}

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    def of_max(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def check(name, err, bar):
        checks[name] = err
        if not err <= bar:
            raise AssertionError(f"distributed: {name} {err:.3e} > {bar}")

    # ---- (a) the composed suite against the single-device path
    fn = make_distributed_z0_suite(
        mesh, NGRID, BOX, nbins_pk=nb_pk, nbins_bk=nb_bk,
        bk_m_min=suite.BISPEC_M_MIN, bk_m_max=suite.BISPEC_M_MAX,
        nplanes=NPLANES, opening_angle_rad=suite.OPENING_ANGLE_RAD,
        chi_s=suite.CHI_SOURCE, omega_m=suite.OMEGA_M, chi0=suite.CHI_NEAR,
        chi1=suite.CHI_FAR)
    got = stage("suite", lambda: fn(xyz))
    body = stage("fast_body", lambda: dpower.fast_power_shard_body(
        xyz, torch.ones(n, device=dev), mesh=mesh, ngrid=NGRID, boxsize=BOX,
        nbins=nb_pk, fine_factor=2, return_coarse=True))
    if not torch.equal(body[1], grid):
        raise AssertionError("distributed: the fast body's coarse grid is "
                             "not the single-device deposit's")
    if not torch.equal(body[0].power, got.pk.power):
        raise AssertionError("distributed: the suite's P(k) is not its fast "
                             "body's")
    nm_d, nm_s = got.pk.nmodes, res.nmodes
    if not (torch.equal(nm_d[:-1], nm_s[:-1])
            and float(nm_s[-1] - nm_d[-1]) == 1.0):
        raise AssertionError(f"distributed: mode counts {nm_d.tolist()} "
                             f"against {nm_s.tolist()}")
    raw_d, raw_s = got.pk.power + shot, res.power + shot
    check("P(k) raw, rel", rel(raw_d[:-1], raw_s[:-1]), DIST_PK_RTOL)
    check("P(k) raw last bin, rel", rel(raw_d[-1:], raw_s[-1:]),
          DIST_PK_LAST_RTOL)
    closed = bk.ntri > 0
    check("ntri closed, rel", rel(got.bk.ntri[closed], bk.ntri[closed]),
          DIST_NTRI_RTOL)
    check("B closed, rel", rel(got.bk.b[closed], bk.b[closed]), DIST_BK_RTOL)
    if not torch.equal(torch.isnan(got.bk.b), torch.isnan(bk.b)):
        raise AssertionError("distributed: B's open triangles differ")
    for name, a, b in (("kappa", got.kappa, kappa),
                       ("gamma1", got.gamma1, g1),
                       ("gamma2", got.gamma2, g2)):
        check(f"{name}, of max", of_max(a, b), DIST_MAP_TOL)
    nv = int(vcat.n)
    if (int(got.n_voids) != nv
            or int(got.n_void_candidates) != int(vcat.n_candidates)):
        raise AssertionError(f"distributed: voids {int(got.n_voids)} / "
                             f"{int(got.n_void_candidates)} against {nv} / "
                             f"{int(vcat.n_candidates)}")
    check("void radii, rel", rel(got.void_radius[:nv], vcat.radius[:nv])
          if nv else 0.0, 1e-4)
    del body, grid, res, bk, kappa, g1, g2, vcat

    # ---- (b) CIC P(k) and multipoles through K2
    afn = dpower.make_distributed_auto_power(mesh, NGRID, BOX, nb_pk,
                                             window="cic")
    mfn = dpower.make_distributed_multipoles(mesh, NGRID, BOX, nb_pk,
                                             window="cic")
    cic = stage("auto_power", lambda: afn(xyz))
    mul = stage("multipoles", lambda: mfn(xyz))
    if not (torch.equal(cic.nmodes, cic_ref.nmodes)
            and torch.equal(mul.nmodes, mul_ref.nmodes)):
        raise AssertionError("distributed: CIC mode counts differ")
    check("CIC P(k), of shot",
          float((cic.power - cic_ref.power).abs().max()) / shot,
          DIST_SHOT_TOL)
    check("multipoles, of shot",
          float((mul.p_ell - mul_ref.p_ell).abs().max()) / shot,
          DIST_SHOT_TOL)

    # ---- (c) the pencil FFT on a 256^3 field
    fwd, inv = make_pfft3d(mesh), make_pfft3d(mesh, inverse=True)
    spec = stage("pfft", lambda: fwd(field))
    back = stage("pifft", lambda: inv(spec))
    check("pfft, of max", of_max(spec, fft_ref), DIST_FFT_TOL)
    check("pfft round trip, of max", of_max(back.real, field), DIST_FFT_TOL)
    del field, spec, back, fft_ref

    # ---- (d) the sharded Gaussian filter on a 2048^2 map
    sfn = dmaps.make_sharded_gaussian_filter(mesh, NPIX, theta,
                                             DIST_FILTER_SIGMA)
    smooth = stage("gaussian_filter", lambda: sfn(img))
    check("gaussian filter, of max", of_max(smooth, filt_ref), DIST_FFT_TOL)
    del img, smooth, filt_ref

    # ---- (e) the facade with numpy positions and no device
    _, p_facade = stage("facade", lambda: PowerSpectrum3D().power_from_points(
        pos_np, BOX, NGRID, nbins=nb_pk, method="fast", mesh=mesh))
    del pos_np
    if not np.array_equal(p_facade, got.pk.power.cpu().numpy()):
        raise AssertionError("distributed: the facade's P(k) is not the "
                             "suite's")

    # ---- (f) launches, seconds, memory
    predicted = {"suite": {"deposit_sorted": 1},
                 "fast_body": {"deposit_sorted": 1},
                 "auto_power": {"paint_windowed": 1},
                 "multipoles": {"paint_windowed": 1},
                 "pfft": {}, "pifft": {}, "gaussian_filter": {},
                 "facade": {"deposit_sorted": 1}}
    total = _held_launches("distributed", predicted, launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    card_s = time.perf_counter() - t_phase
    backend = dist.get_backend()
    dist.destroy_process_group()

    # ---- (g) 4 gloo ranks on the host CPU
    gloo = _gloo_check(seed)
    phase_s = time.perf_counter() - t_phase
    result = {"phase_s": phase_s, "card_s": card_s,
              "references_s": ref_s, "seconds": seconds,
              "launches": launches, "launches_total": total,
              "peak_mem_gb": peak_gb, "checks": checks,
              "bars": {"pk_rtol": DIST_PK_RTOL,
                       "pk_last_rtol": DIST_PK_LAST_RTOL,
                       "bk_rtol": DIST_BK_RTOL, "ntri_rtol": DIST_NTRI_RTOL,
                       "map": DIST_MAP_TOL,
                       "shot": DIST_SHOT_TOL, "fft": DIST_FFT_TOL},
              "n_voids": int(got.n_voids), "backend": backend,
              "gloo_cpu_check": gloo, "card": card}
    log(f"# phase distributed: {phase_s:.1f} s ({card_s:.1f} s on the card, "
        f"{gloo['seconds']:.1f} s the gloo CPU check); {backend} world of "
        f"one; "
        f"launches {total}; peak {peak_gb:.2f} GB; "
        + ", ".join(f"{k} {v:.2e}" for k, v in checks.items())
        + f"; {int(got.n_voids)} voids; {card}")
    log("# distributed " + json.dumps(result))
    return result


# the distributed phase, part B (23), on a world of one over NCCL: (a) the
# lens planes of (b)'s evolved particles (64 planes of 2048^2 from chi 200
# Mpc/h, one box length deep in all, over the suite's 0.35 rad field) and
# their HEALPix shells at nside 1024 (the lightcone lane's edges), both
# through K1 against the single-device functions (K1 in both, float
# atomics in both: WEIGHTED_TOL of the max); the suite and the ray trace
# of those planes (source at DB_CHI_S) and the multiplane tracer of the
# shells, painted again at DB_MP_NSIDE (the tracer's SHTs at nside 1024
# take ~20 s a run: a cut), against the single-device calls on the same
# inputs to DB_MAP_TOL of the max; (b) the distributed PM at the forward
# path's width (phase 7's ICs) against two single-device runs: positions
# within DB_GAP_FACTOR times the two runs' own gap (K2's float atomics;
# floor DB_GAP_FLOOR Mpc/h) and P(k) on NGRID^3 to DB_PK_TOL; (c) field
# inference at phase 20's chain width: the gradient against the
# single-device one within FI_GRAD_TOL (max, mean), the loss to 1e-5; (d)
# the m-sharded scalar and spin-2 transforms (DB_SHT: nside, lmax; cut
# from step 5's nside 1024 / lmax 2048, where the two paths took 37 s of
# a 74.5 s phase on an H100) against the unsharded scan path (one
# synthesis, analyze(niter=3)) to DB_SHT_TOL of the max; (e) the five
# rings at DB_RING_N tracers of (b)'s particles (the clustering lane's
# tile rows, bins and edges) against the single-device estimators: xi,
# wp, kSZ and shear xi to DB_RING_TOL (the same tiles), v12 against K3 at
# K3's bar
DB_CHI0, DB_CHI_S, DB_MP_NSIDE = 200.0, 800.0, 256
DB_FOV = 0.35  # the suite's field of view (suite.OPENING_ANGLE_RAD) [rad]
DB_MAP_TOL, DB_PK_TOL, DB_GAP_FACTOR, DB_GAP_FLOOR = 1e-5, 1e-3, 4.0, 1e-4
DB_SHT, DB_SHT_TOL = (512, 1024), 1e-6
DB_RING_N, DB_RING_TOL = 1 << 15, 1e-6
DB_THETA = (2.0, 40.0, 9)  # the shear xi's edges (geometric) [Mpc/h]
# (g) the 4-rank gloo check on the host CPU at the tests' small sizes
GLOO_B_TIMEOUT = 300


def _uncounted(fn):
    """(fn(), the kernel launches it made), the launch counts left as they
    were: the single-device reference runs of a phase."""
    from astrild_tpu_torch.ops import paint_cuda, pairwise_cuda

    saved = [(c, dict(c)) for c in (paint_cuda.LAUNCHES,
                                    pairwise_cuda.LAUNCHES)]
    try:
        res = fn()
        torch.cuda.synchronize()
        made = {}
        for c, before in saved:
            made.update({k: c[k] - before.get(k, 0) for k in c
                         if c[k] != before.get(k, 0)})
        return res, made
    finally:
        for c, before in saved:
            c.clear()
            c.update(before)


def _gloo_worker_b(rank: int, world: int, port: str, out: str,
                   seed: int) -> None:
    """(g)'s rank of part B: the rings, lens planes, shells, the ring- and
    m-sharded SHTs, the PM evolver and the field-inference gradient at the
    tests' small sizes on a gloo world of the host's CPU (4 ranks: the
    rings over 'sim' (4, 1, 1), the rest over (2, 2, 1) or (1, 2, 2); a
    world of one: (1, 1, 1)); rank r's replicated and assembled outputs
    into out/rank_r.npz."""
    torch.set_num_threads(1)
    from astrild_tpu_torch.parallel import field_infer as DF
    from astrild_tpu_torch.parallel import lensing as DL
    from astrild_tpu_torch.parallel import make_mesh, multihost
    from astrild_tpu_torch.parallel import nbody as DN
    from astrild_tpu_torch.parallel import pairwise as DPW
    from astrild_tpu_torch.parallel import sht as DS
    from astrild_tpu_torch.parallel import sht_large as DSL
    from astrild_tpu_torch.parallel import tpcf as DT
    from astrild_tpu_torch.parallel.mesh import shard, unshard
    from astrild_tpu_torch.utils.cosmology import Cosmology

    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    many = world > 1
    ring = make_mesh(*((4, 1, 1) if many else (1, 1, 1)), device="cpu")
    sims = make_mesh(*((2, 2, 1) if many else (1, 1, 1)), device="cpu")
    pencil = make_mesh(*((1, 2, 2) if many else (1, 1, 1)), device="cpu")
    rng = np.random.default_rng(seed + 23)
    res = {}

    def rows(x, mesh=ring, axis="sim"):
        return shard(x, mesh, (axis,) + (None,) * (x.dim() - 1))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    pos = t(rng.uniform(400, 600, (1024, 3)).astype(np.float32))
    vel = t(rng.normal(0, 100, (1024, 3)).astype(np.float32))
    res["v12"] = torch.stack(DPW.make_distributed_pairwise(
        ring, 16, 10.0, block=256)(rows(pos), rows(vel))).numpy()
    res["ksz"] = torch.stack(DPW.make_distributed_ksz(
        ring, 16, 10.0, block=256)(rows(pos), rows(vel[:, 0]))).numpy()
    box = t(rng.uniform(0, BOX / 5, (1024, 3)).astype(np.float32))
    res["xi"] = DT.make_distributed_tpcf_s_mu(
        ring, BOX / 5, np.linspace(1.0, 9.0, 9), nmu=10, block=128)(
        rows(box))[2].numpy()
    res["wp"] = DT.make_distributed_projected_tpcf(
        ring, BOX / 5, np.linspace(1.0, 6.0, 6), 8.0, n_pi=8, block=128)(
        rows(box))[1].numpy()
    e = t(rng.normal(0, 0.2, (2, 1024)).astype(np.float32))
    res["shear"] = torch.stack(DT.make_distributed_shear_xi(
        ring, np.geomspace(1.0, 9.0, 6), block=128, boxsize=BOX / 5)(
        rows(box[:, 0]), rows(box[:, 1]), rows(e[0]), rows(e[1]))).numpy()
    parts = t(rng.uniform(0, BOX, (4096, 3)).astype(np.float32))
    comps = tuple(rows(parts[:, i], sims) for i in range(3))
    res["planes"] = DL.make_distributed_lens_planes(
        sims, BOX, DB_CHI0, BOX / 8, 8, DB_FOV, 32)(comps)[0] \
        .numpy()
    res["shells"] = DL.make_distributed_healpix_shells(
        sims, np.linspace(*LC_EDGES), 8, BOX)(comps).numpy()
    nside, lmax = 8, 12
    tri = np.tril(np.ones((lmax + 1,) * 2, np.float32))
    a = t((rng.standard_normal((2, lmax + 1, lmax + 1)) * tri).astype(
        np.float32))
    synth, analyze = DS.make_distributed_sht(pencil, nside, lmax)
    plane = unshard(synth(a[0], a[1]), pencil, ("x", None))
    res["table_synth"] = plane[: 4 * nside - 1].numpy()  # the real rings
    res["table_analyze"] = torch.stack(analyze(plane, niter=2)).numpy()
    nside, lmax = 64, 160
    tri = np.tril(np.ones((lmax + 1,) * 2, np.float32))
    a = t((rng.standard_normal((4, lmax + 1, lmax + 1)) * tri * 0.1).astype(
        np.float32))
    synth, analyze = DSL.make_distributed_sht_large(pencil, nside, lmax)
    m = synth(a[0], a[1])
    res["sht_synth"] = m.numpy()
    res["sht_analyze"] = torch.stack(analyze(m, niter=1)).numpy()
    res["spin2_synth"] = torch.stack(DSL.make_distributed_sht_spin2_large(
        pencil, nside, lmax)[0](*a)).numpy()
    cosmo = Cosmology(Om0=0.3, h=0.7)
    ng, allax = 16, (("sim", "x", "y"),)
    pm = t(rng.uniform(0, BOX, (3, ng ** 3)).astype(np.float32))
    c, _ = DN.make_distributed_pm_evolve(pencil, ng, BOX, cosmo, 2)(
        tuple(shard(x, pencil, allax) for x in pm),
        tuple(torch.zeros(ng ** 3 // world) for _ in range(3)), 0.2, 1.0)
    res["pm"] = torch.stack([unshard(x, pencil, allax) for x in c]).numpy()
    fac = DF.make_distributed_field_infer(
        pencil, ng, BOX, lambda k: 2.0e3 * (k / 0.1) ** -1.5, cosmo,
        z_init=9.0, nsteps=2, window="cic")
    spec = ("x", "y", None)
    white = t(rng.standard_normal((ng,) * 3).astype(np.float32))
    data = unshard(fac.simulate(shard(white * 0.9, pencil, spec)), pencil,
                   spec)
    val, g = fac.value_and_grad(shard(white, pencil, spec),
                                shard(data, pencil, spec), 0.05)
    res["field_value"] = val.numpy()
    res["field_grad"] = unshard(g, pencil, spec).numpy()
    np.savez(os.path.join(out, f"rank_{rank}.npz"), **res)


def _gloo_check_b(seed: int) -> dict:
    """(g): a 4-rank gloo world and a world of one on the host CPU through
    `_gloo_worker_b`: the 4 ranks' outputs equal, and the 4-rank run held
    to the world of one (every ring hop, reduce-scatter, all-gather and
    psum of several ranks a world of one skips). Bars: the pair counts
    (xi, wp) and the m-sharded SHT (disjoint rows) equal; v12, kSZ and the
    shear sums 1e-5 relative (float32 partial sums in another order);
    planes, shells and the table SHT 1e-5 of the max; PM positions 1e-4
    Mpc/h (periodic); the field gradient 1e-4 relative L2, its value
    1e-6. A CPU check; no card time."""
    root = Path(__file__).resolve().parent / "build" / \
        f"distributed_b_gloo_{os.getpid()}"
    t0 = time.perf_counter()
    try:
        _gloo_worlds((4, 1), root, seed, "b", GLOO_B_TIMEOUT,
                     "distributed_b gloo")
        ranks = [dict(np.load(root / "world_4" / f"rank_{r}.npz"))
                 for r in range(4)]
        one = dict(np.load(root / "world_1" / "rank_0.npz"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    for r in ranks[1:]:
        for k, v in r.items():
            if not np.array_equal(v, ranks[0][k], equal_nan=True):
                raise AssertionError(f"distributed_b gloo (CPU check): {k} "
                                     "differs between ranks")
    got, errs = ranks[0], {}

    def hold(key, bar, how):
        a, b = got[key], one[key]
        if how == "equal":
            err = 0.0 if np.array_equal(a, b, equal_nan=True) else np.inf
        elif how == "rel":
            ok = np.isfinite(b) & (b != 0)
            err = float(np.max(np.abs(a[ok] - b[ok]) / np.abs(b[ok])))
        elif how == "max":
            err = float(np.max(np.abs(a - b)) / np.abs(b).max())
        elif how == "l2":
            err = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        else:
            d = np.abs((a - b + BOX / 2) % BOX - BOX / 2)
            err = float(d.max())
        errs[key] = err
        if not err <= bar:
            raise AssertionError(f"distributed_b gloo (CPU check): {key} "
                                 f"4 ranks against 1: {err:.3e} > {bar}")

    for key in ("xi", "wp", "sht_synth", "sht_analyze", "spin2_synth"):
        hold(key, 0.0, "equal")
    for key in ("v12", "ksz", "shear"):
        hold(key, 1e-5, "rel")
    for key in ("planes", "shells", "table_synth", "table_analyze"):
        hold(key, 1e-5, "max")
    hold("pm", 1e-4, "periodic")
    hold("field_grad", 1e-4, "l2")
    hold("field_value", 1e-6, "rel")
    log(f"#   distributed_b gloo (CPU check): torch {torch.__version__}, 4 "
        f"gloo ranks on the host CPU against a world of one, "
        f"{seconds:.1f} s; " + ", ".join(f"{k} {v:.2e}"
                                         for k, v in errs.items()))
    return {"seconds": seconds, "errors": errs}


def phase_distributed_b(dev, seed: int, card: str) -> dict:
    """The distributed layer, part B, on a world of one over NCCL
    (`make_mesh(1, 1, 1, device="cuda")`): (b) `make_distributed_pm_evolve`
    at the forward path's 512^3 in 500 Mpc/h, 20 KDK steps, GR, through K2
    (phase 7's ICs), against `nbody.pm_evolve`; (a) lens planes of its
    particles (64 of 2048^2) and HEALPix shells at nside 1024 through K1,
    against `density_planes_from_particles` and `density_shells_healpix`;
    `make_distributed_lensing_suite` and `_raytrace` on those planes,
    `_multiplane_healpix` on shells at DB_MP_NSIDE; (c)
    `make_distributed_field_infer` at phase 20's chain width (256^3, 10
    steps): one value_and_grad, K2 and its adjoint, against
    ops.field_infer's gradient; (d) the m-sharded scalar and spin-2 SHTs
    at DB_SHT (one synthesis, analyze(niter=3)) against the unsharded scan
    path; (e) the five rings at 2^15 tracers against the single-device
    estimators (v12 against K3); (f) each part's launches (K1 one a plane
    or shell flush, K2 nsteps + 1 an evolution and nsteps + 2 and its
    adjoint nsteps + 1 a gradient, K3 and K4 none), seconds and peak
    memory; (g) a 4-rank gloo world on the host CPU (`_gloo_check_b`).

    The port keeps the JAX guards (px > 1, py > 1): a world of one runs no
    ring hop, reduce-scatter or all-gather, and its psums are copies; (g)
    is this script's only run of them, on the CPU (one H100 cannot hold an
    NCCL world of two). Returns the numbers printed in `# distributed_b`.
    """
    import torch.distributed as dist

    from astrild_tpu_torch.ops import (field_infer, lens_planes, lensing,
                                       lightcone_sphere, linear_power, nbody,
                                       paint, paint_cuda, pairwise,
                                       pairwise_cuda, peaks, power,
                                       raytrace, shear_2pt, sht_large,
                                       sht_spin_large, tpcf, voids)
    from astrild_tpu_torch.parallel import field_infer as dfield
    from astrild_tpu_torch.parallel import lensing as dlensing
    from astrild_tpu_torch.parallel import make_mesh
    from astrild_tpu_torch.parallel import nbody as dnbody
    from astrild_tpu_torch.parallel import pairwise as dpairwise
    from astrild_tpu_torch.parallel import sht_large as dsht
    from astrild_tpu_torch.parallel import tpcf as dtpcf
    from astrild_tpu_torch.utils.cosmology import Cosmology

    t_phase = time.perf_counter()
    seconds, launches, refs = {}, {}, {}
    stage = _stage_runner(seconds, launches)
    mesh = make_mesh(1, 1, 1, device="cuda")
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        raise AssertionError(f"distributed_b: a {dist.get_backend()} world "
                             f"on {mesh.device_type}, not NCCL on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    paint_cuda.LAUNCHES.clear()
    pairwise_cuda.LAUNCHES.clear()
    predicted, checks = {}, {}

    def reference(name, fn):
        t0 = time.perf_counter()
        res, made = _uncounted(fn)
        refs[name] = {"s": time.perf_counter() - t0, "launches": made}
        return res

    def check(name, err, bar):
        checks[name] = err
        if not err <= bar:
            raise AssertionError(f"distributed_b: {name} {err:.3e} > {bar}")

    def flushes(name):
        """The K1 launches a part owes: its reference's flushes (the same
        keys, the same entry budget)."""
        return {"deposit_sorted": refs[name]["launches"].get(
            "deposit_sorted", 0)}

    def of_max(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def periodic(a, b, box):
        return max(float(((x - y + box / 2) % box - box / 2).abs().max())
                   for x, y in zip(a, b))

    # ---- (b) the distributed PM at the forward path's width
    gr = Cosmology(Om0=0.3, h=0.7)
    amp = linear_power.normalization(gr)

    def pk_fn(k):
        return linear_power.linear_power(k, gr, 0.0, amplitude=amp)

    gen = torch.Generator(device=dev).manual_seed(seed)
    comps, mom = reference("pm_ics", lambda: nbody.lpt_catalog(
        gen, PM_SIDE, BOX, pk_fn, gr, Z_INIT))
    a0 = 1.0 / (1.0 + Z_INIT)
    evolve = dnbody.make_distributed_pm_evolve(mesh, PM_SIDE, BOX, gr,
                                               PM_STEPS)
    dc, dm = stage("pm_evolve", lambda: evolve(comps, mom, a0, 1.0))
    predicted["pm_evolve"] = {"paint_windowed": PM_STEPS + 1}
    ref1 = reference("pm_evolve", lambda: nbody.pm_evolve(
        comps, mom, gr, PM_SIDE, BOX, a0, 1.0, PM_STEPS)[0])
    ref2 = reference("pm_evolve_again", lambda: nbody.pm_evolve(
        comps, mom, gr, PM_SIDE, BOX, a0, 1.0, PM_STEPS)[0])
    del comps, mom
    own = periodic(ref2, ref1, BOX)
    gap = periodic(dc, ref1, BOX)
    checks["pm positions own gap, Mpc/h"] = own
    check("pm positions, Mpc/h", gap, DB_GAP_FACTOR * own + DB_GAP_FLOOR)

    def pk(c):
        return power.auto_power(paint.paint(c, NGRID, BOX, window="cic"),
                                BOX, window="cic").power

    p_d, p_1 = reference("pm_pk", lambda: (pk(dc), pk(ref1)))
    check("pm P(k), rel", float(((p_d - p_1).abs() / p_1.abs()).max()),
          DB_PK_TOL)
    del ref1, ref2

    # ---- (a) lens planes and shells of (b)'s particles through K1
    dchi = BOX / NPLANES
    geo = (DB_CHI0, dchi, NPLANES, DB_FOV, NPIX)
    pfn = dlensing.make_distributed_lens_planes(mesh, BOX, *geo, axis="sim")
    delta, chis = stage("lens_planes", lambda: pfn(dc))
    want = reference("lens_planes", lambda: lens_planes
                     .density_planes_from_particles(dc, BOX, *geo)[0])
    predicted["lens_planes"] = flushes("lens_planes")
    check("lens planes, of max", of_max(delta, want), WEIGHTED_TOL)
    edges = np.linspace(*LC_EDGES)
    sfn = dlensing.make_distributed_healpix_shells(mesh, edges, LC_NSIDE,
                                                   BOX, axis="sim")
    shells = stage("shells", lambda: sfn(dc))
    want = reference("shells", lambda: lightcone_sphere
                     .density_shells_healpix(dc, edges, LC_NSIDE, BOX)[0])
    predicted["shells"] = flushes("shells")
    check("shells, of max", of_max(shells, want), WEIGHTED_TOL)
    del shells, want
    dchis = torch.full((NPLANES,), dchi, device=dev)
    suite_fn = dlensing.make_distributed_lensing_suite(
        mesh, NPIX, DB_FOV, DB_CHI_S, 0.3)
    got = stage("lensing_suite", lambda: suite_fn(delta[None], chis, dchis))
    predicted["lensing_suite"] = {}

    def one_sim():
        kap = lensing.born_convergence(delta, chis, dchis, DB_CHI_S, 0.3)
        a1, a2 = lensing.kappa_to_alpha(kap, DB_FOV,
                                        padding_factor=2)
        g1, g2 = lensing.alpha_to_gamma(a1, a2, DB_FOV)
        cat = peaks.find_peaks(kap, threshold=kap.std(correction=0),
                               max_peaks=1024, edge_pix=4)
        vc = voids.find_tunnels(cat.pos.to(torch.float32),
                                cat.values > float("-inf"), NPIX,
                                max_voids=128)
        return kap, g1, g2, vc

    kap, g1, g2, vc = reference("lensing_suite", one_sim)
    for name, a, b in (("kappa", got.kappa[0], kap),
                       ("gamma1", got.gamma1[0], g1),
                       ("gamma2", got.gamma2[0], g2)):
        check(f"suite {name}, of max", of_max(a, b), DB_MAP_TOL)
    nv = int(vc.n)
    if int(got.n_voids[0]) != nv:
        raise AssertionError(f"distributed_b: {int(got.n_voids[0])} voids "
                             f"against {nv}")
    check("suite void radii, of max", of_max(got.void_radius[0][:nv],
                                             vc.radius[:nv])
          if nv else 0.0, DB_MAP_TOL)
    n_voids = nv
    del got, kap, g1, g2, vc
    rfn = dlensing.make_distributed_raytrace(mesh, DB_CHI_S, 0.3,
                                             DB_FOV)
    got = stage("raytrace", lambda: rfn(delta[None], chis, dchis))
    predicted["raytrace"] = {}
    want = reference("raytrace", lambda: raytrace.multiplane_raytrace(
        delta, chis, dchis, DB_CHI_S, 0.3, DB_FOV))
    for name in ("kappa", "gamma1", "gamma2", "omega"):
        check(f"raytrace {name}, of max", of_max(got[name][0], want[name]),
              DB_MAP_TOL)
    del got, want, delta
    mp_fn = dlensing.make_distributed_multiplane_healpix(mesh, DB_MP_NSIDE,
                                                         0.3)
    shells_mp = stage("shells_mp", lambda: dlensing
                      .make_distributed_healpix_shells(
                          mesh, edges, DB_MP_NSIDE, BOX, axis="sim")(dc))
    want = reference("shells_mp", lambda: lightcone_sphere
                     .density_shells_healpix(dc, edges, DB_MP_NSIDE, BOX)[0])
    predicted["shells_mp"] = flushes("shells_mp")
    check("shells for the tracer, of max", of_max(shells_mp, want),
          WEIGHTED_TOL)
    s_chis = 0.5 * (edges[1:] + edges[:-1])
    s_dchis = np.diff(edges)
    got = stage("multiplane_healpix", lambda: mp_fn(
        shells_mp, s_chis, s_dchis, LC_SHELL_SOURCE))
    predicted["multiplane_healpix"] = {}
    want = reference("multiplane_healpix", lambda: lightcone_sphere
                     .multiplane_raytrace_healpix(shells_mp, s_chis, s_dchis,
                                                  LC_SHELL_SOURCE, 0.3))
    for name in ("kappa", "gamma1", "gamma2", "omega"):
        check(f"multiplane {name}, of max", of_max(got[name], want[name]),
              DB_MAP_TOL)
    del got, want, shells_mp

    # ---- (e) the rings at 2^15 tracers of (b)'s particles
    sub = torch.randperm(PM_SIDE ** 3, generator=gen, device=dev)[:DB_RING_N]
    tr = torch.stack([c[sub] for c in dc], dim=1)
    tv = torch.stack([100.0 * p[sub] for p in dm], dim=1)
    del dc, dm
    e12 = torch.randn((2, DB_RING_N), generator=gen, device=dev) * 0.2
    nb, bw = V12_BINS[2], (V12_BINS[1] - V12_BINS[0]) / (V12_BINS[2] - 1)
    s_edges = np.linspace(*CL_S_EDGES)
    rp_edges = np.linspace(*CL_RP_EDGES)
    theta = np.geomspace(*DB_THETA)
    blk = CL_BLOCK
    rings = {
        "v12": lambda: dpairwise.make_distributed_pairwise(
            mesh, nb, bw, block=blk)(tr, tv),
        "ksz": lambda: dpairwise.make_distributed_ksz(
            mesh, nb, bw, block=blk)(tr, tv[:, 0].contiguous()),
        "xi": lambda: dtpcf.make_distributed_tpcf_s_mu(
            mesh, BOX, s_edges, nmu=CL_NMU, block=blk)(tr)[2],
        "wp": lambda: dtpcf.make_distributed_projected_tpcf(
            mesh, BOX, rp_edges, CL_PI_MAX, n_pi=CL_N_PI, block=blk)(tr)[1],
        "shear": lambda: dtpcf.make_distributed_shear_xi(
            mesh, theta, block=blk, boxsize=BOX)(
            tr[:, 0].contiguous(), tr[:, 1].contiguous(), e12[0], e12[1])}
    ring_out = {}
    for name, fn in rings.items():
        ring_out[name] = stage(f"ring_{name}", fn)
        predicted[f"ring_{name}"] = {}
    bins = np.arange(nb) * bw
    nom_k, den_k = reference("ring_v12", lambda: pairwise_cuda
                             .pairwise_accumulate(tr, tv, DB_RING_N, bw, nb))
    counts = _pair_counts(tr, DB_RING_N, bw, nb)
    full = counts >= K3_MIN_PAIRS
    for what, g, w in zip(("nom", "den"), ring_out["v12"], (nom_k, den_k)):
        diff = (g - w).abs()
        bound = torch.where(full, K3_RTOL * w.abs() + 1e-6 * w.abs().max(),
                            K3_RTOL * w.abs().max())
        checks[f"ring v12 {what} against K3, of max"] = float(
            diff.max() / w.abs().max())
        if bool((diff > bound).any()):
            raise AssertionError(f"distributed_b: the v12 ring's {what} "
                                 f"against K3: {g.tolist()} {w.tolist()}")
    p_ring = ring_out["ksz"][0] / ring_out["ksz"][1].clamp_min(1e-30)
    want = reference("ring_ksz", lambda: pairwise.pairwise_ksz_momentum(
        tr, tv[:, 0].contiguous(), bins, block=blk)[1])
    ok = torch.isfinite(want)
    check("ring ksz, rel", float(((p_ring - want).abs()
                                  / want.abs().clamp_min(1e-30))[ok].max()),
          DB_RING_TOL)
    want = reference("ring_xi", lambda: tpcf.tpcf_s_mu(
        tr, BOX, s_edges, nmu=CL_NMU, block=blk)[2])
    ok = torch.isfinite(want)
    check("ring xi, of max", of_max(ring_out["xi"][ok], want[ok]),
          DB_RING_TOL)
    want = reference("ring_wp", lambda: tpcf.projected_tpcf(
        tr, BOX, rp_edges, CL_PI_MAX, n_pi=CL_N_PI, block=blk)[1])
    check("ring wp, of max", of_max(ring_out["wp"], want), DB_RING_TOL)
    want = reference("ring_shear", lambda: shear_2pt.xi_pm_catalog(
        tr[:, 0], tr[:, 1], e12[0], e12[1], theta, boxsize=BOX, block=blk))
    for k, name in enumerate(("xi_plus", "xi_minus", "npairs")):
        check(f"ring shear {name}, of max",
              of_max(ring_out["shear"][k], want[k]), DB_RING_TOL)
    del tr, tv, e12, ring_out, want

    # ---- (c) field inference at phase 20's chain width
    n2, box2, nsteps2, noise2 = FI_FULL
    kw2 = dict(z_init=Z_INIT, nsteps=nsteps2, window="cic")
    gen2 = torch.Generator(device=dev).manual_seed(seed + 23)
    truth2 = torch.randn((n2,) * 3, generator=gen2, device=dev)

    def full_data():
        with torch.no_grad():
            d = field_infer.simulate_density(truth2, pk_fn, gr, ngrid=n2,
                                             boxsize=box2, **kw2)
        return d + math.sqrt(noise2) * torch.randn(
            d.shape, generator=gen2, device=dev)

    data2 = reference("field_data", full_data)
    w0 = 0.7 * truth2 + 0.3 * torch.randn((n2,) * 3, generator=gen2,
                                          device=dev)
    del truth2
    fac = dfield.make_distributed_field_infer(mesh, n2, box2, pk_fn, gr,
                                              **kw2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    val_d, g_d = stage("field_grad", lambda: fac.value_and_grad(
        w0, data2, noise2))
    field_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    predicted["field_grad"] = {"paint_windowed": nsteps2 + 2,
                               "paint_windowed_adjoint": nsteps2 + 1}

    def single():
        w = w0.clone().requires_grad_(True)
        loss = field_infer.field_nll(w, data2, noise2, pk_fn, gr,
                                     boxsize=box2, **kw2)
        (g,) = torch.autograd.grad(loss, w)
        return float(loss.detach()), g

    val_1, g_1 = reference("field_grad", single)
    _, g_2 = reference("field_grad_again", single)
    del data2, w0

    def grad_gap(a, b):
        d = (a - b).abs()
        return (float(d.max() / b.abs().max()),
                float(d.double().mean() / b.abs().double().mean()))

    own = grad_gap(g_2, g_1)
    gap = grad_gap(g_d, g_1)
    checks["field grad own gap (max, mean)"] = own
    checks["field grad (max, mean)"] = gap
    check("field loss, rel", abs(float(val_d) - val_1) / abs(val_1), 1e-5)
    if not all(a <= t for a, t in zip(gap, FI_GRAD_TOL)):
        raise AssertionError(f"distributed_b: the field gradient {gap} "
                             f"(max, mean) off the single-device one (bars "
                             f"{FI_GRAD_TOL}; its own gap {own})")
    del g_d, g_1, g_2

    # ---- (d) the m-sharded SHTs
    nside, lmax = DB_SHT
    lg = torch.arange(lmax + 1, device=dev)[:, None]
    keep = torch.tril(torch.ones((lmax + 1,) * 2, device=dev))
    alms = [torch.randn((lmax + 1,) * 2, generator=gen, device=dev) * keep
            * 0.1 for _ in range(4)]
    for a in (alms[1], alms[3]):
        a[:, 0] = 0.0
    eb_in = [a * (lg >= 2) for a in alms]
    synth, analyze = dsht.make_distributed_sht_large(mesh, nside, lmax)
    s2, a2 = dsht.make_distributed_sht_spin2_large(mesh, nside, lmax)
    m = stage("sht_synth", lambda: synth(alms[0], alms[1]))
    back = stage("sht_analyze", lambda: analyze(m, niter=3))
    q, u = stage("sht_spin2_synth", lambda: s2(*eb_in))
    eb = stage("sht_spin2_analyze", lambda: a2(q, u, niter=3))
    for name in ("sht_synth", "sht_analyze", "sht_spin2_synth",
                 "sht_spin2_analyze"):
        predicted[name] = {}
    # the unsharded scan path on the same inputs
    for name, got, fn in (
            ("sht_synth", (m,), lambda: (sht_large.synthesize_large(
                alms[0], alms[1], nside, lmax),)),
            ("sht_analyze", back, lambda: sht_large.analyze_large(
                m, nside, lmax, niter=3)),
            ("sht_spin2_synth", (q, u), lambda: sht_spin_large
             .synthesize_spin2_large(*eb_in, nside, lmax)),
            ("sht_spin2_analyze", eb, lambda: sht_spin_large
             .analyze_spin2_large(q, u, nside, lmax, niter=3))):
        want = reference(name, fn)
        check(f"{name}, of max", max(of_max(a, b) for a, b in zip(got, want)),
              DB_SHT_TOL)
    del m, back, q, u, eb, want, alms, eb_in

    # ---- (f) launches, seconds, memory
    total = _held_launches("distributed_b", predicted, launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    card_s = time.perf_counter() - t_phase
    backend = dist.get_backend()
    dist.destroy_process_group()

    # ---- (g) 4 gloo ranks on the host CPU
    gloo = _gloo_check_b(seed)
    phase_s = time.perf_counter() - t_phase
    result = {"phase_s": phase_s, "card_s": card_s, "seconds": seconds,
              "references": refs, "launches": launches,
              "launches_total": total, "peak_mem_gb": peak_gb,
              "field_grad_peak_mem_gb": field_peak_gb, "checks": checks,
              "bars": {"map": DB_MAP_TOL, "weighted": WEIGHTED_TOL,
                       "pk": DB_PK_TOL, "gap_factor": DB_GAP_FACTOR,
                       "gap_floor": DB_GAP_FLOOR, "grad": FI_GRAD_TOL,
                       "sht": DB_SHT_TOL, "ring": DB_RING_TOL,
                       "k3_rtol": K3_RTOL},
              "sizes": {"pm": [PM_SIDE, PM_STEPS], "planes": [NPLANES, NPIX],
                        "shells_nside": LC_NSIDE,
                        "multiplane_nside": DB_MP_NSIDE,
                        "field": list(FI_FULL), "sht": list(DB_SHT),
                        "ring_tracers": DB_RING_N},
              "n_voids": n_voids, "backend": backend,
              "gloo_cpu_check": gloo, "card": card}
    log(f"# phase distributed_b: {phase_s:.1f} s ({card_s:.1f} s on the "
        f"card, {gloo['seconds']:.1f} s the gloo CPU check); {backend} world "
        f"of one; launches {total}; peak {peak_gb:.2f} GB; "
        + ", ".join(f"{k} {v}" for k, v in seconds.items()) + f"; {card}")
    log("# distributed_b " + json.dumps(result))
    return result


# the least time of a kernel's work: its bytes over the card's memory rate,
# its operations over float32 outside the tensor cores (H100 SXM, NVIDIA's
# data sheet); the larger bounds it
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# K2's float32 operations per particle: CIC / TSC key and fraction
# arithmetic (~6-7 a coordinate), the axis weights, their products and one
# add per deposited cell (8 or 27)
K2_OPS = {2: 44, 3: 111}
# K2's adjoint's per particle: a cell read takes the weights' product and
# four products summed (15), over 8 or 27 cells; the fractions, the axis
# weights and their derivatives, the divisions by h (~30 / ~50)
K2_ADJ_OPS = {2: 150, 3: 455}
# K3's float32 operations per in-range pair, counted from the kernel's
# add_pair and its caller: s (3 sub, 3 mul, 2 add) 8, sqrt 1, the division
# 1, 1 / max(dist, 1e-12) 2, rhat 3, rhat.phat_i and rhat.phat_j 5 each,
# q 6 a component 18, v_i - v_j 3, nom 5, den 5, the two sums 2: 58. A
# pair beyond the last bin needs nothing. The TPU kernel's design works on
# every pair; its bound (bound_all_pairs_ms) counts 20 operations a pair
# (the distance, its bin, the radial velocity and the two sums) over all
# n(n-1)/2 pairs
K3_OPS_PER_IN_RANGE_PAIR = 58
K3_OPS_PER_PAIR = 20


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_k3_timing(pos, vel, binw: float, nbins: int, err: float,
                    in_range: int) -> dict:
    """K3 vs its plain version on the main path's tracers (2^17 drawn from
    the GR snapshot), in turns (plain, kernel, kernel); with the device time of K3's parts (the
    wrapper's ordering and boxes, the pair kernel with its walk, the
    reduction) in one traced call, and the tile pairs visited, the pairs
    they hold and the in-range pairs."""
    from torch.profiler import ProfilerActivity, profile

    from astrild_tpu_torch.ops import pairwise_cuda

    n = pos.shape[0]
    fns = {
        "kernel": lambda: pairwise_cuda.pairwise_accumulate(pos, vel, n,
                                                            binw, nbins),
        "plain": lambda: pairwise_cuda.pairwise_accumulate_reference(
            pos, vel, n, binw, nbins, block=K3_PLAIN_BLOCK),
    }
    reps = {"kernel": 10, "plain": 1}
    ms = {k: [] for k in fns}
    # the plain version (15-21 s a call here) runs one turn, the kernel two
    for turn in (["plain", "kernel"], ["kernel"]):
        for name in turn:
            ms[name].append(_event_ms(fns[name], reps[name]))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fns["kernel"]()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    parts = {"pair_tiles": 0.0, "reduce_partials": 0.0, "torch_ops": 0.0}
    for e in rows:
        part = next((p for p in parts if f"{p}_kernel" in e.key),
                    "torch_ops")
        parts[part] += e.self_device_time_total / 1e3
    plan = pairwise_cuda.plan_stats(
        pairwise_cuda.plan(pos, vel, n, binw, nbins), nbins)
    stats = {"max_abs_err": err,
             "mean": {k: sum(v) / len(v) for k, v in ms.items()},
             "turns": ms, "parts_ms": parts, **plan,
             "in_range_pairs": in_range, "all_pairs": n * (n - 1) // 2}
    log("# k3_timing_ms " + json.dumps({"n": n, "nbins": nbins,
                                        "plain_block": K3_PLAIN_BLOCK,
                                        **stats}))
    return stats


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5,
                    help="timed runs of the suite after one warm-up")
    ap.add_argument("--gloo-worker", nargs=4,
                    metavar=("RANK", "WORLD", "PORT", "OUT"),
                    help="run one rank of phase 22's or 23's gloo check on "
                         "the CPU (started by the phase itself)")
    ap.add_argument("--gloo-part", choices=("a", "b"), default="a",
                    help="the gloo check a rank runs: a phase 22's, b phase "
                         "23's")
    ap.add_argument("--only", choices=("distributed_b",),
                    help="run the device check, the build and this phase "
                         "alone (a first check of a new phase); no kernels "
                         "line")
    args = ap.parse_args()
    if args.gloo_worker:
        rank, world, port, out = args.gloo_worker
        worker = _gloo_worker_b if args.gloo_part == "b" else _gloo_worker
        worker(int(rank), int(world), port, out, args.seed)
        return

    card = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    if args.only:
        phase_distributed_b(dev, args.seed, card)
        log(card)
        return
    phase_kernel_check(dev, args.seed)
    phase_k2_check(dev, args.seed)
    phase_k3_check(dev, args.seed)
    phase_k4_check(dev, args.seed)
    suite_launches = phase_suite(dev, args.seed, args.runs)
    err_bench, k1 = phase_timing(dev, args.seed)
    fwd_launches, (out_gr, mom_gr), k3_inputs = phase_forward(dev, args.seed)
    k2 = phase_k2_timing(out_gr)["cic"]
    lane_launches, k4_err, lane_keys = phase_file_lane(dev, args.seed,
                                                       out_gr, mom_gr)
    lightcone, kappa_map = phase_lightcone(dev, args.seed, out_gr)
    clustering = phase_clustering(dev, args.seed, out_gr, mom_gr,
                                  k3_inputs[:2])
    galaxy, so_cat = phase_galaxy_mocks(dev, args.seed, out_gr, kappa_map)
    phase_shear_survey(dev, args.seed, kappa_map)
    theory = phase_theory(dev, args.seed)
    mapping = phase_map_analysis(dev, args.seed, kappa_map, so_cat, out_gr,
                                 mom_gr)
    moving = phase_moving_lens(dev, args.seed, so_cat,
                               mapping.pop("halo_velocities"), kappa_map,
                               out_gr)
    del mom_gr, kappa_map, so_cat
    mg = phase_mg_master_inference(dev, args.seed)
    full_sky = phase_full_sky(dev, args.seed, out_gr,
                              lightcone["shells_flushes"])
    snapshot = [out_gr]
    del out_gr
    cmb_lensing = phase_cmb_lensing(dev, args.seed, snapshot,
                                    lightcone["shells_flushes"])
    field = phase_field_inference(dev, args.seed)
    file_path = phase_file_path(dev, args.seed, card)
    distributed = phase_distributed(dev, args.seed, card)
    distributed_b = phase_distributed_b(dev, args.seed, card)
    k4 = phase_k4_timing(*lane_keys)["file"]
    del lane_keys
    k3 = phase_k3_timing(*k3_inputs)

    # max_abs_err, ms, plain_ms and library_ms are taken at the main paths'
    # shapes, the bounds from the same inputs: K1 counts of the suite's 2^27
    # keys as they come into 2^27 cells (deposit_flat, what the suite
    # runs), K2 CIC of 2^27 particles onto 512^3
    # (a PM force paint), K3 v12 of 2^17 tracers, K4 counts of the lane's
    # 2^27 file-order keys into 2^27 cells
    n_keys, n_fine = N_SIDE ** 3, 8 * NGRID ** 3
    n_pm, n_tr = PM_SIDE ** 3, V12_N
    measured = {
        "deposit_sorted": (
            suite_launches["deposit_sorted"], err_bench, k1["mean"]["flat"],
            k1["mean"]["plain"], bound_ms(4 * n_keys + 4 * n_fine, n_keys),
            k1["mean"]["index_add_unsorted"]),
        "paint_windowed": (
            fwd_launches["paint_windowed"], k2["max_abs_err"],
            k2["mean"]["kernel"], k2["mean"]["plain"],
            bound_ms(12 * n_pm + 4 * PM_SIDE ** 3, K2_OPS[2] * n_pm), None),
        "pairwise_accumulate": (
            fwd_launches["pairwise_accumulate"], k3["max_abs_err"],
            k3["mean"]["kernel"], k3["mean"]["plain"],
            bound_ms(24 * n_tr + 8 * V12_BINS[2],
                     K3_OPS_PER_IN_RANGE_PAIR * k3["in_range_pairs"]),
            None),
        "deposit_segmented": (
            lane_launches["deposit_segmented"], k4_err, k4["mean"]["kernel"],
            k4["mean"]["plain"],
            bound_ms(4 * n_pm + 4 * 8 * LANE_NGRID ** 3, n_pm),
            k4["mean"]["index_add"]),
        # K2's adjoint: its launches in phase 20's gradients, timed at the
        # full-width gradient's shape (2^24 z = 0 particles, 256^3 CIC)
        "paint_windowed_adjoint": (
            field["launches_total"].get("paint_windowed_adjoint", 0),
            field["adjoint_timing_ms"]["max_abs_err"],
            field["adjoint_timing_ms"]["mean"]["kernel"],
            field["adjoint_timing_ms"]["mean"]["plain"],
            (field["adjoint_timing_ms"]["bound_ms"],
             field["adjoint_timing_ms"]["bound_by"]), None),
    }
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1], "launches": n,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library}
               for name, (n, err, ms, plain, bound, library)
               in measured.items()]
    # K3's bound under the TPU kernel's design (all pairs), comparable with
    # the bound earlier measurements gave
    k3_row = next(k for k in kernels if k["name"] == "pairwise_accumulate")
    k3_row["bound_all_pairs_ms"] = bound_ms(
        24 * n_tr, K3_OPS_PER_PAIR * n_tr * (n_tr - 1) / 2)[0]
    # K1's two entry points at the three shapes (the suite's keys, the
    # farthest plane's weighted entries, one box image's shell keys), each
    # beside index_add_ of the same keys, and the lightcone lane's launches
    k1_row = next(k for k in kernels if k["name"] == "deposit_sorted")
    shapes = {"suite": k1, "plane": lightcone["k1_plane_timing_ms"],
              "shell": lightcone["k1_shell_timing_ms"]}
    k1_row["entry_points"] = {
        entry: {shape: {"n_keys": t["n_keys"], "n_cells": t["n_cells"],
                        "weighted": t["weighted"], "ms": t["mean"][kind],
                        "plain_ms": t["mean"]["plain"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["mean"][f"index_add_{order}"]}
                for shape, t in shapes.items()}
        for entry, kind, order in (("deposit_flat", "flat", "unsorted"),
                                   ("deposit_sorted", "sorted", "sorted"))}
    k1_row["lightcone"] = {
        "planes_launches": lightcone["launches"]["deposit_sorted"],
        "shells_launches": lightcone["shells_launches"]["deposit_sorted"]}
    k2_row = next(k for k in kernels if k["name"] == "paint_windowed")
    k2_row["lightcone_launches"] = lightcone["launches"]["paint_windowed"]
    # the clustering lane's shape: weighted CIC of 2^27 particles onto 256^3
    cl_k2 = clustering["k2_timing_ms"]
    k2_row["clustering"] = {
        "launches": clustering["launches_total"]["paint_windowed"],
        "n": cl_k2["n"], "ngrid": cl_k2["ngrid"], "weighted": True,
        "max_abs_err": cl_k2["max_abs_err"], "ms": cl_k2["mean"]["kernel"],
        "plain_ms": cl_k2["mean"]["plain"], "bound_ms": cl_k2["bound_ms"],
        "bound_by": cl_k2["bound_by"], "library_ms": None}
    k3_row["clustering_launches"] = clustering["launches_total"][
        "pairwise_accumulate"]
    # the galaxy-mocks path's shapes: CIC counts of its galaxies onto
    # 128^3 and of the 2^27-particle snapshot onto 768^3
    k2_row["galaxy_mocks"] = {
        "launches": galaxy["launches_total"]["paint_windowed"],
        **{shape: {"n": t["n"], "ngrid": t["ngrid"], "weighted": False,
                   "max_abs_err": t["max_abs_err"], "ms": t["mean"]["kernel"],
                   "plain_ms": t["mean"]["plain"], "bound_ms": t["bound_ms"],
                   "bound_by": t["bound_by"], "library_ms": None}
           for shape, t in galaxy["k2_timing_ms"].items()}}
    # the theory path's shapes: CIC counts of the RSD mocks, 2^18 onto
    # 64^3 and 2^24 onto 256^3
    k2_row["theory"] = {
        "launches": theory["launches_total"]["paint_windowed"],
        **{shape: {"n": t["n"], "ngrid": t["ngrid"], "weighted": False,
                   "max_abs_err": t["max_abs_err"], "ms": t["mean"]["kernel"],
                   "plain_ms": t["mean"]["plain"], "bound_ms": t["bound_ms"],
                   "bound_by": t["bound_by"], "library_ms": None}
           for shape, t in theory["k2_timing_ms"].items()}}
    # the map-analysis path's shapes: the example's TSC and CIC paints of
    # 2^18 particles onto 128^3, the SO halos' mass-weighted TSC onto
    # 256^3, the 2^27-particle snapshot onto 256^3; K3 on the SO halos
    k2_row["map_analysis"] = {
        "launches": mapping["launches_total"]["paint_windowed"],
        **{shape: {"n": t["n"], "ngrid": t["ngrid"], "order": t["order"],
                   "weighted": t["weighted"],
                   "max_abs_err": t["max_abs_err"], "ms": t["mean"]["kernel"],
                   "plain_ms": t["mean"]["plain"], "bound_ms": t["bound_ms"],
                   "bound_by": t["bound_by"], "library_ms": None}
           for shape, t in mapping["k2_timing_ms"].items()}}
    t = mapping["k3_timing_ms"]
    k3_row["map_analysis"] = {
        "launches": mapping["launches_total"]["pairwise_accumulate"],
        "n": t["n"], "nbins": t["nbins"], "max_abs_err": t["max_abs_err"],
        "ms": t["mean"]["kernel"], "plain_ms": t["mean"]["plain"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None}
    # the moving-lens, SZ and ISW path launches no kernel
    for row in kernels:
        row["moving_lens_launches"] = moving["launches_total"].get(
            row["name"], 0)
    # the modified-gravity, MASTER and inference phase: K2 paints both PM
    # evolutions and their P(k); K1, K3 and K4 launch 0 times there
    for row in kernels:
        row["mg_master_inference_launches"] = mg["launches_total"].get(
            row["name"], 0)
    # the full-sky phase: K1 deposits the Born map's HEALPix shells; K2-K4
    # launch 0 times there
    for row in kernels:
        row["full_sky_launches"] = full_sky["launches_total"].get(
            row["name"], 0)
    # the CMB-lensing phase: K1 deposits its HEALPix shells; K2-K4 launch
    # 0 times there
    for row in kernels:
        row["cmb_lensing_launches"] = cmb_lensing["launches_total"].get(
            row["name"], 0)
    # the field-inference phase: K2 and its adjoint in every gradient, K1
    # in the lightcone's planes; K3 and K4 launch 0 times there
    for row in kernels:
        row["field_inference_launches"] = field["launches_total"].get(
            row["name"], 0)
    # the file path: K2 paints the grav cells, K3 meets the native oracle;
    # K1, K4 and K2's adjoint launch 0 times there
    for row in kernels:
        row["file_path_launches"] = file_path["launches_total"].get(
            row["name"], 0)
    # the distributed phase: K1 in the fast body (the suite, the body alone,
    # the facade), K2 in the CIC P(k) and multipoles; K3, K4 and K2's
    # adjoint launch 0 times there
    for row in kernels:
        row["distributed_launches"] = distributed["launches_total"].get(
            row["name"], 0)
    # the distributed phase, part B: K1 once a plane and shell flush, K2
    # nsteps + 1 in the PM evolution and nsteps + 2 in the field gradient,
    # K2's adjoint nsteps + 1 there; K3 and K4 0 (the rings run the plain
    # tiles)
    for row in kernels:
        row["distributed_b_launches"] = distributed_b["launches_total"].get(
            row["name"], 0)
    adj = field["adjoint_timing_ms"]
    adj_row = next(k for k in kernels if k["name"] == "paint_windowed_adjoint")
    adj_row.update({"n": adj["n"], "ngrid": adj["ngrid"],
                    "plain": "autograd through paint_windowed_reference",
                    "bound_cell_reads_ms": adj["bound_cell_reads_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
