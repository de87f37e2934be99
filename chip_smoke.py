#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``s2p_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, ``nvcc`` (CUDA_HOME, PATH or /usr/local/cuda) and the
packages torch, numpy and scipy; it imports nothing of JAX and nothing of
the JAX package.  Phases, each timed on a line of its own:

  1. device: the card's name and power limit (nvidia-smi), torch's version;
  2. build: the native TIFF reader (g++, its seconds), then the CUDA
     kernels, one nvcc per source in parallel, into
     s2p_tpu_torch/_build/; ptxas's register, shared-memory and stack
     lines, and a check that every instantiation of the scan kernel up to
     4096 candidates (K2 and K4a), of the pre-pass (K1), of the
     averaged-MGM scan (K4b, both instantiations), of the WTA with the
     right-reference map (K5, its three instantiations), of the warp
     (W1, orders 1, 3 and 5) and of msmw's window costs (B1) has a 0-byte
     stack frame and no spill;
 2b. W1's division by 120 (a multiply and two fused multiply-adds behind
     a guard on |x|) against the IEEE division on all 2^32 float32 bit
     patterns: 0 mismatches among non-NaN results;
 2c. B1's division by a window's count mean (the product by its
     reciprocal, corrected once, behind a guard on |x|) against the IEEE
     division, for each of the 110 count means and all 2^32 float32
     numerators: 0 mismatches;
  3. kernels of the mgm flow (stage 4) against their plain PyTorch
     versions on the card, on the inputs the main path gives them at
     bucket A's shapes (the cost pre-pass, the four scan passes of each
     side, the WTA), and once more at bucket B's and at 528 candidates
     (one 64 x 896 tile), compared bitwise and NaN-aware, each timed with
     CUDA events; then the scan per bucket as the flow launches it, both
     sides' four chains of passes at once on side streams, bitwise
     against the passes one by one and timed beside the same passes on
     one stream; then every kernel against its plain version at
     adversarial shapes and values, one line per case: the scan (K2 and
     K4a: tied candidates, columns of 255, D 1 to 4097, ragged lane
     counts, N 1 and 2, laterals -1/0/+1 with sub and accum; signatures
     with padding, allowed candidates and lane-fold segments), K1 (61 and
     100 lanes, D 1, 17 and 4097, N 1 and 2, signed bases, all-pad and
     all-invalid rows, `allowed` zeros, windows that reach the
     secondary's last row, bucket A's and the single tile's shapes), K4b
     on both instantiations (lanes the 16-block cluster does not divide,
     1 to 3 directions of 2 and 3 laterals, D 1, N 1, sub and accum,
     832 and 512 lanes) and a shape that only the global instantiation
     takes, K3 and K5 on NaN, inf and all-BIG partials, K5 also on each
     of its instantiations (bands of 4 and 2 rows, the windowed one past
     1024 columns) with D 1 to 528 and disp_min from -(W + D) to W - 5;
  4. kernels of the classic SGM matcher against their plain versions, on
     the 512 x 512 pair with 64 candidates from -8 (bench.py): the four
     signature-mode scan passes (K4a), one vertical pass with 3 MGM
     laterals and one horizontal pass with 2 (K4b) and K4b's step floor
     (one cluster barrier per step, no work), the WTA with the
     right-reference map (K5); and K4b's two passes at the classic
     tile's shape (832 x 832, 96 candidates);
  5. stage 4: synthetic rectified tiles in two buckets (A: 8 tiles padded
     to 448 x 512 with 80 candidates; B: 2 tiles at the default tile size,
     padded to 832 x 896 with 96 candidates) through
     ``pipeline.stereo_matching_all`` on the card, one call per bucket
     (the launches of each counted apart); the files it writes are
     checked for shape and for the known shift of each tile, and one
     tile of each bucket is held bitwise against the same entry run
     with device="cpu" (the plain versions);
  5b. stage 5 on bucket A's 8 tiles after stage 4 wrote them
     (``pipeline.disparity_to_ply_all`` with the 3D filter on, two
     synthetic RPC cameras 0.35 px/m apart in altitude): its wall time
     per bucket, a plausible cloud per tile, the triangulation's CUDA
     kernels (``torch.profiler``) and time and the neighbour count's time;
     crops of two tiles (96 x 128) card against device="cpu" (cloud.ply
     byte for byte, or within 1e-3 m in x, y and 2e-3 m in altitude); a
     constant disparity against the float64 cameras' altitudes (0.01 m);
  6. the classic matcher on the card: ``ops.sgm.match_pair`` on the
     512 x 512 pair and on an 800 x 800 tile (padded to 832 x 832, 96
     candidates), both with a known shift and NaN borders, once more with
     lr_mode='full', and ``sgm_kernels.aggregate`` with MGM laterals (the
     route of K4b); the known shift is checked on the finite inner pixels;
  7. the classic matcher on a 128 x 128 crop, card against device="cpu",
     byte for byte;
  8. stage 4 at 528 candidates: one 60 x 890 tile through
     ``stereo_matching_all``, its known shift, and its files byte for
     byte against the CPU run;
 8b. (run right after phase 8) one scene through the entry, stages 1 to
     7 on the card: two 2000 x 2800 GeoTIFFs with their cameras in the
     RPC tag (image 2 rendered from image 1 through stage 5's cameras at
     a constant altitude, with a pointing error across the epipolar
     lines) and a config file with relative paths (an ROI of 2400 x 1600
     px, the default tile size 800 and the default config otherwise);
     ``pipeline.main(read_config_file(path))`` tiles the ROI (6 tiles,
     their neighbourhoods and masks) and runs every stage; each stage's
     time as the entry measures it and main's wall time, with the card's
     name and power limit, the launches over main; the tiling against the
     expected layout; stage 1's parts run again one by one (detection
     with its pyramid, orientation and descriptor waves, the match wave,
     RANSAC, the per-tile fit) with the keypoints and matches of each
     tile, and once more under the profiler (CUDA kernels and their
     device time); each tile's pointing.txt against the rendered error
     (0.1 px); stage 1 of two tiles again with device="cpu": pointing.txt
     byte for byte (or within 0.01 px, reported) and both tiles'
     keypoints against the card's by the CPU tests' set criterion; stages
     2 and 3 again with device="cpu" on the card's stage-1 files, their
     files byte for byte; K1, K2 and K3 against their plain versions on
     the bucket stage 4 gave them (``pipeline.matching_buckets`` of the
     card's stage-3 files: 6 tiles, 832 x 960, 16 candidates), and stage
     4 of two tiles with device="cpu", its three files byte for byte; the
     scene's true correspondences' rectified
     rows within 0.1 px (and stage 1's SIFT matches' rows reported),
     stage 4's disparities inside each tile's range, the cloud's
     altitudes near the scene's; dsm.tif's georeferencing (the UTM zone's
     CRS, the grid at dsm_resolution, nodata NaN), its valid share inside
     the ROI's footprint, its median altitude error, and the whole of it
     bitwise against one rasterization of all the tiles' clouds; stage
     3's parts one by one with their shares of its time; W1 at the
     scene's group and tile, bitwise against and timed beside its plain
     version, with its bound, its order 1 beside grid_sample and its
     order 3, and the group again with a NaN band across the image (the
     mask dilated once); then stage 3 again with that NaN band in image 1
     (the path of W1's masked order 5 and of its mask dilation), on the
     card and with device="cpu", the rectified images byte for byte;
 8d. (run right after 8b) a triplet through the entry, stages 1 to 7 on
     the card for two pairs: the scene's two images and a third rendered
     from image 1 through a third camera with its own pointing error, a
     config file over the three (an ROI of 2 x 2 tiles of 800 px, the
     default config with the 3D filter on); each stage's time with stage
     5's four steps apart (5a height maps, 5b and 5c the pairs' mean
     heights, 5d fusion and the fused clouds), main's wall time, stage
     5a's peak device memory and the launches of K1, K2, K3, W1 and the
     mask dilation over main; each pair's pointing.txt against its
     rendered error; K1, K2 and K3 against their plain versions on the
     bucket stage 4 gave them; stages 2 and 3 of pair 2 with
     device="cpu", their files byte for byte; stage 5a of one tile's
     two pairs on crops of their rectified maps, card against CPU; 5b-5d
     with device="cpu" on a copy of the card's 5a output (the mean
     heights, the despeckled and fused maps and the clouds byte for
     byte: the despeckling's window ops on the card against the CPU);
     the two pairs' global mean heights against each other and the
     scene's altitude, the fused clouds' altitudes, dsm.tif as in 8b;
     then 5d's parts one tile after another (fusion, the host float64
     localization, the neighbour counts, the filter and PLY write);
 8e. (run right after 8d) the pair scene with ``mgm_multi``: a copy of
     8b's tree through ``pipeline.main`` from stage 4 (stages 4 to 7 on
     the card), stage 4's time beside 8b's ``mgm`` stage 4, its peak
     device memory and the launches over main (K2 and K3, no K1); K2
     direction by direction and K3 against their plain versions on the
     inputs the cascade gives them at the scene's bucket (its finest
     level), and K3 against its plain version and the port's torch
     ``_wta_refine`` at every level; one tile's stage 4 with
     device="cpu", the three files byte for byte; the clouds' altitudes
     and dsm.tif as in 8b; then the cascade on the single tile of phase
     10 at full width (797 x 803, range -40..55, 6 levels) through
     ``compute_disparity_map``, its known shift and wall time, and a
     256 x 320 crop of it card against device="cpu" byte for byte; then
     ``mgm_multi_lsd`` through stage 4's per-tile route on one of the
     scene's tiles (the host LSD of its two images included), card
     against device="cpu", the files byte for byte;
 8f. (run right after 8e) two processes on the one card over a gloo
     group (both on cuda:0, each building the kernels into one shared
     empty directory, so the build's file lock is exercised):
     ``pipeline.main`` of the pair scene from stage 2 with
     ``clean_intermediate`` on, and of the triplet from stage 5, on copies
     of 8b's and 8d's trees; each process's tiles and stage times; the
     blocks disjoint and covering ``tiles.txt``; both dsm.tif bitwise
     against the one-process runs; then ``parallel/mesh.py`` and
     ``parallel/halo.py`` (the matcher on 4 tiles of 256 x 256 with the
     MGM wavefront and with the kernels, the rasterizer on a 2 x 2 grid
     of 256-cell tiles with 200,000 points each, the global mean, the
     pointing fit) in both processes against one process on the card:
     the matcher bitwise, the rest at the JAX tests' tolerances;
 8g. the MGM wavefront (``ops/mgm.mgm_aggregate``, eager torch) at the
     scene bucket's shape (832 x 960, 16 candidates, float costs, P1 2.4
     and P2 9.6) on the card against device="cpu": S and the votes
     bitwise; both wall times;
 8h. ``sgbm`` through ``pipeline.main`` from stage 4 on a copy of 8b's
     tree (stages 4 to 7 on the card): each stage's time, the profiler's
     CUDA launches over a 128 x 320 crop of one tile (and per wavefront
     step), no confidence file, one
     tile's stage 4 with device="cpu" byte for byte, the clouds'
     altitudes and dsm.tif's valid share;
 8i. (run right after 8c) the matchers of the last slice: hirschmuller02,
     msmw and tvl1 through ``compute_disparity_map`` on a 256 x 320 pair
     with a known shift, then through ``pipeline.stereo_matching_all`` on
     the scene's 6 rectified tiles (8b's stage-3 files): each matcher's
     stage-4 time and launches (B1, one launch a window-cost battery, 32
     a tile for the msmw engines), no confidence file, the median of |its
     disparity - mgm's| per tile; msmw's stage 4 of one tile again with
     ``_window_costs_plain`` in place of B1 on the card, its files byte
     for byte; 256 x 320 crops of two tiles card against device="cpu"
     (byte for byte, or the CPU tests' criterion:
     tests/test_torch_msmw.py and tests/test_torch_tvl1.py); B1
     (``csrc/box.cu``) bitwise against its plain version on the largest
     battery of candidates and of one plane that msmw's stage 4 gave it,
     the first with the variance, and on adversarial shapes, masks and
     values (WINDOW_CASES), each timed beside the plain version;
 8j. SIFT's host route (``sift_device='host'``) against the device route
     on two 150 x 150 crops of the scene's image 1 by the JAX package's
     host-against-device criterion (tests/test_sift.py), then stage 1
     with 'host' on two tiles of 300 px (the host pyramid takes about
     40 s an 800 x 800 crop), their translations against the rendered
     pointing error, its seconds;
 8k. K2's 16-bit source (``s2p_scan16``, uint16 costs of a 17 x 17
     census window on a 128 x 160 crop of the single tile) bitwise
     against its plain version, both orientations, forward and backward
     with accum; the flow at census windows 7 and 17 on that crop
     (``compute_disparity_map``, whose launches count K2 and its 16-bit
     source, the batch and the cascade) and the cascade with tsgm 2,
     card against device="cpu" byte for byte; ``ops.sgm.sgm_match_batch``
     on two 256 x 320 tiles with different bases, bitwise against the
     per-tile lax route and the CPU; the seconds of 8i-8k together;
 8l. (run right after 8k) the native TIFF reader: windows of the default
     tile over an ROI of 4 x 3 tiles and its neighbourhood margin across
     every border and corner, clipped and boundless, of an 8192 x 8192
     uint16 GeoTIFF in 256 x 256 deflate tiles and of a 3000 x 4000
     float32 one in deflate strips, each bitwise against the whole-file
     decode (the Python path); a float32 file with predictor 3 (written by
     the script), refused by the native reader and read right through
     windows; ``tiling.is_tile_all_nodata`` over the first 10 windows with
     the native path and with the whole-file decode, and their ratio;
 8m. ``ops/rasterize.plyflatten_device`` on the pair scene's six clouds
     (float64, as read) at dsm.tif's resolution on the card (cold, then
     warm) and with device="cpu": the same cells filled, the rest within
     a relative 1e-12 (the card's adds are atomic);
 8n. ``utils/`` on the trees 8b and 8d left: the mosaic of the triplet's
     pair_1/height_map.tif, each tile's block its map and the GeoTIFF the
     mosaic; the scene's clouds through ``gather_cloud`` and ``write_las``
     (the points of all clouds, the LAS header's count and size); its SVG
     and KML tile maps, one entry a tile;
 8o. stage 1 with ``debug`` on for two scene tiles on the card: each
     pair's sift_matches_pointing.png decodes to the two crops side by
     side, with coloured matches; the seconds of 8l-8o together;
 8c. a tile mask from GML rings of real size (an ROI ring of 4000
     vertices and a cloud ring of 1000 inside it, on an 800 x 800 tile):
     ``core.masking.image_tile_mask``'s host time and its area against the
     rings';
  9. (run right after phase 4) the single-tile and lane-fold modes of
     the kernels against their plain versions: the pre-pass at a signed base (-40, padded
     secondary) on an 800 x 800 tile with 96 candidates, the WTA's
     edge_subpix and plateau_zero modes on bucket A's summed partials
     (phase 3), and the four signature-mode scans of bucket A folded by 2
     (4 groups of 2 tiles, 448 x 1184 lanes vertical, 592 x 896
     horizontal, segment width 592), timed against the same scans over
     the 8 tiles unfolded and held bitwise against them;
 9b. (run right after phase 9) W1, the homography warp, against its
     plain version, bitwise and NaN-aware, one line per case: orders 1,
     3 and 5, each with a clean source and one with NaN along its borders
     and a NaN block (order 5 through its NaN mask), batches of 1, 2 and
     3 homographies, an output larger than its source, a 1 x 1 output,
     homographies whose z crosses 0 inside the output, output strips
     over each border's last 4 px (supports that cross it by 0, 1 and 2
     px: the edges of the clamp-free interior path), 6 x 6 and 5 x 5
     sources, homographies that scale by 8 both ways, order 5 with a NaN
     band at the scene's bucket, and 65 jobs through
     ``ops.homography.warp_jobs_batched`` (two launches); then the plain
     version on the card against the plain version on the CPU; then the
     mask dilation (``interp.warp_dilate``) against ``dilate_nanmask6``
     on 1 x N, N x 1, 5 x 5 and larger masks with NaN, inf, negative and
     -0 entries, and at the scene's image size, timed there;
 10. the single-tile entry on the card: ``ops.mgm_flow.mgm_binary_match``
     on a 797 x 803 tile (range -40..55, the padded route) and an
     800 x 800 tile (the aligned route), each bitwise against
     ``mgm_binary_match_batch`` on the same tile in a 1-tile bucket, with
     its known shift; ``core.matching.compute_disparity_map`` on the
     797 x 803 tile; a 128 x 160 crop with edge_subpix against
     device="cpu" byte for byte, and the WTA calls of the card's run (its
     single-tile modes) against their plain version on the partials that
     run gave them; the 800 x 800 call's wall time; at non-integer
     penalties (P1 2.4, P2 9.6: ``stereo_regularity_multiplier`` 0.3) a
     128 x 160 crop byte for byte against device="cpu" and the 800 x 800
     tile bitwise against the batch entry on the card;
 11. the lane-folded batch: bucket A's 8 tiles with S2P_TPU_LANE_FOLD=2
     (the fold of phase 9's check: 4 groups of 2), then 3 (two groups of
     3 and a 2-tile tail), each bitwise per tile against the unfolded
     batch on the card;
 12. the whole run's seconds; a JSON line with, per kernel and mode, its
     launches during the run that drives its path and the numbers of its
     comparison at that run's shapes: the flow's kernels in the scene
     through main (8b, its bucket), at stage 4's buckets A and B (5), at
     528 candidates (8) and in the triplet through main (8d, its bucket);
     K2 and K3 on the mgm_multi cascade's levels in the scene through main
     (8e); B1 (``window_costs``, one launch a battery) in msmw's stage 4
     (8i); K2's 16-bit source in the flow at
     17 x 17 (8k); W1 in the scene (8b), its mask dilation in the scene's stage 3 with
     a NaN band (8b); the classic matcher's (6 and 4); the pre-pass
     at a signed base (10 and 9); the WTA's edge modes (10); the folded
     scan (11 at fold 2, and 9); its error against the plain version,
     its time, the plain version's time and the least time the card could
     take (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s, H100
     SXM data sheet; W1's and B1's operations over 33.5e12/s, the rate of separate
     adds and multiplies); the scan's entries also carry ``bucket_ms``, both
     sides of the bucket as the flow launches them, K4b's
     ``step_floor_ms`` and W1's ``group_ms`` (the scene's group of 6);
 13. the last line: {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without the last line.
Without CUDA, or without the package beside it, it fails before any result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
SPIN_CYCLES = 2_000_000         # a device-side spin ahead of a timed run
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# W1 is built with --fmad=false and keeps the reference's roundings, so its
# adds and multiplies execute one by one: 132 SMs x 128 lanes x 1.98 GHz,
# half the rate above, which counts a fused multiply-add as two operations
F32_SEPARATE_OPS_PER_S = 33.5e12

BUCKET_A = dict(n=8, h=448, w=512, D=80)
BUCKET_B = dict(n=2, h=832, w=896, D=96)
# stage 4 at more than 512 candidates: one tile, 64 x 896 padded, D 528
WIDE = dict(index=100, h=60, w1=890, w2=888, dmin=-20, dmax=500, shift=3.0,
            seed=100)
BUCKET_WIDE = dict(n=1, h=64, w=896, D=528)
# the classic matcher: bench.py's pair (512 x 512, 64 candidates from -8)
# and one tile at the default tile size (800 x 800, 96 candidates)
SGM_PAIR = dict(h=512, w=512, dmin=-8, dmax=55, shift=5, seed=0)
SGM_TILE = dict(h=800, w=800, dmin=-30, dmax=65, shift=5, seed=1)
# the single-tile entry: a tile below the alignment of 8 (the padded
# route) and one at the default tile size (the aligned route), 96
# candidates from -40
SINGLE = dict(index=300, h=797, w1=803, w2=803, dmin=-40, dmax=55,
              shift=4.5, seed=300)
SINGLE_800 = dict(index=301, h=800, w1=800, w2=800, dmin=-40, dmax=55,
                  shift=3.0, seed=301)
# stage 5 on bucket A: two synthetic cameras 0.35 px/m apart in altitude
# (a base-to-height ratio near 0.3 at 1 m a pixel), the secondary's
# homography shifted so that 3 px of disparity is about 300 m; the CPU
# comparison runs on crops of two tiles (the triangulation launches about
# 1e5 elementwise ops, too slow on the CPU at full size); tolerances of
# the card against the CPU (the same torch ops, expected bitwise) and of
# the known answer against the float64 model
S5_SHIFT = -67.0
S5_CROP = (96, 128)
S5_XY_TOL_M, S5_ALT_TOL_M = 1e-3, 2e-3
S5_KNOWN_DISP, S5_KNOWN_TOL_M = 3.0, 0.01
# lane folds: the kernel check's and the batch entry's first run (8 tiles:
# 4 groups of 2), and the batch entry's second (two groups and a 2-tile
# tail)
KERNEL_FOLD = 2
BATCH_FOLD = 3
# stages 1 -> 2 -> 3 -> 4 -> 5 of one scene: two 2000 x 2800 images seen by
# stage 5's cameras (shared row polynomials, 0.35 px/m apart), image 2
# rendered from image 1 through both cameras at the constant altitude
# SCENE_H0 with a pointing error of SCENE_POINTING px across the epipolar
# lines; an ROI of 2400 x 1600 px in 6 tiles of 800; the cloud's
# altitudes are held to SCENE_H0 (median and 90th percentile of the
# absolute error, in metres: 1 px of disparity is about 2.9 m)
SCENE = dict(h=2000, w=2800, roi=(200, 200, 2400, 1600), tile=800,
             seed=500)
SCENE_H0 = 300.0
SCENE_POINTING = 0.7
SCENE_ALT_TOL_M = (1.0, 3.0)
SCENE_ROW_TOL_PX = 0.1
# the DSM: its valid share on the cells inside the ROI's footprint
SCENE_DSM_SHARE = 0.8
# stage 3 of the scene again with a NaN band across image 1 (rows), the
# path of W1's masked order 5 and of its mask dilation
SCENE_NAN_ROWS = (1000, 1004)
# the triplet: the scene's two images and a third seen by camera 3 (its
# columns moving 0.05 px per metre, a base of 0.15 px/m to camera 1) with
# its own pointing error, an ROI of 2 x 2 tiles of 800 px, the default
# config with the 3D filter on (r and n of the stage-5 phase); stage 5a's
# maps of one tile, card against CPU, on crops of the rectified maps;
# the two pairs' global mean heights against each other and SCENE_H0 (m)
TRIPLET = dict(roi=(400, 200, 1600, 1600), h_term=0.005, seed=3,
               pointing=-0.5)
TRIPLET_FILTER = (2.5, 8)
# phase 8e: the pair scene with mgm_multi from stage 4; the lsd variant on
# this many of its tiles (the host LSD of a tile's two 832 x 960 images
# takes about 20 s on the H100 machine's host, in the card's run and again
# in the CPU's); the single tile's crop that the card holds against the
# CPU
MULTI_LSD_TILES = 1
MULTI_CROP = (256, 320)
STAGE4_FILES = ('rectified_disp.tif', 'rectified_disp_confidence.tif',
                'rectified_mask.png')
TRIPLET_MEAN_TOL_M = 0.5
# W1's division by 120 without a division (csrc/warp.cu div120): the
# mismatches of the correction alone, without its guard, against the IEEE
# division over all 2^32 float32 inputs, from an exhaustive run in C on
# the CPU (-ffp-contract=off): -0, +-inf and 559,240 inputs with
# |x| < 2^-123, whose quotients are subnormal
DIV120_UNGUARDED = 559_243
# a tile mask from GML rings of the size real ones have: an ROI ring and
# a cloud ring inside it (vertices), on one tile of the default size; the
# mask's area against the rings' (relative)
GML_VERTICES = (4000, 1000)
GML_AREA_TOL = 0.02
# stage 1: each tile's translation against the rendered pointing error
# (px); the card's pointing.txt against the CPU's (px, where the bytes
# differ); the keypoints of two tiles, card against CPU, by the set
# criterion of tests/test_torch_sift.py (a share of the card's keypoints
# within a distance in (x, y, scale, orientation) of a CPU keypoint, the
# counts within a share, and of those keypoints' descriptor entries a
# share equal, a share within 1 and none further than a maximum)
SCENE_POINTING_TOL_PX = 0.1
STAGE1_CPU_TOL_PX = 0.01
KP_DIST, KP_SHARE, COUNT_SHARE = 1e-2, 0.995, 0.01
DESC_EQ_SHARE, DESC_1_SHARE, DESC_MAX = 0.995, 0.9999, 4
# the matchers of the last slice: hirschmuller02 and msmw (B1) and tvl1
# through stage 4 on this many of the scene's tiles; the crop of two of
# them that the card holds against the CPU; their known shift on a
# synthetic pair (px); the bound on the median of |their disparity -
# mgm's| per scene tile (px); the CPU tests' criteria for the card against
# the CPU where the bytes differ (tests/test_torch_msmw.py and
# tests/test_torch_tvl1.py)
NEW_MATCHERS = ('hirschmuller02', 'msmw', 'tvl1')
NEW_MATCHER_TILES = 6
NEW_MATCHER_CROP = (256, 320)
KNOWN = dict(index=400, h=256, w1=320, w2=320, dmin=-8, dmax=8, shift=3.0,
             seed=400)
KNOWN_SHIFT_TOL_PX = 0.25
NEW_MATCHER_MGM_TOL_PX = 0.5
MSMW_VALID_SHARE, MSMW_DISP_TOL = 0.995, 1e-3
# B1's launches in msmw's stage 4 of a scene tile: 4 levels x 2 directions
# x 4 window-cost batteries
MSMW_BATTERIES_PER_TILE = 32
TVL1_TOL = dict(valid=0.995, median=1e-3, p99=0.02, max=0.5)
# the flow at census windows above 5x5 (17 x 17 on K2's 16-bit source) on
# a crop of the single tile, card against CPU
WIDE_WINDOWS = (7, 17)
WIDE_CROP = (128, 160)
# sgm_match_batch: two tiles with different bases (tests/
# test_batch_matching.py's parameters)
SGM_BATCH = dict(h=256, w=320, dmins=(-8, -16), D=32, shift=3.0, seed=7)
SGM_BATCH_PARAMS = dict(mgm=False, p1=12.0, p2=48.0, p2_edge_scale=0.5,
                        lr_tau=1.0, median_first=True, median_fill=True)
# SIFT's host route: crops (x, y, w, h) of the scene's image 1 against the
# device route, and stage 1 with 'host' on two tiles of SIFT_HOST_TILE px
# at these corners (the host pyramid takes about 40 s a crop of 800 px)
SIFT_HOST_CROPS = ((400, 400, 150, 150), (1600, 1100, 150, 150))
SIFT_HOST_TILE = 300
SIFT_HOST_TILES = ((300, 300), (1500, 1000))
# 8l: the native TIFF reader on a panchromatic-like raster (uint16, 256 x
# 256 deflate tiles) and a float32 strip file; windows of the default
# tile (800 px) over an ROI of 4 x 3 tiles, their neighbourhoods' margin
# of 400 px boundless across the raster's borders; the first TIMED_WINDOWS
# of them also through the whole-file decode (about a second each)
NATIVE_TILED = dict(h=8192, w=8192, seed=11)
NATIVE_STRIPS = dict(h=3000, w=4000, seed=12)
NATIVE_PRED3 = dict(h=1000, w=1200, seed=13)
NATIVE_TILE = 800
TIMED_WINDOWS = 10
# 8m: plyflatten_device on the scene's clouds (float64, as read), card
# against device="cpu": the adds' order differs (atomics), so cells are
# held to a relative 1e-12 with equal sets of empty cells
PLYFLATTEN_RTOL = 1e-12
# 8o: stage 1 with debug on for the first scene tiles
DEBUG_TILES = 2


@contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f'== {name}', flush=True)
    yield
    print(f'== {name}: {time.perf_counter() - t0:.3f} s', flush=True)


def tile_specs(bucket, first_index):
    """True extents, ranges and shifts of a bucket's tiles: a little below
    the padded shape, with different disparity bases."""
    specs = []
    for k in range(bucket['n']):
        h = bucket['h'] - 6 * k - 2
        w = bucket['w'] - 7 * k - 3
        d_true = bucket['D'] - k - 1
        dmin = -(d_true // 3) - 2 * k
        specs.append(dict(index=first_index + k, h=h, w1=w, w2=w - 2 * (k % 2),
                          dmin=dmin, dmax=dmin + d_true - 1,
                          shift=2.0 + 0.5 * k, seed=first_index + k))
    return specs


def make_pair(spec):
    """Smooth random texture; the reference is the secondary shifted by
    the tile's known disparity, NaN over a few border rows and columns."""
    import numpy as np
    rng = np.random.RandomState(spec['seed'])
    h, w = spec['h'], max(spec['w1'], spec['w2'])
    tex = rng.rand(h, w).astype(np.float32) * 200
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3
    xs = np.arange(w, dtype=np.float32)
    ref = np.stack([np.interp(xs + spec['shift'], xs, row) for row in tex])
    ref = ref.astype(np.float32)[:, :spec['w1']]
    sec = tex[:, :spec['w2']].copy()
    ref[:5] = np.nan
    sec[:, -7:] = np.nan
    return ref, sec


def write_tile(root, spec, ref, sec):
    import numpy as np
    from s2p_tpu_torch.geo import geotiff
    pair_dir = os.path.join(root, f"tile_{spec['index']}", 'pair_1')
    os.makedirs(pair_dir, exist_ok=True)
    geotiff.write(os.path.join(pair_dir, 'rectified_ref.tif'), ref,
                  nodata=float('nan'))
    geotiff.write(os.path.join(pair_dir, 'rectified_sec.tif'), sec,
                  nodata=float('nan'))
    np.savetxt(os.path.join(pair_dir, 'disp_min_max.txt'),
               [spec['dmin'], spec['dmax']])
    return {'dir': os.path.dirname(pair_dir)}


def equal(a, b):
    """(equal bit for bit, any NaN equal to any NaN; max abs error over
    finite pairs).  +0 and -0 differ."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False, float('inf')
    if a.dtype.is_floating_point:
        it = {torch.float32: torch.int32, torch.float64: torch.int64,
              torch.float16: torch.int16, torch.bfloat16: torch.int16}[
                  a.dtype]
        both_nan = torch.isnan(a) & torch.isnan(b)
        same = (a.view(it) == b.view(it)) | both_nan
        fin = torch.isfinite(a) & torch.isfinite(b)
        err = (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0
        if (torch.isnan(a) != torch.isnan(b)).any():
            err = float('inf')
        return bool(same.all()), err
    same = a == b
    err = (a.long() - b.long()).abs().max().item() if a.numel() else 0
    return bool(same.all()), float(err)


def one_word(census):
    """(signature, valid) of ``census_transform`` with its one word."""
    return census[0][..., 0], census[1]


def timed(fn, reps):
    """Median ms of ``reps`` runs between CUDA events, after one warm run.
    A device-side spin of about a millisecond goes ahead of each first
    event, so the host enqueues the run while the card is busy and the
    events time the card's work, not the wrappers' host time (which is
    longer than a kernel of 0.1 ms)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / ops_per_s * 1e3
    return (t_b, 'bytes') if t_b >= t_o else (t_o, 'operations')


def bucket_arrays(specs, bucket, pairs):
    """The padded batch stereo_matching_all builds for one bucket."""
    import numpy as np
    n, H, W = len(specs), bucket['h'], bucket['w']
    b1 = np.full((n, H, W), np.nan, np.float32)
    b2 = np.full((n, H, W), np.nan, np.float32)
    for k, s in enumerate(specs):
        ref, sec = pairs[s['index']]
        b1[k, :ref.shape[0], :ref.shape[1]] = ref
        b2[k, :sec.shape[0], :sec.shape[1]] = sec
    return b1, b2


def record(stats, name, side, ok, err, ms, plain_ms, nbytes, ops, tag=''):
    """Print one kernel comparison and add it to the stats of the kernel
    (the first word of ``name``, plus ``tag``); the JSON line reports the
    L side of the flow's kernels."""
    t_bound, by = bound(nbytes, ops)
    print(f'  {name:16s} {side}: bitwise={ok} max_abs_err={err} '
          f'kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
          f'bound {t_bound:.4f} ms ({by})', flush=True)
    if not ok:
        raise AssertionError(f'{name} ({side}) differs from its plain '
                             f'version: max abs error {err}')
    if side in ('L', ''):
        st = stats.setdefault(name.split()[0] + tag, dict(
            err=0.0, ms=0.0, plain_ms=0.0, nbytes=0, ops=0))
        st['err'] = max(st['err'], err)
        st['ms'] += ms
        st['plain_ms'] += plain_ms
        st['nbytes'] += nbytes
        st['ops'] += ops


def check_no_spill(log, kernel):
    """Every instantiation of ``kernel`` in a ptxas -v log has a 0-byte
    stack frame and no spill."""
    fn, seen = None, 0
    for line in log.splitlines():
        if 'Function properties for' in line:
            fn = line.split('Function properties for')[1].strip()
        elif fn and 'stack frame' in line:
            if kernel in fn:
                seen += 1
                nums = [int(w) for w in line.replace(',', ' ').split()
                        if w.isdigit()]
                if any(nums):
                    raise AssertionError(f'{fn}: {line.strip()}')
            fn = None
    print(f'  {kernel}: {seen} instantiations, each with a 0-byte stack '
          'frame and no spill', flush=True)
    if not seen:
        raise AssertionError(f'no {kernel} in the ptxas log')


def check_kernels(specs, pairs, stats, bucket, tag, variant=None,
                  edge_modes=False):
    """Phase 3: every kernel of the flow against its plain version, on the
    inputs the main path gives it at the bucket's shapes (``variant``, the
    flow's, None for the default); ``tag`` is appended to the kernels'
    names in ``stats``, whose times and byte counts add up over the
    buckets checked under one tag; ``edge_modes`` also checks the WTA's
    single-tile modes on the same partials."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk

    v = variant or mf.MgmVariant()
    D = bucket['D']
    b1, b2 = bucket_arrays(specs, bucket, pairs)
    dev = torch.device('cuda')

    def ints(key):
        return torch.tensor([s[key] for s in specs], dtype=torch.int32,
                            device=dev)

    dm = ints('dmin')
    dt = ints('dmax') - dm + 1
    h, w1, w2 = ints('h'), ints('w1'), ints('w2')
    s1 = mf.census_bits_raw(torch.as_tensor(b1, device=dev),
                            v.census_win)[..., 0]
    s2 = mf.census_bits_raw(torch.as_tensor(b2, device=dev),
                            v.census_win)[..., 0]
    allowed = (torch.arange(D, device=dev)[None, :] < dt[:, None]) \
        .to(torch.int32)
    nbits = v.census_win ** 2 - 1
    sides = {'L': (s1, s2, dm, h, w1, w2, True),
             'R': (s2, s1, -(dm + dt - 1), h, w2, w1, False)}

    def rec(name, *a):
        record(stats, name, *a, tag=tag)

    vols, seq = {}, {}
    for side, (sref, ssec, base, hr, wr, ws, votes) in sides.items():
        scan_bytes = 0
        sr, ss, _ = mf._side_sigs(sref, ssec, base, hr, wr, ws, D)
        s1t = sr.transpose(1, 2).contiguous()
        s2t = ss.transpose(1, 2).contiguous()
        args = (s1t, s2t, D, 0, nbits, 0, s2t.shape[1], allowed)
        cost_h = sk.cost_prepass(*args)
        ok, err = equal(cost_h, sk.cost_prepass_plain(*args))
        rec('cost_prepass', side, ok, err,
               timed(lambda: sk.cost_prepass(*args), 5),
               timed(lambda: sk.cost_prepass_plain(*args), 2),
               4 * s1t.numel() + 4 * s2t.numel() + 4 * allowed.numel()
               + cost_h.numel(), 0)

        S = {'v': None, 'h': None}
        passes = sk.scan_passes(v)
        sub = float(sum(len(i) for _, i, _ in passes) - 1)
        vols[side] = {o: (cost_h if o == 'h' else
                          cost_h.permute(0, 3, 2, 1).contiguous(), None)
                      for o in ('h', 'v')}
        seq[side] = [None] * sum(len(i) for _, i, _ in passes)
        floor = 0
        for key, dir_idx, lats in passes:
            o = key[0]
            cost = vols[side][o][0]
            B, N, _, lanes = cost.shape
            p2 = torch.full((B, N, lanes), v.p2, dtype=torch.float32,
                            device=dev)
            vols[side][o] = (cost, p2)
            kw = dict(reverse=key[1] == 'b', sub_cost_mult=sub, accum=S[o],
                      emit_votes=votes)
            Sk, vk = sk.scan(cost, p2, lats, v.p1, mf.BIG, **kw)
            Sp, vp = sk.scan_plain(cost, p2, lats, v.p1, mf.BIG, **kw)
            ok, err = equal(Sk, Sp)
            if votes:
                ok_v, err_v = equal(vk, vp)
                ok, err = ok and ok_v, max(err, err_v)
            vol = Sk.numel()
            nbytes = (cost.numel() + 4 * p2.numel() + 4 * vol
                      + (4 * vol if S[o] is not None else 0)
                      + (4 * vk.numel() if votes else 0))
            ops = vol * (8 * len(lats) + 3)
            # one launch per direction: each later direction reads back
            # and rewrites S
            floor += nbytes + 8 * vol * (len(lats) - 1)
            scan_bytes += nbytes
            rec(f'scan {key}', side, ok, err,
                   timed(lambda: sk.scan(cost, p2, lats, v.p1, mf.BIG, **kw),
                         5),
                   timed(lambda: sk.scan_plain(cost, p2, lats, v.p1, mf.BIG,
                                               **kw), 1),
                   nbytes, ops)
            S[o] = Sk
            sub = 0.0
            if votes:
                for j, i in enumerate(dir_idx):
                    seq[side][i] = vk[:, j] if o == 'v' else \
                        vk[:, j].transpose(1, 2)
            del Sp, vp
        print(f'  scan {side}: byte floor of one launch per direction '
              f'{bound(floor, 0)[0]:.4f} ms, fused bound '
              f'{bound(scan_bytes, 0)[0]:.4f} ms',
              flush=True)

        parts = [S['v'], S['h'].permute(0, 3, 2, 1)]
        seq[side] = (parts, seq[side])
        off, d_int = sk.wta(parts, v.subpix, mf.BIG / 2)
        off_p, d_p = sk.wta_plain(parts, v.subpix, mf.BIG / 2)
        ok, err = equal(off, off_p)
        ok_d, err_d = equal(d_int, d_p)
        vol = parts[0].numel()
        rec('wta', side, ok and ok_d, max(err, err_d),
               timed(lambda: sk.wta(parts, v.subpix, mf.BIG / 2), 5),
               timed(lambda: sk.wta_plain(parts, v.subpix, mf.BIG / 2), 2),
               8 * vol + 4 * off.numel() + 4 * d_int.numel(), 2 * vol)
        if edge_modes:
            # the single-tile flow's modes on the same partials: each
            # alone, then both (timed)
            for one in ({'edge_subpix': True}, {'plateau_zero': True}):
                got = sk.wta(parts, v.subpix, mf.BIG / 2, **one)
                ref = sk.wta_plain(parts, v.subpix, mf.BIG / 2, **one)
                if not all(equal(a, b)[0] for a, b in zip(got, ref)):
                    raise AssertionError(f'wta {one} ({side}) differs from '
                                         'its plain version')
            edge = dict(edge_subpix=True, plateau_zero=True)
            off_e, d_e = sk.wta(parts, v.subpix, mf.BIG / 2, **edge)
            off_ep, d_ep = sk.wta_plain(parts, v.subpix, mf.BIG / 2, **edge)
            ok, err = equal(off_e, off_ep)
            ok_d, err_d = equal(d_e, d_ep)
            moved = int((~((off_e == off) | (torch.isnan(off_e)
                                             & torch.isnan(off)))).sum())
            print(f'  wta_edge {side}: {moved} offsets differ from the '
                  'default mode', flush=True)
            rec('wta_edge', side, ok and ok_d, max(err, err_d),
                timed(lambda: sk.wta(parts, v.subpix, mf.BIG / 2, **edge),
                      5),
                timed(lambda: sk.wta_plain(parts, v.subpix, mf.BIG / 2,
                                           **edge), 2),
                8 * vol + 4 * off.numel() + 4 * d_int.numel(), 2 * vol)
        del S, parts, cost_h
        torch.cuda.empty_cache()
    check_bucket_scans(vols, seq, stats['scan' + tag], v)


def check_bucket_scans(vols, seq, st, v):
    """K2 per bucket as the flow launches it: both sides' four chains of
    passes at once (sgm_kernels.flow_scans), bitwise against the passes
    run one by one, and timed twice beside the same passes one after
    another on one stream; the JSON line reports the better of the two
    (added up over the buckets checked under one tag)."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk

    ins = [(vols['L'], True), (vols['R'], False)]
    got = sk.flow_scans(ins, v)
    for (parts, votes), side in zip(got, ('L', 'R')):
        ref_parts, ref_votes = seq[side]
        same = all(equal(a, b)[0] for a, b in zip(parts, ref_parts))
        same = same and all(a is None and b is None or equal(a, b)[0]
                            for a, b in zip(votes, ref_votes))
        print(f'  scan bucket {side}: the concurrent chains equal the '
              f'passes one by one: {same}', flush=True)
        if not same:
            raise AssertionError(f'flow_scans ({side}) differs from the '
                                 'passes run one by one')
    del got

    def serial():
        for vol, votes in ins:
            S = {}
            for o, chain in sk.flow_chains(v).items():
                for key, _, lats, sub in chain:
                    S[o], _ = sk.scan(*vol[o], lats, v.p1, mf.BIG,
                                      reverse=key[1] == 'b',
                                      sub_cost_mult=sub, accum=S.get(o),
                                      emit_votes=votes)

    ts = [timed(lambda: sk.flow_scans(ins, v), 5) for _ in range(2)]
    one_stream = timed(serial, 3)
    print(f'  scan bucket (both sides, four chains at once): {ts[0]:.3f}, '
          f'{ts[1]:.3f} ms', flush=True)
    print(f'  scan bucket, the same passes on one stream: {one_stream:.3f} ms',
          flush=True)
    st['bucket_ms'] = st.get('bucket_ms', 0.0) + min(ts)
    torch.cuda.empty_cache()


def check_adversarial():
    """Every kernel against its plain version at shapes and values that
    stress its design, each case on a line of its own.  The scan (K2 and
    K4a): tied candidates, columns of 255, D from 1 to 4097 (one group, a
    ragged group, past 256, the wide tile's and past 4096,
    scan_wide_kernel), lanes that no chain count divides, N 1 and 2,
    laterals -1/0/+1 in one pass with sub and accum; signatures with
    reference padding, invalid pixels, allowed candidates and lane-fold
    segments, vertical and horizontal.  K1, K4b (both instantiations) and
    K5 at their own edges (check_adversarial_prepass, _mgm, _wta_dr).  K3
    on NaN, inf and all-BIG partials, D 1 and 2, either part
    transposed."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(7)
    failed = []

    def verdict(name, pairs):
        ok = all(equal(a, b)[0] for a, b in pairs)
        print(f'  {name}: bitwise={ok}', flush=True)
        if not ok:
            failed.append(name)

    cases = []
    for D in (1, 17, 257, 528):
        for N, lanes in ((1, 61), (2, 61), (7, 64)):
            cases.append((D, N, lanes, 'random'))
    cases += [(80, 9, 61, 'tied'), (80, 9, 61, '255 columns'),
              (528, 5, 33, 'tied'), (17, 12, 61, '255 columns'),
              (4097, 3, 61, 'random'), (4104, 2, 7, 'tied')]
    for D, N, lanes, kind in cases:
        B = 2
        cost = torch.randint(0, 25, (B, N, D, lanes), dtype=torch.uint8,
                             device=dev, generator=g)
        cost[torch.rand(cost.shape, device=dev, generator=g) < 0.1] = 255
        if kind == 'tied':
            cost.fill_(7)
        elif kind == '255 columns':
            cost[..., ::5] = 255
        p2 = torch.rand((B, N, lanes), device=dev, generator=g) * 40
        accum = torch.rand(cost.shape, device=dev, generator=g) * 100
        for lats, rev, sub, acc in (((-1, 0, 1), False, 2.0, accum),
                                    ((1,), True, 0.0, None),
                                    ((0, -1), True, 1.0, accum)):
            ref = sk.scan_plain(cost, p2, lats, 8.0, mf.BIG, rev, sub, acc)
            got = sk.scan(cost, p2, lats, 8.0, mf.BIG, rev, sub, acc)
            verdict(f'scan D {D} N {N} lanes {lanes} {kind} lats {lats} '
                    f'reverse {rev} sub {sub} accum {acc is not None}',
                    zip(got, ref))
    # a strided view of the cost, as any caller may give
    cost = torch.randint(0, 25, (2, 7, 40, 30), dtype=torch.uint8,
                         device=dev, generator=g)[:, :, ::2]
    p2 = torch.full((2, 7, 30), 32.0, device=dev)
    verdict('scan strided cost', zip(
        sk.scan(cost, p2, (0, 1, -1), 8.0, mf.BIG, False),
        sk.scan_plain(cost, p2, (0, 1, -1), 8.0, mf.BIG, False)))
    check_adversarial_sig(g, verdict)
    check_adversarial_prepass(g, verdict)
    check_adversarial_mgm(g, verdict)
    check_adversarial_wta_dr(g, verdict)

    for D in (1, 2, 17, 80):
        B, H, W = 2, 37, 45
        sv = torch.randint(0, 30, (B, H, D, W), device=dev,
                           generator=g).float()
        sh = torch.randint(0, 30, (B, W, D, H), device=dev,
                           generator=g).float()
        for kind in ('random', 'nan', 'inf', 'all BIG'):
            a, c = sv.clone(), sh.clone()
            if kind == 'nan':
                a[torch.rand(a.shape, device=dev, generator=g) < 0.03] = \
                    float('nan')
            elif kind == 'inf':
                a[torch.rand(a.shape, device=dev, generator=g) < 0.1] = \
                    float('inf')
                c[torch.rand(c.shape, device=dev, generator=g) < 0.05] = \
                    float('-inf')
            elif kind == 'all BIG':
                a[:, :3] = mf.BIG
                c[:] = mf.BIG
            ct = c.permute(0, 3, 2, 1)
            for parts in ([a, ct], [ct, a], [ct, ct], [a], [ct]):
                for subpix, mode in (('vfit', {}), ('parabola', {}),
                                     ('vfit', dict(edge_subpix=True,
                                                   plateau_zero=True))):
                    got = sk.wta(parts, subpix, mf.BIG / 2, **mode)
                    ref = sk.wta_plain(parts, subpix, mf.BIG / 2, **mode)
                    order = ' + '.join('S_v' if t is a else 'S_h'
                                       for t in parts)
                    verdict(f'wta D {D} {kind} {order} {subpix} '
                            f'{sorted(mode)}', zip(got, ref))
    if failed:
        raise AssertionError(f'{len(failed)} adversarial cases differ from '
                             f'the plain versions: {failed[:5]}')
    torch.cuda.empty_cache()


def adversarial_sigs(g, shape, p_pad=0.0):
    """Random census signatures: 90% valid, ``p_pad`` reference padding."""
    import torch
    dev = g.device
    v = torch.randint(0, 1 << 24, shape, device=dev, generator=g)
    v |= (torch.rand(shape, device=dev, generator=g) >= 0.1).long() << 24
    v |= (torch.rand(shape, device=dev, generator=g) < p_pad).long() << 25
    return v.to(torch.int32)


def check_adversarial_prepass(g, verdict):
    """K1 against its plain version: lane counts that no 4-byte word
    divides (the scalar instantiation) and that a 16-lane vector does not,
    D 1, 17 and 4097, N 1 and 2, signed bases with a padded secondary,
    reference padding, all-pad and all-invalid rows, `allowed` with
    zeros, and windows that reach the secondary's last row."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = g.device
    # (B, N, lanes, D, base: 'wide' (0, N + D secondary rows: the last
    # window ends at the last row) or a signed disp_min, kind)
    cases = [(2, 48, 61, 17, 'wide', ''), (2, 1, 64, 1, 'wide', ''),
             (1, 2, 61, 4097, -2000, 'allowed'),
             (2, 2, 40, 17, -5, 'pad'),
             (2, 33, 808, 96, -40, 'allowed zeros pad'),
             (2, 24, 100, 17, 3, ''), (1, 16, 36, 4097, 'wide', ''),
             (2, 40, 61, 80, 'wide', 'all-pad rows'),
             (2, 40, 64, 80, 'wide', 'all-invalid rows'),
             (1, 1, 61, 1, -3, 'allowed'), (8, 512, 448, 80, 'wide', 'pad'),
             (1, 800, 800, 96, -40, 'allowed pad')]
    for B, N, L, D, base, kind in cases:
        s1 = adversarial_sigs(g, (B, N, L), 0.2 if 'pad' in kind else 0.0)
        if kind == 'all-pad rows':
            s1[:, :7] |= 1 << 25
        elif kind == 'all-invalid rows':
            s1[:, :7] &= ~(1 << 24)
        if base == 'wide':
            dmin, pad, sec = 0, 0, N + D
            s2 = adversarial_sigs(g, (B, N + D, L))
        else:
            dmin = base
            s2, pad, sec = sk.prepass_secondary(
                adversarial_sigs(g, (B, L, N)), N, dmin, D)
        allowed = None
        if 'allowed' in kind:
            allowed = (torch.rand((B, D), device=dev, generator=g)
                       < 0.7).to(torch.int32)
            if 'zeros' in kind:
                allowed[0] = 0
        args = (s1, s2, D, dmin, 24, pad, sec, allowed)
        verdict(f'cost_prepass B {B} N {N} lanes {L} D {D} base {base} '
                f'{kind}', [(sk.cost_prepass(*args),
                             sk.cost_prepass_plain(*args))])


def check_adversarial_mgm(g, verdict):
    """K4b against its plain version on both instantiations (the
    shared one, forced global): lanes that the cluster's 16 blocks do not
    divide, 1 to 3 directions of 2 and 3 laterals, D 1, N 1, sub and accum
    together, `allowed`, vertical and horizontal, bucket B's widths (832
    lanes, 96 candidates) and the classic pair's (512, 64); then a shape
    whose carry fits only the global instantiation, chosen by shape."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = g.device
    v3 = ((0, 1, -1), (1, 0, -1), (-1, 0, 1))
    # (B, N, lanes, D, dirs, horizontal, disp_min, sub, accum, allowed)
    cases = [(2, 9, 61, 17, ((0, 1), (1, 0), (-1, 0)), False, -5, 2.0, True,
              True),
             (1, 5, 30, 1, ((0, -1, 1),), False, 0, 0.0, False, False),
             (2, 7, 61, 17, ((0, 1),), True, 3, 1.0, True, False),
             (1, 8, 100, 64, ((0, -1), (-1, 0)), False, -8, 0.0, False,
              False),
             (1, 5, 20, 17, ((0, 1, -1), (1, 0, -1)), False, 2, 3.0, True,
              True),
             (1, 1, 61, 17, v3, False, -4, 2.0, True, False),
             (1, 6, 832, 96, v3, False, -30, 0.0, False, False),
             (1, 6, 832, 96, ((0, 1),), True, -30, 0.0, False, False),
             (1, 4, 512, 64, v3, False, -8, 0.0, False, False),
             (1, 4, 512, 64, ((0, 1, -1),), True, -8, 0.0, False, False)]
    for B, N, lanes, D, dirs, hor, dmin, sub, acc, al in cases:
        s1 = adversarial_sigs(g, (B, N, lanes), 0.05)
        pad = 0
        if hor:
            pad = max(0, -dmin, dmin + D)
            pad += (-(dmin + pad)) % 8
            s2, sec = adversarial_sigs(g, (B, N + 2 * pad, lanes)), N
        else:
            s2, sec = adversarial_sigs(g, (B, N, lanes + 5)), lanes + 5
        p2 = torch.rand((B, N, lanes), device=dev, generator=g) * 40
        kw = dict(pad=pad, sub_cost_mult=sub,
                  allowed=(torch.rand((B, D), device=dev, generator=g)
                           < 0.8).to(torch.int32) if al else None,
                  accum=torch.rand((B, N, D, lanes), device=dev,
                                   generator=g) * 100 if acc else None)
        args = (s1, s2, p2, dirs, 8.0, 24.0, 24, D, dmin, sec, False, hor)
        ref = sk.scan_sig_plain(*args, **kw)
        for variant in ('shared', 'global'):
            verdict(f'scan_mgm {variant} B {B} N {N} lanes {lanes} D {D} '
                    f'dirs {dirs} horizontal {hor} disp_min {dmin} sub {sub} '
                    f'accum {acc} allowed {al}',
                    zip(sk.scan_sig(*args, mgm_variant=variant, **kw), ref))
    # n_dirs x D x lanes too large for a block's shared memory
    s1 = adversarial_sigs(g, (1, 3, 832))
    s2 = adversarial_sigs(g, (1, 3, 832))
    p2 = torch.full((1, 3, 832), 32.0, device=dev)
    args = (s1, s2, p2, v3, 8.0, 24.0, 24, 600, -30, 832, True, False)
    variant = sk.scan_mgm_variant(600, 832, False)
    verdict(f'scan_mgm by shape ({variant}) N 3 lanes 832 D 600 dirs {v3}',
            zip(sk.scan_sig(*args), sk.scan_sig_plain(*args)))
    if variant != 'global':
        raise AssertionError('a 3 x 600 x 832 carry chose the shared '
                             'instantiation')


def check_adversarial_wta_dr(g, verdict):
    """K5 against its plain version on NaN, inf and all-BIG partials
    (the reference's NaN rule): D 1, 2, 17 and 64, one part or two, the
    horizontal part read strided in its (W, D, H) layout.  Then each
    instantiation at its edges: a band of 4 rows (W 45 and 130, H not a
    multiple of 4), of 2 rows (W 600) and the windowed one (W 1100), D 1
    to 528, disp_min from -(W + D) to W - 5 (every column of S_R off the
    image at either end), one line per shape, values and parts with every
    refinement and disp_min."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = g.device

    def volumes(B, H, D, W, kind):
        a = torch.randint(0, 30, (B, H, D, W), device=dev,
                          generator=g).float()
        c = torch.randint(0, 30, (B, W, D, H), device=dev,
                          generator=g).float()
        if kind == 'nan':
            a[torch.rand(a.shape, device=dev, generator=g) < 0.03] = \
                float('nan')
            c[:, 4] = float('nan')
        elif kind == 'inf':
            a[torch.rand(a.shape, device=dev, generator=g) < 0.1] = \
                float('inf')
            c[torch.rand(c.shape, device=dev, generator=g) < 0.05] = \
                float('-inf')
        elif kind == 'all BIG':
            a[:, :3] = mf.BIG
            c[:] = mf.BIG
        return a, c.permute(0, 3, 2, 1)

    def order(parts, a):
        return ' + '.join('S_v' if t is a else 'S_h' for t in parts)

    for D in (1, 2, 17, 64):
        for kind in ('nan', 'inf', 'all BIG'):
            a, ct = volumes(2, 19, D, 45, kind)
            for parts in ([a, ct], [ct, a], [a], [ct]):
                for subpix in ('vfit', 'parabola', 'none'):
                    for dmin in (-3, 5):
                        verdict(f'wta_dr D {D} {kind} {order(parts, a)} '
                                f'{subpix} disp_min {dmin}',
                                zip(sk.wta_dr(parts, dmin, subpix),
                                    sk.wta_dr_plain(parts, dmin, subpix)))
    for B, H, W, D in ((2, 18, 130, 17), (1, 9, 600, 64), (1, 5, 600, 1),
                       (1, 6, 1100, 528), (2, 7, 1100, 2)):
        for kind in ('random', 'nan', 'inf', 'all BIG'):
            a, ct = volumes(B, H, D, W, kind)
            for parts in ([a, ct], [ct, a], [a], [ct]):
                pairs = []
                for subpix in ('vfit', 'parabola', 'none'):
                    for dmin in (-(W + D), -(W // 2), 3, W - 5):
                        pairs += zip(sk.wta_dr(parts, dmin, subpix),
                                     sk.wta_dr_plain(parts, dmin, subpix))
                verdict(f'wta_dr {B} x {H} x {W} D {D} {kind} '
                        f'{order(parts, a)}, 3 refinements x 4 disp_min',
                        pairs)
            del a, ct
    torch.cuda.empty_cache()


def check_adversarial_sig(g, verdict):
    """The scan in signature mode (K4a) against its plain version:
    reference padding, invalid pixels, allowed candidates, lane-fold
    segments, vertical and horizontal passes, D 1 to 4097."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = g.device
    # (D, N, lanes, horizontal, disp_min, segment width, kind)
    cases = [(1, 2, 61, False, 0, None, 'pad'),
             (17, 1, 61, False, -5, None, 'allowed'),
             (17, 7, 61, True, 3, None, 'allowed'),
             (80, 9, 64, False, 0, 16, 'allowed'),
             (80, 9, 60, True, 0, 12, 'pad'),
             (257, 3, 61, False, -100, None, ''),
             (528, 2, 33, True, -20, None, 'allowed'),
             (4097, 2, 7, False, -2000, None, 'allowed')]
    for D, N, lanes, hor, dmin, seg_w, kind in cases:
        B = 2
        s1 = adversarial_sigs(g, (B, N, lanes), 0.1 if kind == 'pad' else 0.0)
        pad = 0
        if hor:
            pad = max(0, -dmin, dmin + D)
            pad += (-(dmin + pad)) % 8
            s2, sec_len = adversarial_sigs(g, (B, N + 2 * pad, lanes)), N
        else:
            s2, sec_len = adversarial_sigs(g, (B, N, lanes + 5)), lanes + 5
        p2 = torch.rand((B, N, lanes), device=dev, generator=g) * 40
        allowed = None
        if kind == 'allowed':
            shape = (B, D) if seg_w is None else (B, lanes // seg_w, D)
            allowed = (torch.rand(shape, device=dev, generator=g)
                       < 0.7).to(torch.int32)
        accum = torch.rand((B, N, D, lanes), device=dev, generator=g) * 100
        for dirs, rev, sub, acc in ((((0,), (1,), (-1,)), False, 2.0, accum),
                                    (((1,),), True, 0.0, None),
                                    (((0,),), True, 1.0, accum)):
            if hor and any(lat for (lat,) in dirs):
                continue
            args = (s1, s2, p2, dirs, 8.0, 24.0, 24, D, dmin, sec_len, rev,
                    hor)
            kw = dict(pad=pad, sub_cost_mult=sub, allowed=allowed,
                      accum=acc, seg_w=seg_w)
            verdict(f'scan_sig D {D} N {N} lanes {lanes} horizontal {hor} '
                    f'disp_min {dmin} seg_w {seg_w} {kind} dirs {dirs} '
                    f'reverse {rev} sub {sub} accum {acc is not None}',
                    zip(sk.scan_sig(*args, **kw),
                        sk.scan_sig_plain(*args, **kw)))


def check_outputs(root, specs, cpu_root, cpu_indices):
    """Phase 4 checks: the written files, the known shifts, and bitwise
    equality with the CPU run on the tiles it covered."""
    import numpy as np
    from s2p_tpu_torch.geo import geotiff
    names = ('rectified_disp.tif', 'rectified_mask.png',
             'rectified_disp_confidence.tif')
    for s in specs:
        d = os.path.join(root, f"tile_{s['index']}", 'pair_1')
        disp = geotiff.read(os.path.join(d, names[0]))
        mask = geotiff.read_png(os.path.join(d, names[1]))
        conf = geotiff.read(os.path.join(d, names[2]))
        shape = (s['h'], s['w1'])
        if disp.shape != shape or mask.shape != shape or conf.shape != shape:
            raise AssertionError(f"tile {s['index']}: shapes {disp.shape} "
                                 f"{mask.shape} {conf.shape} != {shape}")
        if disp.dtype != np.float32 or conf.dtype != np.float32:
            raise AssertionError(f"tile {s['index']}: dtypes {disp.dtype} "
                                 f'{conf.dtype}')
        if not np.array_equal(mask > 0, np.isfinite(disp)):
            raise AssertionError(f"tile {s['index']}: mask != finite disp")
        if not (np.isin(conf * 8, np.arange(9))).all():
            raise AssertionError(f"tile {s['index']}: confidence not k/8")
        inner = disp[8:-8, 8:-8]
        fin = np.isfinite(inner)
        good = (np.abs(inner[fin] - s['shift']) < 1.0).mean()
        print(f"  tile {s['index']}: {shape}, finite inner "
              f"{fin.mean():.4f}, within 1 px of {s['shift']}: {good:.4f}",
              flush=True)
        if fin.mean() < 0.8 or good <= 0.95:
            raise AssertionError(f"tile {s['index']}: the known shift is "
                                 'not recovered')
        if s['index'] in cpu_indices:
            c = os.path.join(cpu_root, f"tile_{s['index']}", 'pair_1')
            for name in names:
                with open(os.path.join(d, name), 'rb') as f1, \
                        open(os.path.join(c, name), 'rb') as f2:
                    if f1.read() != f2.read():
                        raise AssertionError(f"tile {s['index']}: {name} "
                                             'differs from the CPU run')
            print(f"  tile {s['index']}: the three files equal the CPU "
                  'run byte for byte', flush=True)


def sgm_pair(spec):
    """bench.py's pair: uniform noise, the secondary the reference moved
    right by ``shift`` px plus noise (disparity +shift); NaN borders."""
    import numpy as np
    rng = np.random.RandomState(spec['seed'])
    h, w = spec['h'], spec['w']
    im1 = rng.rand(h, w).astype(np.float32) * 1000
    im2 = np.roll(im1, spec['shift'], axis=1) + rng.rand(h, w).astype(
        np.float32)
    im1[:4] = np.nan
    im2[:, -6:] = np.nan
    return im1, im2


def stage5_camera(seed, h_term):
    """A synthetic RPC camera near (55.4 E, 21.0 S), about 1 m a pixel,
    columns moving ``10 * h_term`` px per metre of altitude, small cross
    terms in every polynomial; every camera shares its rows' polynomials,
    so two of them see a ground point on the same row."""
    import numpy as np
    from s2p_tpu_torch.geo.rpc import RPCModel
    rng = np.random.RandomState(seed)
    rows = np.random.RandomState(1000)
    col_num = rng.uniform(-1e-3, 1e-3, 20)
    col_num[:4] = (0.01, 1.0, 0.02, h_term)
    col_den = rng.uniform(-1e-4, 1e-4, 20)
    col_den[0] = 1.0
    row_num = rows.uniform(-1e-3, 1e-3, 20)
    row_num[:4] = (-0.02, 0.015, -1.0, 0.001)
    row_den = rows.uniform(-1e-4, 1e-4, 20)
    row_den[0] = 1.0
    return RPCModel(col_num=col_num, col_den=col_den, row_num=row_num,
                    row_den=row_den, lon_offset=55.4, lon_scale=0.05,
                    lat_offset=-21.0, lat_scale=0.05, alt_offset=500.0,
                    alt_scale=500.0, col_offset=5000.0, col_scale=5000.0,
                    row_offset=5000.0, row_scale=5000.0)


def stage5_config(root):
    from s2p_tpu_torch.config import Config, ImageSpec
    return Config(out_dir=root, out_crs='epsg:32740', gsd=1.0,
                  filtering_3d_r=2.5, filtering_3d_n=8, images=(
                      ImageSpec(img='ref.tif', rpcm=stage5_camera(1, 0.02)),
                      ImageSpec(img='sec.tif',
                                rpcm=stage5_camera(2, -0.015))))


def write_stage5_inputs(root, specs):
    """Stage 5's inputs beside each tile's stage-4 files: the two
    homographies (translations to the tile's place in the image, the
    secondary's by S5_SHIFT more), the tile's original mask (with a hole)
    and the scene's pointing correction (identity).  Returns the tile
    dicts."""
    import numpy as np
    from s2p_tpu_torch.geo import geotiff
    np.savetxt(os.path.join(root, 'global_pointing_pair_1.txt'), np.eye(3))
    tiles = []
    for k, s in enumerate(specs):
        tdir = os.path.join(root, f"tile_{s['index']}")
        x0, y0 = 3000.0 + 700 * k, 4000.0 + 300 * k
        for name, dx in (('H_ref.txt', 0.0), ('H_sec.txt', S5_SHIFT)):
            np.savetxt(os.path.join(tdir, 'pair_1', name),
                       [[1, 0, -x0 + dx], [0, 1, -y0], [0, 0, 1]])
        h, w = s['h'] - 2, s['w1'] - 3
        mask = np.full((h, w), 255, np.uint8)
        mask[40:60, 100:140] = 0
        geotiff.write_png(os.path.join(tdir, 'mask.png'), mask)
        tiles.append({'dir': tdir, 'coordinates': (x0, y0, w, h)})
    return tiles


def crop_tile(tile, root, size):
    """A copy of one tile's stage-5 inputs under ``root``, its rectified
    maps cropped at the origin to ``size`` (the homographies still hold)."""
    import numpy as np
    from s2p_tpu_torch.geo import geotiff
    h, w = size
    tdir = os.path.join(root, os.path.basename(tile['dir']))
    shutil.copytree(tile['dir'], tdir)
    pdir = os.path.join(tdir, 'pair_1')
    for name in ('rectified_disp.tif', 'rectified_ref.tif',
                 'rectified_disp_confidence.tif'):
        path = os.path.join(pdir, name)
        geotiff.write(path, np.ascontiguousarray(geotiff.read(path)[:h, :w]),
                      nodata=float('nan') if 'conf' not in name else None)
    path = os.path.join(pdir, 'rectified_mask.png')
    geotiff.write_png(path, np.ascontiguousarray(
        geotiff.read_png(path)[:h, :w]))
    return dict(tile, dir=tdir)


def model_altitudes(cfg, job, rows, cols):
    """The float64 model's answer at the given rectified pixels: the
    two-ray solve (12 secant steps) on the host cameras."""
    import numpy as np
    r1, r2 = cfg.images[0].rpcm, cfg.images[1].rpcm

    def apply(H, x, y):
        m = np.linalg.inv(H)
        z = m[2, 0] * x + m[2, 1] * y + m[2, 2]
        return ((m[0, 0] * x + m[0, 1] * y + m[0, 2]) / z,
                (m[1, 0] * x + m[1, 1] * y + m[1, 2]) / z)

    px, py = apply(job['H1'], cols, rows)
    qx, qy = apply(job['H2'] @ np.linalg.inv(job['A']),
                   cols + job['disp'][rows, cols].astype(np.float64), rows)
    h = np.zeros_like(px)
    for _ in range(12):
        a = r2.projection(*r1.localization(px, py, h), h)
        b = r2.projection(*r1.localization(px, py, h + 1.0), h + 1.0)
        ax, ay = b[0] - a[0], b[1] - a[1]
        lam = (ax * (qx - a[0]) + ay * (qy - a[1])) / (ax * ax + ay * ay)
        h = h + lam
    return h


def count_launches(fn):
    """(CUDA kernels the profiler saw, their summed device time in ms)
    while ``fn`` runs; (None, None) where it sees no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sum(e.count for e in events)
    if not kernels:
        return None, None
    return kernels, sum(e.self_device_time_total for e in events) / 1e3


def run_stage5(gpu_root, cpu_root, specs):
    """Stage 5 on bucket A's 8 tiles at full size on the card, after
    stage 4 wrote their files: synthetic cameras and homographies, the 3D
    filter on; its wall time per bucket (twice), the triangulation's
    launches and time and the neighbour count's time; then two tiles'
    crops card against CPU and a constant-disparity tile against the
    float64 model."""
    import numpy as np
    import torch
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.core import triangulation
    from s2p_tpu_torch.geo import crs, geotiff, ply
    from s2p_tpu_torch.ops.filtering import count_3d_neighbors_batch

    cfg = stage5_config(gpu_root)
    tiles = write_stage5_inputs(gpu_root, specs)
    for run in (1, 2):
        t0 = time.perf_counter()
        pipeline.disparity_to_ply_all(cfg, tiles)
        torch.cuda.synchronize()
        print(f'  disparity_to_ply_all (bucket A, {len(tiles)} tiles, run '
              f'{run}): {time.perf_counter() - t0:.3f} s', flush=True)
    for t in tiles:
        pts, _ = ply.read_ply(os.path.join(t['dir'], 'cloud.ply'))
        disp = geotiff.read(os.path.join(t['dir'], 'pair_1',
                                         'rectified_disp.tif'))
        frac = len(pts) / np.isfinite(disp).sum()
        alt = pts[:, 2]
        print(f"  {tile_name(t)}: {len(pts)} points "
              f'({frac:.4f} of the finite disparities), altitude '
              f'{np.percentile(alt, 1):.2f} .. {np.percentile(alt, 99):.2f} m',
              flush=True)
        if (pts.shape[1] != 7 or not np.isfinite(pts).all() or frac < 0.5
                or not 200 < np.median(alt) < 400):
            raise AssertionError(f"stage 5: {t['dir']}: an implausible "
                                 'cloud')

    jobs = [pipeline._ply_tile_job(cfg, t) for t in tiles]
    out_crs = crs.CRS(cfg.out_crs)

    def tri():
        return triangulation.disp_to_xyz_batch(jobs, out_crs=out_crs)

    tri()
    t0 = time.perf_counter()
    res = tri()
    torch.cuda.synchronize()
    t_tri = time.perf_counter() - t0
    kernels, busy_ms = count_launches(tri)
    p = int(np.ceil(cfg.filtering_3d_r / cfg.gsd))
    xyzs = [r[0] for r in res]
    count_3d_neighbors_batch(xyzs, cfg.filtering_3d_r, p)
    t0 = time.perf_counter()
    count_3d_neighbors_batch(xyzs, cfg.filtering_3d_r, p)
    torch.cuda.synchronize()
    t_cnt = time.perf_counter() - t0
    busy = ('not measured' if busy_ms is None else
            f'{busy_ms:.1f} ms (idle share {1 - busy_ms / 1e3 / t_tri:.3f})')
    print(f'  disp_to_xyz_batch (bucket A, one batch of {len(jobs)}): '
          f'{t_tri:.3f} s, CUDA kernels '
          f"{kernels if kernels is not None else 'not measured'}, device "
          f'busy {busy}', flush=True)
    print(f'  count_3d_neighbors_batch (bucket A, p {p}): {t_cnt:.4f} s',
          flush=True)

    # card against CPU on crops of two tiles
    runs = {}
    for dev in ('cuda', 'cpu'):
        root = os.path.join(cpu_root, f's5_{dev}')
        os.makedirs(root)
        shutil.copy(os.path.join(gpu_root, 'global_pointing_pair_1.txt'),
                    root)
        crops = [crop_tile(t, root, S5_CROP) for t in tiles[:2]]
        pipeline.disparity_to_ply_all(stage5_config(root), crops,
                                      device=dev)
        runs[dev] = crops
    for a, b in zip(runs['cuda'], runs['cpu']):
        fa, fb = (os.path.join(t['dir'], 'cloud.ply') for t in (a, b))
        with open(fa, 'rb') as x, open(fb, 'rb') as y:
            same = x.read() == y.read()
        pa, pb = ply.read_ply(fa)[0], ply.read_ply(fb)[0]
        if pa.shape != pb.shape or not np.array_equal(pa[:, 3:], pb[:, 3:]):
            raise AssertionError(f"stage 5 crop {a['dir']}: points, colours "
                                 'or confidence differ from the CPU run')
        d_xy = float(np.abs(pa[:, :2] - pb[:, :2]).max()) if len(pa) else 0.
        d_z = float(np.abs(pa[:, 2] - pb[:, 2]).max()) if len(pa) else 0.
        print(f"  crop {S5_CROP} of {tile_name(a)}: "
              f'{len(pa)} points, cloud.ply equals the CPU run byte for '
              f'byte: {same}; max difference xy {d_xy} m, altitude {d_z} m',
              flush=True)
        if d_xy > S5_XY_TOL_M or d_z > S5_ALT_TOL_M:
            raise AssertionError('stage 5 crop: the card differs from the '
                                 'CPU beyond the tolerance')

    # a constant disparity against the float64 model's altitudes
    job = dict(jobs[0])
    job['disp'] = np.where(np.isfinite(job['disp']), S5_KNOWN_DISP,
                           np.nan).astype(np.float32)
    (xyz, err), = triangulation.disp_to_xyz_batch([job], out_crs=None)
    rows, cols = np.mgrid[4:job['disp'].shape[0]:8, 4:job['disp'].shape[1]:8]
    rows, cols = rows.ravel(), cols.ravel()
    alt = xyz[rows, cols, 2]
    fin = np.isfinite(alt)
    ref = model_altitudes(cfg, job, rows[fin], cols[fin])
    d = float(np.abs(alt[fin] - ref).max())
    print(f'  constant disparity {S5_KNOWN_DISP}: {fin.sum()} sampled '
          f'points, altitude {alt[fin].min():.3f} .. {alt[fin].max():.3f} m,'
          f' max difference from the float64 model {d:.5f} m (tolerance '
          f'{S5_KNOWN_TOL_M} m)', flush=True)
    if fin.mean() < 0.5 or d > S5_KNOWN_TOL_M:
        raise AssertionError('stage 5: the constant-disparity tile misses '
                             "the model's altitude")


def check_sgm_kernels(stats):
    """Phase 4: the classic matcher's kernels against their plain versions
    on the inputs ``aggregate_partials`` gives them for bench.py's pair."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk
    from s2p_tpu_torch.ops.census import census_transform
    from s2p_tpu_torch.ops.sgm import SgmParams

    dev = torch.device('cuda')
    im1, im2 = sgm_pair(SGM_PAIR)
    dmin = SGM_PAIR['dmin']
    D = SGM_PAIR['dmax'] - dmin + 1
    H, W = im1.shape
    sig = [sk._pack(*one_word(census_transform(
        torch.as_tensor(im, device=dev), 5)))[None] for im in (im1, im2)]
    p2 = torch.full((1, H, W), 32.0, dtype=torch.float32, device=dev)
    ins = {'v': (sig[0], sig[1], p2),
           'h': tuple(t.transpose(1, 2).contiguous()
                      for t in (sig[0], sig[1], p2))}

    def run_pass(name, key, dirs):
        o = key[0]
        args = (*ins[o], dirs, 8.0, 24.0, 24, D, dmin, W, key[1] == 'b',
                o == 'h')
        Sk, vk = sk.scan_sig(*args)
        Sp, vp = sk.scan_sig_plain(*args)
        ok, err = equal(Sk, Sp)
        ok_v, err_v = equal(vk, vp)
        vol = Sk.numel()
        nbytes = (sum(4 * t.numel() for t in ins[o]) + 4 * vol
                  + 4 * vk.numel())
        # per element: the census cost (xor, and, popcount, 3 tests),
        # 8 f32 operations per lateral, the sums and the vote
        ops = vol * (6 + sum(8 * len(l) + 3 for l in dirs))
        record(stats, f'{name} {key}', '', ok and ok_v, max(err, err_v),
               timed(lambda: sk.scan_sig(*args), 3),
               timed(lambda: sk.scan_sig_plain(*args), 1), nbytes, ops)
        return Sk

    S = {}
    for key, _, dirs in sk.sgm_scan_passes(SgmParams(mgm=False)):
        Sk = run_pass('scan_sig', key, dirs)
        S[key[0]] = Sk if key[0] not in S else S[key[0]] + Sk
    for nb, want in ((3, 'vf'), (2, 'hf')):
        for key, _, dirs in sk.sgm_scan_passes(
                SgmParams(mgm=True, mgm_neighbors=nb)):
            if key == want:
                run_pass('scan_mgm', key, dirs)
    # K4b's step floor: one cluster barrier per step of the two passes
    floor = sum(timed(lambda: sk.cluster_sync_loop(1, n), 5)
                for n in (H, W))
    stats['scan_mgm']['step_floor_ms'] = floor
    print(f'  scan_mgm step floor ({H} + {W} cluster barriers, no work): '
          f'{floor:.4f} ms', flush=True)

    parts = [S['v'], S['h'].permute(0, 3, 2, 1)]
    got = sk.wta_dr(parts, dmin, 'vfit')
    ref = sk.wta_dr_plain(parts, dmin, 'vfit')
    oks, errs = zip(*(equal(a, b) for a, b in zip(got, ref)))
    vol = parts[0].numel()
    record(stats, 'wta_dr', '', all(oks), max(errs),
           timed(lambda: sk.wta_dr(parts, dmin, 'vfit'), 5),
           timed(lambda: sk.wta_dr_plain(parts, dmin, 'vfit'), 2),
           8 * vol + 12 * H * W, 4 * vol)
    del S, parts
    torch.cuda.empty_cache()


def check_mgm_tile():
    """K4b at the classic tile's shape (832 x 832, 96 candidates from
    -30): the 3-lateral vertical pass and the 2-lateral horizontal pass of
    ``aggregate(mgm=True)`` against the plain version, bitwise, timed."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk
    from s2p_tpu_torch.ops.census import census_transform
    from s2p_tpu_torch.ops.sgm import SgmParams

    dev = torch.device('cuda')
    spec = dict(SGM_TILE, h=832, w=832)
    im1, im2 = sgm_pair(spec)
    dmin = spec['dmin']
    D = spec['dmax'] - dmin + 1
    H, W = im1.shape
    sig = [sk._pack(*one_word(census_transform(
        torch.as_tensor(im, device=dev), 5)))[None] for im in (im1, im2)]
    p2 = torch.full((1, H, W), 32.0, dtype=torch.float32, device=dev)
    ins = {'v': (sig[0], sig[1], p2),
           'h': tuple(t.transpose(1, 2).contiguous()
                      for t in (sig[0], sig[1], p2))}
    for nb, want in ((3, 'vf'), (2, 'hf')):
        for key, _, dirs in sk.sgm_scan_passes(
                SgmParams(mgm=True, mgm_neighbors=nb)):
            if key != want:
                continue
            o = key[0]
            args = (*ins[o], dirs, 8.0, 24.0, 24, D, dmin, W, False, o == 'h')
            got = sk.scan_sig(*args)
            ref = sk.scan_sig_plain(*args)
            ok = all(equal(a, b)[0] for a, b in zip(got, ref))
            print(f'  scan_mgm tile {H} x {W} D {D} {key} '
                  f'({sk.scan_mgm_variant(D, W, o == "h")}): '
                  f'bitwise={ok}, kernel '
                  f'{timed(lambda: sk.scan_sig(*args), 3):.3f} ms',
                  flush=True)
            if not ok:
                raise AssertionError(f'scan_mgm tile {key} differs from its '
                                     'plain version')
            del got, ref
    torch.cuda.empty_cache()


def check_shift(name, disp, valid, conf, spec, nv=8):
    """The classic matcher's outputs: shapes, types, the NaN pattern, the
    confidence steps, and the known shift on the finite inner pixels."""
    import numpy as np
    shape = (spec['h'], spec['w'])
    if disp.shape != shape or valid.shape != shape or conf.shape != shape:
        raise AssertionError(f'{name}: shapes {disp.shape} {valid.shape} '
                             f'{conf.shape} != {shape}')
    if disp.dtype != np.float32 or conf.dtype != np.float32:
        raise AssertionError(f'{name}: dtypes {disp.dtype} {conf.dtype}')
    if not np.array_equal(valid, np.isfinite(disp)):
        raise AssertionError(f'{name}: valid != finite disp')
    if not np.isin(conf * nv, np.arange(nv + 1)).all():
        raise AssertionError(f'{name}: confidence not k/{nv}')
    inner = disp[8:-8, 8:-16]
    fin = np.isfinite(inner)
    good = (np.abs(inner[fin] - spec['shift']) < 1.0).mean()
    print(f'  {name}: {shape}, finite inner {fin.mean():.4f}, within 1 px '
          f"of {spec['shift']}: {good:.4f}", flush=True)
    if fin.mean() < 0.8 or good <= 0.95:
        raise AssertionError(f'{name}: the known shift is not recovered')


def run_sgm_path():
    """Phase 6: the classic matcher's entry points on the card."""
    import numpy as np
    import torch
    from s2p_tpu_torch.ops import sgm as tsgm
    from s2p_tpu_torch.ops import sgm_kernels as sk

    p = tsgm.SgmParams(mgm=False)
    pair = sgm_pair(SGM_PAIR)
    for name, spec, params in (
            ('match_pair 512', SGM_PAIR, p),
            ('match_pair 800', SGM_TILE, p),
            ("match_pair 512 lr_mode='full'", SGM_PAIR,
             tsgm.SgmParams(mgm=False, lr_mode='full'))):
        im1, im2 = pair if spec is SGM_PAIR else sgm_pair(spec)
        t0 = time.perf_counter()
        out = tsgm.match_pair(im1, im2, spec['dmin'], spec['dmax'], params)
        print(f'  {name}: {time.perf_counter() - t0:.3f} s', flush=True)
        check_shift(name, *out, spec)
    # K4b's route: a direct aggregate call with MGM laterals
    dev = torch.device('cuda')
    a, b = (torch.as_tensor(im, device=dev) for im in pair)
    t0 = time.perf_counter()
    S, valid1, votes = sk.aggregate(
        a, b, SGM_PAIR['dmin'], SGM_PAIR['dmax'],
        tsgm.SgmParams(mgm=True, mgm_neighbors=3))
    torch.cuda.synchronize()
    print(f'  aggregate (MGM, 3 laterals): {time.perf_counter() - t0:.3f} s',
          flush=True)
    d = (S.argmin(dim=2) + SGM_PAIR['dmin']).cpu().numpy()
    v = valid1.cpu().numpy()
    if not torch.isfinite(S).all() or len(votes) != 8:
        raise AssertionError('aggregate: non-finite costs or missing votes')
    good = (np.abs(d - SGM_PAIR['shift'])[8:-8, 8:-16][v[8:-8, 8:-16]]
            <= 1).mean()
    print(f'  aggregate: WTA within 1 px of the shift on {good:.4f} of the '
          'valid inner pixels', flush=True)
    if good <= 0.95:
        raise AssertionError('aggregate: the known shift is not recovered')


def check_sgm_crop():
    """Phase 7: the classic matcher on a 128 x 128 crop, card against the
    plain versions on the CPU, byte for byte."""
    from s2p_tpu_torch.ops import sgm as tsgm
    im1, im2 = (im[:128, :128].copy() for im in sgm_pair(SGM_PAIR))
    for params in (tsgm.SgmParams(mgm=False),
                   tsgm.SgmParams(mgm=False, lr_mode='full')):
        gpu = tsgm.match_pair(im1, im2, SGM_PAIR['dmin'], SGM_PAIR['dmax'],
                              params)
        cpu = tsgm.match_pair(im1, im2, SGM_PAIR['dmin'], SGM_PAIR['dmax'],
                              params, device='cpu')
        for name, x, y in zip(('disp', 'valid', 'confidence'), gpu, cpu):
            if x.dtype != y.dtype or x.tobytes() != y.tobytes():
                raise AssertionError(f'crop ({params.lr_mode}): {name} '
                                     'differs from the CPU run')
        print(f'  crop 128 x 128 ({params.lr_mode}): disp, valid and '
              'confidence equal the CPU run byte for byte', flush=True)


def check_signed_prepass(pairs, stats):
    """Phase 9: the pre-pass at a signed base with the padded secondary,
    as the single-tile route gives it, on the 800 x 800 tile."""
    import torch
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = torch.device('cuda')
    a, b = (torch.as_tensor(im, device=dev)[None]
            for im in pairs[SINGLE_800['index']])
    dmin = SINGLE_800['dmin']
    D = SINGLE_800['dmax'] - dmin + 1
    s1, s2 = sk.flow_sigs(a, b, 5)
    W = s1.shape[2]
    s1t = s1.transpose(1, 2).contiguous()
    s2tp, pad, sec_len = sk.prepass_secondary(s2, W, dmin, D)
    args = (s1t, s2tp, D, dmin, 24, pad, sec_len)
    got = sk.cost_prepass(*args)
    ok, err = equal(got, sk.cost_prepass_plain(*args))
    print(f'  cost_prepass at base {dmin}: pad {pad}, secondary rows '
          f'{s2tp.shape[1]}, {int((got == 255).sum())} of {got.numel()} '
          'candidates out of range', flush=True)
    record(stats, 'cost_prepass_signed', '', ok, err,
           timed(lambda: sk.cost_prepass(*args), 5),
           timed(lambda: sk.cost_prepass_plain(*args), 2),
           4 * s1t.numel() + 4 * s2tp.numel() + got.numel(), 0)


def check_fold_kernels(specs, pairs, stats):
    """Phase 9: the four signature-mode scans of bucket A's L side folded
    by KERNEL_FOLD against their plain versions, and against the same
    scans over the tiles unfolded (bitwise per tile, timed)."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk

    dev = torch.device('cuda')
    v = mf.MgmVariant()
    D = BUCKET_A['D']
    b1, b2 = bucket_arrays(specs, BUCKET_A, pairs)
    n, H, W = b1.shape
    _, seg_w = mf.lane_fold_plan(W, D, n)
    G, B = n // KERNEL_FOLD, KERNEL_FOLD

    def ints(key):
        return torch.tensor([s[key] for s in specs], dtype=torch.int32,
                            device=dev)

    dm = ints('dmin')
    dt = ints('dmax') - dm + 1
    s1 = mf.census_bits_raw(torch.as_tensor(b1, device=dev),
                            v.census_win)[..., 0]
    s2 = mf.census_bits_raw(torch.as_tensor(b2, device=dev),
                            v.census_win)[..., 0]
    sr, ss, _ = mf._side_sigs(s1, s2, dm, ints('h'), ints('w1'),
                              ints('w2'), extra=seg_w - W, ref_pad=seg_w - W)
    allowed = (torch.arange(D, device=dev)[None, :] < dt[:, None]) \
        .to(torch.int32)
    folded = sk.fold_inputs(sr.reshape(G, B, H, seg_w),
                            ss.reshape(G, B, H, seg_w), D, v.p2)
    # the same tiles one by one: horizontal inputs transposed, the
    # secondary padded by D rows as in the folded layout
    one = {'v': (sr, ss, torch.full((n, H, seg_w), v.p2,
                                    dtype=torch.float32, device=dev), seg_w),
           'h': (sr.transpose(1, 2).contiguous(),
                 torch.nn.functional.pad(ss.transpose(1, 2), (0, 0, 0, D)),
                 torch.full((n, seg_w, H), v.p2, dtype=torch.float32,
                            device=dev), seg_w + D)}
    passes = sk.scan_passes(v)
    sub = float(sum(len(i) for _, i, _ in passes) - 1)
    t_fold = t_one = 0.0
    for key, _, lats in passes:
        o = key[0]
        dirs = tuple((lat,) for lat in lats)
        a, b, p2, sec_len, seg = folded[o]
        args = (a, b, p2, dirs, v.p1, mf.BIG, 24, D, 0, sec_len,
                key[1] == 'b', o == 'h')
        kw = dict(sub_cost_mult=sub, allowed=allowed.reshape(G, B, D),
                  seg_w=seg)
        Sk, vk = sk.scan_sig(*args, **kw)
        Sp, vp = sk.scan_sig_plain(*args, **kw)
        ok, err = equal(Sk, Sp)
        ok_v, err_v = equal(vk, vp)
        vol = Sk.numel()
        nbytes = (sum(4 * t.numel() for t in (a, b, p2)) + 4 * vol
                  + 4 * vk.numel() + 4 * allowed.numel())
        ops = vol * (6 + 11 * len(lats))
        ms = timed(lambda: sk.scan_sig(*args, **kw), 3)
        record(stats, f'scan_sig_seg {key}', '', ok and ok_v,
               max(err, err_v), ms,
               timed(lambda: sk.scan_sig_plain(*args, **kw), 1), nbytes,
               ops)
        del Sp, vp
        # unfolded: the 8 tiles on the batch axis, one segment each
        args1 = (*one[o][:3], dirs, v.p1, mf.BIG, 24, D, 0, one[o][3],
                 key[1] == 'b', o == 'h')
        kw1 = dict(sub_cost_mult=sub, allowed=allowed)
        S1, v1 = sk.scan_sig(*args1, **kw1)
        if o == 'v':      # (G, H, D, B * seg_w) -> (n, H, D, seg_w)
            Sf = Sk.reshape(G, H, D, B, seg_w).permute(0, 3, 1, 2, 4)
            vf = vk.reshape(G, -1, H, B, seg_w).permute(0, 3, 1, 2, 4)
        else:             # (G, seg_w, D, B * H) -> (n, seg_w, D, H)
            Sf = Sk.reshape(G, seg_w, D, B, H).permute(0, 3, 1, 2, 4)
            vf = vk.reshape(G, -1, seg_w, B, H).permute(0, 3, 1, 2, 4)
        same = (equal(Sf.reshape(S1.shape), S1)[0]
                and equal(vf.reshape(v1.shape), v1)[0])
        ms1 = timed(lambda: sk.scan_sig(*args1, **kw1), 3)
        print(f'    {key}: folded {ms:.3f} ms, unfolded {ms1:.3f} ms, '
              f'folded / unfolded {ms / ms1:.4f}, equal per tile: {same}',
              flush=True)
        if not same:
            raise AssertionError(f'scan_sig_seg {key}: the folded scan '
                                 'differs from the unfolded one')
        t_fold += ms
        t_one += ms1
        sub = 0.0
        del Sk, vk, S1, v1
    print(f'  four passes: folded {t_fold:.3f} ms, unfolded {t_one:.3f} ms, '
          f'folded / unfolded {t_fold / t_one:.4f}', flush=True)
    torch.cuda.empty_cache()


def check_known_shift(name, disp, spec):
    """A single-tile map: its shape, and the known shift on the finite
    inner pixels."""
    import numpy as np
    shape = (spec['h'], spec['w1'])
    if disp.shape != shape or disp.dtype != np.float32:
        raise AssertionError(f'{name}: {disp.shape} {disp.dtype}, want '
                             f'{shape} float32')
    inner = disp[8:-8, 8:-8]
    fin = np.isfinite(inner)
    good = (np.abs(inner[fin] - spec['shift']) < 1.0).mean()
    print(f'  {name}: {shape}, finite inner {fin.mean():.4f}, within 1 px '
          f"of {spec['shift']}: {good:.4f}", flush=True)
    if fin.mean() < 0.8 or good <= 0.95:
        raise AssertionError(f'{name}: the known shift is not recovered')


def run_single_path(pairs):
    """Phase 10, the path itself: ``mgm_binary_match`` on the card on
    both tiles.  Returns their (disp, conf) tensors."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    out = {}
    for spec in (SINGLE, SINGLE_800):
        im1, im2 = pairs[spec['index']]
        t0 = time.perf_counter()
        out[spec['index']] = mf.mgm_binary_match(im1, im2, spec['dmin'],
                                                 spec['dmax'])
        torch.cuda.synchronize()
        print(f"  mgm_binary_match {spec['h']} x {spec['w1']}: "
              f'{time.perf_counter() - t0:.3f} s', flush=True)
    return out


def check_single_path(pairs, out):
    """Phase 10 checks: each tile against the batch entry on the card,
    its known shift; compute_disparity_map; the wall time at 800 x 800."""
    import numpy as np
    import torch
    from s2p_tpu_torch.config import Config
    from s2p_tpu_torch.core import matching
    from s2p_tpu_torch.ops import mgm_flow as mf

    for spec in (SINGLE, SINGLE_800):
        im1, im2 = pairs[spec['index']]
        disp, conf = out[spec['index']]
        h, w = spec['h'], spec['w1']
        D = spec['dmax'] - spec['dmin'] + 1
        Hp, Wp = -(-h // 8) * 8, -(-w // 8) * 8
        b1 = np.full((1, Hp, Wp), np.nan, np.float32)
        b2 = np.full((1, Hp, Wp), np.nan, np.float32)
        b1[0, :h, :w] = im1
        b2[0, :h, :spec['w2']] = im2
        ref = mf.mgm_binary_match_batch(b1, b2, [spec['dmin']], D, [h],
                                        [w], [spec['w2']], [D])
        for name, x, y in (('disp', disp, ref['disp'][0, :h, :w]),
                           ('confidence', conf, ref['confidence'][0, :h, :w])):
            ok, err = equal(x, y)
            if not ok:
                raise AssertionError(f'single tile {h} x {w}: {name} '
                                     'differs from the batch entry '
                                     f'(max abs error {err})')
        print(f'  single tile {h} x {w}: disp and confidence equal the '
              'batch entry bitwise', flush=True)
        check_known_shift(f'mgm_binary_match {h} x {w}', disp.cpu().numpy(),
                          spec)
    im1, im2 = pairs[SINGLE['index']]
    t0 = time.perf_counter()
    disp, mask, conf = matching.compute_disparity_map(
        Config(), im1, im2, SINGLE['dmin'], SINGLE['dmax'])
    print(f'  compute_disparity_map: {time.perf_counter() - t0:.3f} s',
          flush=True)
    if mask.dtype != np.uint8 or not np.array_equal(mask > 0,
                                                    np.isfinite(disp)):
        raise AssertionError('compute_disparity_map: mask != finite disp')
    if conf.shape != disp.shape or not np.isin(conf * 8,
                                               np.arange(9)).all():
        raise AssertionError('compute_disparity_map: confidence not k/8')
    check_known_shift('compute_disparity_map', disp, SINGLE)
    im1, im2 = pairs[SINGLE_800['index']]
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        mf.mgm_binary_match(im1, im2, SINGLE_800['dmin'], SINGLE_800['dmax'])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"  mgm_binary_match {SINGLE_800['h']} x {SINGLE_800['w1']} wall, "
          f'warm: median {statistics.median(walls[1:]) * 1e3:.3f} ms of '
          f'{[round(t * 1e3, 3) for t in walls[1:]]}', flush=True)


@contextmanager
def spy_wta(calls):
    """While the block runs, append the arguments of every WTA call on
    CUDA tensors to ``calls`` (the partials copied), through the names
    sgm_kernels and mgm_flow call it by."""
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk
    orig = sk.wta

    def wta(parts, *a, **kw):
        if parts[0].is_cuda:
            calls.append(([p.clone() for p in parts], a, kw))
        return orig(parts, *a, **kw)
    sk.wta = mf.wta = wta
    try:
        yield
    finally:
        sk.wta = mf.wta = orig


def check_single_crop(pairs, stats, launches):
    """Phase 10: a 128 x 160 crop with edge_subpix, card against the CPU
    byte for byte; the launches of the card's run, and its WTA calls (the
    single-tile modes, K3 as ``wta_edge``) held against their plain
    version on the partials that run gave them."""
    import torch
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk
    im1, im2 = (im[:128, :160].copy() for im in pairs[SINGLE['index']])
    v = mf.MgmVariant(edge_subpix=True, subpix_plateau='zero')
    calls = []
    sk.reset_launch_counts()
    with spy_wta(calls):
        gpu = mf.mgm_binary_match(im1, im2, SINGLE['dmin'], SINGLE['dmax'],
                                  v)
        torch.cuda.synchronize()
    launches['single_edge'] = sk.launch_counts()
    print(f"  launches (crop): {launches['single_edge']}", flush=True)
    cpu = mf.mgm_binary_match(im1, im2, SINGLE['dmin'], SINGLE['dmax'], v,
                              device='cpu')
    for name, x, y in zip(('disp', 'confidence'), gpu, cpu):
        x, y = x.cpu().numpy(), y.numpy()
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            raise AssertionError(f'single-tile crop: {name} differs from '
                                 'the CPU run')
    print('  crop 128 x 160 (edge_subpix, plateau zero): disp and '
          'confidence equal the CPU run byte for byte', flush=True)
    for side, (parts, a, kw) in zip(('L', 'R'), calls):
        off, d_int = sk.wta(parts, *a, **kw)
        off_p, d_p = sk.wta_plain(parts, *a, **kw)
        ok, err = equal(off, off_p)
        ok_d, err_d = equal(d_int, d_p)
        vol = parts[0].numel()
        record(stats, 'wta_edge', side, ok and ok_d, max(err, err_d),
               timed(lambda: sk.wta(parts, *a, **kw), 5),
               timed(lambda: sk.wta_plain(parts, *a, **kw), 2),
               4 * len(parts) * vol + 4 * off.numel() + 4 * d_int.numel(),
               len(parts) * vol)


def check_folded_batch(specs, pairs, folded):
    """Phase 11: the folded batch's outputs against the unfolded batch."""
    from s2p_tpu_torch.ops import mgm_flow as mf
    b1, b2 = bucket_arrays(specs, BUCKET_A, pairs)
    plain = mf.mgm_binary_match_batch(*fold_args(specs, b1, b2))
    for key in ('disp', 'confidence', 'confidence_u8'):
        for k in range(len(specs)):
            ok, err = equal(folded[key][k], plain[key][k])
            if not ok:
                raise AssertionError(f'folded batch: tile {k} {key} differs '
                                     f'from the unfolded batch ({err})')
    print(f'  folded batch: {len(specs)} tiles equal the unfolded batch '
          'bitwise (disp, confidence, confidence_u8)', flush=True)


def fold_args(specs, b1, b2):
    """mgm_binary_match_batch's arguments for bucket A."""
    from s2p_tpu_torch.ops import mgm_flow as mf
    return (b1, b2, [s['dmin'] for s in specs], BUCKET_A['D'],
            [s['h'] for s in specs], [s['w1'] for s in specs],
            [s['w2'] for s in specs],
            [s['dmax'] - s['dmin'] + 1 for s in specs], mf.MgmVariant())


def check_warp():
    """W1 against its plain version on the card, bitwise and NaN-aware,
    one line per case; then the plain version on the card against the
    plain version on the CPU."""
    import numpy as np
    import torch
    from s2p_tpu_torch.ops import homography as hom
    from s2p_tpu_torch.ops import interp

    dev = torch.device('cuda')
    rng = np.random.RandomState(41)

    def source(h, w, nan):
        img = (rng.rand(h, w) * 255).astype(np.float32)
        if nan:     # NaN along every border and a block inside
            img[0], img[-1], img[:, 0], img[:, -1] = (np.nan,) * 4
            img[h // 3:h // 3 + 3, w // 2:w // 2 + 4] = np.nan
        return img

    def hinvs(n, z_cross=False):
        out = []
        for _ in range(n):
            A = np.eye(3)
            A[:2, :2] += rng.normal(0, 0.05, (2, 2))
            A[:2, 2] = rng.uniform(-5, 5, 2)
            hv = np.linalg.inv(A)
            if z_cross:     # z = 1 - 0.05 x: 0 at column 20
                hv[2] = (-0.05, 0.0, 1.0)
            out.append(hv)
        return np.stack(out).astype(np.float32)

    def inputs(img, order, nan):
        if order == 5:
            coeffs, mask = hom._spline5_inputs(img)
        else:
            coeffs, mask = (img if nan else np.nan_to_num(img)), None
        return (torch.from_numpy(coeffs).to(dev),
                None if mask is None else torch.from_numpy(mask).to(dev))

    def case(label, img, hv, ow, oh, order, nan):
        c, m = inputs(img, order, nan)
        h = torch.from_numpy(hv).to(dev)
        got = interp.warp_homography(c, h, ow, oh, order, m)
        ref = torch.stack([interp.warp_homography_plain(c, h[k], ow, oh,
                                                        order, m)
                           for k in range(len(h))])
        torch.cuda.synchronize()
        ok, err = equal(got, ref)
        print(f'  W1 {label}: order {order}, {len(hv)} x {oh} x {ow} from '
              f'{img.shape[0]} x {img.shape[1]}, NaN source {nan}: '
              f'bitwise={ok} max_abs_err={err} '
              f'(NaN outputs {int(torch.isnan(got).sum())})', flush=True)
        if not ok:
            raise AssertionError(f'W1 {label} (order {order}) differs from '
                                 f'its plain version: {err}')

    def affine(s, tx, ty):
        """x -> s x + t in both axes, as a batch of one."""
        return np.array([[[s, 0, tx], [0, s, ty], [0, 0, 1]]], np.float32)

    for order in (1, 3, 5):
        for nan in (False, True):
            case('3 jobs', source(61, 77, nan), hinvs(3), 70, 50, order, nan)
            case('larger output', source(40, 50, nan), hinvs(2), 170, 130,
                 order, nan)
            case('z crosses 0', source(61, 77, nan), hinvs(2, True), 60, 40,
                 order, nan)
            # the edges of the interior path: an output strip of 1/8-px
            # steps over the first or last 4 px of each axis, so that the
            # supports cross each border by 0, 1 and 2 px (order 5)
            img = source(61, 77, nan)
            for side, hv, ow, oh in (
                    ('left', [[0.125, 0, 0], [0, 1, 20], [0, 0, 1]], 33,
                     20),
                    ('right', [[0.125, 0, 72], [0, 1, 20], [0, 0, 1]], 33,
                     20),
                    ('top', [[1, 0, 20], [0, 0.125, 0], [0, 0, 1]], 20, 33),
                    ('bottom', [[1, 0, 20], [0, 0.125, 56], [0, 0, 1]], 20,
                     33)):
                case(f'{side} border by 0-2 px', img,
                     np.asarray(hv, np.float32)[None], ow, oh, order, nan)
            # sources with at most one interior position at order 5
            for n in (6, 5):
                case(f'{n} x {n} source', source(n, n, nan),
                     affine(n / 40, -0.1, 0.05), 44, 44, order, nan)
            case('scaled by 8 (magnified)', source(61, 77, nan),
                 affine(0.125, 3.3, 2.7), 300, 200, order, nan)
            case('scaled by 8 (minified)', source(300, 340, nan),
                 affine(8.0, 0.4, 0.6), 42, 37, order, nan)
        case('1 job', source(61, 77, True), hinvs(1), 83, 67, order, True)
        case('1 x 1 output', source(61, 77, True), hinvs(2), 1, 1, order,
             True)
    # order 5 with a NaN band at the scene's bucket: 2 tiles of 832 x 1024
    img = source(2000, 2800, False)
    img[1000:1004] = np.nan
    band = np.stack([np.linalg.inv(np.array(
        [[1.0, 0.01 * k, -200.0 - 800 * k], [-0.01 * k, 1.0, -700.0],
         [0, 0, 1]])) for k in (1, 2)]).astype(np.float32)
    case('NaN band at the scene bucket', img, band, 1024, 832, 5, True)

    # 65 jobs on one source and bucket: two launches (64 + 1)
    img = source(300, 340, True)
    Hs = [np.linalg.inv(hv) for hv in hinvs(65)]
    before = interp.launch_counts()['warp']
    got = hom.warp_jobs_batched([(img, H, 250 + k % 3, 200) for k, H in
                                 enumerate(Hs)])
    launched = interp.launch_counts()['warp'] - before
    c, m = inputs(img, 5, True)
    for k, H in enumerate(Hs):
        hv = torch.from_numpy(hom._inverse_f32(H)).to(dev)
        ref = interp.warp_homography_plain(c, hv, 250 + k % 3, 200, 5, m)
        ok, err = equal(torch.from_numpy(got[k]), ref.cpu())
        if not ok:
            raise AssertionError(f'W1 65 jobs: job {k} differs from its '
                                 f'plain version: {err}')
    print(f'  W1 65 jobs through warp_jobs_batched: {launched} launches, '
          'every job bitwise equal to its plain version', flush=True)
    if launched != 2:
        raise AssertionError(f'65 jobs took {launched} launches, not 2')

    # the plain version on the card against the plain version on the CPU
    img = source(200, 230, True)
    coeffs, mask = hom._spline5_inputs(img)
    hv = hinvs(1)[0]
    outs = [interp.warp_homography_plain(
        torch.from_numpy(coeffs).to(d), torch.from_numpy(hv).to(d), 150,
        120, 5, torch.from_numpy(mask).to(d)).cpu() for d in (dev, 'cpu')]
    ok, err = equal(*outs)
    print(f'  plain warp, order 5 with a NaN mask, 120 x 150: card against '
          f'CPU bitwise={ok} max_abs_err={err}', flush=True)
    if not ok:
        raise AssertionError('the plain warp differs between the card and '
                             'the CPU')


def check_div120():
    """W1's division by 120 (a multiply and two fused multiply-adds behind
    a guard on |x|) against the IEEE division, over all 2^32 float32 bit
    patterns on the card: no mismatch among non-NaN results."""
    import ctypes
    import torch
    from s2p_tpu_torch.ops import _build

    counts = torch.zeros(2, dtype=torch.int64, device='cuda')
    t0 = time.perf_counter()
    _build.call('warp', 's2p_warp_div120_check',
                [ctypes.c_void_p, ctypes.c_void_p], counts.data_ptr())
    torch.cuda.synchronize()
    bad, bad_fast = counts.tolist()
    print(f'  div120 against __fdiv_rn(x, 120) over all 2^32 float32 '
          f'inputs: {bad} mismatches among non-NaN results; the correction '
          f'alone, without its guard: {bad_fast} (the CPU\'s exhaustive '
          f'run: {DIV120_UNGUARDED}); {time.perf_counter() - t0:.3f} s',
          flush=True)
    if bad:
        raise AssertionError(f'div120 differs from the IEEE division on '
                             f'{bad} inputs')
    if bad_fast != DIV120_UNGUARDED:
        raise AssertionError('the unguarded correction differs from the '
                             'CPU on the card')


def check_box_division():
    """B1's division of a window's means by its count mean (``csrc/box.cu``
    ``div_rcp`` behind ``div_rcp_ok``) against the IEEE division, for each
    of the 110 count means and all 2^32 float32 numerators on the card: no
    mismatch where the guard admits the numerator."""
    import ctypes
    import torch
    from s2p_tpu_torch.ops import _build, msmw

    counts = torch.zeros(2, dtype=torch.int64, device='cuda')
    t0 = time.perf_counter()
    _build.call('box', 's2p_box_div_check',
                [ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                 ctypes.c_void_p], msmw._recip_area(4, 4),
                msmw._recip_area(1, 4), counts.data_ptr())
    torch.cuda.synchronize()
    bad, bad_fast = counts.tolist()
    print(f'  B1\'s division against __fdiv_rn over the 110 count means x '
          f'all 2^32 float32 numerators: {bad} mismatches where the guard '
          f'admits the numerator; the correction alone, without its guard: '
          f'{bad_fast} among non-NaN results; '
          f'{time.perf_counter() - t0:.3f} s', flush=True)
    if bad:
        raise AssertionError(f"B1's division differs from the IEEE division "
                             f'on {bad} (numerator, divisor) pairs')


def check_warp_dilate(stats):
    """W1's mask dilation (``interp.warp_dilate``) against its plain
    version ``dilate_nanmask6`` on the card, bitwise, one line per case;
    timed at the scene's image size (the shape of its path run)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from s2p_tpu_torch.ops import interp

    dev = torch.device('cuda')
    rng = np.random.RandomState(43)

    def mask(h, w, kind):
        m = np.zeros((h, w), np.float32)
        if kind == 'band':
            m[h // 2:h // 2 + 4] = 1
        elif kind == 'borders':
            m[0], m[-1], m[:, 0], m[:, -1] = (1,) * 4
        elif kind == 'sparse':
            m[rng.rand(h, w) < 0.001] = 1
            m[rng.randint(h), rng.randint(w)] = 1
        else:       # NaN, inf, negative and -0 entries
            for v, p in ((np.nan, 0.002), (np.inf, 0.001), (-2.0, 0.01),
                         (-0.0, 0.01)):
                m[rng.rand(h, w) < p] = v
            m[rng.randint(h), rng.randint(w)] = np.nan
        return torch.from_numpy(m).to(dev)

    for h, w, kind in ((1, 37, 'sparse'), (37, 1, 'sparse'),
                       (5, 5, 'borders'), (6, 6, 'values'),
                       (61, 77, 'borders'), (61, 77, 'values'),
                       (203, 300, 'sparse'), (203, 300, 'values'),
                       (2000, 2800, 'band')):
        m = mask(h, w, kind)
        got = interp.warp_dilate(m)
        ok, err = equal(got, interp.dilate_nanmask6(m))
        print(f'  warp_dilate {h} x {w} ({kind}): bitwise={ok} '
              f'max_abs_err={err} ({int(got.sum())} pixels set)',
              flush=True)
        if not ok:
            raise AssertionError(f'warp_dilate {h} x {w} ({kind}) differs '
                                 f'from dilate_nanmask6: {err}')
    record(stats, 'warp_dilate', '', ok, err,
           timed(lambda: interp.warp_dilate(m), 10),
           timed(lambda: interp.dilate_nanmask6(m), 3), m.numel() * 5, 0)
    # the library's call for the same map of a 0/1 mask: max_pool2d pads
    # with -inf, so its window [y - 2, y + 3] keeps to the image as the
    # clamped one does (timed here only; the port runs its own kernel)
    def pool():
        return F.max_pool2d(m[None], 6, stride=1, padding=3)
    lib = (pool()[0, 1:, 1:] > 0).to(torch.uint8)
    ok, err = equal(lib, got)
    if not ok:
        raise AssertionError(f'max_pool2d differs from warp_dilate on the '
                             f'0/1 mask: {err}')
    stats['warp_dilate']['library_ms'] = timed(pool, 10)
    print(f'  warp_dilate {h} x {w}: library max_pool2d '
          f'{stats["warp_dilate"]["library_ms"]:.4f} ms, its map '
          f'bitwise={ok}', flush=True)


def check_scene_nan_stage3(cfg, tiles, root, launches):
    """Stage 3 of the scene again with a NaN band across image 1, the path
    of W1's masked order 5 (its mask dilated once for the image's group),
    on the card and with device="cpu": the rectified images byte for byte;
    the launches of the card's run."""
    import dataclasses
    import numpy as np
    import torch
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.geo import geotiff
    from s2p_tpu_torch.ops import interp

    img = geotiff.read(cfg.images[0].img).astype(np.float32)
    img[SCENE_NAN_ROWS[0]:SCENE_NAN_ROWS[1]] = np.nan
    os.makedirs(root)
    path = os.path.join(root, 'img_1_nan.tif')
    geotiff.write(path, img)
    runs = {}
    for name, device in (('card', None), ('cpu', 'cpu')):
        out = os.path.join(root, name)
        shutil.copytree(os.path.join(cfg.out_dir, 'tiles'),
                        os.path.join(out, 'tiles'),
                        ignore=shutil.ignore_patterns('*.ply', '*.tif'))
        shutil.copy(os.path.join(cfg.out_dir, 'global_pointing_pair_1.txt'),
                    out)
        c = dataclasses.replace(cfg, out_dir=out, images=(
            dataclasses.replace(cfg.images[0], img=path),
            *cfg.images[1:]))
        runs[name] = [moved(t, cfg.out_dir, out) for t in tiles]
        interp.reset_launch_counts()
        t0 = time.perf_counter()
        pipeline.rectification_all(c, [(t, 1) for t in runs[name]],
                                   device=device)
        torch.cuda.synchronize()
        print(f'  stage 3 with a NaN band in image 1, {name}: '
              f'{time.perf_counter() - t0:.3f} s', flush=True)
        if device is None:
            launches['scene_nan'] = interp.launch_counts()
    print(f"  launches: {launches['scene_nan']}", flush=True)
    nan_px = 0
    for a, b in zip(runs['card'], runs['cpu']):
        for f in ('rectified_ref.tif', 'rectified_sec.tif'):
            pa = os.path.join(a['dir'], 'pair_1', f)
            with open(pa, 'rb') as f1, \
                    open(os.path.join(b['dir'], 'pair_1', f), 'rb') as f2:
                if f1.read() != f2.read():
                    raise AssertionError(f'stage 3 with a NaN band: {pa} '
                                         'differs from the CPU run')
        nan_px += int(np.isnan(geotiff.read(os.path.join(
            a['dir'], 'pair_1', 'rectified_ref.tif'))).sum())
    print(f'  rectified images equal the CPU run byte for byte: '
          f'{2 * len(tiles)} files, {nan_px} NaN pixels in the reference '
          'images', flush=True)
    if not nan_px:
        raise AssertionError('the NaN band reached no rectified image')


def expected_tiles(out_dir):
    """The scene's 6 tiles as the tiling must lay them out: coordinates
    and the relative directories of each one's 3 x 3 neighbourhood inside
    the ROI."""
    rx, ry, rw, rh = SCENE['roi']
    t = SCENE['tile']

    def rel(x, y):
        return os.path.join('tiles', f'row_{y:07d}_height_{t}',
                            f'col_{x:07d}_width_{t}')
    return [{'dir': os.path.join(out_dir, rel(x, y)),
             'coordinates': (x, y, t, t),
             'neighborhood_dirs': sorted(
                 os.path.join('../../..', rel(x2, y2))
                 for y2 in (y - t, y, y + t) for x2 in (x - t, x, x + t)
                 if rx <= x2 < rx + rw and ry <= y2 < ry + rh)}
            for y in range(ry, ry + rh, t) for x in range(rx, rx + rw, t)]


def render_view(img1, cam1, cam, pointing):
    """Image 1 as camera ``cam`` sees it: at each pixel, the ground point
    at SCENE_H0 that ``cam`` sees ``pointing`` px above it, as camera 1
    sees it (the map in float64 on a grid every 16 px, interpolated
    between; image 1 sampled there by a cubic spline)."""
    import numpy as np
    from scipy import ndimage

    h, w = img1.shape
    step = 16
    gy, gx = np.mgrid[0:h + step:step, 0:w + step:step].astype(np.float64)
    lon, lat = cam.localization(gx.ravel(), gy.ravel() - pointing, SCENE_H0)
    c1, r1 = cam1.projection(lon, lat, SCENE_H0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64) / step
    cmap = ndimage.map_coordinates(c1.reshape(gx.shape), [yy, xx], order=1)
    rmap = ndimage.map_coordinates(r1.reshape(gx.shape), [yy, xx], order=1)
    del yy, xx
    return ndimage.map_coordinates(img1, [rmap, cmap], order=3,
                                   mode='nearest').astype(np.float32)


def render_scene(root):
    """The scene's two images, as GeoTIFFs with their cameras in the RPC
    tag (the port's writer), and its config file (relative paths, the
    default config otherwise) under ``root``; returns the config's path.

    Image 1 is smooth noise.  Image 2 shows, at each pixel, the ground
    point at SCENE_H0 that camera 2 sees SCENE_POINTING px above it (the
    pointing error), as camera 1 sees it (:func:`render_view`: the map
    from image 2 to image 1 is computed in float64 on a grid every 16 px
    and interpolated between, smooth to about 1e-6 px over 16 px, and
    image 1 is sampled there by a cubic spline)."""
    import numpy as np
    from scipy import ndimage
    from s2p_tpu_torch.geo import geotiff

    cam1, cam2 = stage5_camera(1, 0.02), stage5_camera(2, -0.015)
    h, w = SCENE['h'], SCENE['w']
    rng = np.random.RandomState(SCENE['seed'])
    img1 = ndimage.uniform_filter(rng.rand(h, w).astype(np.float32) * 200,
                                  3)
    img2 = render_view(img1, cam1, cam2, SCENE_POINTING)
    os.makedirs(root)
    for k, img, cam in ((1, img1, cam1), (2, img2, cam2)):
        geotiff.write(os.path.join(root, f'img_{k}.tif'), img, rpc=cam)
    rx, ry, rw, rh = SCENE['roi']
    path = os.path.join(root, 'config.json')
    with open(path, 'w') as f:
        json.dump({'out_dir': 'out',
                   'images': [{'img': 'img_1.tif'}, {'img': 'img_2.tif'}],
                   'roi': {'x': rx, 'y': ry, 'w': rw, 'h': rh},
                   'tile_size': SCENE['tile']}, f, indent=2)
    return path


def true_matches(cfg, tile, k, n=200):
    """``n`` correspondences of the scene in a tile: ground points at
    SCENE_H0 seen by both cameras, image 2's rows moved by the pointing
    error (seeded per tile)."""
    import numpy as np
    x, y, w, h = tile['coordinates']
    cam1, cam2 = cfg.images[0].rpcm, cfg.images[1].rpcm
    r = np.random.RandomState(SCENE['seed'] + 1 + k)
    cols, rows = x + r.rand(n) * w, y + r.rand(n) * h
    lon, lat = cam1.localization(cols, rows, SCENE_H0)
    c2, r2 = cam2.projection(lon, lat, SCENE_H0)
    return np.column_stack([cols, rows, c2, r2 + SCENE_POINTING])


def tile_name(tile):
    """A scene tile's row and column directories."""
    return '/'.join(tile['dir'].split(os.sep)[-2:])


def stage1_crops(cfg, tile):
    """The two crops stage 1 detects on for a tile, with their origins:
    the tile in image 1 and its corresponding ROI in image 2 (the RPCs
    over the config's altitude range), both clipped to the images."""
    import numpy as np
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.core import rpc_geom
    from s2p_tpu_torch.ops import sift

    j = pipeline._pointing_jobs(cfg, [(tile, 1)])[0]
    x, y, w, h = tile['coordinates']
    x2, y2, w2, h2 = rpc_geom.corresponding_roi(j['rpc1'], j['rpc2'], x, y,
                                                w, h, **j['alt_kwargs'])
    crops, offsets = [], []
    for img, roi in ((j['im1'], (x, y, w, h)), (j['im2'], (x2, y2, w2, h2))):
        cx, cy, cw, ch = sift._clip_roi(img, *roi)
        crops.append(np.ascontiguousarray(img[cy:cy + ch, cx:cx + cw],
                                          dtype=np.float32))
        offsets.append((cx, cy))
    return crops, offsets


def check_keypoint_sets(name, got, want):
    """The set criterion of tests/test_torch_sift.py, ``got`` (the card's
    keypoint rows) against ``want`` (the CPU's); prints the figures."""
    import numpy as np
    from scipy.spatial import cKDTree

    d, idx = cKDTree(want[:, :4]).query(got[:, :4], k=1)
    close = d < KP_DIST
    diff = np.abs(got[close, 4:] - want[idx[close], 4:])
    eq, le1 = float((diff == 0).mean()), float((diff <= 1).mean())
    mx = float(diff.max()) if diff.size else 0.0
    rows = float((np.abs(got[close] - want[idx[close]]).max(axis=1)
                  == 0).mean())
    print(f'  {name}: {len(got)} keypoints on the card, {len(want)} on the '
          f'CPU; {close.mean():.5f} within {KP_DIST} of a CPU keypoint '
          f'({rows:.5f} equal rows); descriptor entries equal {eq:.6f}, '
          f'within 1 {le1:.6f}, at most {mx:g} apart', flush=True)
    if (abs(len(got) - len(want)) > COUNT_SHARE * len(want)
            or close.mean() < KP_SHARE or eq < DESC_EQ_SHARE
            or le1 < DESC_1_SHARE or mx > DESC_MAX):
        raise AssertionError(f'stage 1: {name}: the card\'s keypoints miss '
                             'the CPU\'s set criterion')


def moved(tile, out_dir, root):
    """A tile of ``out_dir`` at the same place under ``root``."""
    return dict(tile, dir=os.path.join(root,
                                       os.path.relpath(tile['dir'], out_dir)))


def check_scene_stage1(cfg, tiles, cpu_root, t_stage1):
    """Stage 1's checks and parts: each tile's translation against the
    rendered pointing error; the parts run again one by one, then under
    the profiler; two tiles again with device="cpu" (pointing.txt, and
    the keypoints of their crops by the set criterion)."""
    import dataclasses
    import numpy as np
    import torch
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.core import pointing
    from s2p_tpu_torch.ops import sift, sift_device

    worst = 0.0
    for t in tiles:
        A = np.loadtxt(os.path.join(t['dir'], 'pair_1', 'pointing.txt'))
        m = np.loadtxt(os.path.join(t['dir'], 'pair_1', 'sift_matches.txt'))
        err = max(abs(A[0, 2]), abs(A[1, 2] + SCENE_POINTING))
        worst = max(worst, err)
        print(f"  stage 1: {tile_name(t)}: {len(m)} matches, "
              f'translation ({A[0, 2]:.3f}, {A[1, 2]:.3f}) px against (0, '
              f'{-SCENE_POINTING}): off by {err:.3f} px', flush=True)
    if worst > SCENE_POINTING_TOL_PX:
        raise AssertionError(f'stage 1 misses the rendered pointing error '
                             f'by {worst:.3f} px')

    pairs = [(t, 1) for t in tiles]
    jobs = pipeline._pointing_jobs(cfg, pairs)
    st = {}
    t0 = time.perf_counter()
    matches = sift.matches_on_rpc_roi_batch(jobs, stats=st)
    t_sift = time.perf_counter() - t0
    t0 = time.perf_counter()
    for (t, _), m in zip(pairs, matches):
        pointing.local_translation(cfg.images[0].rpcm, cfg.images[1].rpcm,
                                   *t['coordinates'], m, cfg.n_gcp_per_axis,
                                   **pipeline._alt_kwargs(cfg))
    t_fit = time.perf_counter() - t0
    print(f'  stage 1 again, part by part: SIFT {t_sift:.3f} s, the '
          f'per-tile fit {t_fit:.3f} s (stage 1 took {t_stage1:.3f} s)',
          flush=True)
    for name in ('detection', 'pyramid', 'orientation', 'descriptor',
                 'match', 'ransac'):
        indent = '    ' if name in ('pyramid', 'orientation',
                                    'descriptor') else '  '
        print(f'  {indent}stage 1 part: {name}: {st[name]:.3f} s '
              f'({st[name] / t_stage1:.3f} of the stage)', flush=True)
    print(f'    stage 1 part: per-tile fit: {t_fit:.3f} s '
          f'({t_fit / t_stage1:.3f} of the stage)', flush=True)
    for k, (t, m) in enumerate(zip(tiles, matches)):
        print(f"  stage 1: {tile_name(t)}: keypoints "
              f"{st['keypoints'][k]}, {len(m)} matches", flush=True)
    t0 = time.perf_counter()
    kernels, dev_ms = count_launches(
        lambda: sift.matches_on_rpc_roi_batch(jobs))
    print(f'  stage 1 SIFT under the profiler: {kernels} CUDA kernels, '
          f'{dev_ms} ms of device time, {time.perf_counter() - t0:.3f} s '
          'of wall time', flush=True)

    # two tiles with device="cpu"
    cpu_cfg = dataclasses.replace(cfg, out_dir=cpu_root)
    cpu_tiles = [moved(t, cfg.out_dir, cpu_root) for t in tiles[:2]]
    for t in cpu_tiles:
        os.makedirs(os.path.join(t['dir'], 'pair_1'))
    t0 = time.perf_counter()
    pipeline.pointing_correction_all(cpu_cfg, [(t, 1) for t in cpu_tiles],
                                     device='cpu')
    print(f'  stage 1 of two tiles with device="cpu": '
          f'{time.perf_counter() - t0:.3f} s', flush=True)
    for a, b in zip(tiles, cpu_tiles):
        pa, pb = (os.path.join(t['dir'], 'pair_1', 'pointing.txt')
                  for t in (a, b))
        with open(pa, 'rb') as f1, open(pb, 'rb') as f2:
            same = f1.read() == f2.read()
        d = float(np.abs(np.loadtxt(pa) - np.loadtxt(pb)).max())
        print(f"  stage 1: {tile_name(a)}: pointing.txt card "
              f'against CPU: byte for byte {same}, largest difference '
              f'{d:.3f} px', flush=True)
        if not same and d > STAGE1_CPU_TOL_PX:
            raise AssertionError('stage 1: pointing.txt differs from the '
                                 'CPU run')
    for t in tiles[:2]:
        crops, offsets = stage1_crops(cfg, t)
        ths = [0.0133] * len(crops)
        got = sift_device.keypoints_from_arrays(crops, ths, offsets)
        want = sift_device.keypoints_from_arrays(crops, ths, offsets,
                                                 device='cpu')
        for k, (g, w) in enumerate(zip(got, want)):
            check_keypoint_sets(f"{tile_name(t)} image "
                                f'{k + 1} ({crops[k].shape[0]} x '
                                f'{crops[k].shape[1]} crop)', g, w)
    torch.cuda.synchronize()


def scene_stage3_shares(cfg, tiles, t_stage3):
    """Stage 3's parts run again one by one on the card: the input TIFF
    reads, the per-tile geometry, the prefilter, the warps and the TIFF
    writes, each with its share of stage 3's wall time."""
    import functools
    import torch
    from s2p_tpu_torch import pipeline, runner
    from s2p_tpu_torch.geo import geotiff
    from s2p_tpu_torch.ops import homography as hom

    parts = {}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = time.perf_counter() - t0
        return out

    imgs = part('TIFF reads of the two images', lambda: [
        geotiff.read(im.img).astype('float32') for im in cfg.images])
    geoms = part('geometry of the tiles (thread pool)', lambda:
                 runner.launch_calls(
                     functools.partial(pipeline._rectification_geometry,
                                       cfg), [(t, 1) for t in tiles]))
    part('quintic prefilter of the two images (scipy)',
         lambda: [hom._spline5_inputs(im) for im in imgs])
    jobs = [(imgs[k], g[f'H{k + 1}'], g['w'], g['h'])
            for g in geoms for k in (0, 1)]
    rects = part('prefilter, upload, W1 and download (warp_jobs_batched)',
                 lambda: hom.warp_jobs_batched(jobs))
    part('TIFF writes of the rectified pairs (thread pool)',
         lambda: runner.launch_calls(
             pipeline._write_rectified,
             [(g, rects[2 * k], rects[2 * k + 1])
              for k, g in enumerate(geoms)], tilewise=False))
    for name, t in parts.items():
        print(f'  stage 3 part: {name}: {t:.3f} s '
              f'({t / t_stage3:.3f} of the stage)', flush=True)


def time_scene_warp(cfg, tiles, stats):
    """W1 at the main path's shapes: the reference image's group of the
    scene's tiles (one launch) and one tile's warp, bitwise against the
    plain version on the card and timed beside it, with the bound; and
    torch's grid_sample (bilinear, align_corners=True) beside W1's
    order 1 at the tile's shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from s2p_tpu_torch.geo import geotiff
    from s2p_tpu_torch.ops import homography as hom
    from s2p_tpu_torch.ops import interp

    dev = torch.device('cuda')
    img = geotiff.read(cfg.images[0].img).astype(np.float32)
    coeffs, mask = hom._spline5_inputs(img)
    c = torch.from_numpy(coeffs).to(dev)
    m = None if mask is None else torch.from_numpy(mask).to(dev)
    hvs, shapes = [], []
    for t in tiles:
        pdir = os.path.join(t['dir'], 'pair_1')
        hvs.append(hom._inverse_f32(np.loadtxt(os.path.join(pdir,
                                                            'H_ref.txt'))))
        shapes.append(geotiff.read(os.path.join(pdir,
                                                'rectified_ref.tif')).shape)
    oh = -(-max(s[0] for s in shapes) // 64) * 64
    ow = -(-max(s[1] for s in shapes) // 128) * 128
    group = torch.from_numpy(np.stack(hvs)).to(dev)
    one = group[:1]

    def kernel(h):
        return interp.warp_homography(c, h, ow, oh, 5, m)

    def plain():
        return interp.warp_homography_plain(c, one[0], ow, oh, 5, m)

    got = kernel(group)
    ref = torch.stack([interp.warp_homography_plain(c, h, ow, oh, 5, m)
                       for h in group])
    ok, err = equal(got, ref)
    if not ok:
        raise AssertionError(f'W1 at the scene group differs from its plain '
                             f'version: {err}')
    n_inside = int(torch.isfinite(kernel(one)).sum())
    ms_group = timed(lambda: kernel(group), 10)
    ms = timed(lambda: kernel(one), 10)
    plain_ms = timed(plain, 2)
    nbytes = c.numel() * (4 if m is None else 5) + 36 + oh * ow * 4
    ops = interp.warp_ops(5, m is not None, n_inside, oh * ow)
    t_bound, by = bound(nbytes, ops, F32_SEPARATE_OPS_PER_S)
    print(f'  W1 order 5 at the scene: group of {len(hvs)} tiles, '
          f'{oh} x {ow} each, bitwise={ok}: {ms_group:.4f} ms a group, '
          f'{ms:.4f} ms a warp ({n_inside} of {oh * ow} pixels inside); '
          f'plain {plain_ms:.3f} ms a warp; bound {t_bound:.4f} ms a warp '
          f'({by}: {ops:.4g} f32 operations at '
          f'{F32_SEPARATE_OPS_PER_S:.3g}/s, {nbytes} bytes)', flush=True)
    stats['warp'] = dict(err=err, ms=ms, plain_ms=plain_ms, nbytes=nbytes,
                         ops=ops, ops_per_s=F32_SEPARATE_OPS_PER_S,
                         group_ms=ms_group)

    # the same group with the NaN band of the masked stage-3 run: the
    # image's mask dilated once, then the group
    img_nan = img.copy()
    img_nan[SCENE_NAN_ROWS[0]:SCENE_NAN_ROWS[1]] = np.nan
    cn, mn = (torch.from_numpy(a).to(dev)
              for a in hom._spline5_inputs(img_nan))
    bad6 = interp.warp_dilate(mn)
    got = interp.warp_homography(cn, group, ow, oh, 5, mn, bad6)
    ref = torch.stack([interp.warp_homography_plain(cn, h, ow, oh, 5, mn)
                       for h in group])
    ok, err = equal(got, ref)
    if not ok:
        raise AssertionError(f'W1 with the NaN band differs from its plain '
                             f'version: {err}')
    ms_mgroup = timed(lambda: interp.warp_homography(cn, group, ow, oh, 5,
                                                     mn, bad6), 10)
    ms_mone = timed(lambda: interp.warp_homography(cn, one, ow, oh, 5, mn,
                                                   bad6), 10)
    ms_dil = timed(lambda: interp.warp_dilate(mn), 10)
    print(f'  W1 order 5 with a NaN band (rows {SCENE_NAN_ROWS}) at the '
          f'scene: bitwise={ok}, {int(torch.isnan(got).sum())} NaN outputs; '
          f'{ms_mgroup:.4f} ms a group, {ms_mone:.4f} ms a warp, the '
          f'dilation {ms_dil:.4f} ms once per image', flush=True)

    # order 1 beside torch's bilinear grid_sample on the same grid
    src = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
    hv = one[0]
    ys = torch.arange(oh, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(ow, dtype=torch.float32, device=dev)[None, :]
    z = hv[2, 0] * xs + hv[2, 1] * ys + hv[2, 2]
    sx = (hv[0, 0] * xs + hv[0, 1] * ys + hv[0, 2]) / z
    sy = (hv[1, 0] * xs + hv[1, 1] * ys + hv[1, 2]) / z
    H, W = img.shape
    grid = torch.stack([sx / (W - 1) * 2 - 1, sy / (H - 1) * 2 - 1],
                       dim=-1)[None]
    inp = src[None, None]
    lib = F.grid_sample(inp, grid, mode='bilinear', align_corners=True)[0, 0]
    w1 = interp.warp_homography(src, hv, ow, oh, 1)
    fin = torch.isfinite(w1)
    d = (lib[fin] - w1[fin]).abs().max().item()
    ms1 = timed(lambda: interp.warp_homography(src, hv, ow, oh, 1), 10)
    ms3 = timed(lambda: interp.warp_homography(src, hv, ow, oh, 3), 10)
    lib_ms = timed(lambda: F.grid_sample(inp, grid, mode='bilinear',
                                         align_corners=True), 10)
    print(f'  W1 order 1 at {oh} x {ow}: {ms1:.4f} ms; grid_sample '
          f'(bilinear, align_corners=True, zeros outside) {lib_ms:.4f} ms; '
          f'max difference inside {d:.3g}; W1 order 3 {ms3:.4f} ms',
          flush=True)


def check_scene_tiling(cfg, tiles):
    """The tiling's tiles against the layout the scene must have."""
    want = expected_tiles(cfg.out_dir)
    got = [dict(t, neighborhood_dirs=sorted(t['neighborhood_dirs']))
           for t in tiles]
    if [(t['dir'], tuple(t['coordinates']), t['neighborhood_dirs'])
            for t in got] != [(t['dir'], t['coordinates'],
                               t['neighborhood_dirs']) for t in want]:
        raise AssertionError(f'the tiling laid out {tiles}, not {want}')
    print(f'  tiling: {len(tiles)} tiles of {SCENE["tile"]} px with their '
          'neighbourhoods, as expected', flush=True)


def check_scene_dsm(cfg, tiles, roi=SCENE['roi']):
    """The scene's dsm.tif: the UTM CRS of the scene's zone, its grid at
    dsm_resolution, nodata NaN; its valid share on the cells whose ground
    point at SCENE_H0 camera 1 sees inside the ROI ``roi`` (30 px in from
    its edges); its median |z - SCENE_H0|; and, with tolerance 0, one
    rasterization of all the tiles' clouds (the seamlessness check)."""
    import numpy as np
    from s2p_tpu_torch.core import rpc_geom
    from s2p_tpu_torch.geo import crs, geotiff
    from s2p_tpu_torch.ops import rasterize

    path = os.path.join(cfg.out_dir, 'dsm.tif')
    prof = geotiff.read_profile(path)
    dsm = geotiff.read_with_nans(path)
    cam = cfg.images[0].rpcm
    zone = rpc_geom.utm_zone(cam, *roi)
    epsg = crs.epsg_code_from_utm_zone(zone)
    r = cfg.dsm_resolution
    a, b, c, d, e, f = prof.transform
    print(f'  dsm.tif: {prof.width} x {prof.height}, {prof.dtype}, '
          f'EPSG:{prof.crs.epsg if prof.crs else None} (zone {zone}), '
          f'transform {prof.transform}, nodata {prof.nodata}', flush=True)
    if (prof.crs is None or prof.crs.epsg != epsg or not 32701 <= epsg
            <= 32760 or (a, b, d, e) != (r, 0.0, 0.0, -r)
            or c % r or f % r or not np.isnan(prof.nodata)
            or prof.dtype != 'float32'):
        raise AssertionError('stage 7: dsm.tif is not georeferenced as the '
                             'scene needs')
    jj, ii = np.meshgrid(np.arange(prof.width), np.arange(prof.height))
    xs, ys = c + (jj.ravel() + 0.5) * r, f - (ii.ravel() + 0.5) * r
    lon, lat = crs.transform(xs, ys, prof.crs, 4326)
    cols, rows = cam.projection(lon, lat, SCENE_H0)
    rx, ry, rw, rh = roi
    m = 30
    inside = ((cols >= rx + m) & (cols < rx + rw - m) & (rows >= ry + m)
              & (rows < ry + rh - m)).reshape(dsm.shape)
    fin = np.isfinite(dsm)
    share = float(fin[inside].mean())
    err = np.abs(dsm[fin] - SCENE_H0)
    med = float(np.median(err))
    print(f'  dsm.tif: {int(inside.sum())} cells inside the ROI\'s '
          f'footprint, {share:.4f} of them valid (bar {SCENE_DSM_SHARE}); '
          f'{int(fin.sum())} valid cells in all, |z - {SCENE_H0}| median '
          f'{med:.3f} m, 90th percentile {np.percentile(err, 90):.3f} m '
          f'(bar {SCENE_ALT_TOL_M[0]} m on the median)', flush=True)
    if share < SCENE_DSM_SHARE or med > SCENE_ALT_TOL_M[0]:
        raise AssertionError('stage 7: the DSM misses the scene')
    t0 = time.perf_counter()
    clouds = [os.path.join(t['dir'], 'cloud.ply') for t in tiles]
    raster, _ = rasterize.plyflatten_from_plyfiles_list(clouds, r)
    t_mono = time.perf_counter() - t0
    mono = raster[:, :, 0]
    same = mono.shape == dsm.shape and bool(
        np.array_equal(mono, dsm, equal_nan=True))
    print(f'  seamlessness: dsm.tif against one rasterization of the '
          f'{len(clouds)} clouds ({t_mono:.3f} s): equal bitwise {same}',
          flush=True)
    if not same:
        raise AssertionError('stage 7: the tiled DSM differs from the '
                             'monolithic rasterization')


def check_bucket_kernels(cfg, tiles_pairs, stats, launches, tag):
    """K1, K2 and K3 against their plain versions on the buckets stage 4
    gave them inside main (``pipeline.matching_buckets`` over the card's
    stage-3 files of ``tiles_pairs``, the config's variant), under
    ``tag``; main must have launched K1 once per side of each bucket."""
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.core import matching

    variant = matching.mgm_variant_from_cfg(cfg)
    buckets = pipeline.matching_buckets(cfg, tiles_pairs)
    sides = 2 if variant.lr_enabled else 1
    if launches['cost_prepass'] != sides * len(buckets):
        raise AssertionError(f"main launched K1 {launches['cost_prepass']} "
                             f'times, not once per side of its '
                             f'{len(buckets)} buckets')
    for (Hp, Wp, Dp), group in buckets.items():
        specs, pairs = [], {}
        for k, j in enumerate(group):
            h, w1 = j['rect1'].shape
            specs.append(dict(index=k, h=h, w1=w1, w2=j['rect2'].shape[1],
                              dmin=j['dmin'], dmax=j['dmax']))
            pairs[k] = (j['rect1'], j['rect2'])
        print(f'  stage 4 bucket {Hp} x {Wp}, {Dp} candidates, '
              f'{len(group)} tiles: K1, K2 and K3 against their plain '
              'versions', flush=True)
        check_kernels(specs, pairs, stats, dict(n=len(group), h=Hp, w=Wp,
                                                D=Dp), tag, variant)
        del specs, pairs
    del buckets


def check_scene_matching(cfg, tiles, cpu_cfg, cpu_tiles, stats, launches):
    """Stage 4 of the scene: K1, K2 and K3 against their plain versions on
    the buckets main gave them, under the tag ``_scene``; then stage 4 of
    two tiles with device="cpu" on the CPU tree's stage-3 files (equal to
    the card's): the three files byte for byte."""
    from s2p_tpu_torch import pipeline

    check_bucket_kernels(cfg, [(t, 1) for t in tiles], stats, launches,
                         '_scene')
    t0 = time.perf_counter()
    pipeline.stereo_matching_all(cpu_cfg, [(t, 1) for t in cpu_tiles[:2]],
                                 device='cpu')
    print(f'  stage 4 of two tiles with device="cpu": '
          f'{time.perf_counter() - t0:.3f} s', flush=True)
    for a, b in zip(tiles[:2], cpu_tiles[:2]):
        for name in ('rectified_disp.tif', 'rectified_disp_confidence.tif',
                     'rectified_mask.png'):
            with open(os.path.join(a['dir'], 'pair_1', name), 'rb') as f1, \
                    open(os.path.join(b['dir'], 'pair_1', name), 'rb') as f2:
                if f1.read() != f2.read():
                    raise AssertionError(f"stage 4: {a['dir']}/{name} "
                                         'differs from the CPU run')
        print(f'  {tile_name(a)}: the three stage-4 files equal the CPU run '
              'byte for byte', flush=True)


def time_gml_mask(root):
    """``masking.image_tile_mask`` on one tile of SCENE['tile'] px with an
    ROI ring and a cloud ring of GML_VERTICES vertices (wavy circles with
    a little noise about the tile's centre, written as GML): its host time (median of 3)
    and its area against the rings' (shoelace), within GML_AREA_TOL."""
    import numpy as np
    from s2p_tpu_torch.core import masking

    rng = np.random.RandomState(SCENE['seed'])
    t = SCENE['tile']
    paths, areas = [], []
    for name, n, radius in (('roi', GML_VERTICES[0], 0.47 * t),
                            ('clouds', GML_VERTICES[1], 0.2 * t)):
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        r = radius * (1 + 0.05 * np.sin(7 * ang + rng.uniform(0, 7))
                      + 0.002 * rng.standard_normal(n))
        x, y = 100 + t / 2 + r * np.cos(ang), 300 + t / 2 + r * np.sin(ang)
        areas.append(0.5 * abs(np.dot(x, np.roll(y, 1))
                               - np.dot(y, np.roll(x, 1))))
        path = os.path.join(root, f'{name}.gml')
        with open(path, 'w') as f:
            f.write('<gml:FeatureCollection xmlns:gml="http://www.opengis.'
                    'net/gml"><gml:posList>' + ' '.join(
                        f'{a:.3f} {b:.3f}' for a, b in zip(x, y))
                    + '</gml:posList></gml:FeatureCollection>\n')
        paths.append(path)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        mask = masking.image_tile_mask(100, 300, t, t, roi_gml=paths[0],
                                       cld_gml=paths[1])
        times.append(time.perf_counter() - t0)
    want = areas[0] - areas[1]
    rel = abs(int(mask.sum()) - want) / want
    print(f'  image_tile_mask, {t} x {t} tile, GML rings of '
          f'{GML_VERTICES[0]} and {GML_VERTICES[1]} vertices: '
          f'{statistics.median(times):.4f} s (host, median of '
          f'{[round(x, 4) for x in times]}); {int(mask.sum())} pixels '
          f'inside against the rings\' {want:.1f} ({rel:.5f} apart, bar '
          f'{GML_AREA_TOL})', flush=True)
    if rel > GML_AREA_TOL:
        raise AssertionError('the GML tile mask misses its rings\' area')


def run_scene(root, cpu_root, stats, launches, card):
    """The scene through the entry, ``pipeline.main`` of its config file
    on the card (stages 1 to 7), its stage times and the launch counts of
    the port's kernels over it; then the checks.  Returns each stage's
    seconds by its number."""
    import dataclasses
    import numpy as np
    import torch
    from s2p_tpu_torch import pipeline, tiling
    from s2p_tpu_torch.geo import geotiff, ply
    from s2p_tpu_torch.ops import interp
    from s2p_tpu_torch.ops import sgm_kernels as sk
    from s2p_tpu_torch.ops.homography import points_apply_homography

    t0 = time.perf_counter()
    config = render_scene(root)
    print(f"  scene: two {SCENE['h']} x {SCENE['w']} GeoTIFFs with RPC "
          f'tags and {config}, written in {time.perf_counter() - t0:.3f} s',
          flush=True)
    sk.reset_launch_counts()
    interp.reset_launch_counts()
    stage_times = {}
    t0 = time.perf_counter()
    cfg = pipeline.main(pipeline.read_config_file(config),
                        stage_times=stage_times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches['scene'] = {**sk.launch_counts(), **interp.launch_counts()}
    walls = {label.split(')')[0]: t for label, t in stage_times.items()}
    for label, t in stage_times.items():
        print(f'  {label} {t:.3f} s', flush=True)
    print(f'  main: {wall:.3f} s of wall time for stages 1 to 7 '
          f'({sum(walls.values()):.3f} s in the stages) on {card}',
          flush=True)
    print(f"  launches over main: {launches['scene']}", flush=True)
    tw, th = tiling.adjust_tile_size(cfg)
    tiles = tiling.tiles_full_info(cfg, tw, th,
                                   os.path.join(cfg.out_dir, 'tiles.txt'))
    check_scene_tiling(cfg, tiles)
    pairs = [(t, 1) for t in tiles]
    check_scene_stage1(cfg, tiles, os.path.join(cpu_root, 'stage1'),
                       walls['1'])

    # stages 2 and 3 on the CPU over the card's stage-1 files: the same
    # files byte for byte
    shutil.copytree(os.path.join(cfg.out_dir, 'tiles'),
                    os.path.join(cpu_root, 'tiles'))
    cpu_cfg = dataclasses.replace(cfg, out_dir=cpu_root)
    cpu_tiles = [moved(t, cfg.out_dir, cpu_root) for t in tiles]
    t0 = time.perf_counter()
    pipeline.global_pointing_correction(cpu_cfg, cpu_tiles)
    pipeline.rectification_all(cpu_cfg, [(t, 1) for t in cpu_tiles],
                               device='cpu')
    print(f'  stages 2 and 3 with device="cpu": '
          f'{time.perf_counter() - t0:.3f} s', flush=True)
    names = ('H_ref.txt', 'H_sec.txt', 'disp_min_max.txt',
             'rectified_ref.tif', 'rectified_sec.tif')
    files = [('global_pointing_pair_1.txt', cfg.out_dir, cpu_root)] + [
        (os.path.join('pair_1', n), a['dir'], b['dir'])
        for a, b in zip(tiles, cpu_tiles) for n in names]
    for name, a, b in files:
        with open(os.path.join(a, name), 'rb') as f1, \
                open(os.path.join(b, name), 'rb') as f2:
            if f1.read() != f2.read():
                raise AssertionError(f'stage 3: {a}/{name} differs from the '
                                     'CPU run')
    print(f'  stage 2 and 3 files equal the CPU run byte for byte: '
          f'{len(files)} files', flush=True)
    check_scene_matching(cfg, tiles, cpu_cfg, cpu_tiles, stats,
                         launches['scene'])

    worst_row, alts, sift_rows = 0.0, [], []
    for k, t in enumerate(tiles):
        pdir = os.path.join(t['dir'], 'pair_1')
        H1 = np.loadtxt(os.path.join(pdir, 'H_ref.txt'))
        H2 = np.loadtxt(os.path.join(pdir, 'H_sec.txt'))

        def rows_apart(m):
            return np.abs(points_apply_homography(H1, m[:, :2])[:, 1]
                          - points_apply_homography(H2, m[:, 2:])[:, 1])
        worst_row = max(worst_row, float(rows_apart(
            true_matches(cfg, t, k)).max()))
        sift_rows.append(rows_apart(
            np.loadtxt(os.path.join(pdir, 'sift_matches.txt'))))
        lo, hi = np.loadtxt(os.path.join(pdir, 'disp_min_max.txt'))
        disp = geotiff.read(os.path.join(pdir, 'rectified_disp.tif'))
        fin = np.isfinite(disp)
        if fin.mean() < 0.5 or disp[fin].min() < lo or disp[fin].max() > hi:
            raise AssertionError(f"stage 4: {t['dir']}: finite share "
                                 f'{fin.mean():.3f}, disparities outside '
                                 f'[{lo}, {hi}]')
        pts, _ = ply.read_ply(os.path.join(t['dir'], 'cloud.ply'))
        err = np.abs(pts[:, 2] - SCENE_H0)
        alts.append(err)
        print(f"  {tile_name(t)}: range [{lo}, {hi}], "
              f'disparity {np.percentile(disp[fin], 1):.3f} .. '
              f'{np.percentile(disp[fin], 99):.3f} ({fin.mean():.4f} '
              f'finite), {len(pts)} points, |altitude - {SCENE_H0}| median '
              f'{np.median(err):.3f} m, 90th percentile '
              f'{np.percentile(err, 90):.3f} m', flush=True)
    err = np.concatenate(alts)
    med, p90 = float(np.median(err)), float(np.percentile(err, 90))
    sift_rows = np.concatenate(sift_rows)
    print(f'  stage 1\'s SIFT matches: rectified rows apart by median '
          f'{np.median(sift_rows):.4f} px, 90th percentile '
          f'{np.percentile(sift_rows, 90):.4f} px, at most '
          f'{sift_rows.max():.4f} px ({len(sift_rows)} matches)', flush=True)
    print(f'  true matches: rectified rows agree within {worst_row:.4f} px '
          f'(tolerance {SCENE_ROW_TOL_PX}); cloud: {len(err)} points, '
          f'|altitude - {SCENE_H0}| median {med:.3f} m, 90th percentile '
          f'{p90:.3f} m (tolerances {SCENE_ALT_TOL_M})', flush=True)
    if worst_row > SCENE_ROW_TOL_PX:
        raise AssertionError('stage 3: the matches do not fall on the same '
                             'rectified rows')
    if med > SCENE_ALT_TOL_M[0] or p90 > SCENE_ALT_TOL_M[1]:
        raise AssertionError('stage 5: the cloud misses the altitude of the '
                             'scene')
    check_scene_dsm(cfg, tiles)
    scene_stage3_shares(cfg, tiles, walls['3'])
    time_scene_warp(cfg, tiles, stats)
    check_scene_nan_stage3(cfg, tiles, os.path.join(cpu_root, 'nan'),
                           launches)
    return walls


def render_triplet(root, scene_root):
    """The triplet under ``root``: the scene's two images (copied from
    ``scene_root``), a third rendered from image 1 through camera 3 with
    its own pointing error (:func:`render_view`), and a config file over
    the three (relative paths, TRIPLET's ROI, the default tile size and
    config, the 3D filter on); returns the config's path."""
    from s2p_tpu_torch.geo import geotiff

    os.makedirs(root)
    for k in (1, 2):
        shutil.copy(os.path.join(scene_root, f'img_{k}.tif'), root)
    img1 = geotiff.read(os.path.join(root, 'img_1.tif'))
    cam3 = stage5_camera(TRIPLET['seed'], TRIPLET['h_term'])
    geotiff.write(os.path.join(root, 'img_3.tif'),
                  render_view(img1, stage5_camera(1, 0.02), cam3,
                              TRIPLET['pointing']), rpc=cam3)
    rx, ry, rw, rh = TRIPLET['roi']
    path = os.path.join(root, 'config.json')
    with open(path, 'w') as f:
        json.dump({'out_dir': 'out',
                   'images': [{'img': f'img_{k}.tif'} for k in (1, 2, 3)],
                   'roi': {'x': rx, 'y': ry, 'w': rw, 'h': rh},
                   'tile_size': SCENE['tile'],
                   '3d_filtering_r': TRIPLET_FILTER[0],
                   '3d_filtering_n': TRIPLET_FILTER[1]}, f, indent=2)
    return path


def files_equal(pairs, what):
    """Each (path, path) byte for byte, else fail with ``what``."""
    for a, b in pairs:
        with open(a, 'rb') as f1, open(b, 'rb') as f2:
            if f1.read() != f2.read():
                raise AssertionError(f'{what}: {a} differs from {b}')
    return len(pairs)


def check_triplet_5a_crops(cfg, tile, root):
    """Stage 5a of one tile, both pairs, on crops of its rectified maps
    (S5_CROP at the origin; the tile's grid is kept): the card against
    device="cpu", the same NaN sets and altitudes within S5_ALT_TOL_M."""
    import dataclasses
    import numpy as np
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.geo import geotiff

    h, w = S5_CROP
    maps = {}
    for dev in ('cuda', 'cpu'):
        out = os.path.join(root, dev)
        tdir = os.path.join(out, 'tile')
        os.makedirs(tdir)
        shutil.copy(os.path.join(tile['dir'], 'mask.png'), tdir)
        for i in (1, 2):
            shutil.copy(os.path.join(cfg.out_dir,
                                     f'global_pointing_pair_{i}.txt'), out)
            src, dst = (os.path.join(d, f'pair_{i}')
                        for d in (tile['dir'], tdir))
            os.makedirs(dst)
            for name in ('H_ref.txt', 'H_sec.txt'):
                shutil.copy(os.path.join(src, name), dst)
            geotiff.write(os.path.join(dst, 'rectified_disp.tif'),
                          np.ascontiguousarray(geotiff.read(os.path.join(
                              src, 'rectified_disp.tif'))[:h, :w]),
                          nodata=float('nan'))
            geotiff.write_png(os.path.join(dst, 'rectified_mask.png'),
                              np.ascontiguousarray(geotiff.read_png(
                                  os.path.join(src,
                                               'rectified_mask.png'))[:h, :w]))
        t = dict(tile, dir=tdir)
        pipeline.disparity_to_height_all(
            dataclasses.replace(cfg, out_dir=out), [(t, 1), (t, 2)],
            device=dev)
        maps[dev] = [os.path.join(tdir, f'pair_{i}', 'height_map.tif')
                     for i in (1, 2)]
    for i, (a, b) in enumerate(zip(maps['cuda'], maps['cpu'])):
        x, y = geotiff.read(a), geotiff.read(b)
        with open(a, 'rb') as f1, open(b, 'rb') as f2:
            same = f1.read() == f2.read()
        fin = np.isfinite(x)
        d = float(np.abs(x[fin] - y[fin]).max()) if fin.any() else 0.0
        # the resample gives 0 where the tile's grid leaves the crop
        n = int((fin & (x != 0)).sum())
        print(f'  stage 5a of {tile_name(tile)} pair {i + 1} on a {S5_CROP} '
              f'crop: {n} heights from the crop, the card against the CPU: '
              f'byte for byte {same}, altitudes within {d} m', flush=True)
        if (not n or not np.array_equal(fin, np.isfinite(y))
                or d > S5_ALT_TOL_M):
            raise AssertionError('stage 5a: the crop differs from the CPU '
                                 'run')


def run_triplet(root, scene_root, cpu_root, stats, launches, card):
    """The triplet through the entry, ``pipeline.main`` of its config file
    on the card (stages 1 to 7 for two pairs), each stage's time with
    5a-5d apart, main's wall, stage 5a's peak device memory and the
    launches of the port's kernels over main; then the checks."""
    import dataclasses
    import numpy as np
    import torch
    from s2p_tpu_torch import pipeline, tiling
    from s2p_tpu_torch.geo import geotiff, ply
    from s2p_tpu_torch.ops import interp
    from s2p_tpu_torch.ops import sgm_kernels as sk

    t0 = time.perf_counter()
    config = render_triplet(root, scene_root)
    print(f'  triplet: image 3 rendered and {config} written in '
          f'{time.perf_counter() - t0:.3f} s', flush=True)
    # stage 5a's peak memory, and its height maps before 5d despeckles
    # them, by a wrapper around the driver main calls
    peak, after_5a = {}, os.path.join(cpu_root, 'after_5a')
    driver = pipeline.disparity_to_height_all

    def stage_5a(cfg, tiles_pairs, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        driver(cfg, tiles_pairs, **kw)
        torch.cuda.synchronize()
        peak['bytes'] = torch.cuda.max_memory_allocated()
        peak['before'] = before
        for t, i in tiles_pairs:
            rel = os.path.relpath(os.path.join(t['dir'], f'pair_{i}'),
                                  cfg.out_dir)
            os.makedirs(os.path.join(after_5a, rel))
            shutil.copy(os.path.join(cfg.out_dir, rel, 'height_map.tif'),
                        os.path.join(after_5a, rel))
    sk.reset_launch_counts()
    interp.reset_launch_counts()
    stage_times = {}
    pipeline.disparity_to_height_all = stage_5a
    try:
        t0 = time.perf_counter()
        cfg = pipeline.main(pipeline.read_config_file(config),
                            stage_times=stage_times)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipeline.disparity_to_height_all = driver
    launches['triplet'] = {**sk.launch_counts(), **interp.launch_counts()}
    for label, t in stage_times.items():
        print(f'  triplet {label} {t:.3f} s', flush=True)
    steps = {k.split(')')[0]: t for k, t in stage_times.items()}
    print(f"  triplet stage 5: {steps['5']:.3f} s = 5a {steps['5a']:.3f} + "
          f"5b {steps['5b']:.3f} + 5c {steps['5c']:.3f} + 5d "
          f"{steps['5d']:.3f} s", flush=True)
    print(f'  triplet main: {wall:.3f} s of wall time for stages 1 to 7 '
          f"({sum(t for k, t in steps.items() if len(k) == 1):.3f} s in the "
          f'stages) on {card}', flush=True)
    print(f"  triplet stage 5a peak device memory: {peak['bytes']} bytes "
          f"({peak['bytes'] / 2**20:.1f} MiB; {peak['before'] / 2**20:.1f} "
          'MiB allocated before it)', flush=True)
    lt = launches['triplet']
    print('  triplet launches over main: ' + ', '.join(
        f'{name} {lt[key]}' for name, key in (
            ('K1', 'cost_prepass'), ('K2', 'scan'), ('K3', 'wta'),
            ('W1', 'warp'), ('warp_dilate', 'warp_dilate'))), flush=True)
    idle = [k for k in ('cost_prepass', 'scan', 'wta', 'warp') if lt[k] == 0]
    if idle:
        raise AssertionError(f'the triplet launched no {idle}')

    tw, th = tiling.adjust_tile_size(cfg)
    tiles = tiling.tiles_full_info(cfg, tw, th,
                                   os.path.join(cfg.out_dir, 'tiles.txt'))
    if len(tiles) != 4:
        raise AssertionError(f'the triplet has {len(tiles)} tiles, not 4')
    worst = 0.0
    for i, err in ((1, SCENE_POINTING), (2, TRIPLET['pointing'])):
        for t in tiles:
            A = np.loadtxt(os.path.join(t['dir'], f'pair_{i}',
                                        'pointing.txt'))
            off = max(abs(A[0, 2]), abs(A[1, 2] + err))
            worst = max(worst, off)
            print(f'  triplet stage 1: {tile_name(t)} pair {i}: translation '
                  f'({A[0, 2]:.3f}, {A[1, 2]:.3f}) px against (0, {-err}): '
                  f'off by {off:.3f} px', flush=True)
    if worst > SCENE_POINTING_TOL_PX:
        raise AssertionError(f'triplet stage 1 misses the rendered pointing '
                             f'errors by {worst:.3f} px')

    check_bucket_kernels(cfg, [(t, i) for i in (1, 2) for t in tiles], stats,
                         lt, '_triplet')

    # stages 2 and 3 of pair 2 with device="cpu" on the card's stage-1
    # files
    stage23 = os.path.join(cpu_root, 'stage23')
    shutil.copytree(os.path.join(cfg.out_dir, 'tiles'),
                    os.path.join(stage23, 'tiles'))
    cpu_cfg = dataclasses.replace(cfg, out_dir=stage23)
    cpu_tiles = [moved(t, cfg.out_dir, stage23) for t in tiles]
    t0 = time.perf_counter()
    pipeline.global_pointing_correction(cpu_cfg, cpu_tiles)
    pipeline.rectification_all(cpu_cfg, [(t, 2) for t in cpu_tiles],
                               device='cpu')
    print(f'  triplet stages 2 and 3 of pair 2 with device="cpu": '
          f'{time.perf_counter() - t0:.3f} s', flush=True)
    names = ('H_ref.txt', 'H_sec.txt', 'disp_min_max.txt',
             'rectified_ref.tif', 'rectified_sec.tif')
    n = files_equal([(os.path.join(cfg.out_dir, 'global_pointing_pair_2.txt'),
                      os.path.join(stage23, 'global_pointing_pair_2.txt'))]
                    + [(os.path.join(a['dir'], 'pair_2', f),
                        os.path.join(b['dir'], 'pair_2', f))
                       for a, b in zip(tiles, cpu_tiles) for f in names],
                    'triplet stage 3')
    print(f'  triplet pair 2: {n} stage-2 and stage-3 files equal the CPU '
          'run byte for byte', flush=True)
    shutil.rmtree(stage23)

    check_triplet_5a_crops(cfg, tiles[0], os.path.join(cpu_root, 'crops'))

    # 5b-5d with device="cpu" on a copy of the card's 5a output
    rerun = os.path.join(cpu_root, 'rerun')
    cpu_cfg = dataclasses.replace(cfg, out_dir=rerun)
    cpu_tiles = [moved(t, cfg.out_dir, rerun) for t in tiles]
    for a, b in zip(tiles, cpu_tiles):
        os.makedirs(b['dir'])
        shutil.copy(os.path.join(a['dir'], 'mask.png'), b['dir'])
        for i in (1, 2):
            shutil.copytree(os.path.join(after_5a, os.path.relpath(
                a['dir'], cfg.out_dir), f'pair_{i}'),
                os.path.join(b['dir'], f'pair_{i}'))
    t0 = time.perf_counter()
    for t in cpu_tiles:
        pipeline.mean_heights(cpu_cfg, t)
    pipeline.global_mean_heights(cpu_cfg, cpu_tiles)
    pipeline.heights_to_ply_all(cpu_cfg, cpu_tiles, device='cpu')
    print(f'  triplet 5b-5d with device="cpu": {time.perf_counter() - t0:.3f}'
          ' s', flush=True)
    names = ('local_mean_heights.txt', 'height_map.tif', 'cloud.ply',
             'pair_1/height_map.tif', 'pair_2/height_map.tif')
    n = files_equal([(os.path.join(cfg.out_dir, f'global_mean_height_pair_'
                                   f'{i}.txt'),
                      os.path.join(rerun, f'global_mean_height_pair_{i}.txt'))
                     for i in (1, 2)]
                    + [(os.path.join(a['dir'], f), os.path.join(b['dir'], f))
                       for a, b in zip(tiles, cpu_tiles) for f in names],
                    'triplet 5b-5d')
    print(f'  triplet 5b-5d: {n} files (local and global mean heights, the '
          'despeckled and fused height maps, the clouds) equal the CPU run '
          'byte for byte', flush=True)

    means = [float(np.loadtxt(os.path.join(
        cfg.out_dir, f'global_mean_height_pair_{i}.txt'))) for i in (1, 2)]
    print(f'  triplet global mean heights: pair 1 {means[0]:.4f} m, pair 2 '
          f'{means[1]:.4f} m (SCENE_H0 {SCENE_H0}, tolerance '
          f'{TRIPLET_MEAN_TOL_M} m)', flush=True)
    if (abs(means[0] - means[1]) > TRIPLET_MEAN_TOL_M
            or max(abs(m - SCENE_H0) for m in means) > TRIPLET_MEAN_TOL_M):
        raise AssertionError('triplet: the pairs\' mean heights miss the '
                             'scene')
    alts, finite = [], []
    for t in tiles:
        pts, _ = ply.read_ply(os.path.join(t['dir'], 'cloud.ply'))
        alts.append(np.abs(pts[:, 2] - SCENE_H0))
        fused = geotiff.read(os.path.join(t['dir'], 'height_map.tif'))
        finite.append(float(np.isfinite(fused).mean()))
    err = np.concatenate(alts)
    med, p90 = float(np.median(err)), float(np.percentile(err, 90))
    print(f'  triplet fused maps: finite share per tile {finite}; clouds: '
          f'{len(err)} points, |altitude - {SCENE_H0}| median {med:.3f} m, '
          f'90th percentile {p90:.3f} m (tolerances {SCENE_ALT_TOL_M})',
          flush=True)
    if med > SCENE_ALT_TOL_M[0] or p90 > SCENE_ALT_TOL_M[1]:
        raise AssertionError('triplet: the fused cloud misses the altitude '
                             'of the scene')
    check_scene_dsm(cfg, tiles, TRIPLET['roi'])

    triplet_5d_parts(cfg, tiles, after_5a, os.path.join(cpu_root, 'parts'),
                     steps['5d'])


def triplet_5d_parts(cfg, tiles, after_5a, root, t_5d):
    """Stage 5d's parts on the card, one tile after another, on a copy of
    the card's 5a output: the fusion (despeckling and merge), the host
    float64 localization of the fused maps (``height_map_to_xyz``), the
    neighbour counts of all tiles as one batch, and the filter with the
    PLY write; each part's seconds against 5d's wall inside main (which
    ran the tiles on a thread pool)."""
    import dataclasses
    import numpy as np
    import torch
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.core import triangulation
    from s2p_tpu_torch.geo import crs, geotiff
    from s2p_tpu_torch.ops.filtering import count_3d_neighbors_batch

    pcfg = dataclasses.replace(cfg, out_dir=root)
    ptiles = [moved(t, cfg.out_dir, root) for t in tiles]
    for a, b in zip(tiles, ptiles):
        shutil.copytree(os.path.join(after_5a, os.path.relpath(
            a['dir'], cfg.out_dir)), b['dir'])
    for i in (1, 2):
        shutil.copy(os.path.join(cfg.out_dir,
                                 f'global_mean_height_pair_{i}.txt'), root)
    parts = dict.fromkeys(('fusion', 'localization', 'count', 'finish'),
                          0.0)
    xyzs, heights = [], 0
    for t in ptiles:
        t0 = time.perf_counter()
        pipeline.heights_fusion(pcfg, t)
        torch.cuda.synchronize()
        parts['fusion'] += time.perf_counter() - t0
        x, y, _, _ = t['coordinates']
        hmap = geotiff.read(os.path.join(t['dir'], 'height_map.tif'))
        heights += int(np.isfinite(hmap).sum())
        t0 = time.perf_counter()
        xyzs.append(triangulation.height_map_to_xyz(
            hmap, cfg.images[0].rpcm, x, y, crs.CRS(cfg.out_crs)))
        parts['localization'] += time.perf_counter() - t0
    p = int(np.ceil(cfg.filtering_3d_r / cfg.gsd))
    t0 = time.perf_counter()
    counts = count_3d_neighbors_batch(xyzs, cfg.filtering_3d_r, p)
    torch.cuda.synchronize()
    parts['count'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t, xyz, cnt in zip(ptiles, xyzs, counts):
        pipeline._heights_tile_finish(pcfg, t, xyz, None, cnt)
    parts['finish'] = time.perf_counter() - t0
    for name, t in parts.items():
        print(f'  triplet 5d part, one tile after another: {name}: {t:.3f} s'
              f' ({t / t_5d:.3f} of 5d in main)', flush=True)
    print(f"  triplet 5d: height_map_to_xyz localized {heights} heights "
          f"(host float64) in {parts['localization']:.3f} s", flush=True)


def run_multi(scene_root, root, cpu_root, stats, launches, card, mgm_walls):
    """Phase 8e: the pair scene (a copy of 8b's tree) through
    ``pipeline.main`` from stage 4 with ``mgm_multi``; stage 4's time
    beside 8b's ``mgm`` stage 4 (``mgm_walls``), its peak device memory
    and the launches over main; one tile's stage-4 files against
    device="cpu"; K2 and K3 against their plain versions on the inputs
    the cascade gives them at the scene's bucket; the clouds' altitudes
    and the DSM as in 8b.  Then the cascade on the full single tile and a
    crop of it against the CPU, and ``mgm_multi_lsd`` through stage 4's
    per-tile route on MULTI_LSD_TILES of the scene's tiles against the
    CPU."""
    import dataclasses
    import numpy as np
    import torch
    from s2p_tpu_torch import pipeline, tiling
    from s2p_tpu_torch.geo import geotiff, ply
    from s2p_tpu_torch.ops import interp
    from s2p_tpu_torch.ops import sgm_kernels as sk

    shutil.copytree(scene_root, root)
    user = pipeline.read_config_file(os.path.join(root, 'config.json'))
    user['matching_algorithm'] = 'mgm_multi'
    peak, driver = {}, pipeline.stereo_matching_all

    def stage_4(cfg, tiles_pairs, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        driver(cfg, tiles_pairs, **kw)
        torch.cuda.synchronize()
        peak['bytes'] = torch.cuda.max_memory_allocated()
        peak['before'] = before
    sk.reset_launch_counts()
    interp.reset_launch_counts()
    stage_times = {}
    pipeline.stereo_matching_all = stage_4
    try:
        t0 = time.perf_counter()
        cfg = pipeline.main(user, start_from=4, stage_times=stage_times)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipeline.stereo_matching_all = driver
    launches['multi'] = {**sk.launch_counts(), **interp.launch_counts()}
    walls = {label.split(')')[0]: t for label, t in stage_times.items()}
    for label, t in stage_times.items():
        print(f'  mgm_multi {label} {t:.3f} s', flush=True)
    print(f"  mgm_multi stage 4: {walls['4']:.3f} s against mgm's "
          f"{mgm_walls['4']:.3f} s (8b) on {card}; main from stage 4 "
          f'{wall:.3f} s', flush=True)
    print(f"  mgm_multi stage 4 peak device memory: {peak['bytes']} bytes "
          f"({peak['bytes'] / 2**20:.1f} MiB; {peak['before'] / 2**20:.1f} "
          'MiB allocated before it)', flush=True)
    lm = launches['multi']
    print(f'  mgm_multi launches over main: {lm}', flush=True)
    if lm['scan'] == 0 or lm['wta'] == 0 or lm['cost_prepass']:
        raise AssertionError('the mgm_multi stage 4 must launch K2 and K3 '
                             'and no K1')

    tw, th = tiling.adjust_tile_size(cfg)
    tiles = tiling.tiles_full_info(cfg, tw, th,
                                   os.path.join(cfg.out_dir, 'tiles.txt'))
    pairs = [(t, 1) for t in tiles]
    check_multi_kernels(cfg, pairs, stats)

    # one tile's stage 4 with device="cpu" on the same stage-3 files
    cpu_cfg = dataclasses.replace(cfg, out_dir=cpu_root)
    cpu_tiles = [moved(t, cfg.out_dir, cpu_root) for t in tiles[:1]]
    names = ('rectified_ref.tif', 'rectified_sec.tif', 'disp_min_max.txt')
    for a, b in zip(tiles, cpu_tiles):
        os.makedirs(os.path.join(b['dir'], 'pair_1'))
        for n in names:
            shutil.copy(os.path.join(a['dir'], 'pair_1', n),
                        os.path.join(b['dir'], 'pair_1'))
    t0 = time.perf_counter()
    pipeline.stereo_matching_all(cpu_cfg, [(t, 1) for t in cpu_tiles],
                                 device='cpu')
    print(f'  mgm_multi stage 4 of one tile with device="cpu": '
          f'{time.perf_counter() - t0:.3f} s', flush=True)
    n = files_equal([(os.path.join(a['dir'], 'pair_1', f),
                      os.path.join(b['dir'], 'pair_1', f))
                     for a, b in zip(tiles, cpu_tiles) for f in STAGE4_FILES],
                    'mgm_multi stage 4')
    print(f'  mgm_multi stage 4: {n} files of one tile equal the CPU run '
          'byte for byte', flush=True)

    alts = []
    for t in tiles:
        pdir = os.path.join(t['dir'], 'pair_1')
        lo, hi = np.loadtxt(os.path.join(pdir, 'disp_min_max.txt'))
        disp = geotiff.read(os.path.join(pdir, 'rectified_disp.tif'))
        fin = np.isfinite(disp)
        if fin.mean() < 0.5 or disp[fin].min() < lo or disp[fin].max() > hi:
            raise AssertionError(f"mgm_multi stage 4: {t['dir']}: finite "
                                 f'share {fin.mean():.3f}, disparities '
                                 f'outside [{lo}, {hi}]')
        pts, _ = ply.read_ply(os.path.join(t['dir'], 'cloud.ply'))
        alts.append(np.abs(pts[:, 2] - SCENE_H0))
        print(f'  mgm_multi {tile_name(t)}: disparity '
              f'{np.percentile(disp[fin], 1):.3f} .. '
              f'{np.percentile(disp[fin], 99):.3f} ({fin.mean():.4f} '
              f'finite), {len(pts)} points', flush=True)
    err = np.concatenate(alts)
    med, p90 = float(np.median(err)), float(np.percentile(err, 90))
    print(f'  mgm_multi cloud: {len(err)} points, |altitude - {SCENE_H0}| '
          f'median {med:.3f} m, 90th percentile {p90:.3f} m (tolerances '
          f'{SCENE_ALT_TOL_M})', flush=True)
    if med > SCENE_ALT_TOL_M[0] or p90 > SCENE_ALT_TOL_M[1]:
        raise AssertionError('mgm_multi: the cloud misses the altitude of '
                             'the scene')
    check_scene_dsm(cfg, tiles)

    check_multi_single(cpu_root)

    # mgm_multi_lsd through the per-tile route, card and CPU
    lsd_tiles = tiles[:MULTI_LSD_TILES]
    lcfg = dataclasses.replace(cfg, matching_algorithm='mgm_multi_lsd')
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    pipeline.stereo_matching_all(lcfg, [(t, 1) for t in lsd_tiles])
    torch.cuda.synchronize()
    print(f'  mgm_multi_lsd stage 4 of {len(lsd_tiles)} tile(s), per-tile '
          f'route: {time.perf_counter() - t0:.3f} s (LSD on the host '
          f'included); launches {sk.launch_counts()}', flush=True)
    lsd_cpu = [moved(t, cfg.out_dir, os.path.join(cpu_root, 'lsd'))
               for t in lsd_tiles]
    for a, b in zip(lsd_tiles, lsd_cpu):
        os.makedirs(os.path.join(b['dir'], 'pair_1'))
        for f in names:
            shutil.copy(os.path.join(a['dir'], 'pair_1', f),
                        os.path.join(b['dir'], 'pair_1'))
    t0 = time.perf_counter()
    pipeline.stereo_matching_all(
        dataclasses.replace(lcfg, out_dir=os.path.join(cpu_root, 'lsd')),
        [(t, 1) for t in lsd_cpu], device='cpu')
    print(f'  mgm_multi_lsd with device="cpu": {time.perf_counter() - t0:.3f}'
          ' s', flush=True)
    n = files_equal([(os.path.join(a['dir'], 'pair_1', f),
                      os.path.join(b['dir'], 'pair_1', f))
                     for a, b in zip(lsd_tiles, lsd_cpu)
                     for f in STAGE4_FILES], 'mgm_multi_lsd stage 4')
    print(f'  mgm_multi_lsd: {n} stage-4 files equal the CPU run byte for '
          'byte', flush=True)


def check_multi_kernels(cfg, tiles_pairs, stats):
    """K2 and K3 on the cascade's inputs at the scene's bucket: the batch
    again, with a spy on the aggregation that keeps each level's L-side
    cost volume and P2; then, at the finest level, K2 direction by
    direction against its plain version (timed, under ``scan_multi``) and
    K3 against its plain version (``wta_multi``); at every level K3 against
    the plain version and against ``mgm_flow._wta_refine``."""
    import dataclasses
    import torch
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.core import matching
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk

    variant = dataclasses.replace(matching.mgm_variant_from_cfg(cfg),
                                  median_order='none')
    buckets = pipeline.matching_buckets(cfg, tiles_pairs)
    if len(buckets) != 1:
        raise AssertionError(f'the scene has {len(buckets)} stage-4 '
                             'buckets, not 1')
    (Hp, Wp, Dp), group = next(iter(buckets.items()))
    n = len(group)
    b1 = torch.full((n, Hp, Wp), float('nan'))
    b2 = torch.full((n, Hp, Wp), float('nan'))
    for k, j in enumerate(group):
        b1[k, :j['rect1'].shape[0], :j['rect1'].shape[1]] = \
            torch.from_numpy(j['rect1'])
        b2[k, :j['rect2'].shape[0], :j['rect2'].shape[1]] = \
            torch.from_numpy(j['rect2'])
    levels, aggregate = [], mf._aggregate_scans

    def spy(cost, v, p2_map=None, emit_votes=True):
        if emit_votes:
            levels.append((cost, p2_map))
        return aggregate(cost, v, p2_map, emit_votes)
    mf._aggregate_scans = spy
    try:
        mf.mgm_multi_match_batch(
            b1.numpy(), b2.numpy(), [j['dmin'] for j in group], Dp,
            [j['rect1'].shape[0] for j in group],
            [j['rect1'].shape[1] for j in group],
            [j['rect2'].shape[1] for j in group],
            [j['dmax'] - j['dmin'] + 1 for j in group], variant)
    finally:
        mf._aggregate_scans = aggregate
    print(f'  mgm_multi bucket {n} x {Hp} x {Wp}, {Dp} candidates: '
          f'{len(levels)} levels, the finest level\'s cost volume '
          f'{tuple(levels[-1][0].shape)}', flush=True)
    for s, (cost, p2) in enumerate(levels):
        S, _ = aggregate(cost, variant, p2, False)
        off, d = sk.wta([S], variant.subpix, mf.BIG / 2)
        off_p, d_p = sk.wta_plain([S], variant.subpix, mf.BIG / 2)
        ref, d_r = mf._wta_refine(S.permute(0, 1, 3, 2), 0, variant)
        ok = (equal(off, off_p)[0] and equal(d, d_p)[0]
              and equal(d.to(torch.float32) + off, ref)[0]
              and equal(d, d_r)[0])
        rows = int(((S >= mf.BIG / 2).all(dim=2)).any(dim=2).sum())
        print(f'  wta_multi level {len(levels) - 1 - s} '
              f'{tuple(S.shape)}: K3 equals its plain version and '
              f'_wta_refine bitwise: {ok} ({rows} rows with an '
              'out-of-range pixel)', flush=True)
        if not ok:
            raise AssertionError("K3 differs on the cascade's volumes")
    del S, off, d, off_p, d_p, ref, d_r

    cost, p2 = levels[-1]
    B, H, W, D = cost.shape
    vols = {'v': cost.permute(0, 1, 3, 2).contiguous(),
            'h': cost.permute(0, 2, 3, 1).contiguous()}
    p2v = torch.full((B, H, W), variant.p2, device=cost.device)
    p2s = {'v': p2v, 'h': p2v.transpose(1, 2).contiguous()}
    dirs = mf._DIRS_8[:max(2, min(variant.nb_dir, 8))]
    S, o = None, None
    for dx, dy in dirs:
        od = 'h' if dy == 0 else 'v'
        if S is not None and od != o:
            S = S.permute(0, 3, 2, 1).contiguous()
        o = od
        args = (vols[o], p2s[o], (0 if dy == 0 else dx,), variant.p1,
                mf.BIG)
        kw = dict(reverse=(dx if dy == 0 else dy) < 0, accum=S)
        Sk, vk = sk.scan(*args, **kw)
        Sp, vp = sk.scan_plain(*args, **kw)
        ok, err = equal(Sk, Sp)
        ok_v, err_v = equal(vk, vp)
        vol = Sk.numel()
        nbytes = (vols[o].numel() + 4 * p2s[o].numel() + 4 * vol
                  + (4 * vol if S is not None else 0) + 4 * vk.numel())
        record(stats, f'scan_multi ({dx},{dy})', '', ok and ok_v,
               max(err, err_v), timed(lambda: sk.scan(*args, **kw), 5),
               timed(lambda: sk.scan_plain(*args, **kw), 1), nbytes,
               vol * 11)
        S = Sk
        del Sp, vp
    if o == 'h':
        S = S.permute(0, 3, 2, 1).contiguous()
    off, d = sk.wta([S], variant.subpix, mf.BIG / 2)
    off_p, d_p = sk.wta_plain([S], variant.subpix, mf.BIG / 2)
    ok, err = equal(off, off_p)
    ok_d, err_d = equal(d, d_p)
    vol = S.numel()
    record(stats, 'wta_multi', '', ok and ok_d, max(err, err_d),
           timed(lambda: sk.wta([S], variant.subpix, mf.BIG / 2), 5),
           timed(lambda: sk.wta_plain([S], variant.subpix, mf.BIG / 2), 2),
           4 * vol + 4 * off.numel() + 4 * d.numel(), 2 * vol)
    del levels, vols, S
    torch.cuda.empty_cache()


def check_multi_single(cpu_root):
    """The cascade on the single tile at full width (6 levels) through
    ``compute_disparity_map('mgm_multi')``: its known shift and wall
    time; then a MULTI_CROP crop of it on the card against device="cpu",
    all three outputs bitwise."""
    import torch
    from s2p_tpu_torch.core import matching
    from s2p_tpu_torch.ops import sgm_kernels as sk
    from s2p_tpu_torch.state import config_from_state

    cfg = config_from_state({'matching_algorithm': 'mgm_multi'})
    im1, im2 = make_pair(SINGLE)
    sk.reset_launch_counts()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        disp, mask, conf = matching.compute_disparity_map(
            cfg, im1, im2, SINGLE['dmin'], SINGLE['dmax'])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"  mgm_multi single tile {SINGLE['h']} x {SINGLE['w1']}, range "
          f"{SINGLE['dmin']}..{SINGLE['dmax']}: compute_disparity_map "
          f'{walls[0]:.3f} s cold, {walls[1]:.3f} s warm; launches over '
          f'both {sk.launch_counts()}', flush=True)
    check_known_shift('mgm_multi compute_disparity_map', disp, SINGLE)
    h, w = MULTI_CROP
    a, b = im1[:h, :w], im2[:h, :w]
    card = matching.compute_disparity_map(cfg, a, b, SINGLE['dmin'],
                                          SINGLE['dmax'])
    t0 = time.perf_counter()
    cpu = matching.compute_disparity_map(cfg, a, b, SINGLE['dmin'],
                                         SINGLE['dmax'], device='cpu')
    same = all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
               for x, y in zip(card, cpu))
    print(f'  mgm_multi {h} x {w} crop, card against device="cpu" '
          f'({time.perf_counter() - t0:.3f} s on the CPU): disparity, mask '
          f'and confidence byte for byte: {same}', flush=True)
    if not same:
        raise AssertionError('mgm_multi: the crop differs from the CPU run')


# --------------------------------------------------------------------- #
# several processes on the card (parallel/), the lax matcher routes
# --------------------------------------------------------------------- #

# the repair of the single tile: non-integer penalties (m 0.3)
M03 = dict(p1=8.0 * 0.3, p2=32.0 * 0.3)
# mesh and halo across ranks: the matcher's tiles, the rasterizer's grid
MESH_TILES = dict(n=4, h=256, w=256, dmin=-2, dmax=13, shift=3.0)
HALO_GRID = dict(nty=2, ntx=2, gw=256, gh=256, halo=4, res=0.5, radius=2,
                 sigma=0.8, n_pts=200_000)
DSM_TOL = dict(rtol=1e-4, atol=1e-3)     # tests/test_parallel_mesh.py
SGBM_CROP = (128, 320)                   # sgbm's launches, counted here

_WORKER = r"""
import json, os, sys, time
spec = json.load(open(sys.argv[1]))
sys.path.insert(0, spec['repo'])
import numpy as np
import torch
from s2p_tpu_torch.ops import _build
_build._BUILD = spec['build']            # an empty directory, shared
from s2p_tpu_torch import pipeline
from s2p_tpu_torch.parallel import distributed as dist
from s2p_tpu_torch.parallel import mesh as tmesh
import chip_smoke
rank = spec['rank']
dist.init(f"localhost:{spec['port']}", 2, rank)
report = {'rank': rank}
for name, start in (('pair', 2), ('triplet', 5)):
    if not spec.get(name):
        continue
    user = json.load(open(spec[name]))
    times = {}
    t0 = time.perf_counter()
    pipeline.main(user, start_from=start, stage_times=times)
    torch.cuda.synchronize()
    with open(os.path.join(user['out_dir'], 'tiles.txt')) as f:
        tiles = [line.strip() for line in f if line.strip()]
    report[name] = {'tiles': dist.partition_tiles(tiles), 'times': times,
                    'wall': time.perf_counter() - t0,
                    'device': str(torch.cuda.current_device())}
t0 = time.perf_counter()
res = chip_smoke.parallel_cases(tmesh.TileMesh())
report['mesh_wall'] = time.perf_counter() - t0
np.savez(spec['out'] + '.npz', **res)
with open(spec['out'] + '.json', 'w') as f:
    json.dump(report, f)
dist.barrier('done')
"""


def parallel_inputs():
    """The inputs of the mesh and halo cases, made from seeds."""
    import numpy as np
    rng = np.random.RandomState(11)
    m = MESH_TILES
    tex = rng.rand(m['n'], m['h'], m['w'] + 8).astype(np.float32) * 200
    tex = (tex + np.roll(tex, 1, 1) + np.roll(tex, 1, 2)) / 3
    im2 = tex[:, :, :m['w']].copy()
    im1 = np.roll(tex, -int(m['shift']), axis=2)[:, :, :m['w']].copy()
    im1[:, :4] = np.nan
    im2[:, :, -6:] = np.nan
    g = HALO_GRID
    n = g['nty'] * g['ntx']
    spill = (g['halo'] - g['radius']) * g['res']
    x0, y0 = 5000.0, 200.0
    pts = np.zeros((n, g['n_pts'], 3), np.float32)
    xoffs, yoffs = np.zeros(n, np.float32), np.zeros(n, np.float32)
    for k in range(n):
        ty, tx = divmod(k, g['ntx'])
        xoffs[k] = x0 + tx * g['gw'] * g['res']
        yoffs[k] = y0 - ty * g['gh'] * g['res']
        x = xoffs[k] + rng.uniform(-spill, g['gw'] * g['res'] + spill,
                                   g['n_pts'])
        y = yoffs[k] - rng.uniform(-spill, g['gh'] * g['res'] + spill,
                                   g['n_pts'])
        x = np.clip(x, x0, x0 + g['ntx'] * g['gw'] * g['res'] - 1e-3)
        y = np.clip(y, y0 - g['nty'] * g['gh'] * g['res'] + 1e-3, y0)
        pts[k] = np.column_stack([x, y, rng.uniform(10, 50, g['n_pts'])])
    dsm = dict(tile_points=pts,
               tile_valid=rng.rand(n, g['n_pts']) > 0.02, xoffs=xoffs,
               yoffs=yoffs, res=g['res'], gw=g['gw'], gh=g['gh'],
               halo=g['halo'], grid_shape=(g['nty'], g['ntx']),
               radius=g['radius'], sigma=g['sigma'])
    alts = rng.rand(4, 512, 512).astype(np.float32) * 100
    alts[1, :40] = np.nan
    centers = rng.uniform(0, 20000, (64, 2))
    M = np.array([[1.0, 0.001, 3.0], [-0.002, 0.999, -7.0], [0, 0, 1.0]])
    corrected = (np.column_stack([centers, np.ones(64)]) @ M.T)[:, :2]
    return dict(im1=im1, im2=im2, dsm=dsm, alts=alts, centers=centers,
                corrected=corrected)


def parallel_cases(mesh):
    """The mesh and halo functions on ``mesh`` (its ranks on the card):
    {name: numpy result}, with each function's wall time printed."""
    import numpy as np
    import torch
    from s2p_tpu_torch.ops.sgm import SgmParams
    from s2p_tpu_torch.parallel import halo, mesh as tmesh
    ins = parallel_inputs()
    m = MESH_TILES
    out = {}
    for name, params in (('match_mgm', SgmParams()),
                         ('match_classic', SgmParams(mgm=False))):
        t0 = time.perf_counter()
        r = tmesh.sharded_matching_step(mesh, ins['im1'], ins['im2'],
                                        m['dmin'], m['dmax'], params)
        print(f'  rank {mesh.rank} of {mesh.n}: sharded_matching_step '
              f'({name}) {time.perf_counter() - t0:.3f} s', flush=True)
        for k, v in r.items():
            out[f'{name}_{k}'] = v
    t0 = time.perf_counter()
    out['dsm'] = halo.sharded_dsm(mesh, **ins['dsm'])
    torch.cuda.synchronize()
    print(f'  rank {mesh.rank} of {mesh.n}: sharded_dsm '
          f'{time.perf_counter() - t0:.3f} s', flush=True)
    out['mean'] = np.float64(tmesh.global_mean_height_allreduce(
        mesh, ins['alts']))
    out['fit'] = halo.distributed_pointing_fit(mesh, ins['centers'],
                                               ins['corrected'])
    return out


def check_parallel(got, want, what):
    """Two ranks' results against one rank's: the matcher bitwise, the
    rasterizer (atomic sums on the card) at the JAX tests' tolerances, the
    mean and the fit likewise."""
    import numpy as np
    import torch
    for name in ('match_mgm', 'match_classic'):
        for k in ('disp', 'valid', 'confidence'):
            ok, err = equal(torch.from_numpy(np.asarray(got[f'{name}_{k}'])),
                            torch.from_numpy(np.asarray(want[f'{name}_{k}'])))
            if not ok:
                raise AssertionError(f'{what}: {name} {k} differs from one '
                                     f'rank (max abs error {err})')
        d = want[f'{name}_disp'][:, 8:-8, 8:-8]
        fin = np.isfinite(d)
        shift = float(np.median(np.abs(d[fin] - MESH_TILES['shift'])))
        if fin.mean() < 0.5 or shift > 0.3:
            raise AssertionError(f'{what}: {name} misses the shift')
    a, b = got['dsm'], want['dsm']
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError(f'{what}: the DSM tiles differ in shape or NaN')
    fin = ~np.isnan(b)
    np.testing.assert_allclose(a[fin], b[fin], **DSM_TOL)
    if not np.isclose(float(got['mean']), float(want['mean']), rtol=1e-5):
        raise AssertionError(f'{what}: global mean {got["mean"]} against '
                             f'{want["mean"]}')
    np.testing.assert_allclose(got['fit'], want['fit'], rtol=1e-3, atol=1e-3)
    print(f'  {what}: matcher (mgm and classic) bitwise, DSM tiles within '
          f'{DSM_TOL} (max abs {float(np.abs(a[fin] - b[fin]).max())}, '
          f'{int(fin.sum())} cells), mean and fit within tolerance',
          flush=True)


def run_two_processes(tmp, card):
    """Two processes on the one card over a gloo group (both on cuda:0),
    each from an empty shared build directory: ``pipeline.main`` of the
    pair scene from stage 2 and of the triplet from stage 5 on copies of
    the one-process runs' trees (``clean_intermediate`` on for the pair),
    then the mesh and halo functions.  Each process's tiles and stage
    times; both dsm.tif bitwise against the one-process runs; the blocks
    disjoint and covering the tiling; mesh and halo against one process
    on the card."""
    import socket
    import numpy as np
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.geo import geotiff
    from s2p_tpu_torch.parallel import mesh as tmesh

    repo = os.path.dirname(os.path.abspath(__file__))
    spec = {'repo': repo, 'build': os.path.join(tmp, 'build_two')}
    os.makedirs(spec['build'])
    for name, src in (('pair', 'scene'), ('triplet', 'triplet')):
        root = os.path.join(tmp, f'{src}_two')
        shutil.copytree(os.path.join(tmp, src), root)
        user = pipeline.read_config_file(os.path.join(root, 'config.json'))
        user['clean_intermediate'] = name == 'pair'
        os.remove(os.path.join(user['out_dir'], 'dsm.tif'))
        spec[name] = os.path.join(tmp, f'{name}_two.json')
        with open(spec[name], 'w') as f:
            json.dump(user, f)
        spec[name + '_out'] = user['out_dir']
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        spec['port'] = sock.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    for k in (0, 1):
        path = os.path.join(tmp, f'worker_{k}.json')
        with open(path, 'w') as f:
            json.dump(dict(spec, rank=k,
                           out=os.path.join(tmp, f'worker_{k}')), f)
        procs.append(subprocess.Popen(
            [sys.executable, '-c', _WORKER, path], cwd=repo,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for k, (p, log) in enumerate(zip(procs, logs)):
        lines = [ln.strip() for ln in log.splitlines()
                 if ln.startswith('  rank')]
        print(f'  process {k}: exit {p.returncode}; ' + '; '.join(lines),
              flush=True)
        if p.returncode != 0:
            raise AssertionError(f'process {k} failed:\n{log[-4000:]}')
    reports = [json.load(open(os.path.join(tmp, f'worker_{k}.json')))
               for k in (0, 1)]
    print(f'  two processes: {wall:.3f} s of wall time from their start '
          f'(an empty build directory each, {len(os.listdir(spec["build"]))}'
          f' entries after) on {card}', flush=True)
    for name, src in (('pair', 'scene'), ('triplet', 'triplet')):
        out = spec[name + '_out']
        with open(os.path.join(out, 'tiles.txt')) as f:
            tiles = [ln.strip() for ln in f if ln.strip()]
        blocks = [r[name]['tiles'] for r in reports]
        if (not all(blocks) or set(blocks[0]) & set(blocks[1])
                or sorted(blocks[0] + blocks[1]) != sorted(tiles)):
            raise AssertionError(f'{name}: the blocks {blocks} do not '
                                 f'split the tiling {tiles}')
        for r in reports:
            rep = r[name]
            stages = {k.split(')')[0]: round(v, 3)
                      for k, v in rep['times'].items()}
            print(f"  {name}, process {r['rank']} (cuda:{rep['device']}): "
                  f"tiles {[t.split('/')[1:3] for t in rep['tiles']]}, "
                  f"main {rep['wall']:.3f} s, stage seconds {stages}",
                  flush=True)
        one = os.path.join(tmp, src)
        one_user = pipeline.read_config_file(os.path.join(one,
                                                          'config.json'))
        a = geotiff.read_with_nans(os.path.join(out, 'dsm.tif'))
        b = geotiff.read_with_nans(os.path.join(one_user['out_dir'],
                                                'dsm.tif'))
        if a.shape != b.shape or not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f'{name}: the two-process dsm.tif differs '
                                 'from the one-process run')
        print(f'  {name}: the two-process dsm.tif ({a.shape}, '
              f'{int(np.isfinite(a).sum())} valid cells) equals the '
              'one-process run bitwise', flush=True)
    t0 = time.perf_counter()
    one = parallel_cases(tmesh.TileMesh())
    print(f'  mesh and halo in one process: {time.perf_counter() - t0:.3f} '
          's; in two: ' + ', '.join(f"{r['mesh_wall']:.3f} s"
                                    for r in reports), flush=True)
    for k in (0, 1):
        got = dict(np.load(os.path.join(tmp, f'worker_{k}.npz')))
        check_parallel(got, one, f'mesh and halo, rank {k} of 2')


def check_wavefront():
    """``ops.mgm.mgm_aggregate`` (eager torch, no kernel of its own) on
    the card against device="cpu" at the scene bucket's shape (832 x 960,
    16 candidates), float costs and non-integer penalties: S and the
    votes bitwise; both wall times (its launches are counted in
    :func:`run_sgbm`, whose tiles run it)."""
    import numpy as np
    import torch
    from s2p_tpu_torch.ops import mgm
    rng = np.random.RandomState(5)
    cost = torch.from_numpy((rng.rand(832, 960, 16) * 20).astype(np.float32))
    args = (2.4, 9.6, 8, 3)
    t0 = time.perf_counter()
    S_c, v_c = mgm.mgm_aggregate(cost, *args)
    t_cpu = time.perf_counter() - t0
    gpu = cost.cuda()
    mgm.mgm_aggregate(gpu[:64, :64], *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S_g, v_g = mgm.mgm_aggregate(gpu, *args)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    ok, err = equal(S_g.cpu(), S_c)
    ok_v, _ = equal(v_g.cpu(), v_c)
    print(f'  mgm_aggregate 832 x 960 x 16 (tsgm 3, 8 traversals): card '
          f'{t_gpu:.3f} s, CPU {t_cpu:.3f} s; S bitwise {ok} (max abs '
          f'error {err}), votes bitwise {ok_v}', flush=True)
    if not (ok and ok_v):
        raise AssertionError('mgm_aggregate: the card differs from the CPU')


def run_sgbm(scene_root, root, cpu_root, card):
    """``sgbm`` through ``pipeline.main`` from stage 4 on a copy of 8b's
    tree (stages 4 to 7 on the card): stage 4's time, its launches (the
    wavefront is eager torch: the profiler's count over SGBM_CROP of one
    tile, and per wavefront step), no confidence file; one tile's stage 4
    with device="cpu", the disparity and mask byte for byte; the clouds'
    altitudes and the dsm.tif's valid share."""
    import dataclasses
    import numpy as np
    import torch
    from s2p_tpu_torch import pipeline, tiling
    from s2p_tpu_torch.core import matching
    from s2p_tpu_torch.geo import geotiff, ply

    shutil.copytree(scene_root, root)
    user = pipeline.read_config_file(os.path.join(root, 'config.json'))
    user['matching_algorithm'] = 'sgbm'
    for d in os.listdir(os.path.join(user['out_dir'], 'tiles')):
        for c in os.listdir(os.path.join(user['out_dir'], 'tiles', d)):
            conf = os.path.join(user['out_dir'], 'tiles', d, c, 'pair_1',
                                'rectified_disp_confidence.tif')
            if os.path.exists(conf):
                os.remove(conf)
    stage_times = {}
    t0 = time.perf_counter()
    cfg = pipeline.main(user, start_from=4, stage_times=stage_times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for label, t in stage_times.items():
        print(f'  sgbm {label} {t:.3f} s', flush=True)
    print(f'  sgbm: main from stage 4 {wall:.3f} s on {card}', flush=True)
    tw, th = tiling.adjust_tile_size(cfg)
    tiles = tiling.tiles_full_info(cfg, tw, th,
                                   os.path.join(cfg.out_dir, 'tiles.txt'))
    # the profiler over a crop of one tile (over a whole tile it takes
    # about two minutes): the wavefront's launches per step
    pdir = os.path.join(tiles[0]['dir'], 'pair_1')
    h, w = SGBM_CROP
    crop = [geotiff.read(os.path.join(pdir, f'rectified_{n}.tif'))[:h, :w]
            for n in ('ref', 'sec')]
    lo, hi = np.loadtxt(os.path.join(pdir, 'disp_min_max.txt'))
    full = geotiff.read(os.path.join(pdir, 'rectified_ref.tif')).shape
    t0 = time.perf_counter()
    kernels, dev_ms = count_launches(
        lambda: matching.compute_disparity_map(cfg, *crop, lo, hi))
    t_prof = time.perf_counter() - t0
    if kernels is None:
        raise AssertionError('sgbm: the profiler saw no CUDA launch')

    def steps(shape):
        # match_pair pads to multiples of 64; a half pass steps over the
        # skewed diagonals t = x + 2y
        hp, wp = (-(-n // 64) * 64 for n in shape)
        return wp + 2 * (hp - 1)
    per_step = kernels / (2 * steps(crop[0].shape))
    print(f'  sgbm stage 4 of a {h} x {w} crop of one tile (range [{lo}, '
          f'{hi}]) under the profiler: {kernels} CUDA launches, {dev_ms} '
          f'ms of device time, {t_prof:.3f} s of wall time; '
          f'{per_step:.1f} launches a wavefront step ({steps(crop[0].shape)}'
          f' steps a half pass; a {full[0]} x {full[1]} tile has '
          f'{steps(full)}); {len(tiles)} tiles in the scene', flush=True)
    cpu_cfg = dataclasses.replace(cfg, out_dir=cpu_root)
    cpu_tiles = [moved(t, cfg.out_dir, cpu_root) for t in tiles[:1]]
    for a, b in zip(tiles, cpu_tiles):
        os.makedirs(os.path.join(b['dir'], 'pair_1'))
        for n in ('rectified_ref.tif', 'rectified_sec.tif',
                  'disp_min_max.txt'):
            shutil.copy(os.path.join(a['dir'], 'pair_1', n),
                        os.path.join(b['dir'], 'pair_1'))
    t0 = time.perf_counter()
    pipeline.stereo_matching_all(cpu_cfg, [(t, 1) for t in cpu_tiles],
                                 device='cpu')
    print(f'  sgbm stage 4 of one tile with device="cpu": '
          f'{time.perf_counter() - t0:.3f} s', flush=True)
    n = files_equal([(os.path.join(a['dir'], 'pair_1', f),
                      os.path.join(b['dir'], 'pair_1', f))
                     for a, b in zip(tiles, cpu_tiles)
                     for f in ('rectified_disp.tif', 'rectified_mask.png')],
                    'sgbm stage 4')
    alts = []
    for t in tiles:
        pdir = os.path.join(t['dir'], 'pair_1')
        if os.path.exists(os.path.join(pdir, STAGE4_FILES[1])):
            raise AssertionError('sgbm wrote a confidence file')
        pts, _ = ply.read_ply(os.path.join(t['dir'], 'cloud.ply'))
        alts.append(np.abs(pts[:, 2] - SCENE_H0))
    err = np.concatenate(alts)
    med = float(np.median(err))
    dsm = geotiff.read_with_nans(os.path.join(cfg.out_dir, 'dsm.tif'))
    share = float(np.isfinite(dsm).mean())
    print(f'  sgbm: {n} stage-4 files of one tile equal the CPU run byte '
          f'for byte, no confidence file; cloud {len(err)} points, '
          f'|altitude - {SCENE_H0}| median {med:.3f} m; dsm.tif '
          f'{dsm.shape}, {share:.4f} valid', flush=True)
    if med > SCENE_ALT_TOL_M[0] or share < 0.5:
        raise AssertionError('sgbm: the cloud or the DSM misses the scene')


# --------------------------------------------------------------------- #
# The matchers of the last slice: msmw and hirschmuller02 (B1), tvl1,
# the flow at wide census windows (K2's 16-bit source), the cascade with
# tsgm 2, sgm_match_batch and SIFT's host route
# --------------------------------------------------------------------- #

def matcher_crop(tile, size):
    """A crop of a tile's rectified pair at its origin, and its range."""
    import numpy as np
    from s2p_tpu_torch.geo import geotiff
    pdir = os.path.join(tile['dir'], 'pair_1')
    h, w = size
    ims = [geotiff.read(os.path.join(pdir, f'rectified_{n}.tif'))[:h, :w]
           .astype(np.float32) for n in ('ref', 'sec')]
    lo, hi = np.loadtxt(os.path.join(pdir, 'disp_min_max.txt'))
    return ims, (lo, hi)


def same_or_within(name, got, want, criterion):
    """Card against CPU: byte for byte, else the CPU tests' criterion
    (``criterion`` (disp, valid) pairs -> (ok, figures)); fails if
    neither holds."""
    import numpy as np
    (d, m), (dr, mr) = got, want
    if d.tobytes() == dr.tobytes() and m.tobytes() == mr.tobytes():
        return 'byte for byte'
    ok, figures = criterion((d, m > 0), (dr, mr > 0))
    if not ok:
        raise AssertionError(f'{name}: the card differs from the CPU beyond '
                             f'the tests\' criterion ({figures})')
    return f'within the tests\' criterion ({figures})'


def msmw_criterion(ours, ref):
    """tests/test_torch_msmw.py's criterion."""
    import numpy as np
    (d, v), (dr, vr) = ours, ref
    agree = float((v == vr).mean())
    both = v & vr
    err = float(np.abs(d[both] - dr[both]).max()) if both.any() else 0.0
    return (agree >= MSMW_VALID_SHARE and err <= MSMW_DISP_TOL,
            f'masks agree on {agree}, max |error| {err} px')


def tvl1_criterion(ours, ref):
    """tests/test_torch_tvl1.py's criterion."""
    import numpy as np
    (d, v), (dr, vr) = ours, ref
    agree = float((v == vr).mean())
    both = v & vr
    err = np.abs(d[both] - dr[both]) if both.any() else np.zeros(1)
    med, p99, top = (float(np.median(err)), float(np.percentile(err, 99)),
                     float(err.max()))
    return (agree >= TVL1_TOL['valid'] and med <= TVL1_TOL['median']
            and p99 <= TVL1_TOL['p99'] and top <= TVL1_TOL['max'],
            f'masks agree on {agree}, |error| median {med}, p99 {p99}, '
            f'max {top} px')


# B1's own cases beside the calls msmw's stage 4 makes: (label, D, h, w,
# mask, values); masks 'none', 'all' or 'rand' (70% True); values 'noise'
# (intensities of about 100 +- 40) or 'huge' (about +-3e37 and FLT_MAX,
# where the plain version's costs are inf or NaN); 'permuted' stores the
# candidates as (h, D, w), as msmw's gathers do
WINDOW_CASES = (
    ('1 x 1 x 1', 1, 1, 1, 'rand', 'noise'),
    ('one plane 5 x 9', 1, 5, 9, 'all', 'noise'),
    ('8 x 10', 16, 8, 10, 'rand', 'noise'),
    ('9 x 5, no pair', 40, 9, 5, 'none', 'noise'),
    ('10 x 8, all pairs', 16, 10, 8, 'all', 'noise'),
    ('one row', 40, 1, 300, 'rand', 'noise'),
    ('one column', 16, 300, 1, 'rand', 'noise'),
    ('odd 33 x 257', 16, 33, 257, 'rand', 'noise'),
    ('even 34 x 256', 40, 34, 256, 'rand', 'noise'),
    ('huge values', 16, 40, 140, 'rand', 'huge'),
    ('permuted', 16, 41, 139, 'rand', 'permuted'),
)


def check_window_costs(inputs, stats):
    """B1 (``msmw._window_costs``, one launch a battery) against
    ``_window_costs_plain`` on the card, bitwise and NaN-aware: on the
    largest candidate battery and the largest one-plane battery that
    msmw's stage 4 gave it (``inputs``: (label, (a, b_sh, fin_pair))), the
    first again with the variance, and WINDOW_CASES; each case's time
    beside the plain version's.  The JSON line's numbers are the largest
    battery's; its bound is ``msmw.window_costs_work`` over 33.5e12
    separate float32 operations a second (the library has no call that
    computes the battery)."""
    import torch
    from s2p_tpu_torch.ops import msmw
    g = torch.Generator(device='cuda').manual_seed(18)
    cases = [(label, args, False) for label, args in inputs]
    cases.append((f'{inputs[0][0]} with the variance', inputs[0][1], True))
    for label, D, h, w, mask, values in WINDOW_CASES:
        a = torch.randn((h, w), device='cuda', generator=g) * 40 + 100
        b = torch.randn((D, h, w), device='cuda', generator=g) * 40 + 100
        if values == 'huge':
            a, b = a * 3e35, b * 3e35
            a.view(-1)[::7] = 3.4e38
        fin = {'none': torch.zeros((D, h, w), dtype=torch.bool,
                                   device='cuda'),
               'all': torch.ones((D, h, w), dtype=torch.bool, device='cuda'),
               'rand': torch.rand((D, h, w), device='cuda', generator=g)
               < 0.7}[mask]
        if values == 'permuted':
            b = b.permute(1, 0, 2).contiguous().permute(1, 0, 2)
            fin = fin.permute(1, 0, 2).contiguous().permute(1, 0, 2)
        cases.append((f'{label}, mask {mask}', (a, b, fin), True))
    for k, (label, (a, b, fin), need_var) in enumerate(cases):
        D, h, w = b.shape
        msmw.reset_launch_counts()
        got = msmw._window_costs(a, b, fin, need_var)
        torch.cuda.synchronize()
        if msmw.launch_counts() != {'window_costs': 1}:
            raise AssertionError(f'B1 {label}: {msmw.launch_counts()} '
                                 'launches, not one')
        want = msmw._window_costs_plain(a, b, fin, need_var)
        ok, err = equal(got[0], want[0])
        if need_var:
            ok_v, err_v = equal(got[1], want[1])
            ok, err = ok and ok_v, max(err, err_v)
        nbytes, ops = msmw.window_costs_work(D, h, w, need_var)
        ms = timed(lambda: msmw._window_costs(a, b, fin, need_var), 5)
        plain_ms = timed(lambda: msmw._window_costs_plain(a, b, fin,
                                                          need_var), 2)
        nan = int(torch.isnan(want[0]).sum())
        t_bound, by = bound(nbytes, ops, F32_SEPARATE_OPS_PER_S)
        print(f'  B1 {label}: {D} x {h} x {w}, bitwise={ok} '
              f'max_abs_err={err}, {nan} NaN costs; kernel {ms:.4f} ms, '
              f'plain {plain_ms:.3f} ms, bound {t_bound:.4f} ms ({by}: '
              f'{ops} operations, {nbytes} bytes)', flush=True)
        if not ok:
            raise AssertionError(f'B1 {label} differs from its plain '
                                 f'version: max abs error {err}')
        if k == 0:
            stats['window_costs'] = dict(
                err=err, ms=ms, plain_ms=plain_ms, nbytes=nbytes, ops=ops,
                ops_per_s=F32_SEPARATE_OPS_PER_S, library_ms=None)
        else:
            st = stats['window_costs']
            st['err'] = max(st['err'], err)


def check_scan16(stats):
    """K2's 16-bit source against its plain version on the card, bitwise:
    the uint16 cost of a 17 x 17 census window on a crop of the single
    tile (Hamming counts up to 288, 65535 for BIG), both orientations,
    forward and backward, the second pass of each with accum."""
    import torch
    from s2p_tpu_torch.device import resolve
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk
    dev = resolve(None)
    im1, im2 = (torch.as_tensor(im[:WIDE_CROP[0], :WIDE_CROP[1]].copy(),
                                device=dev)
                for im in make_pair(SINGLE))
    D = 16
    cost = mf._cost_int(mf.census_cost_raw(im1, im2, -4, D, 17), 17)[None]
    if cost.dtype != torch.uint16 or int(cost.to(torch.int32).max()) != 65535:
        raise AssertionError('the 17 x 17 cost is not the 16-bit volume')
    vols = {'v': cost.permute(0, 1, 3, 2), 'h': cost.permute(0, 2, 3, 1)}
    for o, vol in vols.items():
        B, N, _, lanes = vol.shape
        p2 = torch.full((B, N, lanes), 32.0, dtype=torch.float32,
                        device=dev)
        S = None
        for reverse in (False, True):
            kw = dict(reverse=reverse, accum=S)
            Sk, vk = sk.scan(vol, p2, (0,), 8.0, mf.BIG, **kw)
            Sp, vp = sk.scan_plain(vol, p2, (0,), 8.0, mf.BIG, **kw)
            ok, err = equal(Sk, Sp)
            ok_v, _ = equal(vk, vp)
            n = Sk.numel()
            record(stats, f"scan16 {o}{'b' if reverse else 'f'}", '',
                   ok and ok_v, err,
                   timed(lambda: sk.scan(vol, p2, (0,), 8.0, mf.BIG, **kw),
                         5),
                   timed(lambda: sk.scan_plain(vol, p2, (0,), 8.0, mf.BIG,
                                               **kw), 1),
                   2 * vol.numel() + 4 * p2.numel() + 4 * n
                   + (4 * n if S is not None else 0) + 4 * vk.numel(),
                   n * 11)
            S = Sk


def run_new_matchers(scene_root, root, cpu_root, stats, launches, card):
    """hirschmuller02, msmw and tvl1: the known shift of a synthetic pair
    through ``compute_disparity_map``; then stage 4 through
    ``pipeline.stereo_matching_all`` on NEW_MATCHER_TILES of the scene's
    rectified tiles (8b), each matcher's time, its launches (B1 for the
    msmw engines), no confidence file and its agreement with mgm's stage
    4 of 8b; msmw's stage 4 of one tile through the plain window costs;
    crops of two tiles card against device="cpu" (byte for byte or by the
    CPU tests' criteria); B1 against its plain version on the batteries
    msmw's stage 4 gave it and on WINDOW_CASES."""
    import dataclasses
    import glob
    import numpy as np
    import torch
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.core import matching
    from s2p_tpu_torch.geo import geotiff
    from s2p_tpu_torch.ops import msmw
    from s2p_tpu_torch.ops import sgm_kernels as sk

    user = pipeline.read_config_file(os.path.join(scene_root, 'config.json'))
    cfg = pipeline.build_cfg(user)
    ref, sec = make_pair(KNOWN)
    for algo in NEW_MATCHERS:
        c = dataclasses.replace(cfg, matching_algorithm=algo)
        t0 = time.perf_counter()
        d, m, conf = matching.compute_disparity_map(c, ref, sec,
                                                    KNOWN['dmin'],
                                                    KNOWN['dmax'])
        t = time.perf_counter() - t0
        fin = np.isfinite(d)
        med = float(np.median(d[fin]))
        print(f"  {algo}: known shift {KNOWN['shift']} on a "
              f"{KNOWN['h']} x {KNOWN['w1']} pair: median {med:.3f} px, "
              f'{fin.mean():.4f} valid, {t:.3f} s', flush=True)
        if conf is not None or fin.mean() < 0.5 or \
                abs(med - KNOWN['shift']) > KNOWN_SHIFT_TOL_PX:
            raise AssertionError(f'{algo}: misses the known shift')

    pdirs = sorted(glob.glob(os.path.join(user['out_dir'], 'tiles', '*',
                                          '*', 'pair_1')))[:NEW_MATCHER_TILES]
    if len(pdirs) < 2:
        raise AssertionError(f'the scene has {len(pdirs)} tiles')
    battery = {}
    window_costs = msmw._window_costs

    def spy(a, b_sh, fin_pair, need_var=False):
        # the largest battery of several candidates and of one that msmw's
        # stage 4 gives B1
        key = b_sh.shape[0] > 1
        if key not in battery or b_sh.numel() > battery[key][1].numel():
            battery[key] = (a.clone(), b_sh.clone(), fin_pair.clone())
        return window_costs(a, b_sh, fin_pair, need_var)

    names = ('rectified_ref.tif', 'rectified_sec.tif', 'disp_min_max.txt')
    walls = {}
    for algo in NEW_MATCHERS:
        tiles = []
        for k, p in enumerate(pdirs):
            d = os.path.join(root, algo, f'tile_{k}')
            os.makedirs(os.path.join(d, 'pair_1'))
            for n in names:
                shutil.copy(os.path.join(p, n), os.path.join(d, 'pair_1'))
            tiles.append(({'dir': d}, 1))
        c = dataclasses.replace(cfg, matching_algorithm=algo,
                                out_dir=os.path.join(root, algo))
        sk.reset_launch_counts()
        msmw.reset_launch_counts()
        msmw._window_costs = spy
        try:
            t0 = time.perf_counter()
            pipeline.stereo_matching_all(c, tiles)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
        finally:
            msmw._window_costs = window_costs
        launches[algo] = {**sk.launch_counts(), **msmw.launch_counts()}
        walls[algo] = t
        agree = []
        for (tile, _), p in zip(tiles, pdirs):
            od = os.path.join(tile['dir'], 'pair_1')
            if os.path.exists(os.path.join(od, STAGE4_FILES[1])):
                raise AssertionError(f'{algo} wrote a confidence file')
            dn = geotiff.read(os.path.join(od, 'rectified_disp.tif'))
            dm = geotiff.read(os.path.join(p, 'rectified_disp.tif'))
            both = np.isfinite(dn) & np.isfinite(dm)
            agree.append((float(np.isfinite(dn).mean()),
                          float(np.median(np.abs(dn[both] - dm[both])))
                          if both.any() else float('inf')))
        worst = max(a[1] for a in agree)
        print(f'  {algo} stage 4 of {len(tiles)} scene tiles: {t:.3f} s on '
              f'{card}; launches {launches[algo]}; valid shares '
              f"{[round(a[0], 4) for a in agree]}; median |disp - mgm's| "
              f'per tile at most {worst:.3f} px', flush=True)
        if worst > NEW_MATCHER_MGM_TOL_PX or min(a[0] for a in agree) < 0.3:
            raise AssertionError(f"{algo}: stage 4 misses mgm's disparities "
                                 'of the scene')
        # 4 levels x 2 directions x 4 batteries (the match, the
        # self-similarity and the two of fDistTrans) a tile
        if algo != 'tvl1' and launches[algo]['window_costs'] != \
                MSMW_BATTERIES_PER_TILE * len(tiles):
            raise AssertionError(
                f"{algo}: stage 4 launched B1 {launches[algo]['window_costs']}"
                f' times, not {MSMW_BATTERIES_PER_TILE} a tile')
    check_msmw_plain_route(cfg, pdirs[0], os.path.join(root, 'msmw'),
                           os.path.join(root, 'msmw_plain'), names)

    # crops of two tiles, card against CPU
    for algo in NEW_MATCHERS:
        c = dataclasses.replace(cfg, matching_algorithm=algo)
        crit = tvl1_criterion if algo == 'tvl1' else msmw_criterion
        for p in pdirs[:2]:
            (a, b), (lo, hi) = matcher_crop({'dir': os.path.dirname(p)},
                                            NEW_MATCHER_CROP)
            got = matching.compute_disparity_map(c, a, b, lo, hi)[:2]
            t0 = time.perf_counter()
            want = matching.compute_disparity_map(c, a, b, lo, hi,
                                                  device='cpu')[:2]
            how = same_or_within(algo, got, want, crit)
            print(f'  {algo}: {NEW_MATCHER_CROP[0]} x {NEW_MATCHER_CROP[1]} '
                  f'crop of {tile_name({"dir": os.path.dirname(p)})}: the '
                  f'card equals the CPU run {how} (CPU '
                  f'{time.perf_counter() - t0:.3f} s)', flush=True)
    check_window_costs([('the largest battery', battery[True]),
                        ('the largest one-plane battery', battery[False])],
                       stats)
    return walls


def check_msmw_plain_route(cfg, pdir, kernel_root, root, names):
    """msmw's stage 4 of one scene tile with ``_window_costs_plain`` in
    place of B1, on the card: its files equal the kernel route's (the
    first tile of ``kernel_root``) byte for byte."""
    import dataclasses
    import torch
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.ops import msmw
    d = os.path.join(root, 'tile_0')
    os.makedirs(os.path.join(d, 'pair_1'))
    for n in names:
        shutil.copy(os.path.join(pdir, n), os.path.join(d, 'pair_1'))
    c = dataclasses.replace(cfg, matching_algorithm='msmw', out_dir=root)
    window_costs = msmw._window_costs
    msmw._window_costs = msmw._window_costs_plain
    try:
        t0 = time.perf_counter()
        pipeline.stereo_matching_all(c, [({'dir': d}, 1)])
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
    finally:
        msmw._window_costs = window_costs
    for n in STAGE4_FILES:
        got, want = (os.path.join(r, 'pair_1', n) for r in
                     (d, os.path.join(kernel_root, 'tile_0')))
        if os.path.exists(got) != os.path.exists(want):
            raise AssertionError(f'msmw plain route: {n} in one route only')
        if not os.path.exists(got):
            continue
        with open(got, 'rb') as f1, open(want, 'rb') as f2:
            if f1.read() != f2.read():
                raise AssertionError(f'msmw: {n} of the plain route differs '
                                     'from the kernel route')
    print(f'  msmw stage 4 of one scene tile with _window_costs_plain on the '
          f'card: {t:.3f} s; its files equal the kernel route\'s byte for '
          'byte', flush=True)


def check_wide_flow(launches):
    """The flow at census windows 7 and 17 (the lax route; 17 on K2's
    16-bit source) on a WIDE_CROP crop of the single tile: the single
    tile (through ``compute_disparity_map``, its launches counted), the
    batch and the cascade, card against device="cpu" byte for byte; then
    the cascade with tsgm 2 on the same crop."""
    import dataclasses
    import torch
    from s2p_tpu_torch.config import Config
    from s2p_tpu_torch.core import matching
    from s2p_tpu_torch.ops import mgm_flow as mf
    from s2p_tpu_torch.ops import sgm_kernels as sk
    h, w = WIDE_CROP
    im1, im2 = (im[:h, :w].copy() for im in make_pair(SINGLE))
    lo, hi = SINGLE['dmin'] // 4, SINGLE['dmax'] // 4
    D = hi - lo + 1

    def bytes_of(x):
        if isinstance(x, dict):
            return b''.join(bytes_of(x[k]) for k in sorted(x))
        if isinstance(x, (tuple, list)):
            return b''.join(bytes_of(y) for y in x)
        return x.cpu().numpy().tobytes() if torch.is_tensor(x) else \
            x.tobytes()

    for win in WIDE_WINDOWS:
        v = mf.MgmVariant(census_win=win)
        cfg = Config(census_ncc_win=win)
        runs = {
            'compute_disparity_map': lambda dev: matching
            .compute_disparity_map(cfg, im1, im2, lo, hi, device=dev),
            'batch': lambda dev: mf.mgm_binary_match_batch(
                im1[None], im2[None], [lo], D, [h], [w], [w], [D], v,
                device=dev),
            'cascade': lambda dev: mf.mgm_multi_match(
                im1, im2, lo, hi, dataclasses.replace(v, median_order='none'),
                scales=3, device=dev)}
        for name, run in runs.items():
            sk.reset_launch_counts()
            t0 = time.perf_counter()
            got = run(None)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            counts = sk.launch_counts()
            if name == 'compute_disparity_map':
                launches[f'flow{win}'] = counts
            if bytes_of(got) != bytes_of(run('cpu')):
                raise AssertionError(f'the flow at {win} x {win} ({name}) '
                                     'differs from the CPU run')
            print(f'  census {win} x {win}, {name}: {h} x {w} crop equal '
                  f'to the CPU run byte for byte; card {t:.3f} s; '
                  f'launches {counts}', flush=True)
        key = 'scan16' if win * win - 1 >= 255 else 'scan'
        if launches[f'flow{win}'][key] == 0:
            raise AssertionError(f'the flow at {win} x {win} launched no '
                                 f'{key}')
    v = mf.MgmVariant(tsgm=2, median_order='none')
    t0 = time.perf_counter()
    got = mf.mgm_multi_match(im1, im2, lo, hi, v, scales=3)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    if bytes_of(got) != bytes_of(mf.mgm_multi_match(im1, im2, lo, hi, v,
                                                    scales=3,
                                                    device='cpu')):
        raise AssertionError('the cascade with tsgm 2 differs from the CPU '
                             'run')
    print(f'  cascade with tsgm 2 (the MGM wavefront per level): {h} x {w} '
          f'crop equal to the CPU run byte for byte; card {t:.3f} s',
          flush=True)


def check_sgm_batch():
    """``ops.sgm.sgm_match_batch`` on two tiles with different disparity
    bases on the card, bitwise against ``sgm_match``'s lax route tile by
    tile (the batch's route), and against the CPU."""
    import numpy as np
    import torch
    from s2p_tpu_torch.device import resolve
    from s2p_tpu_torch.ops import sgm
    spec = SGM_BATCH
    pairs = [make_pair(dict(index=0, h=spec['h'], w1=spec['w'],
                            w2=spec['w'], shift=spec['shift'], seed=s))
             for s in (spec['seed'], spec['seed'] + 1)]
    b1 = torch.as_tensor(np.stack([p[0] for p in pairs]), device=resolve())
    b2 = torch.as_tensor(np.stack([p[1] for p in pairs]), device=resolve())
    params = sgm.SgmParams(**SGM_BATCH_PARAMS)
    t0 = time.perf_counter()
    out = sgm.sgm_match_batch(b1, b2, spec['dmins'], spec['D'], params)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    for k, dm in enumerate(spec['dmins']):
        one = sgm._match_core(b1[k], b2[k], dm, spec['D'], params,
                              allow_kernels=False)
        for name in ('disp', 'valid', 'confidence'):
            ok, err = equal(out[name][k], one[name])
            if not ok:
                raise AssertionError(f'sgm_match_batch tile {k}: {name} '
                                     f'differs from the lax route ({err})')
    cpu = sgm.sgm_match_batch(b1.cpu().numpy(), b2.cpu().numpy(),
                              spec['dmins'], spec['D'], params, device='cpu')
    for name in ('disp', 'valid', 'confidence'):
        ok, err = equal(out[name].cpu(), cpu[name])
        if not ok:
            raise AssertionError(f'sgm_match_batch: {name} differs from the '
                                 f'CPU run ({err})')
    disp = out['disp'].cpu().numpy()
    med = [float(np.nanmedian(d)) for d in disp]
    print(f"  sgm_match_batch: 2 tiles of {spec['h']} x {spec['w']}, bases "
          f"{spec['dmins']}, {spec['D']} candidates: {t:.3f} s on the card; "
          'bitwise the per-tile lax route and the CPU run; median '
          f"disparity {med} (shift {spec['shift']})", flush=True)
    if any(abs(m - spec['shift']) > 0.5 for m in med):
        raise AssertionError('sgm_match_batch misses the known shift')


def run_sift_host(scene_root, root, card):
    """SIFT's host route: on two crops of the scene's image 1 against the
    port's device route on the card, by the JAX package's own
    host-against-device criterion (tests/test_sift.py); then stage 1 with
    ``sift_device='host'`` on two tiles of SIFT_HOST_TILE px (threads, the
    host route tile by tile), each tile's translation against the
    rendered pointing error, and its seconds."""
    import dataclasses
    import numpy as np
    from scipy.spatial import cKDTree
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.ops import sift

    user = pipeline.read_config_file(os.path.join(scene_root, 'config.json'))
    cfg = pipeline.build_cfg(user)
    img = pipeline._image(cfg.images[0].img)
    try:
        for (x, y, w, h) in SIFT_HOST_CROPS:
            sift.set_device_mode('host')
            t0 = time.perf_counter()
            kp_host = sift.image_keypoints(img, x, y, w, h)
            t_host = time.perf_counter() - t0
            sift.set_device_mode('auto')
            kp_dev = sift.image_keypoints(img, x, y, w, h)
            d, idx = cKDTree(kp_host[:, :4]).query(kp_dev[:, :4], k=1)
            close = d < 1e-3
            inner = ((kp_dev[:, 0] > x + 10) & (kp_dev[:, 0] < x + w - 10)
                     & (kp_dev[:, 1] > y + 10) & (kp_dev[:, 1] < y + h - 10))
            diff = np.abs(kp_dev[close, 4:] - kp_host[idx[close], 4:])
            sift.set_device_mode('host')
            m_host = sift.keypoints_match(kp_host, kp_dev)
            sift.set_device_mode('auto')
            m_dev = sift.keypoints_match(kp_host, kp_dev)
            print(f'  SIFT host route, crop {(x, y, w, h)}: {len(kp_host)} '
                  f'keypoints ({t_host:.3f} s), the device route '
                  f'{len(kp_dev)}; {close.mean():.4f} within 1e-3 '
                  f'({close[inner].mean():.4f} inside), descriptor entries '
                  f'within 1 {(diff <= 1).mean():.5f}; matches {len(m_host)}'
                  f' host, {len(m_dev)} device', flush=True)
            if (abs(len(kp_dev) - len(kp_host)) > 0.03 * len(kp_host)
                    or close.mean() <= 0.93 or close[inner].mean() <= 0.97
                    or (diff <= 1).mean() <= 0.99
                    or abs(len(m_dev) - len(m_host))
                    > max(2, 0.01 * len(m_host))):
                raise AssertionError('SIFT host route: misses the device '
                                     'route by the host-against-device '
                                     'criterion')

        tiles = []
        for k, (x, y) in enumerate(SIFT_HOST_TILES):
            d = os.path.join(root, f'tile_{k}')
            os.makedirs(os.path.join(d, 'pair_1'))
            tiles.append({'dir': d, 'coordinates': (x, y, SIFT_HOST_TILE,
                                                    SIFT_HOST_TILE),
                          'neighborhood_dirs': []})
        hcfg = dataclasses.replace(cfg, out_dir=root, sift_device='host')
        sift.set_device_mode('host')
        t0 = time.perf_counter()
        pipeline.pointing_correction_all(hcfg, [(t, 1) for t in tiles],
                                         nb_workers=len(tiles))
        t = time.perf_counter() - t0
    finally:
        sift.set_device_mode('auto')
    for tile in tiles:
        A = np.loadtxt(os.path.join(tile['dir'], 'pair_1', 'pointing.txt'))
        m = np.loadtxt(os.path.join(tile['dir'], 'pair_1',
                                    'sift_matches.txt'))
        err = max(abs(A[0, 2]), abs(A[1, 2] + SCENE_POINTING))
        print(f"  stage 1 with sift_device='host', tile at "
              f"{tile['coordinates']}: {len(m)} matches, translation "
              f'({A[0, 2]:.3f}, {A[1, 2]:.3f}) px, off by {err:.3f} px',
              flush=True)
        if err > SCENE_POINTING_TOL_PX:
            raise AssertionError('the host route misses the rendered '
                                 'pointing error')
    print(f"  stage 1 with sift_device='host' on {len(tiles)} tiles of "
          f'{SIFT_HOST_TILE} px: {t:.3f} s ({card})', flush=True)


def write_float_predictor3(path, arr, rows_per_strip=64):
    """A float32 TIFF with the floating-point predictor (tag 317 = 3) and
    deflate strips: each row's bytes split into planes, most significant
    first, then differenced across the row (the port's Python decoder
    undoes exactly that; the card machine has no PIL to write one)."""
    import zlib
    import numpy as np
    h, w = arr.shape
    chunks = []
    for y0 in range(0, h, rows_per_strip):
        rows = np.ascontiguousarray(arr[y0:y0 + rows_per_strip], '>f4')
        n = rows.shape[0]
        planes = rows.view(np.uint8).reshape(n, w, 4).transpose(0, 2, 1) \
            .reshape(n, 4 * w)
        diff = planes.copy()
        diff[:, 1:] = planes[:, 1:] - planes[:, :-1]
        chunks.append(zlib.compress(diff.tobytes(), 6))
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [32]), (259, 3, [8]),
               (262, 3, [1]), (273, 4, None), (277, 3, [1]),
               (278, 4, [rows_per_strip]), (279, 4, [len(c) for c in chunks]),
               (284, 3, [1]), (317, 3, [3]), (339, 3, [3])]
    ifd_end = 8 + 2 + 12 * len(entries) + 4
    heap_at = {273: ifd_end, 279: ifd_end + 4 * len(chunks)}
    data_at = ifd_end + 8 * len(chunks)
    offsets = list(np.cumsum([data_at] + [len(c) for c in chunks[:-1]]))
    out = bytearray(b'II*\0' + struct.pack('<I', 8)
                    + struct.pack('<H', len(entries)))
    for tag, typ, vals in entries:
        vals = offsets if tag == 273 else vals
        fmt = '<H' if typ == 3 else '<I'
        if len(vals) == 1:
            val = struct.pack(fmt, int(vals[0])).ljust(4, b'\0')
        else:
            val = struct.pack('<I', heap_at[tag])
        out += struct.pack('<HHI', tag, typ, len(vals)) + val
    out += struct.pack('<I', 0)
    out += struct.pack(f'<{len(chunks)}I', *map(int, offsets))
    out += struct.pack(f'<{len(chunks)}I', *[len(c) for c in chunks])
    for c in chunks:
        out += c
    with open(path, 'wb') as f:
        f.write(bytes(out))


def native_windows(h, w):
    """(x, y, w, h) windows of the default tile over an ROI of 4 x 3 tiles
    at the raster's top left corner, then of the neighbourhood margin
    (NATIVE_TILE / 2) across each border and corner of the raster."""
    t, m = NATIVE_TILE, NATIVE_TILE // 2
    wins = [(x, y, t, t) for y in range(200, 200 + 3 * t, t)
            for x in range(200, 200 + 4 * t, t)]
    wins += [(-m, -m, t, t), (w - m, h - m, t, t), (-m, h // 2, t, t),
             (w // 2, -m, t, t), (w - m, h // 3, t, t), (w // 3, h - m, t, t),
             (-m, -m, w + 2 * m, 2 * m), (w + 10, 10, t, t)]
    return wins


def check_native_reader(tmp):
    """8l: windowed reads through the native reader against the whole-file
    decode (the Python path), bitwise, on a large tiled uint16 file and a
    float32 strip file; a float32 file with predictor 3 read right through
    windows (the native reader refuses it); ``tiling.is_tile_all_nodata``
    over the same windows with the native path and with the whole-file
    decode."""
    import numpy as np
    from s2p_tpu_torch import tiling
    from s2p_tpu_torch.geo import geotiff, geotiff_native

    def whole_cut(arr, window, boundless):
        x, y, w, h = window
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, arr.shape[1]), min(y + h, arr.shape[0])
        if not boundless:
            return arr[y0:y1, x0:x1]
        out = np.zeros((h, w), arr.dtype)
        if x0 < x1 and y0 < y1:
            out[y0 - y:y1 - y, x0 - x:x1 - x] = arr[y0:y1, x0:x1]
        return out

    results = {}
    for name, spec, dtype, tiled in (('tiled uint16', NATIVE_TILED,
                                      np.uint16, True),
                                     ('strip float32', NATIVE_STRIPS,
                                      np.float32, False)):
        rng = np.random.RandomState(spec['seed'])
        h, w = spec['h'], spec['w']
        yy = np.arange(h, dtype=np.float32)[:, None]
        xx = np.arange(w, dtype=np.float32)[None, :]
        arr = (2000 + 800 * np.sin(xx / 97.0) * np.cos(yy / 131.0)
               + rng.randint(0, 64, (h, w))).astype(dtype)
        arr[:, :300] = 0                       # a nodata band on the left
        path = os.path.join(tmp, f'native_{dtype.__name__}.tif')
        t0 = time.perf_counter()
        geotiff.write(path, arr, compress='deflate', tiled=tiled)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole = geotiff._Tiff(path).read_array()[:, :, 0]
        t_whole = time.perf_counter() - t0
        if not np.array_equal(whole, arr):
            raise AssertionError(f'{name}: the Python decode differs from '
                                 'the written array')
        wins = native_windows(h, w)
        t_native = 0.0
        for win in wins:
            for boundless in (False, True):
                t0 = time.perf_counter()
                got = geotiff.read(path, window=win, boundless=boundless)
                t_native += time.perf_counter() - t0
                want = whole_cut(whole, win, boundless)
                if (got.dtype != want.dtype or got.shape != want.shape
                        or got.tobytes() != want.tobytes()):
                    raise AssertionError(f'{name}: window {win} boundless '
                                         f'{boundless}: native != Python')
        print(f'  native reader, {name} {h} x {w} deflate '
              f"({os.path.getsize(path) / 2 ** 20:.1f} MiB, written in "
              f'{t_write:.3f} s): {2 * len(wins)} windows bitwise against '
              f'the whole-file decode ({t_whole:.3f} s a decode); native '
              f'{t_native:.3f} s for all of them', flush=True)
        results[name] = path
    # is_tile_all_nodata over the same windows, both routes
    path = results['tiled uint16']
    wins = native_windows(NATIVE_TILED['h'], NATIVE_TILED['w'])[
        :TIMED_WINDOWS]
    t0 = time.perf_counter()
    native = [tiling.is_tile_all_nodata(path, *win) for win in wins]
    t_native = time.perf_counter() - t0
    saved = geotiff._read_native
    geotiff._read_native = lambda *args: None
    try:
        t0 = time.perf_counter()
        whole = [tiling.is_tile_all_nodata(path, *win) for win in wins]
        t_whole = time.perf_counter() - t0
    finally:
        geotiff._read_native = saved
    if native != whole:
        raise AssertionError('is_tile_all_nodata differs between the routes')
    print(f'  tiling.is_tile_all_nodata over {len(wins)} windows of '
          f'{NATIVE_TILE} px of the {NATIVE_TILED["h"]} x '
          f'{NATIVE_TILED["w"]} file: native {t_native:.4f} s, whole-file '
          f'decode {t_whole:.3f} s, ratio {t_whole / t_native:.1f}', flush=True)
    # the floating-point predictor: refused natively, read right in Python
    spec = NATIVE_PRED3
    rng = np.random.RandomState(spec['seed'])
    arr = (rng.rand(spec['h'], spec['w']) * 300 - 100).astype(np.float32)
    path = os.path.join(tmp, 'pred3.tif')
    write_float_predictor3(path, arr)
    if geotiff_native.read_window(path, 0, 0, 30, 20) is not None:
        raise AssertionError('the native reader took predictor 3')
    for win in ((20, 10, 30, 20), (-50, 900, 400, 200), (0, 0, 1200, 1000)):
        for boundless in (False, True):
            got = geotiff.read(path, window=win, boundless=boundless)
            if not np.array_equal(got, whole_cut(arr, win, boundless)):
                raise AssertionError(f'predictor 3: window {win} read wrong')
    print(f"  a float32 file with predictor 3 ({spec['h']} x {spec['w']}): "
          'refused by the native reader, its windows read right by the '
          'Python path', flush=True)
    return t_native, t_whole


def run_plyflatten(scene_out, card):
    """8m: ``plyflatten_device`` on the scene's clouds on the card and with
    device="cpu": its time and the largest difference, the sets of empty
    cells equal."""
    import glob
    import numpy as np
    import torch
    from s2p_tpu_torch.geo import geotiff, ply
    from s2p_tpu_torch.ops import rasterize

    clouds = sorted(glob.glob(os.path.join(scene_out, 'tiles', '*', '*',
                                           'cloud.ply')))
    pts = np.vstack([ply.read_ply(c)[0] for c in clouds])
    res = geotiff.read_profile(os.path.join(scene_out, 'dsm.tif')) \
        .transform[0]
    xoff, yoff, xsize, ysize = rasterize.grid_from_roi(
        np.nanmin(pts[:, 0]), np.nanmin(pts[:, 1]), np.nanmax(pts[:, 0]),
        np.nanmax(pts[:, 1]), res)
    grid = (xoff, yoff, res, xsize, ysize)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = rasterize.plyflatten_device(pts, *grid)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    want = rasterize.plyflatten_device(pts, *grid, device='cpu').numpy()
    t_cpu = time.perf_counter() - t0
    got = got.cpu().numpy()
    full = np.isfinite(want)
    if got.shape != want.shape or not np.array_equal(np.isfinite(got), full):
        raise AssertionError('plyflatten_device: the card and the CPU fill '
                             'different cells')
    diff = np.abs(got[full] - want[full])
    rel = float((diff / np.maximum(np.abs(want[full]), 1e-300)).max())
    print(f'  plyflatten_device: {len(clouds)} clouds, {len(pts)} points '
          f'(float64), grid {ysize} x {xsize} at {res} m, '
          f'{int(full[..., 0].sum())} cells filled; the card '
          f'{", ".join(f"{t:.4f}" for t in walls)} s (cold, warm, warm), '
          f'device="cpu" {t_cpu:.3f} s; largest difference '
          f'{float(diff.max()):.3e} (relative {rel:.3e}) on {card}',
          flush=True)
    if rel > PLYFLATTEN_RTOL:
        raise AssertionError(f'plyflatten_device: card against CPU off by '
                             f'{rel:.3e} (relative)')


def run_utils(scene_out, triplet_out, tmp):
    """8n: the utils on the trees of the scene and the triplet: the mosaic
    of the triplet's pair_1/height_map.tif (each tile's block its map),
    the scene's clouds through gather_cloud and write_las (the points of
    every cloud), the scene's two tile maps."""
    import glob
    import numpy as np
    from s2p_tpu_torch.geo import geotiff, ply
    from s2p_tpu_torch.utils import exporters, mosaic, tilemap

    t0 = time.perf_counter()
    tiles_txt = os.path.join(triplet_out, 'tiles.txt')
    out = mosaic.main(tiles_txt, os.path.join(tmp, 'mosaic.tif'),
                      'pair_1/height_map.tif')
    t_mosaic = time.perf_counter() - t0
    with open(tiles_txt) as f:
        cfgs = [os.path.join(triplet_out, line.strip()) for line in f
                if line.strip()]
    rois = []
    for c in cfgs:
        with open(c) as f:
            rois.append(json.load(f)['roi'])
    x0, y0 = min(r['x'] for r in rois), min(r['y'] for r in rois)
    for c, r in zip(cfgs, rois):
        hmap = geotiff.read_with_nans(os.path.join(os.path.dirname(c),
                                                   'pair_1',
                                                   'height_map.tif'))
        block = out[r['y'] - y0:r['y'] - y0 + hmap.shape[0],
                    r['x'] - x0:r['x'] - x0 + hmap.shape[1]]
        if not np.array_equal(block, hmap, equal_nan=True):
            raise AssertionError(f'mosaic: the block of {c} is not its map')
    if not np.array_equal(geotiff.read(os.path.join(tmp, 'mosaic.tif')), out,
                          equal_nan=True):
        raise AssertionError('mosaic: the GeoTIFF is not the mosaic')
    t0 = time.perf_counter()
    pts = exporters.gather_cloud(scene_out)
    n = sum(len(ply.read_ply(c)[0]) for c in glob.glob(
        os.path.join(scene_out, 'tiles', '*', '*', 'cloud.ply')))
    las = os.path.join(tmp, 'cloud.las')
    exporters.write_las(las, pts)
    t_las = time.perf_counter() - t0
    with open(las, 'rb') as f:
        head = f.read(227)
    if (len(pts) != n or int.from_bytes(head[107:111], 'little') != n
            or os.path.getsize(las) != 227 + 26 * n):
        raise AssertionError(f'LAS: {len(pts)} points gathered, {n} in the '
                             'clouds')
    t0 = time.perf_counter()
    tiles = os.path.join(scene_out, 'tiles.txt')
    with open(tiles) as f:
        n_tiles = sum(1 for line in f if line.strip())
    tilemap.svg_tilemap(tiles, os.path.join(tmp, 'map.svg'))
    tilemap.kml_tilemap(tiles, os.path.join(tmp, 'map.kml'))
    t_maps = time.perf_counter() - t0
    with open(os.path.join(tmp, 'map.svg')) as f:
        rects = f.read().count('<rect')
    with open(os.path.join(tmp, 'map.kml')) as f:
        marks = f.read().count('<Placemark')
    if rects != n_tiles or marks != n_tiles:
        raise AssertionError(f'tile maps: {rects} and {marks} tiles of '
                             f'{n_tiles}')
    print(f'  utils: the mosaic of the triplet\'s {len(cfgs)} height maps '
          f'({out.shape[0]} x {out.shape[1]}) {t_mosaic:.3f} s, each block '
          f'its map; gather_cloud and write_las of the scene\'s {n} points '
          f'{t_las:.3f} s; the SVG and KML tile maps ({n_tiles} tiles) '
          f'{t_maps:.3f} s', flush=True)


def run_debug_plot(scene_root, root):
    """8o: stage 1 with debug on for the first DEBUG_TILES scene tiles on
    the card: each pair's sift_matches_pointing.png, decoded, has the size
    of the two crops side by side and coloured matches."""
    import dataclasses
    import numpy as np
    from s2p_tpu_torch import pipeline, tiling
    from s2p_tpu_torch.core import rpc_geom
    from s2p_tpu_torch.geo import geotiff

    cfg = pipeline.build_cfg(pipeline.read_config_file(
        os.path.join(scene_root, 'config.json')))
    tiles = tiling.tiles_full_info(cfg, *tiling.adjust_tile_size(cfg),
                                   os.path.join(cfg.out_dir, 'tiles.txt'))
    tiles = [moved(t, cfg.out_dir, root) for t in tiles[:DEBUG_TILES]]
    for t in tiles:
        os.makedirs(os.path.join(t['dir'], 'pair_1'))
    dcfg = dataclasses.replace(cfg, out_dir=root, debug=True)
    t0 = time.perf_counter()
    pipeline.pointing_correction_all(dcfg, [(t, 1) for t in tiles])
    wall = time.perf_counter() - t0
    im1 = pipeline._image(cfg.images[0].img)
    im2 = pipeline._image(cfg.images[1].img)
    for t in tiles:
        png = os.path.join(t['dir'], 'pair_1', 'sift_matches_pointing.png')
        got = geotiff.read_png(png)
        x, y, w, h = t['coordinates']
        x2, y2, w2, h2 = map(int, rpc_geom.corresponding_roi(
            cfg.images[0].rpcm, cfg.images[1].rpcm, x, y, w, h))
        h1, w1 = im1[y:y + h, x:x + w].shape
        h2, w2 = im2[max(y2, 0):y2 + h2, max(x2, 0):x2 + w2].shape
        coloured = int((got.max(axis=2) != got.min(axis=2)).sum())
        n = len(np.loadtxt(os.path.join(t['dir'], 'pair_1',
                                        'sift_matches.txt')))
        if got.shape != (max(h1, h2), w1 + w2, 3) or coloured == 0:
            raise AssertionError(f'{png}: {got.shape}, {coloured} coloured '
                                 'pixels')
        print(f'  debug plot: {tile_name(t)}: {got.shape[0]} x '
              f'{got.shape[1]} RGB, {n} matches, {coloured} coloured pixels',
              flush=True)
    print(f'  stage 1 with debug on, {len(tiles)} tiles: {wall:.3f} s',
          flush=True)


def check_single_m03(pairs):
    """The single tile at non-integer penalties (m 0.3): a 128 x 160 crop
    on the card against device="cpu" byte for byte, and the 800 x 800
    tile on the card against the batch entry on the card, bitwise."""
    import numpy as np
    from s2p_tpu_torch.ops import mgm_flow as mf
    v = mf.MgmVariant(**M03)
    im1, im2 = (im[:128, :160].copy() for im in pairs[SINGLE['index']])
    gpu = mf.mgm_binary_match(im1, im2, SINGLE['dmin'], SINGLE['dmax'], v)
    cpu = mf.mgm_binary_match(im1, im2, SINGLE['dmin'], SINGLE['dmax'], v,
                              device='cpu')
    for name, x, y in zip(('disp', 'confidence'), gpu, cpu):
        ok, err = equal(x.cpu(), y)
        if not ok:
            raise AssertionError(f'single tile at m 0.3: {name} differs '
                                 f'from the CPU run (max abs error {err})')
    spec = SINGLE_800
    im1, im2 = pairs[spec['index']]
    D = spec['dmax'] - spec['dmin'] + 1
    disp, conf = mf.mgm_binary_match(im1, im2, spec['dmin'], spec['dmax'], v)
    ref = mf.mgm_binary_match_batch(im1[None], im2[None], [spec['dmin']], D,
                                    [spec['h']], [spec['w1']], [spec['w2']],
                                    [D], v)
    for name, x, y in (('disp', disp, ref['disp'][0]),
                       ('confidence', conf, ref['confidence'][0])):
        ok, err = equal(x, y)
        if not ok:
            raise AssertionError(f'single tile at m 0.3: {name} differs '
                                 f'from the batch entry ({err})')
    fin = np.isfinite(disp.cpu().numpy()).mean()
    print(f'  m 0.3 (P1 {M03["p1"]}, P2 {M03["p2"]}): crop 128 x 160 equal '
          'to the CPU run byte for byte; 800 x 800 equal to the batch '
          f'entry bitwise ({fin:.4f} finite)', flush=True)


def main():
    import torch
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    from s2p_tpu_torch import pipeline
    from s2p_tpu_torch.config import Config
    from s2p_tpu_torch.ops import _build
    from s2p_tpu_torch.ops import sgm_kernels as sk

    with phase('device'):
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(card)
        print(f'torch {torch.__version__} cuda {torch.version.cuda} '
              f'device {torch.cuda.get_device_name(0)} '
              f'count {torch.cuda.device_count()}', flush=True)

    with phase('build'):
        from s2p_tpu_torch.geo import geotiff_native
        t0 = time.perf_counter()
        native = geotiff_native.build()
        print(f'  g++: {time.perf_counter() - t0:.3f} s for the native TIFF '
              f'reader ({os.path.relpath(native)})')
        libs, secs = _build.build()
        print(f'  nvcc: {secs:.3f} s for {sorted(libs)}')
        for name in _build.SOURCES:
            for line in _build.build_log(name).splitlines():
                if ('registers' in line or 'spill' in line
                        or 'Function properties' in line):
                    print(f'  {name}: {line.strip()}')
        check_no_spill(_build.build_log('scan'), 'scan_kernel')
        check_no_spill(_build.build_log('cost_prepass'),
                       'cost_prepass_kernel')
        check_no_spill(_build.build_log('scan_mgm'), 'scan_mgm_kernel')
        check_no_spill(_build.build_log('wta'), 'wta_dr_kernel')
        check_no_spill(_build.build_log('warp'), 'warp_kernel')
        check_no_spill(_build.build_log('box'), 'window_costs_kernel')
    with phase("W1's division by 120: all 2^32 float32 inputs"):
        check_div120()
    with phase("B1's division by a count mean: all 2^32 float32 inputs for "
               'each of the 110'):
        check_box_division()

    specs_a = tile_specs(BUCKET_A, 0)
    specs_b = tile_specs(BUCKET_B, len(specs_a))
    specs = specs_a + specs_b
    pairs = {s['index']: make_pair(s)
             for s in specs + [WIDE, SINGLE, SINGLE_800]}

    stats = {}
    with phase('flow kernels against their plain versions (bucket A)'):
        check_kernels(specs_a, pairs, stats, BUCKET_A, '_a', edge_modes=True)
    with phase('flow kernels against their plain versions (bucket B)'):
        check_kernels(specs_b, pairs, stats, BUCKET_B, '_b')
    with phase('flow kernels against their plain versions (D 528)'):
        check_kernels([WIDE], pairs, stats, BUCKET_WIDE, '_d528')
    with phase('K1 to K5 against their plain versions: adversarial '
               'shapes and values'):
        check_adversarial()
    with phase('classic matcher kernels against their plain versions'):
        check_sgm_kernels(stats)
        check_mgm_tile()
    with phase('single-tile and lane-fold kernel modes against their '
               'plain versions'):
        check_signed_prepass(pairs, stats)
        check_fold_kernels(specs_a, pairs, stats)
    with phase('W1 (the homography warp) against its plain version'):
        check_warp()
        check_warp_dilate(stats)

    launches = {}
    tmp = tempfile.mkdtemp(prefix='s2p_chip_smoke_')
    try:
        gpu_root = os.path.join(tmp, 'gpu')
        cpu_root = os.path.join(tmp, 'cpu')
        cfg = Config(out_dir=gpu_root)
        tiles = {b: [(write_tile(gpu_root, s, *pairs[s['index']]), 1)
                     for s in group]
                 for b, group in (('a', specs_a), ('b', specs_b))}
        cpu_specs = specs_a[:1] + specs_b[:1]
        cpu_tiles = [(write_tile(cpu_root, s, *pairs[s['index']]), 1)
                     for s in cpu_specs]
        with phase('stage 4 on the card (buckets A and B)'):
            for b, group in tiles.items():
                sk.reset_launch_counts()
                t0 = time.perf_counter()
                pipeline.stereo_matching_all(cfg, group)
                torch.cuda.synchronize()
                launches[f'flow_{b}'] = sk.launch_counts()
                print(f'  stereo_matching_all, bucket {b.upper()}: '
                      f'{len(group)} tiles in {time.perf_counter() - t0:.3f}'
                      f" s; launches {launches[f'flow_{b}']}", flush=True)
        with phase('stage 4 on the CPU (1 tile of each bucket)'):
            pipeline.stereo_matching_all(cfg, cpu_tiles, device='cpu')
        with phase('stage 4 checks'):
            check_outputs(gpu_root, specs, cpu_root,
                          {s['index'] for s in cpu_specs})
        with phase('stage 5 on bucket A (8 tiles, the 3D filter on)'):
            sk.reset_launch_counts()
            run_stage5(gpu_root, cpu_root, specs_a)
            launches['stage5'] = sk.launch_counts()
            print(f"  launches of the port's kernels: {launches['stage5']}",
                  flush=True)

        with phase('classic matcher on the card'):
            sk.reset_launch_counts()
            run_sgm_path()
            torch.cuda.synchronize()
            launches['sgm'] = sk.launch_counts()
            print(f"  launches: {launches['sgm']}", flush=True)
        with phase('classic matcher: card against the CPU (128 x 128)'):
            check_sgm_crop()

        with phase('stage 4 at 528 candidates, card and CPU'):
            wide_tile = (write_tile(gpu_root, WIDE, *pairs[WIDE['index']]),
                         1)
            wide_cpu = (write_tile(cpu_root, WIDE, *pairs[WIDE['index']]), 1)
            sk.reset_launch_counts()
            pipeline.stereo_matching_all(cfg, [wide_tile])
            torch.cuda.synchronize()
            launches['wide'] = sk.launch_counts()
            print(f"  launches: {launches['wide']}", flush=True)
            pipeline.stereo_matching_all(cfg, [wide_cpu], device='cpu')
            check_outputs(gpu_root, [WIDE], cpu_root, {WIDE['index']})
        with phase('one scene through pipeline.main on the card (stages 1 '
                   'to 7)'):
            mgm_walls = run_scene(os.path.join(tmp, 'scene'),
                                  os.path.join(tmp, 'scene_cpu'), stats,
                                  launches, card)
        with phase('a triplet through pipeline.main on the card (stages 1 '
                   'to 7, two pairs)'):
            run_triplet(os.path.join(tmp, 'triplet'),
                        os.path.join(tmp, 'scene'),
                        os.path.join(tmp, 'triplet_cpu'), stats, launches,
                        card)
        with phase('the pair scene with mgm_multi through pipeline.main '
                   '(stages 4 to 7), the cascade on a full tile, '
                   'mgm_multi_lsd per tile'):
            run_multi(os.path.join(tmp, 'scene'), os.path.join(tmp, 'multi'),
                      os.path.join(tmp, 'multi_cpu'), stats, launches, card,
                      mgm_walls)
        with phase('two processes on the card (gloo): main of the pair '
                   'from stage 2 and of the triplet from stage 5, mesh and '
                   'halo'):
            run_two_processes(tmp, card)
        with phase('the MGM wavefront on the card against the CPU (the '
                   "scene bucket's shape)"):
            check_wavefront()
        with phase('sgbm through pipeline.main (stages 4 to 7), card and '
                   'CPU'):
            run_sgbm(os.path.join(tmp, 'scene'), os.path.join(tmp, 'sgbm'),
                     os.path.join(tmp, 'sgbm_cpu'), card)
        with phase('a tile mask from GML rings (host)'):
            time_gml_mask(tmp)
        t_new = time.perf_counter()
        with phase('hirschmuller02, msmw and tvl1: a known shift, stage 4 '
                   'on the scene\'s tiles, crops against the CPU, B1 '
                   'against its plain version'):
            new_walls = run_new_matchers(
                os.path.join(tmp, 'scene'), os.path.join(tmp, 'matchers'),
                os.path.join(tmp, 'matchers_cpu'), stats, launches, card)
        with phase("SIFT's host route against the device route; stage 1 "
                   "with sift_device='host'"):
            run_sift_host(os.path.join(tmp, 'scene'),
                          os.path.join(tmp, 'sift_host'), card)
        with phase("K2's 16-bit source against its plain version (17 x 17)"):
            check_scan16(stats)
        with phase('the flow at census windows 7 and 17 and the cascade with '
                   'tsgm 2, card against the CPU'):
            check_wide_flow(launches)
        with phase('sgm_match_batch on the card'):
            check_sgm_batch()
        t_new = time.perf_counter() - t_new
        print(f"  the phases 8i-8k: {t_new:.3f} s; stage 4 on the "
              f"scene's tiles: {new_walls} s on {card}", flush=True)
        t_last = time.perf_counter()
        with phase('the native TIFF reader: windows against the whole-file '
                   'decode'):
            check_native_reader(tmp)
        scene_out = os.path.join(tmp, 'scene', 'out')
        with phase('plyflatten_device on the scene\'s clouds, card and CPU'):
            run_plyflatten(scene_out, card)
        with phase('utils on the scene and triplet trees'):
            run_utils(scene_out, os.path.join(tmp, 'triplet', 'out'), tmp)
        with phase('stage 1 with debug on: the match plots'):
            run_debug_plot(os.path.join(tmp, 'scene'),
                           os.path.join(tmp, 'debug'))
        print(f'  the phases 8l-8o: {time.perf_counter() - t_last:.3f} s on '
              f'{card}', flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    with phase('the single-tile entry on the card'):
        sk.reset_launch_counts()
        single = run_single_path(pairs)
        launches['single'] = sk.launch_counts()
        print(f"  launches: {launches['single']}", flush=True)
        check_single_path(pairs, single)
        del single
        check_single_crop(pairs, stats, launches)
        check_single_m03(pairs)
    with phase('the lane-folded batch on the card'):
        from s2p_tpu_torch.ops import mgm_flow as mf
        b1, b2 = bucket_arrays(specs_a, BUCKET_A, pairs)
        # the fold of the kernel check first (its launches go into the
        # JSON line), then one that leaves a tail group
        for run, fold in (('fold', KERNEL_FOLD), ('fold_tail', BATCH_FOLD)):
            os.environ['S2P_TPU_LANE_FOLD'] = str(fold)
            try:
                sk.reset_launch_counts()
                folded = mf.mgm_binary_match_batch(
                    *fold_args(specs_a, b1, b2))
                torch.cuda.synchronize()
                launches[run] = sk.launch_counts()
            finally:
                del os.environ['S2P_TPU_LANE_FOLD']
            print(f'  fold {fold}: launches {launches[run]}', flush=True)
            check_folded_batch(specs_a, pairs, folded)
            del folded
    for run, keys in (('single', ('cost_prepass', 'scan', 'wta')),
                      ('fold', ('scan_sig_seg', 'wta')),
                      ('fold_tail', ('scan_sig_seg', 'cost_prepass', 'scan',
                                     'wta'))):
        idle = [k for k in keys if launches[run][k] == 0]
        if idle:
            raise AssertionError(f'the {run} path launched no {idle}')

    pallas = 's2p_tpu/ops/sgm_pallas.py'
    csrc = 's2p_tpu_torch/csrc'
    # JSON name -> (source, TPU kernel, the path run that counts it, its
    # key there, the stats of the comparisons at that run's shapes)
    flow = {'cost_prepass': (f'{csrc}/cost_prepass.cu', f'{pallas}:474'),
            'scan': (f'{csrc}/scan.cu', f'{pallas}:81'),
            'wta': (f'{csrc}/wta.cu', f'{pallas}:358')}
    table = {}
    # the scene through main (its bucket), then stage 4's buckets A and B,
    # the tile at 528 candidates and the triplet through main
    for suffix, run, tag in (('', 'scene', '_scene'), ('_a', 'flow_a', '_a'),
                             ('_b', 'flow_b', '_b'),
                             ('_d528', 'wide', '_d528'),
                             ('_triplet', 'triplet', '_triplet')):
        for kern, (src, replaces) in flow.items():
            table[kern + suffix] = (src, replaces, run, kern, kern + tag)
    table.update({
        'scan_sig': (f'{csrc}/scan.cu', f'{pallas}:81', 'sgm', 'scan_sig',
                     'scan_sig'),
        'scan_mgm': (f'{csrc}/scan_mgm.cu', f'{pallas}:81', 'sgm',
                     'scan_mgm', 'scan_mgm'),
        'wta_dr': (f'{csrc}/wta.cu', f'{pallas}:358', 'sgm', 'wta_dr',
                   'wta_dr'),
        'cost_prepass_signed': (f'{csrc}/cost_prepass.cu', f'{pallas}:474',
                                'single', 'cost_prepass',
                                'cost_prepass_signed'),
        'wta_edge': (f'{csrc}/wta.cu', f'{pallas}:358', 'single_edge',
                     'wta_edge', 'wta_edge'),
        'scan_sig_seg': (f'{csrc}/scan.cu', f'{pallas}:81', 'fold',
                         'scan_sig_seg', 'scan_sig_seg'),
        # the mgm_multi cascade's levels: K2 one direction a launch, K3
        'scan_multi': (f'{csrc}/scan.cu', f'{pallas}:81', 'multi', 'scan',
                       'scan_multi'),
        'wta_multi': (f'{csrc}/wta.cu', f'{pallas}:358', 'multi', 'wta',
                      'wta_multi'),
        # W1 replaces a jitted jnp program, not a Pallas kernel
        'warp': (f'{csrc}/warp.cu', 's2p_tpu/ops/interp.py:145', 'scene',
                 'warp', 'warp'),
        # the dilation replaces the 36-tap mask maxima of the quintic
        # sampler, on stage 3's path for an image with NaN
        'warp_dilate': (f'{csrc}/warp.cu', 's2p_tpu/ops/interp.py:134',
                        'scene_nan', 'warp_dilate', 'warp_dilate'),
    })
    table.update({
        # B1 replaces msmw's window costs, a jnp program
        'window_costs': (f'{csrc}/box.cu', 's2p_tpu/ops/msmw.py:71', 'msmw',
                         'window_costs', 'window_costs'),
        # K2's 16-bit source: the flow's lax scan at windows from 16 x 16
        'scan16': (f'{csrc}/scan.cu', 's2p_tpu/ops/sgm.py:114', 'flow17',
                   'scan16', 'scan16'),
    })
    missing = [name for name, (_, _, run, key, _) in table.items()
               if launches[run][key] == 0]
    if missing:
        raise AssertionError(f'kernels never launched on their path: '
                             f'{missing}')
    kernels = []
    for name, (src, replaces, run, key, stat) in table.items():
        st = stats[stat]
        t_bound, by = bound(st['nbytes'], st['ops'],
                            st.get('ops_per_s', F32_OPS_PER_S))
        kernels.append({'name': name, 'route': 'cuda', 'source': src,
                        'replaces': replaces, 'launches': launches[run][key],
                        'max_abs_err': st['err'], 'ms': st['ms'],
                        'plain_ms': st['plain_ms'], 'bound_ms': t_bound,
                        'bound_by': by,
                        'library_ms': st.get('library_ms'),
                        **{k: st[k] for k in ('bucket_ms', 'step_floor_ms',
                                              'group_ms') if k in st}})
    print(f'== the whole run: {time.perf_counter() - t_run:.3f} s',
          flush=True)
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
