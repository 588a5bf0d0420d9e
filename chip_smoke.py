#!/usr/bin/env python3
"""Smoke test of ife_tpu_torch on one NVIDIA Hopper GPU (sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --ranks 4     # the sharded path, one rank per card
    python3 chip_smoke.py --sweep-times [ROOT [GROUP...]]  # the sweep
                                        # family's (GROUP sweep), the
                                        # direct entries' (GROUP tap), the
                                        # Hessian kernel's (GROUP hessian)
                                        # and the normalized convolution's
                                        # (GROUP nc) 512^3 times of the
                                        # checkout under ROOT
    python3 chip_smoke.py --hist-times [ROOT]    # the histogram's 512^3
                                        # shapes, call ms and device ms, of
                                        # the checkout under ROOT
    python3 chip_smoke.py --dense       # phase 5's dense bag of one lung
                                        # alone (phase_full_dense)
    python3 chip_smoke.py --dispatch-table   # phase 5's table of the three
                                        # features8 branches alone
    python3 chip_smoke.py --probes [mode...]  # the probe phase alone (modes:
                                        # PROBE_MODES; default all)
    python3 chip_smoke.py --dicom       # phase 4's dicom path alone, at
                                        # its full size (DICOM_SHAPE)
    python3 chip_smoke.py --cli-full    # phase 4's main path alone, the
                                        # feature CLI at its full size
                                        # (CLI_SHAPE)
    python3 chip_smoke.py --profile     # phase 6 alone (the default run
                                        # runs it so, in a process of its
                                        # own)

Run from the root of a checkout; needs one CUDA device of compute
capability 9.0, nvcc and nvidia-smi (`--ranks N`: N of them on one host, and
runs that phase alone: N processes under torch.distributed / NCCL, one block
per rank on a 1D and a 2D mesh, sharded_features8 per sigma,
sharded_hessian_eig and a fine histogram at 512^3, each rank holding the
gathered result against its own single-device pass, with the slowest rank's
time per pass). Phases, one line (or a few) each; any
failing phase exits non-zero:

  1. device   torch/CUDA/nvcc versions, the card's name and power limit;
  2. build    compile the CUDA kernels of ife_tpu_torch/csrc and, beside
              them, the native host library (g++; timed);
  3. kernels  each kernel against its plain PyTorch twin on the card, at
              (128,124,120) and (64,64,64), spacing (0.78,0.78,1.0) and
              (0.7,0.9,1.2) (the Hessian kernel's features and its reference
              output), sigma 0.6/1.2/2.4/4.8 (the sweep and xs-stream
              kernels where their rings fit shared memory; the tiled
              normalized convolution with 1-4 slabs, also against the
              untiled kernel; the windowed post kernel at three block
              shapes); the multi-scale kernels features8_ys_multi and
              features8_sweep_multi with 1, 2 and 3 scales, ys_multi also on
              a thin volume whose y radius exceeds Y; the histogram
              kernel over the features8 channels, whole-volume and box
              forms, E 1/31/4096, weighted and not, with NaN, +-inf and
              duplicate edges, once on its global-memory path, and on the
              cases of its design (hist_case_checks: a constant field, E = 1,
              8 x 4096 edges, views at an odd offset, NaN, int32 weights, an
              empty mask, runs empty / full / half full, conflict-free
              values, boxes at odd starts); the windowed
              kernels features8_tap and features8_xs (also on a thin volume),
              and every shard mode against its twin in that mode: clamps of
              the two sweeps (the default clamps also against the call
              without), x_halo and pre_padded of the Hessian and post
              kernels (an edge-replicated halo also against the whole-volume
              mode); every instantiation of the two sweeps with and without
              clamps: the single sweep at each x radius 1 .. 10 with
              ry != rx != rz, the multi-scale sweep at S = 1 .. 4 with mixed
              radii in every class of its register budget, on small odd
              shapes (X below a chunk, Y below a tile, Z = 1, radii beyond
              the extent, X over a chunk) and under masks that leave planes,
              tiles or the whole volume empty; the xs-stream kernel at every
              x radius 11 .. 20, 24, 28, 36 (every tile its launcher picks
              from) and ys_multi at S = 1 .. 4 (both skip the
              planes and tails the mask leaves empty) under an empty, a
              one-octant, a full and the sphere mask, on thin odd shapes and
              on (128, 124, 120); the direct entries (tap_xs_radius_checks):
              the tap and its copy floor at every equal radius 1 .. 12 (its
              ring in shared memory to 11, in global scratch beyond), 20, 32
              and 44, at three scales with rx != ry != rz and at radii 2 /
              25 / 2, xs at x radii 1 .. 12,
              20, 29, on shapes thin, prime and one voxel over the kernels'
              tiles and the tap's row chunk on each axis, under an empty, a
              one-octant, a full, the sphere and a clamped sphere mask (the
              tap skips rows, xs blocks, with no voxel inside); the
              normalized-convolution kernels (nc_radius_checks: nc,
              smooth_yz, smooth_xz and the tiled entry at 1 - 3 slabs at
              every radius 1 .. 128 on each axis, anisotropic radii and
              sigma 0, Z of 1 .. 30001, X / Y one voxel over their tile,
              under empty / one-octant / full / sphere masks and on an
              image with NaN / inf off the mask) and their SASS
              (nc_sass_check: no FFMA in the walks);
  4. main     five paths of user entry points, the launch counters reset
              before each and read after it (and a sixth, graft, below). Features: the CLI
              (extract-features -s 0.6 2.4, hessian-features with and
              without --fused) on a 128x128x64 NIfTI (256x256x128 with
              --cli-full; the 256x256x128 pair is written beside it, the
              input of the bag and tool runs), outputs checked
              against the plain f64 ops (hessian-features without --fused
              also per channel against hessian_eig_reference_plain: ife_tpu's
              hessian_eig_features, bit for bit), then features8_auto_channels at
              sigma 1.2 and 4.8, fused_features8 on its xs-stream branch at
              2.4 and hessian_eig_features_channels at 512^3. Bags: the CLI generate-rois,
              determine-bin-edges -s 0.6 2.4 --bins 32 over two volumes,
              make-bag --device and make-bag with that spec; the spec
              checked against the plain twins' pipeline, the device bag
              against the host bag. Multi-scale:
              multiscale_features8_fused at sigma (2.4, 4.8) and the
              four-scale stack of bench.py config 3 (sigma 0.6, 1.2 through
              fused_features8_sweep_multi, 2.4, 4.8 through
              multiscale_features8_fused) at 256x256x128 and 512^3, every
              scale checked against the plain f64 ops and the per-scale
              pass; sigma 4.8 once more through the tiled normalized
              convolution and the windowed post kernel. Tools: the 17
              subcommands of the ROI, image, converter and dataset tools
              (make-bag-dense, make-bag-only-intensity,
              generate-rois-many-regions, sample-rois, extract-labels,
              image-browser, convert-hr2, convert-from-octave, merge-bags,
              expected-distance, masked-image-filter, extract-masked-region,
              extract-bounding-box, extract-slices, extract-window at orders
              0 / 1 / 3, pad-image, resample with and without --nearest)
              through the CLI on the 256x256x128 pair, each one's wall time;
              the files of the device tools against the same functions on
              the CPU (bit for bit; order-1 resampling within 1 f32 ulp);
              resample_to_grid orders 0 and 1 at 512^3 onto a shifted 0.7 x
              0.7 x 1.1 mm grid, card against CPU; call ms of the two
              resamples, mask_image, relabel_mask and intensity_window at
              512^3. DICOM: three 512 x 512 x 32 int16 CT series (512 x 512
              x 128 with --dicom; explicit
              VR raw, fragmented JPEG Lossless, JPEG-LS) through the CLI
              convert-dicom, the native decoders' counters reset first:
              every NIfTI equal to the series' float32 volume with its
              spacing and name, every compressed frame decoded natively
              with no fallback, native against Python decoders on a frame
              of each codec; then extract-features -s 1.2 on a converted
              volume under a sphere mask, its 8 files equal to the pass on
              the in-memory volume and that pass to its twin, to the bit;
              the Deriche yardstick (the card's f64 FIR smoothing against
              the IIR on a 48^3 CT at sigma 0.6 / 1.2 / 4.8); one JSON line
              {"dicom": ...} of wall s per series (decode, gzip-9 write),
              decode ms of a 512^2 slice, extract-features s and the host
              make-bag s of the bag path. Every kernel must
              have launched, features8_ys_multi exactly once per
              multiscale_features8_fused call. Sharded: the CLI
              extract-features (on the feature CLI's pair) / make-bag /
              determine-bin-edges (on the 256x256x128 pair) --sharded
              --blocks 4 against the unsharded files; at 512^3 on
              cuda:0 a 4-block 1D mesh and a 2 x 2 mesh in one process:
              sharded_features8 per sigma (sweep + clamps at 0.6 / 1.2, the
              normalized convolution of the extended block + post with
              x_halo / pre_padded at 2.4 / 4.8), sharded_hessian_eig,
              sharded_feature_fine_histograms and make_bag_sharded, each
              against the single-device port with the mode kernels' launch
              counts asserted; the same once more under torch.distributed
              (NCCL, world size 1); then the direct entries
              fused_features8_tap / _xs, fused_features8_sweep_multi with
              clamps and fused_features8_post pre_padded;
     graft    graft_entry_torch.py's entry() (features8 of a 64^3 synthetic
              CT at sigma 1.0 through the sweep kernel, bit-equal to its
              twin, held to the plain f64 ops as the CLI's outputs are) and
              dryrun_multichip(4)
              / dryrun_step(4) (a 2 x 2 block mesh: the sweep with clamps at
              sigma 0.8 and 1.6 within SHARD_TOL of the single-device pass,
              the histogram kernel's counts equal to histogram_counts of the
              gathered smoothed channel), counters reset first;
  5. full     512^3 f32: kernel and plain times (CUDA events, median of 5
              with spread) and kernel-vs-plain checks per kernel and sigma,
              the features8 pass per sigma, the sweep at sigma 0.6 / 1.2 /
              1.7 (x radius 4 / 7 / 10) in turns with the staged
              normalized_conv + post pair and under a mask of ones (its time
              depends on the mask: it skips the planes and tails the mask
              leaves empty), the multi-scale kernels beside
              the per-scale passes they replace, the four-scale stack at
              256^3 (bench.py's random 75% mask) and 512^3 both ways, the
              device's copy rate, and
              the histogram kernel on the shapes of hist_time_shapes (the
              bench.py config-4 shape: 8 channels, 31 edges, mask weights,
              under the sphere and bench.py's random 75% mask, at E = 1 and
              on conflict-free values; 1 and 8 channels of 4096 edges; 50
              ROIs of 41^3 per sigma, beside the feature pass), each against
              its twin; the dense bag of one lung (phase_full_dense:
              make_bag_dense_device at 512^3, an ROI of 41^3 at each of the
              ~4.5 M voxels of an ellipsoid lung of the benchmark lung's
              extent, 4 scales, 32 bins; its launches counted, one scale's
              rows bit-equal to dense_counts_plain's, the kernels' call and
              device ms beside the twin's and the rows kernel's plan,
              kernels.DENSE_HIST_PLAN); tap and xs beside the sweep;
              every shard mode beside its whole-volume mode; the 4-block
              and 2 x 2 sharded pass beside the single-device pass;
     probes   the probe path (kernels/probes.py and the copy-floor variants
              of fused_hessian_eig and fused_features8_tap: the ports of
              benchmarks/probe10.py, probe11.py, probe_fused.py and of
              ife_tpu's variant="copyfloor"), its counters reset before and
              read after one call of each entry at 512^3, each output
              against its twin bitwise; every probe kernel (both access
              widths of pcopy1 and trivial6) bitwise against its twin at
              (128,124,120) and (5,7,9); at 512^3 each one's ms and GB/s
              touched beside its twin's and its library form's (torch.mul,
              Tensor.copy_, six torch.mul, six torch.add, six clone), the
              Hessian kernel's split (copy floor, copy6, stencil6, full),
              probe11's ovh (5 and 20 launches between one event pair give
              the same ms a launch) and the LDG and LDGSTS (cp.async) counts
              of each Hessian and tap instantiation (cuobjdump -sass: the
              copy floors keep the features' loads);
     bench    bench_torch.py's three modes as a user runs them, each in a
              process of its own: the headline line (the Hessian kernel's
              first channel at 512^3 by device ms, with the verify gate),
              --verify (the gate alone) and --all (BASELINE.md configs 1-4,
              the gate before config 4) into a temporary artifact; the
              metric must name the card, the value be finite and > 0, every
              gate entry < 1e-4 over at least three dispatch branches, the
              line and the artifact carry every key of bench.py's (no
              *_error), each mode launched the seven kernels of its path
              (BENCH_PATH, from its own `launches`); one JSON line
              {"bench": ...} of the headline, the configs, the launches,
              the processes' wall s and the card;
     dispatch the features8 pass at 512^3 through each branch that takes
              the scale (sweep, y/z passes + xs-stream, normalized_conv +
              post), in turns, under the sphere mask and a mask of ones, at
              every x radius 4 .. 28 and at 30, 32, 36, 40, 48: one JSON line
              {"dispatch": [...]}, the table the dispatcher's radii are cut
              from;
  6. profile  device time per CUDA kernel launch of one features8 pass per
              sigma, one Hessian+eig pass (the hessian-features route,
              hessian_eig_features_channels: the kernel's reference output
              and no other launch), one config-4 histogram, one
              multiscale_features8_fused pass, one sweep_multi pass and one
              4-block sharded features8 pass at sigma 1.2 and 4.8
              (torch.profiler over 3 calls after a warm-up step, each
              kernel's events counted from the raw event list: a count not
              a multiple of the calls reads "not measured"), in a process
              of its own (--profile).

Two yardsticks: "call ms" (cuda_ms) starts each call on an idle card, so
it holds the wrapper's host time, what a caller waits for; "device ms"
(device_ms) times 10 back-to-back calls behind a torch.cuda._sleep, so the
host's time hides behind queued work and what is left is the card's. Every
kernel of the {"kernels": ...} line has both (ms, device_ms; library_ms,
library_device_ms); the features8 passes, the stacks and the CLI stay on
call ms. The probe phase times pcopy1 and trivial6 at both widths beside
torch.mul / Tensor.copy_ / six torch.mul in turns on the device yardstick
(one JSON line each).

Kernel vs plain twin: the kernels are built without FMA contraction and
keep their twins' association, so each must equal its twin to the bit (NaN
where the twin is NaN; the histogram kernel's integer counts exactly); the relative error bench.py defines,
max|kernel - plain| / max(max|plain|, 1) per channel with eigenvalue
channels as value-sorted triples and the normalized convolution inside the
mask, is printed beside it. The CLI outputs are held against the plain f64
ops within 1e-4 of that measure, the scales of the multi-scale stack within
1e-4 or twice the distance of the per-scale f32 pass from them (the f32
floor of a wide sigma's second differences). Wherever eigenvalues are held
to another computation within a tolerance, they are held within it both as
value-sorted triples and per channel (eigen_channel_error: against the
triple's joint scale, as sorted triples only where the reference's
adjacent |e_k| differ by less than twice the tolerance), so an eigenvalue
in the wrong channel outside a tie fails. The sharded results equal the
single-device port to the bit wherever both run the same kernel arithmetic
(every sigma the single-device dispatcher does not send to the xs-stream
branch, y-z-x, where the sharded route takes the normalized convolution,
x-y-z: there the sharded pass equals the single-device normalized
convolution + post to the bit and the dispatcher's pass within SHARD_TOL).
Ahead of the last two lines is {"kernels": [...]}: per kernel its launches
on the main paths, its time, its plain twin's time and its bound at 512^3. The bound is the larger of the
bytes the function must move (each input read once, each output written
once) over 3.35 TB/s and its arithmetic (counted from this run's shapes and
radii) over 67 TFLOP/s, the published peaks of the H100 SXM. library_ms is
the time of the PyTorch calls named in `library` that compute the same
function on the same inputs (the probes': torch.mul, six torch.mul, six
torch.add, six clone), null where none does: the feature kernels are each a
chain of pads, per-axis convolutions, a divide and a closed-form eigen solve,
or a search plus a scatter; `library` says which. The line before the
last is [budget]: the wall s of each phase, their total and the card's name
and power limit (--dicom and --cli-full print it too; it never changes the
exit code).
The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

try:
    # the yardsticks, one copy for this script and bench_torch.py
    from ife_tpu_torch.utils.profiling import (
        DEVICE_CALLS, DEVICE_SLEEP_CYCLES, card_line, cuda_ms, device_ms)
except ModuleNotFoundError as e:
    raise SystemExit("chip_smoke: run it from a checkout of the repo "
                     f"(ife_tpu_torch/ not found beside it: {e})") from e

TOL = 1e-4
SIGMAS = (0.6, 1.2, 2.4, 4.8)
# bench.py's headline line and its TPU artifact (BENCH_DETAIL.json), the
# keys bench_torch.py's must carry
BENCH_PY_HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline",
                          "baseline", "spread", "verify")
BENCH_PY_ARTIFACT_KEYS = (
    "device", "platform", "config1_eigen_64cubed_voxels_per_sec",
    "config2_hessian_eig_128cubed_voxels_per_sec",
    "config3_per_scale_voxels_per_sec", "config3_fused_voxels_per_sec",
    "config3_multiscale4_features8_voxels_per_sec", "config3_shape",
    "verify_on_chip", "config4_feat_ms", "config4_hist_ms",
    "config4_features_plus_hist_512cubed_voxels_per_sec", "config4_shape",
    "config4_composed_one_jit_ms")
# the kernels each of bench_torch.py's modes must launch (every mode runs
# the gate, which reaches all seven)
BENCH_PATH = ("hessian_eig", "features8_sweep", "features8_xs_stream",
              "normalized_conv", "features8_post", "features8_ys_multi",
              "histogram")
SPACINGS = ((0.78, 0.78, 1.0), (0.7, 0.9, 1.2))
FULL = (512, 512, 512)
FULL_SPACING = (0.78, 0.78, 1.0)
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "hessian_eig": ("ife_tpu_torch/csrc/hessian_eig.cu",
                    "ife_tpu/kernels/fused.py:1461"),
    "normalized_conv": ("ife_tpu_torch/csrc/normalized_conv.cu",
                        "ife_tpu/kernels/fused.py:1204"),
    "features8_post": ("ife_tpu_torch/csrc/features8_post.cu",
                       "ife_tpu/kernels/fused.py:1950"),
    "features8_sweep": ("ife_tpu_torch/csrc/features8_sweep.cu",
                        "ife_tpu/kernels/fused.py:2160"),
    "features8_xs_stream": ("ife_tpu_torch/csrc/features8_sweep.cu",
                            "ife_tpu/kernels/fused.py:1545"),
    # the y/z passes ahead of the xs-stream kernel; ife_tpu runs them as
    # XLA band einsums in its fused_features8 (no Pallas kernel there)
    "smooth_yz": ("ife_tpu_torch/csrc/normalized_conv.cu",
                  "ife_tpu/kernels/fused.py:1839"),
    "histogram": ("ife_tpu_torch/csrc/histogram.cu",
                  "ife_tpu/kernels/histogram.py:83"),
    # the x/z passes ahead of the ys-multi kernel; XLA band einsums in
    # ife_tpu's multiscale_features8_fused (no Pallas kernel there)
    "smooth_xz": ("ife_tpu_torch/csrc/normalized_conv.cu",
                  "ife_tpu/ops/features.py:325"),
    "normalized_conv_tiled": ("ife_tpu_torch/csrc/normalized_conv.cu",
                              "ife_tpu/kernels/fused.py:1271"),
    "features8_post_windowed": ("ife_tpu_torch/csrc/features8_post.cu",
                                "ife_tpu/kernels/fused.py:1865"),
    "features8_ys_multi": ("ife_tpu_torch/csrc/features8_ys_multi.cu",
                           "ife_tpu/kernels/fused.py:1634"),
    "features8_sweep_multi": ("ife_tpu_torch/csrc/features8_sweep_multi.cu",
                              "ife_tpu/kernels/fused.py:2055"),
    "features8_tap": ("ife_tpu_torch/csrc/features8_tap.cu",
                      "ife_tpu/kernels/fused.py:2268"),
    "features8_xs": ("ife_tpu_torch/csrc/features8_tap.cu",
                     "ife_tpu/kernels/fused.py:2395"),
    # the shard modes, counted apart from their kernels' whole-volume mode
    "features8_sweep_clamps": ("ife_tpu_torch/csrc/features8_sweep.cu",
                               "ife_tpu/kernels/fused.py:2169"),
    "features8_sweep_multi_clamps": (
        "ife_tpu_torch/csrc/features8_sweep_multi.cu",
        "ife_tpu/kernels/fused.py:2064"),
    "hessian_eig_x_halo": ("ife_tpu_torch/csrc/hessian_eig.cu",
                           "ife_tpu/kernels/fused.py:1467"),
    "hessian_eig_pre_padded": ("ife_tpu_torch/csrc/hessian_eig.cu",
                               "ife_tpu/kernels/fused.py:1368"),
    "features8_post_x_halo": ("ife_tpu_torch/csrc/features8_post.cu",
                              "ife_tpu/kernels/fused.py:1958"),
    "features8_post_pre_padded": ("ife_tpu_torch/csrc/features8_post.cu",
                                  "ife_tpu/kernels/fused.py:1957"),
    "features8_post_windowed_pre_padded": (
        "ife_tpu_torch/csrc/features8_post.cu", "ife_tpu/kernels/fused.py:1872"),
    # the roofline probes: trivial6 replaces probe10.py:66 as well (the same
    # function), the Hessian copy floor probe11.py:138 floor_window as well
    "pcopy1": ("ife_tpu_torch/csrc/probes.cu", "benchmarks/probe11.py:92"),
    "trivial6": ("ife_tpu_torch/csrc/probes.cu", "benchmarks/probe11.py:73"),
    "hessian_eig_copyfloor": ("ife_tpu_torch/csrc/hessian_eig.cu",
                              "ife_tpu/kernels/fused.py:472"),
    "hessian_eig_copy6": ("ife_tpu_torch/csrc/hessian_eig.cu",
                          "benchmarks/probe_fused.py:59"),
    "hessian_eig_stencil6": ("ife_tpu_torch/csrc/hessian_eig.cu",
                             "benchmarks/probe_fused.py:59"),
    "features8_tap_copyfloor": ("ife_tpu_torch/csrc/features8_tap.cu",
                                "ife_tpu/kernels/fused.py:638"),
    # the Hessian kernel's reference output: the function of ife_tpu's
    # hessian_eig_features, XLA ops there (no Pallas kernel)
    "hessian_eig_reference": ("ife_tpu_torch/csrc/hessian_eig.cu",
                              "ife_tpu/ops/features.py:357"),
    # the box histograms at every start of a dense bag: ife_tpu bins a
    # dense bag box by box through its histogram kernel
    "dense_hist": ("ife_tpu_torch/csrc/dense_hist.cu",
                   "ife_tpu/kernels/histogram.py:83"),
}
# the kernels each main path must launch
FEATURE_PATH = ("hessian_eig", "normalized_conv", "features8_post",
                "features8_sweep", "features8_xs_stream", "smooth_yz",
                "hessian_eig_reference")
BAG_PATH = ("histogram",)  # and the kernels of the branches at 0.6 / 2.4
# phase 5's dense bag: one lung of the benchmark's scans (ifebench/inputs.py:
# a lung's centres span 147 x 203 x 291 voxels, 4.5-5.4 M of them) as an
# ellipsoid (centre, semi-axes) in the 512^3 volume, 41^3 ROIs, 32 bins at
# every scale of SIGMAS, the scale whose rows are held against the twin
DENSE_LUNG = ((166, 256, 256), (73, 101, 145))
DENSE_SIZE = (41, 41, 41)
DENSE_BINS = 32
DENSE_CHECK_SIGMA = 1.2
MULTISCALE_PATH = ("smooth_xz", "features8_ys_multi", "features8_sweep_multi",
                   "normalized_conv_tiled", "features8_post_windowed")
SHARDED_PATH = ("features8_sweep_clamps", "normalized_conv",
                "features8_post_x_halo", "features8_post_pre_padded",
                "hessian_eig_x_halo", "hessian_eig_pre_padded", "histogram",
                "features8_tap", "features8_xs", "smooth_yz",
                "features8_sweep_multi_clamps",
                "features8_post_windowed_pre_padded")
# the probe kernels and the 512^3 volumes a call moves (one read of each
# input, one write of each output)
PROBE_VOLUMES = {"pcopy1": 2, "trivial6": 7, "hessian_eig_copyfloor": 7,
                 "hessian_eig_copy6": 7, "hessian_eig_stencil6": 7,
                 "features8_tap_copyfloor": 10}
PROBE_PATH = tuple(PROBE_VOLUMES)
PROBE_MODES = ("check", "pcopy1", "trivial6", "ovh", "hessian", "tap", "ldg")
# floating-point operations per voxel of the stencil alone: 4 in each of the
# three second differences, 6 in each cascaded cross term
STENCIL6_OPS = 30
# ms a launch at 5 and at 20 launches between one event pair may differ by
# this share before the timing method counts as broken (probe11's ovh)
OVH_TOL = 0.1
# the library's calls for the same function, where there are such
NO_LIBRARY = ("none: no PyTorch call computes this function (pads, "
              "per-axis convolutions, a divide and a closed-form eigen solve, "
              "or a search and a scatter)")
LIBRARY = {
    "pcopy1": "torch.mul(x, c)",
    "trivial6": "six torch.mul(x, c_k) (probe11's xla6h)",
    "hessian_eig_copyfloor": "six torch.add(x, k)",
    "hessian_eig_copy6": "six Tensor.clone()",
    "hessian_eig_stencil6": ("none: the edge-clamped stencil is a replicate "
                             "pad and a conv3d (TF32 by default), not one call"),
    "features8_tap_copyfloor": ("none: a clamp, a product and eight adds, "
                                "one call each"),
    "dense_hist": ("none: a search, box sums of each bin's indicator and a "
                   "divide (dense_counts_plain: a one-hot, three cumsums and "
                   "eight corners a box), not one call"),
}
# sharded against single-device where the two take different passes (sigma
# 2.4): two f32 passes of one function, each within TOL of the f64 ops
SHARD_TOL = 2e-4
# tap (x-y-z) against the sweep (y-z-x) at 512^3: as above, with the sorted
# eigenvalues' sqrt(ulp) floor near repeated eigenvalues on top
TAP_TOL = 4e-4
# the sigma whose 512^3 times stand in the {"kernels": ...} line: one the
# dispatcher (or the multi-scale path) sends to the kernel at 0.78 mm
REPORT_SIGMA = {"normalized_conv": 4.8, "features8_post": 4.8,
                "features8_sweep": 1.2, "features8_xs_stream": 2.4,
                "smooth_yz": 2.4, "smooth_xz": 4.8,
                "normalized_conv_tiled": 4.8, "features8_post_windowed": 4.8,
                "features8_tap": 1.2, "features8_xs": 1.2,
                "features8_sweep_clamps": 1.2}
# the sigmas at which phase 5 runs the kernels of this table (every sigma
# for the others): the twins at 512^3 are slow
FULL_SIGMAS = {"smooth_xz": (2.4, 4.8), "normalized_conv_tiled": (4.8,),
               "features8_post_windowed": (4.8,)}
# the scale sets of the multi-scale kernels: bench.py config 3 splits its
# four scales so (the small ones through sweeps, the large ones through
# multiscale_features8_fused)
SWEEP_SIGMAS = (0.6, 1.2)
YS_SIGMAS = (2.4, 4.8)
# phase 3's scale sets of the multi-scale sweep, S = 1, 2, 3 with mixed
# radii, that one launch takes at both SPACINGS (its register budget:
# kernels.sweep_multi_max_scales)
SWEEP_CHECK_SIGMAS = ((1.2,), (0.6, 1.0), (0.3, 0.45, 0.6))
# the sigmas at which phase 5 times the sweep in turns with the staged
# normalized_conv + post pair: x radius 4, 7 and 10 at 0.78 mm
SWEEP_VS_STAGED = (0.6, 1.2, 1.7)
# the x radii of the xs-stream kernel that phase 3 checks one by one (those
# past the sweep's instantiations up to ife_tpu's xs-stream limit), and the
# scale sets of the ys-multi kernel, S = 1 .. 4
XS_CHECK_RADII = tuple(range(11, 21)) + (24, 28, 36)
# the direct entries' tiles (csrc/features8_tap.cu): the tap sweeps y over
# (x, z) tiles of 14 x 32 voxels in chunks of max(128, 32 (ry + 1)) rows, the
# xs kernel takes (y, z) tiles of 14 x 32 and 32 planes of x. Shapes thin on
# each axis, prime, and one voxel over a tile or a chunk on each axis (289
# rows: one over a chunk of 288 at ry 8, 33 over two of 128 at ry <= 3); the
# x radii of the xs kernel checked one by one
TAP_XS_SHAPES = ((15, 289, 33), (33, 15, 33), (29, 31, 97), (5, 40, 33),
                 (40, 9, 33), (23, 17, 1))
XS_DIRECT_RADII = tuple(range(1, 13)) + (20, 29)
YS_CHECK_SIGMAS = ((2.4,), YS_SIGMAS, (0.6, 2.4, 4.8), SIGMAS)
# the normalized-convolution kernels' radii checked one by one on each axis
# (sigma 0, the identity, beside them; MAX_RADIUS last) and anisotropic
# radii (x, y, z); their shapes: Z of 1, 2, 5, 127 and 513 (a z run is 4
# voxels, a block's rows of up to 1024 one chunk), one voxel over a z chunk
# (1025) and past the 29056 that bounded the old z pass, X and Y thin and one
# voxel over the x / y tile of 128
NC_CHECK_RADII = (1, 2, 4, 11, 14, 22, 28, 64, 128)
NC_ANISO_RADII = ((28, 14, 22), (128, 1, 64), (2, 64, 11), (14, 28, 128))
NC_CHECK_SHAPES = ((7, 9, 1), (9, 7, 2), (6, 5, 5), (5, 6, 127),
                   (3, 4, 513), (2, 3, 1025), (1, 2, 30001), (129, 3, 33),
                   (3, 129, 33), (129, 130, 5))
# the scales at which phase 5 times the three features8 branches against
# each other (the dispatch table): these, and one sigma more for every x
# radius 4 .. 28 at 0.78 mm that they leave out and for DISPATCH_WIDE_RADII,
# where only the xs-stream kernel and the staged pair take the scale
DISPATCH_SIGMAS = (0.6, 1.2, 1.7, 1.8, 2.0, 2.4, 3.0, 3.4, 3.5, 4.8)
DISPATCH_WIDE_RADII = (30, 32, 36, 40, 48)
# the kernels each features8 branch launches
BRANCH_KERNELS = {"sweep": ("features8_sweep",),
                  "xs_stream": ("smooth_yz", "features8_xs_stream"),
                  "nc_conv+post": ("normalized_conv", "features8_post")}
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = 67e12
# floating-point operations per voxel of the shared tail, counted from
# csrc/features8_tail.cuh: 42 in the differences and the gradient
# magnitude, ~110 in the eigen solve and its features
TAIL_OPS = 150
# the same for the Hessian kernel's reference output: TAIL_OPS less the
# polynomial cos(arccos(r)/3) and its sine (~36), plus acosf and two cosf
# (~60 in CUDA's forms, their range reduction included) and the diagonal
# comparison tree (~15)
REFERENCE_OPS = 190


class PhaseError(RuntimeError):
    pass


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


class Budget:
    """Wall seconds of a run's phases, summed by name over their visits:
    enter(name) closes the phase that is open and opens the next."""

    def __init__(self):
        self.secs, self.name, self.t0 = {}, None, time.perf_counter()

    def enter(self, name):
        now = time.perf_counter()
        if self.name is not None:
            self.secs[self.name] = self.secs.get(self.name, 0.0) + now - self.t0
        self.name, self.t0 = name, now
        return name

    def report(self):
        """The [budget] line: each phase's wall s, their total, the card's
        name and power limit. For information only: it never raises."""
        self.enter(None)
        try:
            card = card_line()
        except Exception as e:  # noqa: BLE001 - the line may not fail a run
            card = f"card not read: {e}"
        say("budget", " | ".join(f"{k} {v:.1f} s" for k, v in self.secs.items())
            + f" | total {sum(self.secs.values()):.1f} s | {card}")


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _rel(got, ref):
    """(max|got-ref| / max(max|ref|, 1), max|got-ref|) as floats, in f64."""
    d = (got.double() - ref.double()).abs().max().item()
    return d / max(ref.double().abs().max().item(), 1.0), d


def feature_errors(got, ref, eig=(0, 1, 2), tol=None):
    """Worst (relative, absolute) error over a channel tuple; the channels
    at positions `eig` (none or three: e1, e2, e3) compared as value-sorted
    triples and, given the tolerance `tol` the caller holds them to, also
    per channel outside the ties (eigen_channel_error): an eigenvalue in
    another channel than the reference's, where no tie excuses it, then
    counts."""
    from ife_tpu_torch.ops.eigen import value_sorted3

    rel = ab = 0.0
    pairs = [(got[i], ref[i]) for i in range(len(ref)) if i not in eig]
    if eig:
        pairs += zip(value_sorted3(*(got[i] for i in eig)),
                     value_sorted3(*(ref[i] for i in eig)))
    errs = [_rel(g, r) for g, r in pairs]
    if eig and tol is not None:
        errs.append(eigen_channel_error([got[i] for i in eig],
                                        [ref[i] for i in eig], tol))
    for e_rel, e_abs in errs:
        rel, ab = max(rel, e_rel), max(ab, e_abs)
    return rel, ab


def eigen_channel_error(got, ref, tol):
    """(relative, absolute) error of three eigenvalue channels against the
    triple's joint scale s = max(max|ref|, 1): channel by channel where
    ref's adjacent |e_k| differ by more than the margin 2 tol s, as
    value-sorted triples where they tie (tie_sorted_eigenvalues; margin as
    PERF.md section 2 states it). Within tol whenever the sorted triples are,
    unless an eigenvalue sits in another channel than the reference's
    outside a tie."""
    from ife_tpu_torch.ops.eigen import tie_sorted_eigenvalues

    s = max(max(r.abs().max().item() for r in ref), 1.0)
    g, r = tie_sorted_eigenvalues(list(got), list(ref), 2 * tol * s)
    ab = max((a.double() - b.double()).abs().max().item()
             for a, b in zip(g, r))
    return ab / s, ab


def bit_equal(got, ref):
    """Every channel equal to the bit, NaN exactly where ref is NaN."""
    return all(bool(((g == r) | (torch.isnan(g) & torch.isnan(r))).all())
               for g, r in zip(got, ref))


def kernel_check(name, got, ref, inside=None):
    """(relative error, absolute error) of a kernel's outputs against its
    twin's; raises unless they are bit-equal. `inside` masks the
    normalized convolution (NaN off the certainty support)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    if not bit_equal(got, ref):
        raise PhaseError(f"{name}: kernel differs from its plain twin")
    if inside is not None:
        zero = torch.zeros((), dtype=got[0].dtype, device=got[0].device)
        return _rel(torch.where(inside, got[0], zero),
                    torch.where(inside, ref[0], zero))
    eig = {6: (0, 1, 2), 8: (2, 3, 4)}.get(len(ref), ())
    return feature_errors(got, ref, eig)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is false")
    cc = torch.cuda.get_device_capability(0)
    if cc != (9, 0):
        raise PhaseError(f"compute capability {cc}, need (9, 0) for sm_90a")
    from ife_tpu_torch.kernels._build import find_nvcc

    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {nvcc[-1] if nvcc else 'nvcc ?'}")
    say("device", f"{torch.cuda.get_device_name(0)} cc {cc} "
        f"count {torch.cuda.device_count()}")
    try:
        print(card_line(), flush=True)
    except (OSError, RuntimeError) as e:
        raise PhaseError(f"nvidia-smi: {e}") from e


def phase_build():
    """The CUDA kernels and, in a thread beside them, the native host
    library (g++); either failing to build fails the phase."""
    from concurrent.futures import ThreadPoolExecutor

    from ife_tpu_torch import native_lib
    from ife_tpu_torch.kernels import _build

    def native():
        t = time.perf_counter()
        native_lib.lib()
        return native_lib.build(), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(native)
        path = _build.build()
        _build.lib()
        try:
            host_path, host_s = host.result()
        except RuntimeError as e:
            raise PhaseError(f"the native library did not build: {e}") from e
    say("build", f"{time.perf_counter() - t0:.1f} s -> {path}; native host "
        f"library {host_s:.1f} s -> {host_path}")
    # -Xptxas -v per kernel: its (mangled) name, registers, barriers, shared
    # memory, and its own stack frame and spills
    log = path.parent / "build.log"
    name = frame = None
    for line in log.read_text().splitlines() if log.is_file() else []:
        if "Compiling entry function" in line:
            name, frame = line.split("'")[1], None
        elif "bytes stack frame" in line and frame is None:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            say("build", f"{name[:72]}: {line.split(':', 1)[1].strip()}; {frame}")
            name = None


def _inputs(shape, seed, device):
    """A synthetic CT with a sphere mask (the repo's test volumes), f32."""
    from ife_tpu_torch.core.volume import sphere_mask, synthetic_ct

    img = synthetic_ct(shape, seed=seed, device=device).data.contiguous()
    mask = sphere_mask(shape, 0.4, dtype=torch.float32, device=device).data
    return img, mask.contiguous()


def kernel_pairs(img, mask, sigma, sp):
    """(name, kernel call, plain twin call, inside-mask or None) for every
    kernel that takes this scale (the sweep and xs-stream rings must fit a
    block's shared memory), on the inputs the main path gives each: the
    post and xs-stream kernels take the twins' smoothed volumes."""
    from ife_tpu_torch import kernels as K

    s_ref = K.normalized_conv_plain(img, mask, sigma, sp)
    num, den = K.smooth_yz_plain(img, mask, sigma, sp)
    fits = {"features8_sweep": K.sweep_fits(sigma, sp),
            "features8_xs_stream": K.xs_stream_fits(sigma, sp)}
    pairs = [
        ("normalized_conv",
         lambda: K.fused_normalized_conv_sweep(img, mask, sigma, sp),
         lambda: K.normalized_conv_plain(img, mask, sigma, sp), mask != 0),
        ("features8_post",
         lambda: K.fused_features8_post_stream(s_ref, mask, sp, stack=False),
         lambda: K.features8_post_plain(s_ref, mask, sp), None),
        ("features8_sweep",
         lambda: K.fused_features8_sweep(img, mask, sigma, sp, stack=False),
         lambda: K.features8_sweep_plain(img, mask, sigma, sp), None),
        ("smooth_yz",
         lambda: K.fused_smooth_yz(img, mask, sigma, sp),
         lambda: K.smooth_yz_plain(img, mask, sigma, sp), None),
        ("features8_xs_stream",
         lambda: K.fused_features8_xs_stream(num, den, mask, sigma, sp,
                                             stack=False),
         lambda: K.features8_xs_stream_plain(num, den, mask, sigma, sp), None),
        ("smooth_xz",
         lambda: K.fused_smooth_xz(img, mask, sigma, sp),
         lambda: K.smooth_xz_plain(img, mask, sigma, sp), None),
        ("normalized_conv_tiled",
         lambda: K.fused_normalized_conv_sweep_tiled(img, mask, sigma, sp,
                                                     n_tiles=2),
         lambda: K.normalized_conv_tiled_plain(img, mask, sigma, sp,
                                               n_tiles=2), mask != 0),
        ("features8_post_windowed",
         lambda: K.fused_features8_post(s_ref, mask, sp, stack=False),
         lambda: K.features8_post_plain(s_ref, mask, sp), None),
    ]
    return [pair for pair in pairs if fits.get(pair[0], True)]


def multi_check(name, got, ref):
    """kernel_check per scale of a multi-scale kernel's output; the worst
    (relative, absolute) error."""
    errs = [kernel_check(f"{name} scale {i}", g, r)
            for i, (g, r) in enumerate(zip(got, ref))]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def ys_multi_pair(img, mask, sigmas, sp):
    """(kernel call, plain twin call) of features8_ys_multi on the inputs
    multiscale_features8_fused gives it: the twins' x/z-smoothed volumes."""
    from ife_tpu_torch import kernels as K

    pairs = [K.smooth_xz_plain(img, mask, s, sp) for s in sigmas]
    nums, dens = [p[0] for p in pairs], [p[1] for p in pairs]
    return (lambda: K.fused_features8_ys_multi(nums, dens, mask, sigmas, sp,
                                               stack=False),
            lambda: K.features8_ys_multi_plain(nums, dens, mask, sigmas, sp))


def multi_kernel_checks(img, mask, sp, errs):
    """The multi-scale kernels against their twins with 1, 2 and 3 scales;
    the tiled normalized convolution against the untiled kernel; the
    windowed post kernel at other block shapes."""
    from ife_tpu_torch import kernels as K

    line = []
    for sigmas in ((4.8,), YS_SIGMAS, (0.6, 2.4, 4.8)):
        kern, plain = ys_multi_pair(img, mask, sigmas, sp)
        rel, _ = multi_check(f"features8_ys_multi {sigmas}", kern(), plain())
        errs["features8_ys_multi"].append(rel)
    line.append("ys_multi S=1,2,3")
    for sigmas in SWEEP_CHECK_SIGMAS:
        if not K.sweep_multi_fits(sigmas, sp):
            raise PhaseError(f"sweep_multi does not take {sigmas} at {sp}")
        labels = mask * 3.0  # the sweep clamps the mask itself
        rel, _ = multi_check(
            f"features8_sweep_multi {sigmas}",
            K.fused_features8_sweep_multi(img, labels, sigmas, sp, stack=False),
            K.features8_sweep_multi_plain(img, labels, sigmas, sp))
        errs["features8_sweep_multi"].append(rel)
    line.append("sweep_multi S=1,2,3")
    for sigma in (1.2, 4.8):
        untiled = K.fused_normalized_conv_sweep(img, mask, sigma, sp)
        for n_tiles in (1, 2, 3, 4):
            tiled = K.fused_normalized_conv_sweep_tiled(img, mask, sigma, sp,
                                                        n_tiles=n_tiles)
            if not bit_equal((tiled,), (untiled,)):
                raise PhaseError(f"normalized_conv_tiled s={sigma} n_tiles="
                                 f"{n_tiles}: differs from the untiled kernel")
    line.append("nc tiled 1-4 slabs == untiled")
    s_ref = K.normalized_conv_plain(img, mask, 1.2, sp)
    want = K.features8_post_plain(s_ref, mask, sp)
    for block in (1, (64, 8), (5, 1000)):
        rel, _ = kernel_check(
            f"features8_post_windowed block {block}",
            K.fused_features8_post(s_ref, mask, sp, block=block, stack=False),
            want)
        errs["features8_post_windowed"].append(rel)
    line.append("post windowed blocks 1, (64,8), (5,1000)")
    return line


def edge_layer(v):
    """v with a one-voxel edge-replicated layer on x and y (what a block
    with no neighbour carries in pre_padded mode)."""
    from ife_tpu_torch.parallel import halo_pad

    return halo_pad(halo_pad(v, 0, 1), 1, 1).contiguous()


def mode_pairs(img, mask, sigma, sp):
    """(name, kernel call, plain twin call) for the windowed kernels and
    every shard mode: clamps that put a true face inside the array on one
    side of each axis and none on the other; x_halo rows and a pre_padded
    layer that replicate the faces."""
    from ife_tpu_torch import kernels as K

    X, Y, _ = img.shape
    cl = [min(2, X - 1), K.NO_FACE, -K.NO_FACE, max(Y - 3, 0)]
    s = torch.nan_to_num(K.normalized_conv_plain(img, mask, sigma, sp))
    halo = (s[:1].contiguous(), s[-1:].contiguous())
    ihalo = (img[:1].contiguous(), img[-1:].contiguous())
    s_pad, img_pad = edge_layer(s), edge_layer(img)
    pairs = [
        ("features8_sweep_clamps",
         lambda: K.fused_features8_sweep(img, mask, sigma, sp, stack=False,
                                         clamps=cl),
         lambda: K.features8_sweep_plain(img, mask, sigma, sp, clamps=cl)),
        ("hessian_eig_x_halo",
         lambda: K.fused_hessian_eig_stream(img, sp, stack=False, x_halo=ihalo),
         lambda: K.hessian_eig_plain(img, sp, x_halo=ihalo)),
        ("hessian_eig_pre_padded",
         lambda: K.fused_hessian_eig(img_pad, sp, stack=False, pre_padded=True),
         lambda: K.hessian_eig_plain(img_pad, sp, pre_padded=True)),
        ("features8_post_x_halo",
         lambda: K.fused_features8_post_stream(s, mask, sp, stack=False,
                                               x_halo=halo),
         lambda: K.features8_post_plain(s, mask, sp, x_halo=halo)),
        ("features8_post_pre_padded",
         lambda: K.fused_features8_post_stream(s_pad, mask, sp, stack=False,
                                               pre_padded=True),
         lambda: K.features8_post_plain(s_pad, mask, sp, pre_padded=True)),
        ("features8_post_windowed_pre_padded",
         lambda: K.fused_features8_post(s_pad, mask, sp, stack=False,
                                        pre_padded=True),
         lambda: K.features8_post_plain(s_pad, mask, sp, pre_padded=True)),
    ]
    if K.tap_fits(sigma, sp):
        pairs.append(("features8_tap",
                      lambda: K.fused_features8_tap(img, mask, sigma, sp,
                                                    stack=False),
                      lambda: K.features8_tap_plain(img, mask, sigma, sp)))
    if K.xs_fits(sigma, sp):
        pairs.append(("features8_xs",
                      lambda: K.fused_features8_xs(img, mask, sigma, sp,
                                                   stack=False),
                      lambda: K.features8_xs_plain(img, mask, sigma, sp)))
    return pairs


def mode_kernel_checks(img, mask, sp, errs, sigma=1.2):
    """tap, xs and every shard mode against its twin in that mode; the
    default clamps against the call without; an edge-replicated halo
    against the whole-volume mode."""
    from ife_tpu_torch import kernels as K

    X, Y, _ = img.shape
    for name, kern, plain in mode_pairs(img, mask, sigma, sp):
        rel, _ = kernel_check(f"{name} {tuple(img.shape)} {sp}", kern(), plain())
        errs[name].append(rel)
    labels = mask * 3.0  # the sweeps clamp the mask themselves
    sigmas = (0.6, sigma)
    if not K.sweep_multi_fits(sigmas, sp):  # two scales take an rx <= 7
        sigmas = SWEEP_CHECK_SIGMAS[1]
    cl = [min(2, X - 1), K.NO_FACE, -K.NO_FACE, max(Y - 3, 0)]
    rel, _ = multi_check(
        "features8_sweep_multi_clamps",
        K.fused_features8_sweep_multi(img, labels, sigmas, sp, stack=False,
                                      clamps=cl),
        K.features8_sweep_multi_plain(img, labels, sigmas, sp, clamps=cl))
    errs["features8_sweep_multi_clamps"].append(rel)
    whole = [0, X - 1, 0, Y - 1]
    same = [
        ("sweep default clamps",
         K.fused_features8_sweep(img, labels, sigma, sp, clamps=whole),
         K.fused_features8_sweep(img, labels, sigma, sp)),
        ("sweep_multi default clamps",
         K.fused_features8_sweep_multi(img, labels, sigmas, sp, clamps=whole),
         K.fused_features8_sweep_multi(img, labels, sigmas, sp)),
        ("hessian x_halo of the face rows",
         K.fused_hessian_eig_stream(img, sp, x_halo=(img[:1].contiguous(),
                                                     img[-1:].contiguous())),
         K.fused_hessian_eig_stream(img, sp)),
        ("hessian pre_padded edge layer",
         K.fused_hessian_eig(edge_layer(img), sp, pre_padded=True),
         K.fused_hessian_eig(img, sp)),
    ]
    for label, got, want in same:
        if not bit_equal(got.unbind(0), want.unbind(0)):
            raise PhaseError(f"{label}: differs from the whole-volume call")
    return ("tap, xs, clamps (single, multi), x_halo and pre_padded (hessian, "
            "post, windowed post); default clamps and face-row halos == the "
            "whole-volume mode")


def sweep_radius_checks(errs):
    """Every instantiation of the two sweeps against its twin, with and
    without clamps: the single sweep at each x radius 1 .. SWEEP_MAX_RX
    (an anisotropic spacing, so that ry != rx != rz), the multi-scale sweep
    at S = 1 .. 4 with mixed radii in every class of its largest x radius,
    on small odd shapes: thin ones (X below a chunk, Y below a tile, Z = 1,
    radii beyond the extent) and one longer than a chunk; then masks that
    leave whole planes, tiles or the volume empty (the sweeps skip the
    planes of a chunk that hold no voxel inside)."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.stencil import smooth_taps

    dev = torch.device("cuda")
    sp, sp_multi = (0.78, 0.6, 1.1), (0.78, 0.9, 1.0)
    multi_sets = ((1.2,), (0.6, 1.2), (0.3, 0.45, 0.6), (0.2,) * 4, (1.7,),
                  (0.34, 0.2, 0.3, 0.1))
    for sigmas in multi_sets:
        if not K.sweep_multi_fits(sigmas, sp_multi):
            raise PhaseError(f"sweep_multi does not take {sigmas}")
    radii = []
    for shape in ((37, 29, 41), (5, 40, 33), (40, 9, 33), (23, 17, 1),
                  (3, 2, 70), (140, 15, 35)):
        img, mask = _inputs(shape, 0, dev)
        labels = mask * 3.0  # the sweeps clamp the mask themselves
        X, Y, _ = shape
        cl = [min(2, X - 1), K.NO_FACE, -K.NO_FACE, max(Y - 3, 0)]
        radii = []
        for rx in range(1, K.SWEEP_MAX_RX + 1):
            sigma = (rx - 0.5) * sp[0] / 4.5
            r = tuple(smooth_taps(sigma, h)[1] for h in sp)
            if r[0] != rx or not K.sweep_fits(sigma, sp):
                raise PhaseError(f"sigma {sigma}: radii {r}, wanted rx {rx}")
            radii.append(r)
            for clamps, name in ((None, "features8_sweep"),
                                 (cl, "features8_sweep_clamps")):
                rel, _ = kernel_check(
                    f"{name} {shape} radii {r}",
                    K.fused_features8_sweep(img, labels, sigma, sp,
                                            stack=False, clamps=clamps),
                    K.features8_sweep_plain(img, labels, sigma, sp,
                                            clamps=clamps))
                errs[name].append(rel)
        for sigmas in multi_sets:
            for clamps, name in ((None, "features8_sweep_multi"),
                                 (cl, "features8_sweep_multi_clamps")):
                rel, _ = multi_check(
                    f"{name} {shape} {sigmas}",
                    K.fused_features8_sweep_multi(img, labels, sigmas,
                                                  sp_multi, stack=False,
                                                  clamps=clamps),
                    K.features8_sweep_multi_plain(img, labels, sigmas,
                                                  sp_multi, clamps=clamps))
                errs[name].append(rel)
        torch.cuda.synchronize()
    say("kernels", f"sweep at radii {radii} and sweep_multi at {multi_sets}, "
        "with and without clamps, on (37,29,41), (5,40,33), (40,9,33), "
        "(23,17,1), (3,2,70), (140,15,35): bit-equal to the twins")
    shape = (70, 40, 45)
    img, mask = _inputs(shape, 0, dev)
    x_half = (torch.arange(shape[0], device=dev) > 30).float()[:, None, None]
    corner = torch.zeros_like(mask)
    corner[-1, -1, -1] = 2.0
    origin = torch.zeros_like(mask)
    origin[0, 0, 0] = 1.0
    masks = {"empty": mask * 0, "half of x": (mask * x_half).contiguous(),
             "the last voxel": corner, "the first voxel": origin,
             "ones": torch.ones_like(mask)}
    for label, m in masks.items():
        for sigma in (0.3, 1.0):
            rel, _ = kernel_check(
                f"features8_sweep mask {label} s={sigma}",
                K.fused_features8_sweep(img, m, sigma, sp, stack=False),
                K.features8_sweep_plain(img, m, sigma, sp))
            errs["features8_sweep"].append(rel)
        rel, _ = multi_check(
            f"features8_sweep_multi mask {label}",
            K.fused_features8_sweep_multi(img, m, (0.3, 0.6), sp, stack=False),
            K.features8_sweep_multi_plain(img, m, (0.3, 0.6), sp))
        errs["features8_sweep_multi"].append(rel)
    torch.cuda.synchronize()
    say("kernels", f"{shape} sweep and sweep_multi under masks "
        f"{tuple(masks)}: bit-equal to the twins")


def region_masks(shape, dev, sphere):
    """Masks that leave everything, all but one octant, or nothing empty,
    beside the sphere: a kernel that skips work outside the mask must store
    its zeros there."""
    X, Y, Z = shape
    octant = torch.zeros(shape, device=dev)
    octant[: (X + 1) // 2, : (Y + 1) // 2, : (Z + 1) // 2] = 1.0
    return {"empty": torch.zeros(shape, device=dev), "one octant": octant,
            "full": torch.ones(shape, device=dev), "sphere": sphere}


def xs_ys_radius_checks(errs):
    """The xs-stream kernel at every x radius XS_CHECK_RADII and the
    ys-multi kernel at S = 1 .. 4 against their twins, on the inputs the
    main path gives them (the twins' y/z- or x/z-smoothed volumes), under an
    empty, a one-octant, a full and the sphere mask, on odd thin shapes and
    on a shape with true faces on every side: both skip the planes and
    tails the mask leaves empty."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.stencil import smooth_taps

    dev = torch.device("cuda")
    sp = (0.78, 0.6, 1.1)
    shapes = ((37, 29, 41), (5, 40, 33), (40, 9, 33), (23, 17, 1),
              (140, 15, 35), (128, 124, 120))
    for shape in shapes:
        img, sphere = _inputs(shape, 0, dev)
        for label, m in region_masks(shape, dev, sphere).items():
            for rx in XS_CHECK_RADII:
                sigma = (rx - 0.5) * sp[0] / 4.5
                if (smooth_taps(sigma, sp[0])[1] != rx
                        or not K.xs_stream_fits(sigma, sp)):
                    raise PhaseError(f"sigma {sigma}: not x radius {rx}")
                num, den = K.smooth_yz_plain(img, m, sigma, sp)
                rel, _ = kernel_check(
                    f"features8_xs_stream {shape} mask {label} rx {rx}",
                    K.fused_features8_xs_stream(num, den, m, sigma, sp,
                                                stack=False),
                    K.features8_xs_stream_plain(num, den, m, sigma, sp))
                errs["features8_xs_stream"].append(rel)
                del num, den
            for sigmas in YS_CHECK_SIGMAS:
                kern, plain = ys_multi_pair(img, m, sigmas, sp)
                rel, _ = multi_check(
                    f"features8_ys_multi {shape} mask {label} {sigmas}",
                    kern(), plain())
                errs["features8_ys_multi"].append(rel)
        torch.cuda.synchronize()
    say("kernels", f"xs_stream at x radii {XS_CHECK_RADII} "
        f"and ys_multi at S = 1..4 {YS_CHECK_SIGMAS} on {shapes}, masks "
        "empty / one octant / full / sphere: bit-equal to the twins")


def tap_max_radius(K):
    """The largest r that the checkout's tap_fits takes at equal radii."""
    unit = (1.0, 1.0, 1.0)
    return max(r for r in range(1, 129) if K.tap_fits(r / 4.5, unit))


def tap_xs_radius_checks(errs):
    """The direct entries against their twins on TAP_XS_SHAPES under an
    empty, a one-octant, a full, the sphere and a sphere of -0.5 / 1.5 (the
    kernels clamp it) mask (both skip what the mask leaves empty: the tap the
    rows of a chunk, xs whole blocks): the tap and its copy floor at every
    equal radius 1 .. 12 (its ring in shared memory up to 11, in global
    scratch from 12), at 20, 32 and its limit, at three anisotropic scales
    (rx != ry != rz) and at radii 2 / 25 / 2 (a ring in global scratch beside
    small x and z radii); the xs entry at every x radius XS_DIRECT_RADII."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.stencil import smooth_taps

    dev = torch.device("cuda")
    unit, sp = (1.0, 1.0, 1.0), (0.78, 0.6, 1.1)
    top = tap_max_radius(K)
    scales = [(r / 4.5, unit) for r in (*range(1, 13), 20, 32, top)]
    scales += [(s, sp) for s in (0.5, 1.0, 1.3)] + [(1.1, (4.0, 0.2, 4.0))]
    for sigma, h in scales:
        if not K.tap_fits(sigma, h):
            raise PhaseError(f"tap_fits does not take sigma {sigma} at {h}")
    for shape in TAP_XS_SHAPES:
        img, sphere = _inputs(shape, 0, dev)
        masks = region_masks(shape, dev, sphere)
        masks["clamped sphere"] = sphere * 2.0 - 0.5
        for label, m in masks.items():
            for sigma, h in scales:
                r = tuple(smooth_taps(sigma, a)[1] for a in h)
                rel, _ = kernel_check(
                    f"features8_tap {shape} mask {label} radii {r}",
                    K.fused_features8_tap(img, m, sigma, h, stack=False),
                    K.features8_tap_plain(img, m, sigma, h))
                errs["features8_tap"].append(rel)
                bitwise_check(
                    f"features8_tap_copyfloor {shape} mask {label} radii {r}",
                    K.fused_features8_tap(img, m, sigma, h, stack=False,
                                          variant="copyfloor"),
                    K.features8_tap_copyfloor_plain(img, m))
            for rx in XS_DIRECT_RADII:
                sigma = (rx - 0.5) * sp[0] / 4.5
                if (smooth_taps(sigma, sp[0])[1] != rx
                        or not K.xs_fits(sigma, sp)):
                    raise PhaseError(f"sigma {sigma}: not x radius {rx}")
                rel, _ = kernel_check(
                    f"features8_xs {shape} mask {label} rx {rx}",
                    K.fused_features8_xs(img, m, sigma, sp, stack=False),
                    K.features8_xs_plain(img, m, sigma, sp))
                errs["features8_xs"].append(rel)
        torch.cuda.synchronize()
    say("kernels", f"tap and its copy floor at equal radii 1 .. 12, 20, 32, "
        f"{top}, at sigma 0.5 / 1.0 / 1.3 on {sp} and at radii 2 / 25 / 2, xs "
        f"at x radii {XS_DIRECT_RADII}, "
        f"on {TAP_XS_SHAPES}, masks empty / one octant / full / sphere / "
        "clamped sphere: bit-equal to the twins")


def radii_spacing(radii, sigma=1.0):
    """Per-axis spacing at which `sigma` has the x / y / z radii `radii`
    (radius = ceil(4.5 sigma / h))."""
    return tuple(4.5 * sigma / (r - 0.5) for r in radii)


def nc_entry_pairs(img, m, sigma, sp):
    """(name, kernel call, plain twin call, inside-mask or None) of the four
    entries on csrc/normalized_conv.cu's kernels: the z pass with the divide
    (normalized_conv, its tiled entry at 1 - 3 slabs) and in place
    (smooth_yz, smooth_xz)."""
    from ife_tpu_torch import kernels as K

    inside = m != 0
    pairs = [
        ("normalized_conv",
         lambda: K.fused_normalized_conv_sweep(img, m, sigma, sp),
         lambda: K.normalized_conv_plain(img, m, sigma, sp), inside),
        ("smooth_yz", lambda: K.fused_smooth_yz(img, m, sigma, sp),
         lambda: K.smooth_yz_plain(img, m, sigma, sp), None),
        ("smooth_xz", lambda: K.fused_smooth_xz(img, m, sigma, sp),
         lambda: K.smooth_xz_plain(img, m, sigma, sp), None),
    ]
    pairs += [("normalized_conv_tiled",
               lambda n=n: K.fused_normalized_conv_sweep_tiled(
                   img, m, sigma, sp, n_tiles=n),
               lambda n=n: K.normalized_conv_tiled_plain(
                   img, m, sigma, sp, n_tiles=n), inside)
              for n in (1, 2, 3)]
    return pairs


def nc_radius_checks(errs):
    """The four entries on csrc/normalized_conv.cu (nc_entry_pairs: both
    forms of the z pass, the paired and single axis passes) against their
    twins: every radius NC_CHECK_RADII on each axis and NC_ANISO_RADII on
    (37, 35, 33) under the sphere; sigma 4.8 and 0.6 at FULL_SPACING (radii
    28 / 28 / 22 and 4 / 4 / 3) and radii (128, 64, 11) on every
    NC_CHECK_SHAPES; under an empty, a one-octant, a full and the sphere
    mask, and on an image with NaN and +-inf where the sphere is 0; the
    tiled entry at 1 - 3 slabs also against the untiled kernel. The passes
    skip nothing, so every output is the twin's, NaN of 0/0 included."""
    from ife_tpu_torch import kernels as K

    dev = torch.device("cuda")
    n = 0

    def check(label, img, m, sigma, sp):
        nonlocal n
        for name, kern, plain, inside in nc_entry_pairs(img, m, sigma, sp):
            rel, _ = kernel_check(f"{name} {label}", kern(), plain(), inside)
            errs[name].append(rel)
            n += 1
        untiled = K.fused_normalized_conv_sweep(img, m, sigma, sp)
        for t in (1, 2, 3):
            tiled = K.fused_normalized_conv_sweep_tiled(img, m, sigma, sp,
                                                        n_tiles=t)
            if not bit_equal((tiled,), (untiled,)):
                raise PhaseError(f"normalized_conv_tiled {label} n_tiles {t}: "
                                 "differs from the untiled kernel")

    shape = (37, 35, 33)
    img, sphere = _inputs(shape, 0, dev)
    check(f"{shape} sigma 0", img, sphere, 0.0, FULL_SPACING)
    radii = [tuple(r if a == d else 2 for a in range(3))
             for d in range(3) for r in NC_CHECK_RADII] + list(NC_ANISO_RADII)
    for rs in radii:
        check(f"{shape} radii {rs}", img, sphere, 1.0, radii_spacing(rs))
    torch.cuda.synchronize()
    for shape in NC_CHECK_SHAPES:
        img, sphere = _inputs(shape, 0, dev)
        for sigma, sp in ((4.8, FULL_SPACING), (0.6, FULL_SPACING),
                          (1.0, radii_spacing((128, 64, 11)))):
            check(f"{shape} sigma {sigma} spacing {sp}", img, sphere, sigma,
                  sp)
        torch.cuda.synchronize()
    shape = (40, 36, 33)
    img, sphere = _inputs(shape, 0, dev)
    masks = region_masks(shape, dev, sphere)
    bad = img.clone()
    out = sphere == 0
    bad[out] = torch.tensor([float("nan"), float("inf"), -float("inf")],
                            device=dev).repeat(int(out.sum()) // 3 + 1)[
                                :int(out.sum())]
    for sigma in (2.4, 4.8):
        for label, m in masks.items():
            check(f"{shape} sigma {sigma} mask {label}", img, m, sigma,
                  FULL_SPACING)
        check(f"{shape} sigma {sigma} NaN / inf image off the sphere", bad,
              sphere, sigma, FULL_SPACING)
    torch.cuda.synchronize()
    say("kernels", f"normalized_conv, smooth_yz, smooth_xz and the tiled entry "
        f"(1 - 3 slabs, also == untiled): {n} cases bit-equal to the twins, "
        f"radii {NC_CHECK_RADII} on each axis, {NC_ANISO_RADII} and sigma 0; "
        f"shapes {NC_CHECK_SHAPES}; masks empty / one octant / full / sphere, "
        "NaN / inf image off the mask")


def phase_kernels(errs):
    from ife_tpu_torch import kernels as K

    dev = torch.device("cuda")
    for shape in ((128, 124, 120), (64, 64, 64)):
        img, mask = _inputs(shape, 0, dev)
        for sp in SPACINGS:
            rel, _ = kernel_check("hessian_eig",
                                  K.fused_hessian_eig_stream(img, sp, stack=False),
                                  K.hessian_eig_plain(img, sp))
            errs["hessian_eig"].append(rel)
            line = [f"hessian_eig {rel:.2e}"]
            rel, _ = kernel_check(
                "hessian_eig_reference",
                K.hessian_eig_reference_features(img, sp),
                K.hessian_eig_reference_plain(img, sp))
            errs["hessian_eig_reference"].append(rel)
            line.append(f"hessian_eig_reference {rel:.2e}")
            for sigma in SIGMAS:
                part = []
                for name, kern, plain, inside in kernel_pairs(img, mask, sigma, sp):
                    rel, _ = kernel_check(f"{name} {shape} {sp} s={sigma}",
                                          kern(), plain(), inside)
                    errs[name].append(rel)
                    part.append(f"{name} {rel:.1e}")
                line.append(f"s={sigma}: " + " ".join(part))
            line += multi_kernel_checks(img, mask, sp, errs)
            line.append(mode_kernel_checks(img, mask, sp, errs))
            torch.cuda.synchronize()
            say("kernels", f"{shape} spacing {sp}, bit-equal to the twins: "
                + "; ".join(line))
        hist_kernel_checks(img, mask, shape, errs)
    hist_case_checks(errs)
    # a thin volume: both y radii (14 and 28 voxels) exceed Y = 9, every
    # tap row is a clamped one (the dense-dot branch of ife_tpu's _banded_dot)
    img, mask = _inputs((40, 9, 33), 0, dev)
    kern, plain = ys_multi_pair(img, mask, YS_SIGMAS, SPACINGS[0])
    rel, _ = multi_check("features8_ys_multi thin", kern(), plain())
    errs["features8_ys_multi"].append(rel)
    torch.cuda.synchronize()
    say("kernels", "(40, 9, 33) features8_ys_multi, y radii 14 and 28 > Y: "
        f"bit-equal to the twin, rel {rel:.1e}")
    # thin in y and thin in x: every window of tap and xs is all boundary
    for shape in ((40, 9, 33), (5, 40, 33)):
        img, mask = _inputs(shape, 0, dev)
        for sigma in (0.6, 1.2):
            mode_kernel_checks(img, mask, SPACINGS[0], errs, sigma)
        torch.cuda.synchronize()
        say("kernels", f"{shape} tap, xs and the shard modes at sigma 0.6 and "
            "1.2: bit-equal to the twins")
    sweep_radius_checks(errs)
    xs_ys_radius_checks(errs)
    tap_xs_radius_checks(errs)
    nc_radius_checks(errs)
    nc_sass_check()


def hist_edges(chans, E):
    """(C, E) f64 edges: per channel, evenly spaced order statistics of a
    strided sample, scaled by 1 + 2^-30 so that they are not f32 values
    (they round down to f32), with a run of duplicates and +-inf at the
    ends when E >= 8."""
    rows = []
    for c in chans:
        v = c.reshape(-1)[:: max(1, c.numel() // 65536)]
        v = v[torch.isfinite(v)].double().sort().values
        idx = torch.linspace(0, v.numel() - 1, E, device=v.device).round().long()
        rows.append(v[idx])
    e = torch.stack(rows).cpu() * (1.0 + 2.0 ** -30)
    if E >= 8:
        e[:, 2:6] = e[:, 2:3]
        e[:, 0], e[:, -1] = -float("inf"), float("inf")
    return e


def hist_kernel_checks(img, mask, shape, errs):
    """The histogram kernel against its twin on the features8 channels of
    img (sigma 1.2, the kernels' output, with NaN and +-inf planted):
    whole-volume and box forms, E 1/31/4096, unweighted, mask (uint8) and
    integer (int32) weights; at (64,64,64) also 64 channels x 4097 bins,
    over a block's shared memory: the kernel's global-memory path."""
    import numpy as np

    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.kernels.histogram import _plan
    from ife_tpu_torch.ops.features import features8_auto_channels
    from ife_tpu_torch.roi import generate_random_rois

    chans = list(features8_auto_channels(img, mask, 1.2, SPACINGS[0]))
    chans[1] = chans[1].clone()
    chans[1].view(-1)[:3] = torch.tensor([float("nan"), float("inf"),
                                          -float("inf")], device=img.device)
    g = torch.Generator(device=img.device).manual_seed(0)
    weights = {"none": None, "mask": (mask != 0).to(torch.uint8),
               "int": torch.randint(0, 4, shape, device=img.device,
                                    dtype=torch.int32, generator=g)}
    size = (17, 15, 13)
    rois = generate_random_rois((mask != 0).cpu().numpy(), 12, size, seed=0)
    starts = [r.index for r in rois] + [(0, 0, 0)]  # the corner: no mask
    line = []
    for E in (1, 31, 4096):
        e = hist_edges(chans, E)
        for wname, w in weights.items():
            got = K.histogram_counts_multi(chans, e, w)
            rel, _ = kernel_check(f"histogram {shape} E={E} w={wname}", got,
                                  K.histogram_counts_multi_plain(chans, e, w))
            errs["histogram"].append(rel)
            got = K.histogram_boxes(chans, w, starts, size, e)
            rel, _ = kernel_check(f"histogram boxes {shape} E={E} w={wname}",
                                  got, K.histogram_boxes_plain(chans, w, starts,
                                                               size, e))
            errs["histogram"].append(rel)
            if wname == "mask" and int(got[-1].sum()) != 0:
                raise PhaseError("histogram: a box with no mask counted voxels")
        line.append(f"E={E} ({_plan(8, E, img.numel())})")
    if shape == (64, 64, 64):
        wide = chans * 8
        e = hist_edges(wide, 4096)
        if _plan(64, 4096, img.numel()).copies != 0:
            raise PhaseError("64 x 4097 bins should take the global path")
        rel, _ = kernel_check("histogram global path 64 x 4096",
                              K.histogram_counts_multi(wide, e, weights["mask"]),
                              K.histogram_counts_multi_plain(wide, e,
                                                             weights["mask"]))
        errs["histogram"].append(rel)
        line.append("64 channels x 4096 edges (global path)")
    torch.cuda.synchronize()
    say("kernels", f"{shape} histogram equal to its twin, whole volume and "
        f"{len(starts)} boxes, unweighted/mask/int32 weights: " + ", ".join(line))


def hist_case_checks(errs):
    """The histogram kernel against its twin, counts equal, on the cases its
    design must get right: a constant field (every lane of a run in one
    bin), E = 1, 8 channels of 4096 edges (bins in shared memory, edges
    read through L1), channels that are views at an odd 4-byte offset with
    n % 4 != 0, NaN values, int32 weights up to 999, an empty mask, a mask
    whose runs of 32 are empty, full or half full, conflict-free values,
    and boxes at odd starts (rows shorter and longer than a warp)."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.kernels.histogram import _plan

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    n = 100_003
    base = torch.randn(8 * n + 1, device=dev, generator=g) * 300.0 - 600.0
    views = [base[1 + c * n: 1 + (c + 1) * n] for c in range(8)]
    e31 = torch.linspace(-1200.0, 600.0, 31, dtype=torch.float64)
    runs = torch.arange(n, device=dev) // 32
    half = torch.rand(n, device=dev, generator=g) > 0.5
    patchy = ((runs % 3 == 0) | ((runs % 3 == 1) & half)).to(torch.uint8)
    ones = torch.ones(n, dtype=torch.uint8, device=dev)
    nan = views[0].clone()
    nan[::7] = float("nan")
    fine = torch.linspace(-1500.0, 300.0, 4096, dtype=torch.float64)
    cases = [
        ("a constant field", [torch.full((n,), 0.5, device=dev)] * 8, e31, ones),
        ("E = 1", views, torch.tensor([-600.0], dtype=torch.float64), patchy),
        ("8 channels x 4096 edges", views, fine, ones),
        ("views at an odd offset, n % 4 = 3", views, e31, patchy),
        ("NaN values", [nan] + views[1:], e31, ones),
        ("int32 weights up to 999", views, e31,
         torch.randint(0, 1000, (n,), dtype=torch.int32, device=dev,
                       generator=g)),
        ("an empty mask", views, e31, torch.zeros_like(ones)),
        ("runs empty, full and half full", views, e31, patchy),
        ("conflict-free values", conflict_free_channels(ones, 8, e31), e31,
         ones),
    ]
    if (_plan(8, 4096, n)[:2] != (False, 1)
            or _plan(64, 4096, n).copies != 0):
        raise PhaseError("histogram plan: 8 x 4096 edges should keep the bins "
                         "alone in shared memory, 64 x 4096 take the global form")
    for label, chans, e, w in cases:
        got = K.histogram_counts_multi(chans, e, w)
        rel, _ = kernel_check(f"histogram {label}", got,
                              K.histogram_counts_multi_plain(chans, e, w))
        errs["histogram"].append(rel)
        if label == "an empty mask" and int(got.sum()) != 0:
            raise PhaseError("histogram: an empty mask counted voxels")
    shape = (37, 29, 43)
    vol = [torch.randn(shape, device=dev, generator=g) * 300.0 - 600.0
           for _ in range(8)]
    wv = (torch.rand(shape, device=dev, generator=g) > 0.4).to(torch.uint8)
    wi = torch.randint(0, 5, shape, dtype=torch.int32, device=dev, generator=g)
    e8 = torch.linspace(-1200.0, 600.0, 31, dtype=torch.float64).expand(8, 31)
    for size in ((17, 15, 13), (3, 5, 33), (1, 1, 43), (11, 9, 41)):
        starts = [(1, 3, 5), (7, 1, 0), (36 - size[0], 28 - size[1],
                                        43 - size[2]), (5, 11, 1)]
        for w in (None, wv, wi):
            rel, _ = kernel_check(
                f"histogram boxes {size} at odd starts",
                K.histogram_boxes(vol, w, starts, size, e8),
                K.histogram_boxes_plain(vol, w, starts, size, e8))
            errs["histogram"].append(rel)
    torch.cuda.synchronize()
    say("kernels", "histogram equal to its twin: " + "; ".join(
        c[0] for c in cases) + "; boxes at odd starts of 17x15x13, 3x5x33, "
        "1x1x43 and 11x9x41, unweighted / uint8 / int32 weights")


def dispatched_kernels(sigmas):
    """The kernels of the features8 branches the dispatcher takes at
    `sigmas` (FULL_SPACING)."""
    from ife_tpu_torch.ops.features import features8_dispatch_branch

    return tuple(k for s in sigmas for k in BRANCH_KERNELS[
        features8_dispatch_branch(s, FULL_SPACING, FULL)])


def takes_staged_passes(sigma):
    """True when the single-device dispatcher runs the same passes as the
    sharded route at `sigma` (that route takes the sweep or the staged
    pair, never the xs-stream kernel), so the two agree to the bit."""
    from ife_tpu_torch.ops.features import features8_dispatch_branch

    return features8_dispatch_branch(sigma, FULL_SPACING, FULL) != "xs_stream"


def branch_twin(img, m, sigma, sp):
    """The plain twins of the kernels features8 dispatches to at sigma."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.features import features8_dispatch_branch

    branch = features8_dispatch_branch(sigma, sp, img.shape)
    if branch == "sweep":
        return K.features8_sweep_plain(img, m, sigma, sp)
    if branch == "xs_stream":
        return K.features8_xs_stream_plain(*K.smooth_yz_plain(img, m, sigma, sp),
                                           m, sigma, sp)
    return K.features8_post_plain(K.normalized_conv_plain(img, m, sigma, sp),
                                  m, sp)


# the NIfTI pair the bag, tool and sharded CLI runs read, and the feature
# CLI's input with --cli-full; the default run's feature CLI reads a pair an
# eighth its size (gzip-9 writes of the outputs take nearly all its time)
CLI_SHAPE = (256, 256, 128)
CLI_SMOKE_SHAPE = (128, 128, 64)


def phase_main(tmp, cli_shape=CLI_SMOKE_SHAPE):
    """The user entry points, counters reset first; returns the counts. The
    feature CLI runs on the pair cli_img / cli_mask of `cli_shape`; the
    CLI_SHAPE pair img / mask is written to `tmp` beside it."""
    from ife_tpu_torch.cli.main import main
    from ife_tpu_torch.core.volume import Volume
    from ife_tpu_torch.io import read_volume, write_volume
    from ife_tpu_torch.kernels import (
        LAUNCHES, hessian_eig_plain, hessian_eig_reference_plain,
        reset_launches,
    )
    from ife_tpu_torch.ops.eigen import eigenvalue_features
    from ife_tpu_torch.ops.features import (
        FEATURE_NAMES, features8, features8_auto_channels,
        features8_dispatch_branch, fused_features8,
        hessian_eig_features_channels,
    )
    from ife_tpu_torch.ops.stencil import hessian

    sp = FULL_SPACING

    def write_pair(shape, prefix):
        img, mask = _inputs(shape, 1, "cpu")
        paths = [os.path.join(tmp, f"{prefix}{n}.nii.gz")
                 for n in ("img", "mask")]
        write_volume(paths[0], Volume(img, spacing=sp))
        write_volume(paths[1], Volume(mask.to(torch.uint8), spacing=sp))
        return img, mask, paths

    write_pair(CLI_SHAPE, "")
    shape = tuple(cli_shape)
    img, mask, (img_path, mask_path) = write_pair(shape, "cli_")
    big_img, big_mask = _inputs(FULL, 2, "cuda")
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    for argv in (["extract-features", "-i", img_path, "-m", mask_path,
                  "-o", os.path.join(tmp, "feat"), "-s", "0.6", "2.4"],
                 ["hessian-features", "--fused", "-i", img_path, "-m",
                  mask_path, "-o", os.path.join(tmp, "hess_")],
                 ["hessian-features", "-i", img_path, "-m", mask_path, "-o",
                  os.path.join(tmp, "hessc_")]):
        rc = main(argv)
        if rc != 0:
            raise PhaseError(f"CLI {argv[0]} exited {rc}")
    t_cli = time.perf_counter() - t0
    for sigma in (1.2, 4.8):
        feats = features8_auto_channels(big_img, big_mask, sigma, FULL_SPACING)
        del feats
    # the xs-stream branch through the entry point that names a branch,
    # whether or not the dispatcher sends a sigma of this run there
    feats = fused_features8(big_img, big_mask, 2.4, FULL_SPACING, stack=False,
                            branch="xs_stream")
    del feats
    hess = hessian_eig_features_channels(big_img, FULL_SPACING)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    del hess
    branches = {s: features8_dispatch_branch(s, FULL_SPACING, FULL)
                for s in (0.6, 1.2, 2.4, 4.8)}
    cli_branches = {s: features8_dispatch_branch(s, FULL_SPACING, shape)
                    for s in (0.6, 2.4)}
    say("main", f"CLI {t_cli:.1f} s on {shape} (branches {cli_branches}); "
        f"branches at {FULL} {branches}; launches {launches}")
    if cli_branches != {0.6: "sweep", 2.4: "xs_stream"}:
        raise PhaseError(f"the CLI's scales on {shape} reach {cli_branches}, "
                         "not the sweep and xs_stream")
    missing = [k for k in FEATURE_PATH if launches.get(k, 0) < 1]
    if missing:
        raise PhaseError(f"feature path launched no {missing} kernel")

    # The CLI's files against the plain ops in f64 (the reference
    # semantics, trig eigen path). Every channel but the eigenvalues must be
    # within TOL. Value-sorted eigenvalues of an f32 Hessian carry a
    # sqrt(ulp) noise floor near repeated eigenvalues (docs/design.md
    # "Precision policy"; the synthetic CT has exact ties), so for them the
    # criterion is the repo's own (tests/test_kernels.py): within TOL, or no
    # farther from f64 than twice the kernels' algorithm run as plain ops
    # in f32 (the kernels' twins).
    dev = torch.device("cuda")
    img32, m = img.to(dev), mask.to(dev)
    inside = m != 0
    sp = read_volume(img_path).spacing  # as the CLI saw it: f32 in NIfTI
    checks = []
    for sigma in (0.6, 2.4):
        got = [read_volume(os.path.join(tmp, f"feat_scale_{sigma:g}{n}.nii.gz")
                           ).data.to(dev) for n in FEATURE_NAMES]
        checks.append((
            f"extract-features s={sigma}", got, (2, 3, 4),
            features8(img32.double(), m, sigma, sp).unbind(-1),
            branch_twin(img32, m, sigma, sp)))
    hess_names = ("Eigenvalue1", "Eigenvalue2", "Eigenvalue3",
                  "LaplacianOfGaussian", "GaussianCurvature", "FrobeniusNorm")
    want64 = [c * inside for c in eigenvalue_features(
        hessian(img32.double(), sp)).unbind(-1)]
    got = [read_volume(os.path.join(tmp, f"hess_{n}.nii.gz")).data.to(dev)
           for n in hess_names]
    checks.append(("hessian-features --fused", got, (0, 1, 2), want64,
                   [c * inside for c in hessian_eig_plain(img32, sp)]))
    # without --fused the route is hessian_eig_features_channels, ife_tpu's
    # hessian_eig_features: the kernel's reference output, held to its twin
    # per channel (value-sorted triples would hide the order of tied
    # eigenvalues, where the two eigen paths differ)
    got = [read_volume(os.path.join(tmp, f"hessc_{n}.nii.gz")).data.to(dev)
           for n in hess_names]
    ref = [c * inside for c in hessian_eig_reference_plain(img32, sp)]
    if not bit_equal(got, ref):
        raise PhaseError("hessian-features: the files without --fused differ "
                         "from hessian_eig_reference_plain per channel")
    checks.append(("hessian-features", got, (0, 1, 2), want64, ref))
    for name, got, eig, want, twin in checks:
        for g in got:
            if tuple(g.shape) != shape or not bool(torch.isfinite(g).all()):
                raise PhaseError(f"{name}: output not finite or not {shape}")
            if bool((g[~inside] != 0).any()):
                raise PhaseError(f"{name}: nonzero output outside the mask")
        rest = [i for i in range(len(want)) if i not in eig]
        e_rest, _ = feature_errors([got[i] for i in rest],
                                   [want[i] for i in rest], ())
        e_twin, _ = feature_errors([twin[i] for i in eig],
                                   [want[i] for i in eig])
        bound = max(TOL, 2 * e_twin)
        e_eig, _ = feature_errors([got[i] for i in eig],
                                  [want[i] for i in eig], tol=bound)
        say("main", f"{name}: {len(got)} files finite, zero outside the "
            f"mask; from the f64 plain ops: other channels {e_rest:.2e}, "
            f"eigenvalues {e_eig:.2e} (sorted triples and per channel "
            f"outside ties; the kernels' f32 twins, sorted: {e_twin:.2e})")
        if e_rest > TOL or e_eig > bound:
            raise PhaseError(f"{name}: too far from the f64 plain ops")
    return launches, big_img, big_mask


def phase_bags(tmp):
    """The bag path of user entry points on the 256x256x128 NIfTI pair of
    phase_main and a second volume (seed 3), counters reset first; returns
    the counts, the wall seconds of make-bag without --device (host
    binning in the native library) and host_binning_s's split."""
    import numpy as np

    from ife_tpu_torch.cli.main import main
    from ife_tpu_torch.core.volume import Volume
    from ife_tpu_torch.io import read_hist_spec, read_rois, read_volume, write_volume
    from ife_tpu_torch.kernels import LAUNCHES, reset_launches
    from ife_tpu_torch.roi.bag import make_bag, make_bag_device
    from ife_tpu_torch.stats.equalize import determine_edges_for_equalized_histogram

    shape = CLI_SHAPE
    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    img3, _ = _inputs(shape, 3, "cpu")
    write_volume(path("img3.nii.gz"), Volume(img3, spacing=FULL_SPACING))
    with open(path("pairs.txt"), "w") as f:
        f.write(f"{path('img.nii.gz')},{path('mask.nii.gz')}\n"
                f"{path('img3.nii.gz')},{path('mask.nii.gz')}\n")
    bag_args = ["-i", path("img.nii.gz"), "-m", path("mask.nii.gz"), "-b",
                path("spec.txt"), "-s", "0.6", "2.4", "-n", "50",
                "--roi-size", "41,41,41", "--seed", "0"]
    runs = [["generate-rois", "-m", path("mask.nii.gz"), "-o", path("gen.roi"),
             "-n", "50", "--size", "41,41,41", "--seed", "0"],
            ["determine-bin-edges", "-l", path("pairs.txt"), "-o",
             path("spec.txt"), "-s", "0.6", "2.4", "--bins", "32"],
            ["make-bag", "--device", *bag_args, "-o", path("dev")],
            ["make-bag", *bag_args, "-o", path("host")]]
    torch.cuda.synchronize()
    reset_launches()
    secs = []
    for argv in runs:
        t0 = time.perf_counter()
        if main(argv) != 0:
            raise PhaseError(f"CLI {argv[0]} exited non-zero")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        secs.append(f"{' '.join(argv[:2])} {wall:.1f} s")
    host_bag_s = wall  # make-bag without --device: the native binning
    launches = dict(LAUNCHES)
    say("bags", "; ".join(secs) + f"; launches {launches}")
    missing = [k for k in BAG_PATH + dispatched_kernels((0.6, 2.4))
               if launches.get(k, 0) < 1]
    if missing:
        raise PhaseError(f"bag path launched no {missing} kernel")

    # the spec against the same pipeline through the plain twins
    spec = read_hist_spec(path("spec.txt"))
    if len(spec) != 16 or any(r.size != 31 or not np.isfinite(r).all()
                              or (np.diff(r) < 0).any() for r in spec):
        raise PhaseError("spec: not 16 finite non-decreasing rows of 31 edges")
    samples = [[] for _ in range(16)]
    for name in ("img.nii.gz", "img3.nii.gz"):
        vol = read_volume(path(name))
        fg = read_volume(path("mask.nii.gz")).data.cuda() == 1
        x = vol.data.cuda().float().contiguous()
        for i, sigma in enumerate((0.6, 2.4)):
            twin = branch_twin(x, fg.float(), sigma, vol.spacing)
            for k in range(8):
                samples[i * 8 + k].append(twin[k][fg].cpu().numpy())
    want = [determine_edges_for_equalized_histogram(
        np.sort(np.concatenate(v)), 32) for v in samples]
    if not all(np.array_equal(a, b) for a, b in zip(spec, want)):
        raise PhaseError("spec differs from the plain twins' pipeline")

    # the bags: the CLI's ROIs are generate-rois'; the device bag equals
    # the host bag within the f32 division; every histogram sums to 1
    with open(path("gen.roi")) as a, open(path("dev.ROIInfo")) as b:
        if a.read() != b.read():
            raise PhaseError("make-bag drew other ROIs than generate-rois")
    vol, mask = read_volume(path("img.nii.gz")), read_volume(path("mask.nii.gz"))
    rois = read_rois(path("dev.ROIInfo"))
    args = (vol.numpy(), mask.numpy(), [0.6, 2.4], spec, rois)
    dev_bag = make_bag_device(*args, spacing=vol.spacing)
    host_bag = make_bag(*args, spacing=vol.spacing)
    d = float(np.abs(dev_bag - host_bag).max())
    sums = dev_bag.reshape(len(rois), 16, 32).sum(-1)
    masked = np.asarray([(mask.numpy()[r.slices()] != 0).any() for r in rois])
    s_err = float(np.abs(sums[masked] - 1.0).max())
    csv = [np.loadtxt(path(f"{n}.bag"), delimiter=",") for n in ("dev", "host")]
    c_err = max(float((np.abs(c - b) / np.maximum(np.abs(b), 1e-30)).max())
                for c, b in zip(csv, (dev_bag, host_bag)))
    say("bags", f"spec equal to the plain twins' pipeline; bag {dev_bag.shape}, "
        f"device vs host max |d| {d:.3g} (<= 2^-23), histogram sums within "
        f"{s_err:.3g} of 1 ({int(masked.sum())} ROIs with mask), CSV files "
        f"within {c_err:.3g} (relative) of the bags")
    if d > 2.0 ** -23 or s_err > 1e-5 or c_err > 5.01e-6 or not masked.any():
        raise PhaseError("bags: device and host bags disagree, a histogram "
                         "does not sum to 1, or a CSV file is off")
    binning = host_binning_s(vol, mask, (0.6, 2.4), spec, rois)
    say("bags", f"make_bag's host binning alone (2 scales, {len(rois)} ROIs): "
        f"native {binning['native_s']:.3f} s, numpy {binning['numpy_s']:.3f} s, "
        "equal frequencies")
    return launches, host_bag_s, binning


def host_binning_s(vol, mask, sigmas, spec, rois):
    """make_bag's host binning alone, on the same f32 features of the card:
    the native library's one call for the 8 channels of a ROI against
    numpy's branch (_roi_frequencies a channel), in turns, the faster of
    two runs each; the frequencies must be equal. Wall seconds."""
    import numpy as np

    from ife_tpu_torch.native_lib import histogram_channels_native
    from ife_tpu_torch.ops.features import features8_auto_channels
    from ife_tpu_torch.roi.bag import _edges_block, _roi_frequencies

    img = vol.data.cuda().float().contiguous()
    fg = mask.data.cuda().clamp(0, 1).to(torch.uint8)
    inside = [(mask.numpy()[r.slices()] != 0) for r in rois]
    vox = []
    for i, sigma in enumerate(sigmas):
        feats = [c.cpu().numpy() for c in features8_auto_channels(
            img, fg, float(sigma), vol.spacing)]
        edges = _edges_block(spec, i)
        for r, m in zip(rois, inside):
            vox.append(([f[r.slices()][m] for f in feats], edges))

    def native():
        out = []
        for v, edges in vox:
            counts = histogram_channels_native(np.stack(v, axis=1), edges)
            with np.errstate(divide="ignore", invalid="ignore"):
                out.append(counts.astype(np.float64) / np.float64(len(v[0])))
        return out

    def numpy_branch():
        return [np.stack([_roi_frequencies(v[k], edges[k]) for k in range(8)])
                for v, edges in vox]

    secs = {"native_s": [], "numpy_s": []}
    for _ in range(2):
        for key, fn in (("native_s", native), ("numpy_s", numpy_branch)):
            t0 = time.perf_counter()
            got = fn()
            secs[key].append(time.perf_counter() - t0)
            if key == "native_s":
                a = got
            elif not all(np.array_equal(x, y, equal_nan=True)
                         for x, y in zip(a, got)):
                raise PhaseError("host binning: native and numpy frequencies "
                                 "differ")
    return {k: min(v) for k, v in secs.items()}


def f32_ulps(got, want):
    """Largest distance in f32 ulps of two f32 tensors (on the host)."""
    def ordered(t):
        i = t.cpu().contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(got) - ordered(want)).abs().max())


def window_pipeline(img2d, sp, mask2d, msp, order, device):
    """extract-window's function (resample, window, mask) on `device`."""
    from ife_tpu_torch.ops.transform import intensity_window, resample_to_spacing_2d

    res = resample_to_spacing_2d(img2d, sp, 0.25, order=order, device=device)
    win = intensity_window(res, -500.0, 1500.0, device=device)
    mres = resample_to_spacing_2d(mask2d.astype("float32"), msp, 0.25,
                                  order=0, device=device)
    return torch.where(mres > 0.5, win, torch.zeros_like(win)), res


def phase_tools(tmp, big_img, big_mask):
    """The 17 subcommands of the ROI, image, converter and dataset tools
    through the CLI on the card, on the 256x256x128 pair of phase_main and
    the files of phase_bags, counters reset first; the device tools' files
    against the same functions on the CPU; resample_to_grid at 512^3 on the
    card against the CPU; call ms of the device ops at 512^3. Returns the
    counts (make-bag-dense runs the features8 dispatcher's kernels)."""
    import contextlib
    import io

    import numpy as np

    from ife_tpu_torch.cli.main import main
    from ife_tpu_torch.core.volume import Volume
    from ife_tpu_torch.io import read_volume, write_hr2, write_octave, write_volume
    from ife_tpu_torch.io.hist_spec import write_hist_spec
    from ife_tpu_torch.kernels import LAUNCHES, reset_launches
    from ife_tpu_torch.ops import transform as T

    t_phase = time.perf_counter()
    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    img = read_volume(path("img.nii.gz"))
    mask = read_volume(path("mask.nii.gz"))
    shape = img.shape
    # inputs of the tools: two labels, a mask of a few hundred voxels (one
    # ROI per voxel in make-bag-dense), an intensity spec, HR2 and Octave
    # files, a target grid 0.7 x 0.7 x 1.1 mm shifted by a few mm
    m = mask.numpy()
    labels = m * (1 + (np.arange(shape[0]) >= shape[0] // 2)[:, None, None])
    write_volume(path("labels.nii.gz"), mask.with_data(
        torch.from_numpy(labels.astype(np.uint8))))
    x, y, z = np.ogrid[tuple(slice(0, n) for n in shape)]
    c = [int(f * n) for f, n in zip((0.4, 0.55, 0.47), shape)]
    small = ((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) <= 16
    write_volume(path("small.nii.gz"), mask.with_data(
        torch.from_numpy(small.astype(np.uint8))))
    write_hist_spec(path("ispec.txt"), [np.linspace(-1000.0, 0.0, 31)])
    write_hr2(path("img.hr2"), img)
    write_octave(path("small.mat"), img.with_data(img.data[:48, :40, :32]))
    write_volume(path("target.nii.gz"), Volume(
        torch.zeros((260, 250, 110)), spacing=(0.7, 0.7, 1.1),
        origin=tuple(o + d for o, d in zip(img.origin, (3.0, -2.5, 4.0)))))
    with open(path("bag_labels.csv"), "w") as f:
        f.write("1\n0\n")
    mid = shape[2] // 2  # the axial slice of extract-slices
    info_argv = ["image-browser", "-i", path("img.nii.gz"), "--cmd", "info"]
    dist_argv = ["expected-distance", "-m", path("mask.nii.gz"), "-p",
                 path("mask.nii.gz")]
    runs = [
        ["make-bag-dense", "-i", path("img.nii.gz"), "-m", path("small.nii.gz"),
         "-b", path("spec.txt"), "-s", "0.6", "2.4", "--roi-size", "5,5,5",
         "-o", path("dense")],
        ["make-bag-only-intensity", "-i", path("img.nii.gz"), "-m",
         path("mask.nii.gz"), "-b", path("ispec.txt"), "-n", "50", "--seed",
         "0", "-o", path("ibag")],
        ["generate-rois-many-regions", "-m", path("labels.nii.gz"), "-o",
         path("many"), "-n", "50", "--size", "9,9,9", "--seed", "0"],
        ["sample-rois", "-i", path("img.nii.gz"), "-r", path("many_1.ROIInfo"),
         "-o", path("samples.csv")],
        ["extract-labels", "-l", path("labels.nii.gz"), "-r",
         path("many_2.ROIInfo"), "--ignore", "0", "-o", path("labels.txt")],
        info_argv,
        ["image-browser", "-i", path("img.nii.gz"), "--cmd", "hist"],
        ["image-browser", "-i", path("mask.nii.gz"), "--cmd", "coverage",
         "--coverage-samples", "100"],
        ["convert-hr2", path("img.hr2"), path("hr2.nii.gz")],
        ["convert-from-octave", path("small.mat"), path("oct.nii.gz")],
        ["merge-bags", "-b", path("dev.bag"), path("host.bag"), "--bag-labels",
         path("bag_labels.csv"), "-o", path("merged.npz")],
        dist_argv,
        ["masked-image-filter", "-i", path("img.nii.gz"), "-m",
         path("mask.nii.gz"), "--outside", "-1024", "-o", path("mif.nii.gz")],
        ["extract-masked-region", "-m", path("labels.nii.gz"), "--include", "2",
         "-o", path("emr.nii.gz")],
        ["extract-bounding-box", "-i", path("img.nii.gz"), "-m",
         path("small.nii.gz"), "-o", path("ebb.nii.gz")],
        ["extract-slices", "-i", path("img.nii.gz"), "--indices", str(mid),
         "-o", path("slc")],
        ["extract-slices", "-i", path("mask.nii.gz"), "--indices", str(mid),
         "-o", path("mslc")],
        ["extract-slices", "-i", path("img.nii.gz"), "--axis", "0",
         "--fractions", "0.5", "--window", "1", "-o", path("xslc")],
        *(["extract-window", "-i", path(f"slc_{mid}.nii.gz"), "--mask",
           path(f"mslc_{mid}.nii.gz"), "-b", str(b), "-o",
           path(f"win{b}.nii.gz")] for b in (0, 1, 3)),
        ["pad-image", "-i", path(f"slc_{mid}.nii.gz"), "--size", "300,300",
         "--value", "-1024", "-o", path("pad.nii.gz")],
        ["resample", "-s", path("img.nii.gz"), "-t", path("target.nii.gz"),
         "--nearest", "--default-value", "-1024", "-o", path("rs0.nii.gz")],
        ["resample", "-s", path("img.nii.gz"), "-t", path("target.nii.gz"),
         "--default-value", "-1024", "-o", path("rs1.nii.gz")],
    ]
    names = sorted({r[0] for r in runs})
    if len(names) != 17:
        raise PhaseError(f"tools: {len(names)} subcommands, not 17: {names}")
    torch.cuda.synchronize()
    reset_launches()
    secs, printed = [], {}
    for argv in runs:
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        torch.cuda.synchronize()
        if rc != 0:
            raise PhaseError(f"CLI {argv[0]} exited {rc}")
        secs.append(f"{argv[0]} {time.perf_counter() - t0:.2f}")
        printed[tuple(argv)] = out.getvalue()
    launches = dict(LAUNCHES)
    card = card_line()
    say("tools", f"CLI wall s at {shape} ({card}): " + "; ".join(secs))
    say("tools", f"launches {launches}")
    missing = [k for k in dispatched_kernels((0.6, 2.4))
               if launches.get(k, 0) < 1]
    if missing:
        raise PhaseError(f"make-bag-dense launched no {missing} kernel")
    info = printed[tuple(info_argv)]
    dist = float(printed[tuple(dist_argv)])
    if "dtype: float32" not in info or not np.isfinite(dist) or dist <= 0:
        raise PhaseError(f"tools: image-browser info {info!r} or "
                         f"expected-distance {dist}")
    n_dense = len(open(path("dense.ROIInfo")).read().splitlines())
    dense = np.loadtxt(path("dense.bag"), delimiter=",", ndmin=2)
    if not 100 <= n_dense == dense.shape[0] or dense.shape[1] != 16 * 32:
        raise PhaseError(f"make-bag-dense: {n_dense} ROIs, bag {dense.shape}")
    with np.load(path("merged.npz")) as z:
        if z["instances"].shape != (100, 512):
            raise PhaseError(f"merge-bags: {z['instances'].shape}")

    # the device tools' files against the same functions on the CPU
    def data(name):
        return read_volume(path(name)).data

    checks = {
        "masked-image-filter": torch.equal(
            data("mif.nii.gz"), T.mask_image(img.data, mask.data, -1024.0,
                                             device="cpu")),
        "extract-masked-region": torch.equal(
            data("emr.nii.gz"), T.relabel_mask(torch.from_numpy(
                labels.astype(np.uint8)), [2], device="cpu")),
    }
    tgt = read_volume(path("target.nii.gz"))
    rs = {o: T.resample_to_grid(img, tgt, o, -1024.0, device="cpu")
          for o in (0, 1)}
    checks["resample --nearest"] = torch.equal(data("rs0.nii.gz"), rs[0].data)
    rs_ulps = f32_ulps(data("rs1.nii.gz"), rs[1].data)
    checks["resample"] = rs_ulps <= 1
    slc = read_volume(path(f"slc_{mid}.nii.gz"))
    mslc = read_volume(path(f"mslc_{mid}.nii.gz"))
    win_ulps = {}
    for b in (0, 1):
        want, res_cpu = window_pipeline(slc.numpy()[..., 0], slc.spacing[:2],
                                        mslc.numpy()[..., 0], mslc.spacing[:2],
                                        b, "cpu")
        got = data(f"win{b}.nii.gz")[..., 0]
        _, res_card = window_pipeline(slc.numpy()[..., 0], slc.spacing[:2],
                                      mslc.numpy()[..., 0], mslc.spacing[:2],
                                      b, "cuda")
        win_ulps[b] = f32_ulps(res_card, res_cpu)
        differ = got != want
        if b == 0:
            checks[f"extract-window -b {b}"] = not bool(differ.any())
        else:
            # a window value may differ only where the order-1 value lies
            # within 1e-5 of a half before rounding
            y = (res_cpu.double() + 1250.0) / 1500.0 * 255.0
            near = ((y - y.floor() - 0.5).abs() <= 1e-5)
            checks[f"extract-window -b {b}"] = (
                win_ulps[b] <= 1 and not bool((differ & ~near).any()))
    say("tools", "files against the CPU: " + "; ".join(
        f"{k} {'equal' if v else 'DIFFER'}" for k, v in checks.items())
        + f"; resample order 1 within {rs_ulps} ulp, extract-window's "
        f"resample on the card within {win_ulps} ulp of the CPU; "
        f"make-bag-dense {n_dense} ROIs; expected distance {dist:.6g}")
    if not all(checks.values()):
        raise PhaseError("tools: a device tool's file differs from the CPU")

    # 512^3: resample_to_grid onto a 0.7 x 0.7 x 1.1 mm grid shifted by a
    # few mm (some outputs outside the source take cval), card against CPU;
    # then call ms of the device ops
    src = Volume(big_img, spacing=FULL_SPACING)
    tgt = Volume(torch.zeros(1, device="cuda").expand(FULL), spacing=(0.7, 0.7, 1.1),
                 origin=(3.0, -2.5, 4.0))
    src_cpu = Volume(big_img.cpu(), spacing=FULL_SPACING)
    full = []
    for order in (0, 1):
        got = T.resample_to_grid(src, tgt, order, -1024.0, device="cuda").data
        t0 = time.perf_counter()
        want = T.resample_to_grid(src_cpu, tgt, order, -1024.0,
                                  device="cpu").data
        cpu_s = time.perf_counter() - t0
        ulps = f32_ulps(got, want)
        outside = float((want == -1024.0).double().mean())
        full.append(f"order {order}: {ulps} ulp from the CPU ({cpu_s:.1f} s "
                    f"there), {outside:.3f} of outputs all cval")
        if ulps > (1 if order else 0) or not 0 < outside < 1:
            raise PhaseError(f"resample_to_grid order {order} at 512^3: "
                             f"{ulps} ulp from the CPU, cval share {outside}")
        del got, want
    say("tools", f"512^3 resample_to_grid on the card ({card}): "
        + "; ".join(full))
    big_labels = (big_mask * (1 + (torch.arange(FULL[0], device="cuda")
                                   >= FULL[0] // 2)[:, None, None])
                  ).to(torch.uint8)
    times = {
        "resample_to_grid order 0": lambda: T.resample_to_grid(
            src, tgt, 0, -1024.0, device="cuda"),
        "resample_to_grid order 1": lambda: T.resample_to_grid(
            src, tgt, 1, -1024.0, device="cuda"),
        "mask_image": lambda: T.mask_image(big_img, big_mask, -1024.0,
                                           device="cuda"),
        "relabel_mask": lambda: T.relabel_mask(big_labels, [2], device="cuda"),
        "intensity_window": lambda: T.intensity_window(big_img, device="cuda"),
    }
    ms = {k: cuda_ms(fn) for k, fn in times.items()}
    say("tools", f"512^3 f32 call ms (median, min, max of 5; {card}): "
        + "; ".join(f"{k} {v[0]:.3f} ({v[1]:.3f}-{v[2]:.3f})"
                    for k, v in ms.items()))
    del big_labels
    torch.cuda.empty_cache()
    say("tools", f"phase {time.perf_counter() - t_phase:.1f} s ({card})")
    return launches


# the dicom phase's series: a slab of a chest CT, each series in its own
# transfer syntax; the Python encoders take seconds a 512^2 slice, so each
# codec encodes DICOM_DISTINCT slices and the files reuse their frames.
# Each converted series is one gzip-9 write of its f32 volume (~100 s at
# DICOM_SHAPE): the default run converts DICOM_SMOKE_SHAPE, the same 512^2
# slices a quarter as deep, and --dicom the full size
DICOM_SHAPE = (512, 512, 128)     # rows, columns, slices of a series
DICOM_SMOKE_SHAPE = (512, 512, 32)
DICOM_SPACING = (0.7, 0.7, 1.25)  # row and column spacing, slice step (mm)
DICOM_DISTINCT = 4
DICOM_SERIES = (  # patient id (it names the file), transfer syntax
    ("CHEST-RAW", "1.2.840.10008.1.2.1"),     # explicit VR little endian
    ("CHEST-JLL", "1.2.840.10008.1.2.4.70"),  # JPEG Lossless SV1
    ("CHEST-JLS", "1.2.840.10008.1.2.4.80"),  # JPEG-LS lossless
)
DICOM_SIGMA = 1.2


def _dicom_element(group, el, vr, value):
    """One explicit-VR little-endian data element."""
    import struct

    if len(value) % 2:
        value += b"\x00" if vr in (b"OB", b"OW", b"UI") else b" "
    if vr in (b"OB", b"OW"):
        return struct.pack("<HH2sHI", group, el, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, el, vr, len(value)) + value


def ct_stored_slices(n, rows, cols, seed):
    """n chest-CT slices as stored int16 values (HU + 1024; slope 1,
    intercept -1024): air, a body of soft tissue, two lungs that change
    size along z, a vertebra, quantum noise of 20 HU."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y, x = np.ogrid[:rows, :cols]
    out = []
    for i in range(n):
        hu = np.full((rows, cols), -1000.0)
        body = (((y - rows / 2) / (0.42 * rows)) ** 2
                + ((x - cols / 2) / (0.47 * cols)) ** 2) <= 1
        hu[body] = 40.0
        ry = 0.28 * rows * (0.85 + 0.1 * i / max(n - 1, 1))
        for cx in (0.3, 0.7):
            lung = (((y - 0.47 * rows) / ry) ** 2
                    + ((x - cx * cols) / (0.13 * cols)) ** 2) <= 1
            hu[lung] = -850.0
        hu[((y - 0.78 * rows) ** 2 + (x - cols / 2) ** 2) <= (0.05 * rows) ** 2] = 700.0
        hu += rng.normal(0.0, 20.0, hu.shape)
        out.append(np.clip(np.rint(hu + 1024.0), 0, 4095).astype(np.int16))
    return out


def dicom_slice_bytes(ts, stored, z, patient, uid, frame=None):
    """A single-frame file of a series: `stored` (rows, cols) int16 raw, or
    `frame` (the compressed frame) encapsulated in two fragments past an
    empty Basic Offset Table (PS3.5 A.4)."""
    import struct

    rows, cols = stored.shape
    el = _dicom_element
    if frame is None:
        pixel = el(0x7FE0, 0x0010, b"OW", stored.tobytes())
    else:
        cut = (len(frame) // 2) & ~1
        items = [struct.pack("<HHI", 0xFFFE, 0xE000, 0)]
        for frag in (frame[:cut], frame[cut:]):
            if len(frag) % 2:
                frag += b"\x00"
            items.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag)
        items.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
        pixel = struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0,
                            0xFFFFFFFF) + b"".join(items)
    body = b"".join([
        el(0x0008, 0x0020, b"DA", b"20261017"),
        el(0x0010, 0x0020, b"LO", patient.encode()),
        el(0x0018, 0x0050, b"DS", f"{DICOM_SPACING[2]:g}".encode()),
        el(0x0018, 0x1210, b"SH", b"B30f"),
        el(0x0020, 0x000E, b"UI", uid.encode()),
        el(0x0020, 0x0032, b"DS", f"-179.3\\-179.3\\{z:g}".encode()),
        el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        el(0x0028, 0x0030, b"DS", f"{DICOM_SPACING[0]:g}\\{DICOM_SPACING[1]:g}"
           .encode()),
        el(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        el(0x0028, 0x0103, b"US", struct.pack("<H", 1)),
        el(0x0028, 0x1052, b"DS", b"-1024"),
        el(0x0028, 0x1053, b"DS", b"1"),
        pixel,
    ])
    meta = el(0x0002, 0x0010, b"UI", ts.encode())
    return b"\x00" * 128 + b"DICM" + meta + body


def write_dicom_dir(root, shape, distinct, seed=0):
    """One directory of the DICOM_SERIES, each `shape` (rows, columns,
    slices), slice i holding distinct slice i % distinct at z = i x the
    slice step, the files named in another order than z. Returns the
    distinct stored slices, each series' frames (None for raw) and the
    seconds the encoders took."""
    from ife_tpu_torch.io.jpegll import encode_jpeg_lossless
    from ife_tpu_torch.io.jpegls import encode_jpegls

    rows, cols, n = shape
    stored = ct_stored_slices(distinct, rows, cols, seed)
    encoders = {"1.2.840.10008.1.2.1": None,
                "1.2.840.10008.1.2.4.70": encode_jpeg_lossless,
                "1.2.840.10008.1.2.4.80": encode_jpegls}
    frames, enc_s = {}, {}
    os.makedirs(root, exist_ok=True)
    for k, (patient, ts) in enumerate(DICOM_SERIES):
        enc = encoders[ts]
        t0 = time.perf_counter()
        frames[patient] = None if enc is None else [
            enc(s.view("uint16"), precision=16) for s in stored]
        enc_s[patient] = time.perf_counter() - t0
        uid = dicom_uid(k)
        for i in range(n):
            j = i % distinct
            data = dicom_slice_bytes(
                ts, stored[j], i * DICOM_SPACING[2], patient, uid,
                None if enc is None else frames[patient][j])
            # file names in reverse z order: the reader sorts by position
            with open(os.path.join(root, f"{patient}_{n - 1 - i:04d}.dcm"),
                      "wb") as f:
                f.write(data)
    return stored, frames, enc_s


def dicom_expected_volume(stored, n):
    """The float32 (X, Y, Z) volume the series hold: stored * 1 - 1024,
    columns on x, rows on y, slices on z."""
    import numpy as np

    planes = [stored[i % len(stored)].astype(np.float32) - 1024.0
              for i in range(n)]
    return np.ascontiguousarray(np.stack(planes).transpose(2, 1, 0))


def dicom_uid(k):
    """SeriesInstanceUID of series k of DICOM_SERIES."""
    return f"1.2.826.0.1.3680043.2.1143.{k + 1}"


def dicom_file_name(patient):
    return f"{patient}_20261017_B30f_{DICOM_SPACING[2]:g}.nii.gz"


def deriche_yardstick():
    """The FIR smoothing of the port (ops.stencil.gaussian_smooth) on the
    card in f64 against the reference's IIR smoother (ops.deriche, on the
    host) on a 48^3 CT: the bounds of tests/test_torch_deriche.py. Returns
    {sigma: [fir-iir, fir-exact, iir-exact]}, relative to the value scale."""
    import numpy as np

    from ife_tpu_torch.core.volume import synthetic_ct
    from ife_tpu_torch.ops.deriche import deriche_gaussian_smooth
    from ife_tpu_torch.ops.stencil import gaussian_smooth

    sp = (0.78, 0.78, 1.0)
    ct = synthetic_ct((48, 48, 48), seed=3, dtype=torch.float64)
    x = ct.data.numpy()
    scale = float(np.abs(x).max())
    dev = ct.data.cuda()
    out = {}
    for sigma, bound in ((0.6, 3e-4), (1.2, 3e-4), (4.8, 1e-4)):
        fir = gaussian_smooth(dev, sigma, sp)
        exact = gaussian_smooth(dev, sigma, sp, truncate=12.0).cpu().numpy()
        cpu = gaussian_smooth(ct.data, sigma, sp).numpy()
        fir = fir.cpu().numpy()
        iir = deriche_gaussian_smooth(x, sigma, sp)
        d = [float(np.abs(fir - iir).max() / scale),
             float(np.abs(fir - exact).max() / scale),
             float(np.abs(iir - exact).max() / scale)]
        card_cpu = float(np.abs(fir - cpu).max() / scale)
        if not (d[0] < bound and d[1] < 1e-5 and d[1] < d[2]
                and card_cpu < 1e-12):
            raise PhaseError(f"deriche: sigma {sigma}: fir-iir {d[0]:.3g} "
                             f"(bound {bound}), fir-exact {d[1]:.3g}, "
                             f"iir-exact {d[2]:.3g}, card-cpu {card_cpu:.3g}")
        out[sigma] = d + [card_cpu]
    return out


def phase_dicom(tmp, shape, make_bag_s, binning):
    """convert-dicom through the CLI on a directory of three CT series of
    `shape` (raw, fragmented JPEG Lossless, JPEG-LS), the native
    decoders' counters reset first: every file equal to the expected
    float32 volume with its spacing and name, every compressed frame
    decoded natively with no fallback, the native decoders equal to the
    Python ones on a frame of each codec; then extract-features on a
    converted volume on the card, bit-equal to the same pass on the
    in-memory volume (and that pass to its plain twin), the launch
    counters reset first; the Deriche yardstick. Prints the {"dicom": ...}
    line; returns the kernel launches of extract-features."""
    import numpy as np

    from ife_tpu_torch import native_lib
    from ife_tpu_torch.cli.main import main
    from ife_tpu_torch.core.volume import Volume, sphere_mask
    from ife_tpu_torch.io import read_volume, write_volume
    from ife_tpu_torch.io.jpegll import decode_jpeg_lossless
    from ife_tpu_torch.io.jpegls import decode_jpegls
    from ife_tpu_torch.kernels import LAUNCHES, reset_launches
    from ife_tpu_torch.ops.features import (FEATURE_NAMES,
                                            features8_auto_channels,
                                            features8_dispatch_branch)
    from ife_tpu_torch.utils.profiling import global_metrics

    t_phase = time.perf_counter()
    card = card_line()
    rows, cols, n = shape
    src, out = os.path.join(tmp, "dicom"), os.path.join(tmp, "dicom_nii")
    t0 = time.perf_counter()
    stored, frames, enc_s = write_dicom_dir(src, shape, DICOM_DISTINCT)
    build_s = time.perf_counter() - t0

    # the native decoders against the Python ones on a frame of each codec
    # (these calls are not the path's: the counters are reset below)
    decode_ms = {}
    for patient, native, python in (
            ("CHEST-JLL", native_lib.jll_decode_native, decode_jpeg_lossless),
            ("CHEST-JLS", native_lib.jls_decode_native, decode_jpegls)):
        frame = frames[patient][0]
        t0 = time.perf_counter()
        a = native(frame, rows, cols)
        t1 = time.perf_counter()
        b = python(frame)
        t2 = time.perf_counter()
        if not (np.array_equal(a, b) and np.array_equal(a, stored[0].view("uint16"))):
            raise PhaseError(f"dicom: {patient}: the native decoder differs "
                             "from the Python decoder or the slice")
        decode_ms[patient] = {"native": (t1 - t0) * 1e3, "python": (t2 - t1) * 1e3,
                              "frame_bytes": len(frame)}

    native_lib.reset_counts()
    first = len(global_metrics().records)
    t0 = time.perf_counter()
    if main(["convert-dicom", "-d", src, "-o", out]) != 0:
        raise PhaseError("CLI convert-dicom exited non-zero")
    convert_s = time.perf_counter() - t0
    calls, fallbacks = dict(native_lib.CALLS), dict(native_lib.FALLBACKS)
    if (calls["jll_decode"] != n or calls["jls_decode"] != n
            or any(fallbacks.values())):
        raise PhaseError(f"dicom: native decodes {calls}, fallbacks "
                         f"{fallbacks}: want {n} of each codec, no fallback")
    spans = {r.name: r.seconds for r in global_metrics().records[first:]}

    want = dicom_expected_volume(stored, n)
    spacing = tuple(float(np.float32(s)) for s in
                    (DICOM_SPACING[1], DICOM_SPACING[0], DICOM_SPACING[2]))
    names = sorted(os.listdir(out))
    if names != sorted(dicom_file_name(p) for p, _ in DICOM_SERIES):
        raise PhaseError(f"dicom: convert-dicom wrote {names}")
    series = {}
    for k, (patient, ts) in enumerate(DICOM_SERIES):
        vol = read_volume(os.path.join(out, dicom_file_name(patient)))
        got = vol.numpy()
        if (got.dtype != np.float32 or not np.array_equal(got, want)
                or vol.spacing != spacing):
            raise PhaseError(f"dicom: {patient}: volume or spacing "
                             f"{vol.spacing} differs from the series")
        decode_s = spans[f"convert-dicom decode {dicom_uid(k)}"]
        write_s = spans[f"convert-dicom write {dicom_uid(k)}"]
        series[patient] = {
            "transfer_syntax": ts, "wall_s": decode_s + write_s,
            "decode_s": decode_s, "write_s": write_s,
            "encode_s": enc_s[patient]}
    say("dicom", f"{len(DICOM_SERIES)} series of {rows}x{cols}x{n} int16 "
        f"(built in {build_s:.1f} s), convert-dicom {convert_s:.1f} s: "
        + "; ".join(f"{p} decode {s['decode_s']:.2f} s, gzip-9 write "
                    f"{s['write_s']:.2f} s" for p, s in series.items())
        + f"; native decodes {calls}, fallbacks {fallbacks}; every file "
        "equal to the series")

    # a converted volume into the card's feature pass through the CLI
    img_path = os.path.join(out, dicom_file_name("CHEST-JLS"))
    vol = read_volume(img_path)
    mask = sphere_mask(vol.shape, 0.4, dtype=torch.uint8)
    write_volume(os.path.join(tmp, "dicom_mask.nii.gz"),
                 Volume(mask.data, spacing=vol.spacing))
    prefix = os.path.join(tmp, "dicom_feat")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    if main(["extract-features", "-i", img_path, "-m",
             os.path.join(tmp, "dicom_mask.nii.gz"), "-o", prefix, "-s",
             f"{DICOM_SIGMA:g}"]) != 0:
        raise PhaseError("CLI extract-features exited non-zero")
    torch.cuda.synchronize()
    features_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    branch = features8_dispatch_branch(DICOM_SIGMA, vol.spacing, vol.shape)
    missing = [k for k in BRANCH_KERNELS[branch] if launches[k] < 1]
    if missing:
        raise PhaseError(f"dicom: extract-features launched no {missing}")
    # the in-memory pass: the series' own volume, the mask as the CLI read it
    img = torch.from_numpy(want).cuda()
    m = read_volume(os.path.join(tmp, "dicom_mask.nii.gz")).data.cuda()
    mem = features8_auto_channels(img, m, DICOM_SIGMA, vol.spacing)
    twin = branch_twin(img, m.float(), DICOM_SIGMA, vol.spacing)
    for k, fname in enumerate(FEATURE_NAMES):
        got = read_volume(f"{prefix}_scale_{DICOM_SIGMA:g}{fname}.nii.gz").data
        if not (torch.equal(got, mem[k].cpu()) and torch.equal(mem[k], twin[k])):
            raise PhaseError(f"dicom: {fname}: the CLI's file differs from the "
                             "in-memory pass, or that pass from its twin")
    del img, m, mem, twin
    torch.cuda.empty_cache()
    say("dicom", f"extract-features -s {DICOM_SIGMA:g} on {dicom_file_name('CHEST-JLS')}"
        f" ({branch}) {features_s:.1f} s, the 8 files equal to the in-memory "
        f"pass and its twin to the bit; launches {launches}")

    deriche = deriche_yardstick()
    say("dicom", "Deriche yardstick (48^3 f64, spacing 0.78/0.78/1.0; "
        "fir-iir, fir-exact, iir-exact, card-cpu relative to the value "
        "scale): " + "; ".join(f"sigma {s:g} " + " ".join(f"{v:.3g}" for v in d)
                               for s, d in deriche.items()))
    phase_s = time.perf_counter() - t_phase
    print(json.dumps({"dicom": {
        "card": card, "shape": list(shape), "series": series,
        "convert_dicom_s": convert_s, "build_series_s": build_s,
        "decode_ms_512": decode_ms, "native_calls": calls,
        "native_fallbacks": fallbacks, "extract_features_s": features_s,
        "extract_features_branch": branch, "make_bag_host_s": make_bag_s,
        "host_binning_s": binning,
        "deriche": {f"{s:g}": d for s, d in deriche.items()},
        "phase_s": phase_s}}), flush=True)
    say("dicom", f"phase {phase_s:.1f} s ({card})")
    return launches


def config3_stack(img, mask, sp=FULL_SPACING):
    """The four-scale feature stack of bench.py config 3 as its multi_fused
    composes it on the accelerator: the two small scales through the sweep
    (here one fused_features8_sweep_multi launch), the two large ones
    through multiscale_features8_fused. Four tuples of eight channels, in
    the order of SIGMAS."""
    from ife_tpu_torch.kernels import fused_features8_sweep_multi
    from ife_tpu_torch.ops.features import multiscale_features8_fused

    small = fused_features8_sweep_multi(img, mask, SWEEP_SIGMAS, sp,
                                        stack=False)
    large = multiscale_features8_fused(img, mask, YS_SIGMAS, sp, stack=False)
    return tuple(small) + tuple(large)


def per_scale_stack(img, mask, sp=FULL_SPACING):
    """The same four scales, one features8 pass each."""
    from ife_tpu_torch.ops.features import features8_auto_channels

    return tuple(features8_auto_channels(img, mask, s, sp) for s in SIGMAS)


def phase_multiscale(big_img, big_mask):
    """The multi-scale path of user entry points, counters reset first;
    returns the counts. At 256x256x128 every scale is held against the
    plain f64 ops and against the per-scale pass on the same card; at 512^3
    the stack is run for its shape and finiteness."""
    from ife_tpu_torch.kernels import (
        LAUNCHES, fused_features8_post, fused_normalized_conv_sweep_tiled,
        reset_launches,
    )
    from ife_tpu_torch.ops.features import (
        clamp_mask, features8, features8_auto_channels,
        multiscale_features8_fused,
    )

    shape, sp = (256, 256, 128), FULL_SPACING
    img, mask = _inputs(shape, 1, "cuda")
    torch.cuda.synchronize()
    reset_launches()
    pair = multiscale_features8_fused(img, mask, YS_SIGMAS, sp, stack=True)
    if LAUNCHES["features8_ys_multi"] != 1 or LAUNCHES["smooth_xz"] != 2:
        raise PhaseError("multiscale_features8_fused: expected one "
                         f"features8_ys_multi launch, counted {dict(LAUNCHES)}")
    if tuple(pair.shape) != (2, 8) + shape:
        raise PhaseError(f"multiscale_features8_fused: shape {tuple(pair.shape)}")
    stack = config3_stack(img, mask)
    # sigma 4.8 once more, through the Y-tiled normalized convolution and the
    # windowed post kernel (the staged tier's other two entries)
    mf = clamp_mask(mask).float().contiguous()
    staged = fused_features8_post(
        fused_normalized_conv_sweep_tiled(img, mf, 4.8, sp, n_tiles=3), mf,
        sp, stack=False)
    big = config3_stack(big_img, big_mask)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for g in big:
        for c in g:
            if tuple(c.shape) != FULL or not bool(torch.isfinite(c).all()):
                raise PhaseError("config-3 stack at 512^3: output not finite "
                                 f"or not {FULL}")
    del big
    torch.cuda.empty_cache()
    say("multiscale", f"launches {launches}")
    missing = [k for k in MULTISCALE_PATH if launches.get(k, 0) < 1]
    if missing:
        raise PhaseError(f"multi-scale path launched no {missing} kernel")
    if launches["features8_ys_multi"] != 3:
        raise PhaseError("three multiscale_features8_fused calls should make "
                         "three features8_ys_multi launches")

    inside = mask != 0
    for i, sigma in enumerate(YS_SIGMAS):
        if not bit_equal(stack[2 + i], pair[i].unbind(0)):
            raise PhaseError("multiscale_features8_fused: stacked and "
                             "unstacked forms differ")
    single = features8_auto_channels(img, mask, 4.8, sp)
    if not bit_equal(staged, single):
        raise PhaseError("tiled nc + windowed post differ from the sigma-4.8 "
                         "pass of features8_auto_channels")
    # every scale against the plain f64 ops (trig eigen path): within TOL,
    # or no farther from f64 than twice the per-scale f32 pass on the same
    # card. The f32 smoothing leaves ~1e-6 of |s| in s, which the second
    # differences of a wide sigma (small derivatives, h^2 = 0.6) magnify
    # beyond 1e-4 of their own scale in any f32 implementation
    # (docs/design.md "Precision policy"); sorted eigenvalues add the
    # sqrt(ulp) floor near repeated eigenvalues, as in phase_main. The
    # distance from the per-scale pass itself is printed.
    eig, rest = (2, 3, 4), (0, 1, 5, 6, 7)

    def errors(a, b, tol=None):
        return (feature_errors([a[i] for i in rest], [b[i] for i in rest], ())[0],
                feature_errors([a[i] for i in eig], [b[i] for i in eig],
                               tol=tol)[0])

    for got, sigma in zip(stack, SIGMAS):
        for c in got:
            if tuple(c.shape) != shape or not bool(torch.isfinite(c).all()):
                raise PhaseError(f"stack s={sigma}: not finite or not {shape}")
            if bool((c[~inside] != 0).any()):
                raise PhaseError(f"stack s={sigma}: nonzero outside the mask")
        want = features8(img.double(), mask, sigma, sp).unbind(-1)
        one = features8_auto_channels(img, mask, sigma, sp)
        o_rest, o_eig = errors(one, want)
        e_rest, e_eig = errors(got, want, max(TOL, 2 * o_eig))
        d_rest, d_eig = errors(got, one)
        say("multiscale", f"s={sigma}: from the f64 plain ops: other channels "
            f"{e_rest:.2e}, eigenvalues {e_eig:.2e} (sorted triples and per "
            f"channel outside ties; the per-scale pass: {o_rest:.2e}, "
            f"{o_eig:.2e} sorted); from the per-scale pass: "
            f"{d_rest:.2e}, {d_eig:.2e}")
        if e_rest > max(TOL, 2 * o_rest) or e_eig > max(TOL, 2 * o_eig):
            raise PhaseError(f"multi-scale stack s={sigma}: too far from the "
                             "f64 plain ops")
        del want, one
    return launches


GRAFT_PATH = ("features8_sweep", "features8_sweep_clamps", "histogram")


def phase_graft():
    """graft_entry_torch.py's two entry points on the card, counters reset
    first: entry()'s fn on its 64^3 inputs (the sweep kernel), then
    dryrun_multichip(4) and dryrun_step(4) (a 2 x 2 block mesh in this
    process: the sweep with clamps, the histogram kernel). fn's output
    against the plain f64 ops and the sweep's twin; the gathered features at
    both scales bit-equal to the sweep's twin and to the single-device
    kernel on the whole volume, the counts equal to the plain histogram
    (searchsorted and scatter_add) of the gathered smoothed channel.
    Returns the counts."""
    import graft_entry_torch as G
    from ife_tpu_torch.core.volume import sphere_mask, synthetic_ct
    from ife_tpu_torch.kernels import (
        LAUNCHES, features8_sweep_plain, reset_launches,
    )
    from ife_tpu_torch.ops.features import features8, features8_auto_channels
    from ife_tpu_torch.stats.histogram import histogram_counts_plain

    reset_launches()
    fn, (img, mask) = G.entry()
    got = fn(img, mask)
    G.dryrun_multichip(4)
    feats, counts, dims = G.dryrun_step(4)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    say("graft", f"entry() on {img.device}, dryrun_multichip(4) and "
        f"dryrun_step(4) on a {dims} mesh: launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    missing = [k for k in GRAFT_PATH if launches.get(k, 0) < 1]
    if missing:
        raise PhaseError(f"graft_entry_torch launched no {missing} kernel")

    if tuple(got.shape) != G.ENTRY_SHAPE + (8,) or got.device.type != "cuda":
        raise PhaseError(f"entry: output {tuple(got.shape)} on {got.device}")
    chans = got.unbind(-1)
    if not all(bool(torch.isfinite(c).all()) for c in chans):
        raise PhaseError("entry: output not finite")
    if bool(got[mask == 0].any()):
        raise PhaseError("entry: nonzero output outside the mask")
    twin = features8_sweep_plain(img, mask, G.ENTRY_SIGMA, G.ENTRY_SPACING)
    if not bit_equal(chans, twin):
        raise PhaseError("entry: differs from the sweep's plain twin")
    # against the plain f64 ops: every channel but the eigenvalues within
    # TOL; the eigenvalues, whose value-sorted f32 triples carry a sqrt(ulp)
    # floor at the synthetic CT's ties (as in phase_main), within TOL or
    # twice the plain f32 ops' distance, also per channel outside ties
    rest, eig = (0, 1, 5, 6, 7), (2, 3, 4)
    want = features8(img.double(), mask, G.ENTRY_SIGMA,
                     G.ENTRY_SPACING).unbind(-1)
    plain32 = features8(img, mask, G.ENTRY_SIGMA, G.ENTRY_SPACING).unbind(-1)
    e_rest, _ = feature_errors([chans[i] for i in rest],
                               [want[i] for i in rest], ())
    e_plain, _ = feature_errors([plain32[i] for i in eig],
                                [want[i] for i in eig])
    bound = max(TOL, 2 * e_plain)
    e_eig, _ = feature_errors([chans[i] for i in eig], [want[i] for i in eig],
                              tol=bound)
    if e_rest > TOL or e_eig > bound:
        raise PhaseError(f"entry: {e_rest:.2e} / {e_eig:.2e} (eigenvalues) "
                         f"from the f64 plain ops")

    shape = tuple(feats.shape[:3])
    vol = synthetic_ct(shape, seed=1, device="cuda").data
    msk = sphere_mask(shape, 0.45, device="cuda").data
    for i, sigma in enumerate(G.DRYRUN_SIGMAS):
        got_s = feats[..., i, :].unbind(-1)
        if not bit_equal(got_s, features8_sweep_plain(vol, msk, sigma,
                                                      G.DRYRUN_SPACING)):
            raise PhaseError(f"dryrun_step(4) s={sigma}: differs from the "
                             "sweep's plain twin on the whole volume")
        if not bit_equal(got_s, features8_auto_channels(vol, msk, sigma,
                                                        G.DRYRUN_SPACING)):
            raise PhaseError(f"dryrun_step(4) s={sigma}: differs from the "
                             "single-device kernel")
    want_counts = histogram_counts_plain(feats[..., 0, 0], G.DRYRUN_EDGES,
                                         (msk != 0).to(torch.int32))
    if not torch.equal(counts, want_counts):
        raise PhaseError(f"dryrun_step(4): counts {counts.tolist()} against "
                         f"the plain histogram {want_counts.tolist()}")
    say("graft", f"entry: bit-equal to the sweep's twin; from the f64 plain "
        f"ops: other channels {e_rest:.2e}, eigenvalues {e_eig:.2e} (sorted "
        f"triples and per channel outside ties; the plain f32 ops, sorted: "
        f"{e_plain:.2e}); dryrun {shape} at sigma {G.DRYRUN_SIGMAS}: "
        "bit-equal to the sweep's twin and to the single-device kernel, "
        f"counts {counts.tolist()} equal to the plain histogram of the "
        "gathered smoothed channel")
    return launches


def _expect_launches(label, want):
    """Raise unless the launch counters hold exactly `want` (every other
    counter 0): a route that silently took another kernel, or a plain twin,
    fails here."""
    from ife_tpu_torch.kernels import LAUNCHES

    got = {k: v for k, v in LAUNCHES.items() if v}
    if got != want:
        raise PhaseError(f"{label}: launches {got}, expected {want}")


def _gathered(chans):
    from ife_tpu_torch.parallel import gather_volume

    return [gather_volume(c) for c in chans]


def sharded_feature_checks(img, mask, mesh, label, singles):
    """sharded_features8 per sigma and sharded_hessian_eig on `mesh` against
    the single-device results `singles`, with the mode kernels' launch
    counts; returns the launches made."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch import parallel as P
    from ife_tpu_torch.ops.features import features8_dispatch_branch

    n = mesh.n_blocks
    one_d = len([d for d in mesh.dims if d > 1]) <= 1
    post = "features8_post_x_halo" if one_d else "features8_post_pre_padded"
    hess = "hessian_eig_x_halo" if one_d else "hessian_eig_pre_padded"
    xi, mi = P.shard_volume(img, mesh), P.shard_volume(mask, mesh)
    total = dict.fromkeys(K.LAUNCHES, 0)
    line = []
    for sigma in SIGMAS:
        K.reset_launches()
        got = _gathered(P.sharded_features8(xi, mi, sigma, mesh, FULL_SPACING,
                                            stack=False))
        sweep = features8_dispatch_branch(sigma, FULL_SPACING, None) == "sweep"
        _expect_launches(f"sharded_features8 {label} s={sigma}",
                         {"features8_sweep_clamps": n} if sweep
                         else {"normalized_conv": n, post: n})
        for k, v in K.LAUNCHES.items():
            total[k] += v
        exact, near = singles[sigma]
        if not bit_equal(got, exact):
            raise PhaseError(f"sharded_features8 {label} s={sigma}: differs "
                             "from the single-device kernels")
        rel, _ = feature_errors(got, near, (2, 3, 4), tol=SHARD_TOL)
        line.append(f"s={sigma} {'sweep+clamps' if sweep else 'nc+' + post[15:]}"
                    f" bit-equal" + ("" if near is exact else
                                     f" (dispatcher's pass: {rel:.2e})"))
        if rel > SHARD_TOL:
            raise PhaseError(f"sharded_features8 {label} s={sigma}: {rel:.2e} "
                             "from the single-device dispatcher's pass")
        del got
    K.reset_launches()
    got = _gathered(P.sharded_hessian_eig(xi, mesh, FULL_SPACING, stack=False))
    _expect_launches(f"sharded_hessian_eig {label}", {hess: n})
    total[hess] += n
    if not bit_equal(got, singles["hessian"]):
        raise PhaseError(f"sharded_hessian_eig {label}: differs from the "
                         "single-device kernel")
    line.append(f"hessian ({hess[12:]}) bit-equal")
    say("sharded", f"{label}, {n} blocks {mesh.dims} on {mesh.device}, 512^3 "
        "against the single-device port: " + "; ".join(line))
    return total


def sharded_stats_checks(img_np, mask_np, meshes, edges, rois):
    """sharded_feature_fine_histograms and make_bag_sharded on every mesh
    against the one-block mesh / make_bag_device: counts and bags equal."""
    import numpy as np

    from ife_tpu_torch import kernels as K
    from ife_tpu_torch import parallel as P
    from ife_tpu_torch.roi.bag import make_bag_device, make_bag_sharded

    one = P.make_mesh(1, ("x",))
    want_h = P.sharded_feature_fine_histograms(img_np, mask_np, (1.2, 4.8), one,
                                               FULL_SPACING, n_fine=4096)
    want_b = make_bag_device(img_np, mask_np, (1.2,), edges, rois, FULL_SPACING)
    total = dict.fromkeys(K.LAUNCHES, 0)
    for label, mesh in meshes:
        K.reset_launches()
        got_h = P.sharded_feature_fine_histograms(
            img_np, mask_np, (1.2, 4.8), mesh, FULL_SPACING, n_fine=4096)
        for (gb, gc), (wb, wc) in zip(got_h, want_h):
            if not (np.array_equal(gb, wb) and np.array_equal(gc, wc)):
                raise PhaseError(f"fine histograms {label}: differ from the "
                                 "one-block mesh")
        got_b = make_bag_sharded(img_np, mask_np, (1.2,), edges, rois, mesh,
                                 FULL_SPACING)
        if not np.array_equal(got_b, want_b):
            raise PhaseError(f"make_bag_sharded {label}: differs from "
                             f"make_bag_device by {np.abs(got_b - want_b).max()}")
        if K.LAUNCHES["features8_sweep_clamps"] != 2 * mesh.n_blocks:
            raise PhaseError(f"stats {label}: launches {dict(K.LAUNCHES)}")
        for k, v in K.LAUNCHES.items():
            total[k] += v
        say("sharded", f"{label}: 16 fine histograms of 4096 bins (sigma 1.2, "
            f"4.8; {int(want_h[0][1].sum())} voxels each) equal to the "
            f"one-block mesh; make_bag_sharded {got_b.shape} equal to "
            "make_bag_device")
    return total


def phase_sharded_cli(tmp):
    """The three --sharded routes, 4 blocks in this process, against the
    unsharded runs of phases main and bags (their files are in tmp):
    extract-features on phase main's CLI pair, make-bag and
    determine-bin-edges on the CLI_SHAPE pair. Returns the launches."""
    import numpy as np

    from ife_tpu_torch.cli.main import main
    from ife_tpu_torch.io import read_hist_spec, read_volume
    from ife_tpu_torch.kernels import LAUNCHES, reset_launches
    from ife_tpu_torch.ops.features import FEATURE_NAMES

    path = lambda name: os.path.join(tmp, name)  # noqa: E731
    shard = ["--sharded", "--blocks", "4"]
    runs = [["extract-features", "-i", path("cli_img.nii.gz"), "-m",
             path("cli_mask.nii.gz"), "-o", path("sfeat"), "-s", "0.6", "2.4",
             *shard],
            ["make-bag", "-i", path("img.nii.gz"), "-m", path("mask.nii.gz"),
             "-b", path("spec.txt"), "-s", "0.6", "2.4", "-n", "50",
             "--roi-size", "41,41,41", "--seed", "0", "-o", path("sbag"), *shard],
            ["determine-bin-edges", "-l", path("pairs.txt"), "-o",
             path("sspec.txt"), "-s", "0.6", "2.4", "--bins", "32", *shard]]
    torch.cuda.synchronize()
    reset_launches()
    secs = []
    for argv in runs:
        t0 = time.perf_counter()
        if main(argv) != 0:
            raise PhaseError(f"CLI {argv[0]} --sharded exited non-zero")
        torch.cuda.synchronize()
        secs.append(f"{argv[0]} {time.perf_counter() - t0:.1f} s")
    launches = dict(LAUNCHES)
    say("sharded", "CLI --sharded --blocks 4: " + "; ".join(secs)
        + f"; launches { {k: v for k, v in launches.items() if v} }")
    worst = {}
    for sigma in (0.6, 2.4):
        got, want = ([read_volume(path(f"{pre}_scale_{sigma:g}{n}.nii.gz")
                                  ).data.cuda() for n in FEATURE_NAMES]
                     for pre in ("sfeat", "feat"))
        if takes_staged_passes(sigma) and not bit_equal(got, want):
            raise PhaseError(f"extract-features --sharded s={sigma}: files "
                             "differ from the unsharded run's")
        worst[sigma] = feature_errors(got, want, (2, 3, 4), tol=SHARD_TOL)[0]
        if worst[sigma] > SHARD_TOL:
            raise PhaseError(f"extract-features --sharded s={sigma}: "
                             f"{worst[sigma]:.2e} from the unsharded files")
    bag, dev = (np.loadtxt(path(f"{n}.bag"), delimiter=",")
                for n in ("sbag", "dev"))
    half = bag.shape[1] // 2  # the columns of sigma 0.6
    d06 = float(np.abs(bag[:, :half] - dev[:, :half]).max())
    d24 = float(np.abs(bag[:, half:] - dev[:, half:]).max())
    # sigma 0.6: the same features, the same counts. sigma 2.4: features
    # within SHARD_TOL move a few of a box's 41^3 voxels across an edge
    if bag.shape != dev.shape or d06 > 5.01e-6 or d24 > 5e-3:
        raise PhaseError(f"make-bag --sharded: {d06:.3g} / {d24:.3g} from "
                         "make-bag --device")
    # the scalable edges invert a 4096-bin CDF over [min, max]: within a fine
    # bin of the exact, sort-based edges, a small share (<= 0.1) of the span
    # between a row's first and last edge even for a heavy-tailed channel
    spec, fine = read_hist_spec(path("spec.txt")), read_hist_spec(path("sspec.txt"))
    off = max(float(np.abs(f - s).max() / max(s[-1] - s[0], 1e-30))
              for f, s in zip(fine, spec))
    if len(fine) != 16 or any((np.diff(f) < 0).any() for f in fine) or off > 0.1:
        raise PhaseError(f"determine-bin-edges --sharded: edges {off:.3g} of "
                         "a row's span from the exact ones")
    say("sharded", "CLI files against the unsharded runs: extract-features "
        f"s=0.6 equal to the bit, s=2.4 within {worst[2.4]:.2e}; bag columns "
        f"within {d06:.3g} (s=0.6) / {d24:.3g} (s=2.4) of make-bag --device; "
        f"CDF edges within {off:.3g} of a row's span of the sorted ones")
    return launches


def phase_sharded(img, mask):
    """The sharded path at 512^3 on cuda:0, counters reset before each step
    and read after it; returns the launches added up."""
    import socket

    from ife_tpu_torch import kernels as K
    from ife_tpu_torch import parallel as P
    from ife_tpu_torch.ops.features import features8_auto_channels
    from ife_tpu_torch.roi import generate_random_rois

    sp = FULL_SPACING
    # the single-device results: per sigma (what the sharded pass must equal
    # to the bit, the dispatcher's pass). They differ at sigma 2.4 only.
    singles = {}
    mf = mask.clamp(0, 1)
    for sigma in SIGMAS:
        disp = features8_auto_channels(img, mask, sigma, sp)
        if not takes_staged_passes(sigma):
            staged = K.fused_features8_post_stream(
                K.fused_normalized_conv_sweep(img, mf, sigma, sp), mf, sp,
                stack=False)
            singles[sigma] = (staged, disp)
        else:
            singles[sigma] = (disp, disp)
    singles["hessian"] = K.fused_hessian_eig_stream(img, sp, stack=False)
    total = dict.fromkeys(K.LAUNCHES, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    meshes = [("1D", P.make_mesh(4, ("x",))), ("2D", P.make_mesh(4, ("x", "y")))]
    for label, mesh in meshes:
        add(sharded_feature_checks(img, mask, mesh, label, singles))
    img_np, mask_np = img.cpu().numpy(), mask.cpu().numpy().astype("uint8")
    edges = list(hist_edges(singles[1.2][0], 31).numpy())
    rois = generate_random_rois(mask_np, 50, (41, 41, 41), seed=0)
    add(sharded_stats_checks(img_np, mask_np, meshes, edges, rois))

    # once more as rank 0 of a torch.distributed world of one process: the
    # launcher, NCCL's init and the collectives (all_reduce of the counts,
    # min / max of the ranges) run on the card
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    rank, world = P.distributed_init(f"127.0.0.1:{port}", 1, 0)
    try:
        import torch.distributed as dist

        mesh = P.make_mesh(4, ("x", "y"))
        if (rank, world, mesh.world_size, dist.get_backend()) != (0, 1, 1, "nccl"):
            raise PhaseError("distributed_init: not rank 0 of 1 on NCCL")
        add(sharded_feature_checks(img, mask, mesh, "2D under NCCL", singles))
        add(sharded_stats_checks(img_np, mask_np, [("2D under NCCL", mesh)],
                                 edges, rois))
    finally:
        P.distributed_shutdown()
    del singles
    torch.cuda.empty_cache()

    # the direct entries nothing dispatches
    K.reset_launches()
    X, Y, _ = img.shape
    outs = [K.fused_features8_tap(img, mask, 1.2, sp),
            K.fused_features8_xs(img, mask, 1.2, sp)]
    for o in outs:
        if tuple(o.shape) != (8,) + FULL or not bool(torch.isfinite(o).all()):
            raise PhaseError("tap / xs at 512^3: output not finite or not "
                             f"{(8,) + FULL}")
    sweep = K.fused_features8_sweep(img, mask, 1.2, sp)
    rel_tap, _ = feature_errors(outs[0].unbind(0), sweep.unbind(0), (2, 3, 4),
                                tol=TAP_TOL)
    if not bit_equal(outs[1].unbind(0), sweep.unbind(0)) or rel_tap > TAP_TOL:
        raise PhaseError("xs differs from the sweep (the same passes), or tap "
                         f"is {rel_tap:.2e} from it")
    del outs
    multi = K.fused_features8_sweep_multi(img, mask, SWEEP_SIGMAS, sp,
                                          clamps=[0, X - 1, 0, Y - 1])
    if not bit_equal(multi[1].unbind(0), sweep.unbind(0)):
        raise PhaseError("sweep_multi with the array's faces as clamps differs "
                         "from the sweep")
    del multi, sweep
    s = K.fused_normalized_conv_sweep(img, mf, 4.8, sp)
    if not bit_equal(K.fused_features8_post(edge_layer(s), mf, sp,
                                            pre_padded=True).unbind(0),
                     K.fused_features8_post_stream(s, mf, sp).unbind(0)):
        raise PhaseError("windowed post pre_padded on an edge layer differs "
                         "from the whole-volume post")
    torch.cuda.synchronize()
    say("sharded", f"direct entries at 512^3: xs == sweep to the bit, tap "
        f"{rel_tap:.2e} from it (x-y-z against y-z-x), sweep_multi with clamps "
        f"and windowed post pre_padded == their whole-volume forms; launches "
        f"{ {k: v for k, v in K.LAUNCHES.items() if v} }")
    add(K.LAUNCHES)
    torch.cuda.empty_cache()
    return total


def timed(label, fn, phase="full"):
    med, lo, hi = cuda_ms(fn)
    say(phase, f"{label}: {med:.3f} ms (min {lo:.3f}, max {hi:.3f})")
    return med


def timed_both(label, fn, phase="full"):
    """(call ms, device ms), medians of cuda_ms and device_ms, both
    printed. The device yardstick first: taken first after the phase's
    preceding work (a plain twin's runs, empty_cache), call ms read 0.2 -
    0.3 ms high where the same call timed again right away read what a
    fresh process reads (call_gap); device_ms's 60 calls absorb that."""
    dmed, dlo, dhi = device_ms(fn)
    med, lo, hi = cuda_ms(fn)
    say(phase, f"{label}: call {med:.3f} ms (min {lo:.3f}, max {hi:.3f}); "
        f"device {dmed:.3f} ms (min {dlo:.3f}, max {dhi:.3f})")
    return med, dmed


def phase_full(img, mask, errs, results):
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.features import (
        features8_auto_channels, features8_dispatch_branch,
    )

    sp = FULL_SPACING
    nvox = img.numel()

    copy_ms = timed("copy_ of one 512^3 f32 volume (device copy rate)",
                    lambda: torch.empty_like(img).copy_(img))
    say("full", f"copy rate {2 * 4 * nvox / (copy_ms * 1e-3) / 1e9:.0f} GB/s "
        "(read + write)")

    k_ms, k_dev = timed_both("hessian_eig kernel 512^3",
                             lambda: K.fused_hessian_eig_stream(img, sp,
                                                                stack=False))
    p_ms = timed("hessian_eig plain 512^3", lambda: K.hessian_eig_plain(img, sp))
    rel, ab = kernel_check("hessian_eig 512^3",
                           K.fused_hessian_eig_stream(img, sp, stack=False),
                           K.hessian_eig_plain(img, sp))
    errs["hessian_eig"].append(rel)
    results["hessian_eig"] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms,
                                  max_abs_err=ab)
    say("full", f"hessian_eig 512^3 bit-equal to plain, rel {rel:.2e}; "
        f"{nvox / (k_ms * 1e-3) / 1e9:.2f} Gvox/s kernel, "
        f"{nvox / (k_dev * 1e-3) / 1e9:.2f} Gvox/s on device ms")
    torch.cuda.empty_cache()
    # the reference output (hessian_eig_features_channels' kernel), held to
    # its twin per channel (bit_equal), its eigenvalues also as sorted
    # triples in the printed error
    k_ms, k_dev = timed_both("hessian_eig_reference kernel 512^3",
                             lambda: K.hessian_eig_reference_features(img, sp))
    p_ms = timed("hessian_eig_reference plain 512^3",
                 lambda: K.hessian_eig_reference_plain(img, sp))
    rel, ab = kernel_check("hessian_eig_reference 512^3",
                           K.hessian_eig_reference_features(img, sp),
                           K.hessian_eig_reference_plain(img, sp))
    errs["hessian_eig_reference"].append(rel)
    results["hessian_eig_reference"] = dict(ms=k_ms, device_ms=k_dev,
                                            plain_ms=p_ms, max_abs_err=ab)
    say("full", f"hessian_eig_reference 512^3 bit-equal to plain per "
        f"channel, rel {rel:.2e}")
    torch.cuda.empty_cache()

    for sigma in SIGMAS:
        for name, kern, plain, inside in kernel_pairs(img, mask, sigma, sp):
            if sigma not in FULL_SIGMAS.get(name, SIGMAS):
                continue
            report = REPORT_SIGMA[name] == sigma
            if report:
                km, kd = timed_both(f"s={sigma} {name} kernel", kern)
            else:
                km = timed(f"s={sigma} {name} kernel", kern)
            pm = timed(f"s={sigma} {name} plain", plain)
            rel, ab = kernel_check(f"{name} 512^3 s={sigma}", kern(), plain(),
                                   inside)
            errs[name].append(rel)
            say("full", f"s={sigma} {name}: bit-equal to plain, rel {rel:.2e}")
            if report:
                results[name] = dict(ms=km, device_ms=kd, plain_ms=pm,
                                     max_abs_err=ab)
            torch.cuda.empty_cache()
        branch = features8_dispatch_branch(sigma, sp, img.shape)
        f8_k = timed(f"s={sigma} features8 pass ({branch} kernels)",
                     lambda: features8_auto_channels(img, mask, sigma, sp))
        f8_p = timed(f"s={sigma} features8 pass (their plain twins)",
                     lambda: branch_twin(img, mask, sigma, sp))
        say("full", f"s={sigma} features8 {f8_k:.3f} ms kernels vs "
            f"{f8_p:.3f} ms plain")
        torch.cuda.empty_cache()
    say("full", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(card_line(), flush=True)


def phase_full_sweep(img, mask, errs):
    """The sweep in turns with the staged normalized_conv + post pair at the
    same sigma (sweep, staged, staged, sweep), at x radius 4, 7 and 10; then
    the sweep under a mask of ones, where it skips no plane and no tail."""
    from ife_tpu_torch import kernels as K

    sp = FULL_SPACING
    mf = mask.clamp(0, 1)

    def staged(sigma):
        return K.fused_features8_post_stream(
            K.fused_normalized_conv_sweep(img, mf, sigma, sp), mf, sp)

    for sigma in SWEEP_VS_STAGED:
        if not K.sweep_fits(sigma, sp):
            raise PhaseError(f"the sweep does not take sigma {sigma}")
        rel, _ = kernel_check(
            f"features8_sweep 512^3 s={sigma}",
            K.fused_features8_sweep(img, mask, sigma, sp, stack=False),
            K.features8_sweep_plain(img, mask, sigma, sp))
        errs["features8_sweep"].append(rel)
        torch.cuda.empty_cache()
        turns = []
        for label, fn in (("features8_sweep", K.fused_features8_sweep),
                          ("normalized_conv + post", None)) * 2:
            turns.append(timed(
                f"s={sigma} {label} kernel{'s' if fn is None else ''}, "
                f"turn {len(turns) + 1}",
                (lambda: staged(sigma)) if fn is None
                else (lambda: fn(img, mask, sigma, sp))))
        far, _ = feature_errors(
            K.fused_features8_sweep(img, mask, sigma, sp).unbind(0),
            staged(sigma).unbind(0), (2, 3, 4))
        say("full", f"s={sigma}: sweep {(turns[0] + turns[2]) / 2:.3f} ms "
            f"against the staged pair {(turns[1] + turns[3]) / 2:.3f} ms "
            f"(bit-equal to its twin; {far:.2e} from the staged pair, "
            "x-y-z against y-z-x)")
        torch.cuda.empty_cache()
    ones = torch.ones_like(mask)
    rel, _ = kernel_check(
        "features8_sweep 512^3, a mask of ones",
        K.fused_features8_sweep(img, ones, 1.2, sp, stack=False),
        K.features8_sweep_plain(img, ones, 1.2, sp))
    errs["features8_sweep"].append(rel)
    torch.cuda.empty_cache()
    dense = timed("s=1.2 features8_sweep kernel, a mask of ones",
                  lambda: K.fused_features8_sweep(img, ones, 1.2, sp))
    sphere = timed("s=1.2 features8_sweep kernel, the sphere mask",
                   lambda: K.fused_features8_sweep(img, mask, 1.2, sp))
    say("full", f"s=1.2 sweep: {dense:.3f} ms under a mask of ones against "
        f"{sphere:.3f} ms under the sphere mask "
        f"({float(mf.mean()):.1%} inside): the planes and tails the mask "
        "leaves empty are skipped")
    print(card_line(), flush=True)


def dispatch_sigmas():
    """(x radius, sigma) at FULL_SPACING for every x radius 4 .. 28 and
    DISPATCH_WIDE_RADII: DISPATCH_SIGMAS, and for each radius they leave out
    the sigma (rx - 0.5) * h / 4.5, whose radius is rx."""

    rows = {}
    for sigma in DISPATCH_SIGMAS:
        rows.setdefault(math.ceil(4.5 * sigma / FULL_SPACING[0]), sigma)
    for rx in (*range(4, 29), *DISPATCH_WIDE_RADII):
        rows.setdefault(rx, round((rx - 0.5) * FULL_SPACING[0] / 4.5, 4))
    return sorted(rows.items())


def phase_dispatch(img, mask):
    """The dispatch table: the features8 pass at 512^3 through each branch
    that takes the scale (fused_features8 with `branch`: the sweep only at
    its instantiated radii, the xs-stream kernel where its ring fits, the
    staged normalized_conv + post everywhere), in turns (a, b, c, c, b, a),
    under the sphere mask and a mask of ones, at every x radius 4 .. 28 and
    at DISPATCH_WIDE_RADII.
    Prints one JSON line {"dispatch": [...]} and returns the rows. The
    dispatcher's radii (ops.features _SWEEP_RX_MAX, _XS_RX_MAX) are cut where
    the sphere mask's times cross; the line says, per radius, which branch
    the dispatcher takes and which was fastest."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.features import (
        _SWEEP_RX_MAX, _XS_RX_MAX, features8_dispatch_branch, fused_features8,
    )

    sp = FULL_SPACING
    masks = (("sphere", mask), ("ones", torch.ones_like(mask)))
    rows = []
    for rx, sigma in dispatch_sigmas():
        branches = [b for b, fits in (
            ("sweep", K.sweep_fits(sigma, sp)),
            ("xs_stream", K.xs_stream_fits(sigma, sp)),
            ("nc_conv+post", True)) if fits]
        for label, m in masks:
            ms = {b: [] for b in branches}
            for b in branches + branches[::-1]:
                ms[b].append(cuda_ms(lambda: fused_features8(
                    img, m, sigma, sp, stack=False, branch=b))[0])
            row = {"rx": rx, "sigma": sigma, "mask": label}
            row.update({b: round(sum(v) / len(v), 3) for b, v in ms.items()})
            row["fastest"] = min(ms, key=lambda b: sum(ms[b]))
            row["dispatched"] = features8_dispatch_branch(sigma, sp, FULL)
            rows.append(row)
            torch.cuda.empty_cache()
        say("dispatch", "; ".join(
            f"rx {r['rx']} s={r['sigma']} {r['mask']}: " + ", ".join(
                f"{b} {r[b]:.3f}" for b in branches)
            + f" -> {r['dispatched']}" for r in rows[-2:]))
    disagree = [(r["rx"], r["dispatched"], r["fastest"]) for r in rows
                if r["mask"] == "sphere" and r["dispatched"] != r["fastest"]]
    say("dispatch", f"cut at _SWEEP_RX_MAX {_SWEEP_RX_MAX}, _XS_RX_MAX "
        f"{_XS_RX_MAX}; under the sphere mask the dispatched branch is the "
        f"fastest at every radius but {disagree}")
    print(json.dumps({"dispatch": rows, "card": card_line()}), flush=True)
    return rows


def phase_full_multi(img, mask, errs, results):
    """The multi-scale kernels at 512^3 beside what they replace, the tiled
    normalized convolution beside the untiled one, and the four-scale stack
    of bench.py config 3 both ways at 512^3 and at bench.py's own shape."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.features import (
        features8_auto_channels, multiscale_features8_fused,
    )

    sp = FULL_SPACING
    kern, plain = ys_multi_pair(img, mask, YS_SIGMAS, sp)
    km, kd = timed_both(f"features8_ys_multi kernel, S=2 {YS_SIGMAS}", kern)
    pm = timed("features8_ys_multi plain, S=2", plain)
    rel, ab = multi_check("features8_ys_multi 512^3", kern(), plain())
    errs["features8_ys_multi"].append(rel)
    results["features8_ys_multi"] = dict(ms=km, device_ms=kd, plain_ms=pm,
                                         max_abs_err=ab)
    say("full", f"features8_ys_multi S=2: bit-equal to plain, rel {rel:.2e}")
    del kern, plain
    torch.cuda.empty_cache()
    ones = []
    for sigma in YS_SIGMAS:
        kern, _ = ys_multi_pair(img, mask, (sigma,), sp)
        ones.append(timed(f"features8_ys_multi kernel, S=1 ({sigma})", kern))
        del kern
    torch.cuda.empty_cache()
    m_ms = timed(f"multiscale_features8_fused {YS_SIGMAS}",
                 lambda: multiscale_features8_fused(img, mask, YS_SIGMAS, sp))
    p_ms = [timed(f"s={s} features8 pass",
                  lambda s=s: features8_auto_channels(img, mask, s, sp))
            for s in YS_SIGMAS]
    say("full", f"sigma {YS_SIGMAS}: one ys_multi launch {km:.3f} ms vs one "
        f"launch per scale {sum(ones):.3f} ms; multiscale_features8_fused "
        f"{m_ms:.3f} ms vs the two per-scale passes {sum(p_ms):.3f} ms")

    km, kd = timed_both(
        f"features8_sweep_multi kernel, S=2 {SWEEP_SIGMAS}",
        lambda: K.fused_features8_sweep_multi(img, mask, SWEEP_SIGMAS, sp))
    pm = timed("features8_sweep_multi plain, S=2",
               lambda: K.features8_sweep_multi_plain(img, mask, SWEEP_SIGMAS, sp))
    rel, ab = multi_check(
        "features8_sweep_multi 512^3",
        K.fused_features8_sweep_multi(img, mask, SWEEP_SIGMAS, sp, stack=False),
        K.features8_sweep_multi_plain(img, mask, SWEEP_SIGMAS, sp))
    errs["features8_sweep_multi"].append(rel)
    results["features8_sweep_multi"] = dict(ms=km, device_ms=kd, plain_ms=pm,
                                            max_abs_err=ab)
    torch.cuda.empty_cache()
    two = [timed(f"s={s} features8_sweep kernel",
                 lambda s=s: K.fused_features8_sweep(img, mask, s, sp))
           for s in SWEEP_SIGMAS]
    say("full", f"sigma {SWEEP_SIGMAS}: sweep_multi bit-equal to plain, rel "
        f"{rel:.2e}; one launch {km:.3f} ms vs two sweeps {sum(two):.3f} ms")

    untiled = K.fused_normalized_conv_sweep(img, mask, 4.8, sp)
    u_ms = timed("s=4.8 normalized_conv kernel (untiled)",
                 lambda: K.fused_normalized_conv_sweep(img, mask, 4.8, sp))
    for n_tiles in (2, 3):
        t_ms = timed(f"s=4.8 normalized_conv_tiled kernel, n_tiles={n_tiles}",
                     lambda: K.fused_normalized_conv_sweep_tiled(
                         img, mask, 4.8, sp, n_tiles=n_tiles))
        tiled = K.fused_normalized_conv_sweep_tiled(img, mask, 4.8, sp,
                                                    n_tiles=n_tiles)
        if not bit_equal((tiled,), (untiled,)):
            raise PhaseError(f"normalized_conv_tiled n_tiles={n_tiles} differs "
                             "from the untiled kernel at 512^3")
        say("full", f"s=4.8 nc tiled n_tiles={n_tiles}: equal to the untiled "
            f"kernel to the bit, {t_ms:.3f} ms vs {u_ms:.3f} ms")
        del tiled
    del untiled
    torch.cuda.empty_cache()

    # bench.py config 3: 256^3, normal(-600, 200) voxels, a random 75% mask
    g = torch.Generator(device=img.device).manual_seed(3)
    x256 = torch.randn((256,) * 3, device=img.device, generator=g) * 200.0 - 600.0
    m256 = (torch.rand((256,) * 3, device=img.device, generator=g) > 0.25).float()
    for label, x, m in (("256^3 (random 75% mask)", x256, m256),
                        ("512^3 (sphere mask)", img, mask)):
        f_ms = timed(f"config-3 stack {label}: sweep_multi + "
                     "multiscale_features8_fused", lambda: config3_stack(x, m))
        p_ms = timed(f"config-3 stack {label}: one features8 pass per scale",
                     lambda: per_scale_stack(x, m))
        vox4 = 4 * x.numel()
        say("full", f"config-3 stack {label}: {f_ms:.3f} ms "
            f"({vox4 / (f_ms * 1e-3) / 1e9:.2f} Gvox/s) one-launch forms vs "
            f"{p_ms:.3f} ms ({vox4 / (p_ms * 1e-3) / 1e9:.2f} Gvox/s) per scale")
        torch.cuda.empty_cache()
    print(card_line(), flush=True)


def phase_full_modes(img, mask, errs, results):
    """tap and xs beside the sweep, every shard mode beside its whole-volume
    mode, and the sharded pass beside the single-device pass, at 512^3."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch import parallel as P
    from ife_tpu_torch.ops.features import features8_auto_channels

    sp = FULL_SPACING
    base = {"features8_sweep_clamps": "features8_sweep",
            "hessian_eig_x_halo": "hessian_eig",
            "hessian_eig_pre_padded": "hessian_eig",
            "features8_post_x_halo": "features8_post",
            "features8_post_pre_padded": "features8_post",
            "features8_post_windowed_pre_padded": "features8_post_windowed"}
    for sigma in SWEEP_SIGMAS:
        sw = timed(f"s={sigma} features8_sweep kernel",
                   lambda: K.fused_features8_sweep(img, mask, sigma, sp))
        yz = timed(f"s={sigma} smooth_yz kernel (ahead of the xs kernel)",
                   lambda: K.fused_smooth_yz(img, mask, sigma, sp))
        for name, kern, plain in mode_pairs(img, mask, sigma, sp):
            if name not in ("features8_tap", "features8_xs"):
                continue
            report = REPORT_SIGMA[name] == sigma
            if report:
                km, kd = timed_both(f"s={sigma} {name} kernel", kern)
            else:
                km = timed(f"s={sigma} {name} kernel", kern)
            pm = timed(f"s={sigma} {name} plain", plain)
            rel, ab = kernel_check(f"{name} 512^3 s={sigma}", kern(), plain())
            errs[name].append(rel)
            say("full", f"s={sigma} {name}: bit-equal to plain, rel {rel:.2e}; "
                f"{km:.3f} ms against the sweep's {sw:.3f}"
                + (f" (of it {yz:.3f} ms in smooth_yz)" if name == "features8_xs"
                   else ""))
            if report:
                results[name] = dict(ms=km, device_ms=kd, plain_ms=pm,
                                     max_abs_err=ab)
            torch.cuda.empty_cache()
    sigma = REPORT_SIGMA["features8_sweep_clamps"]
    for name, kern, plain in mode_pairs(img, mask, sigma, sp):
        if name in ("features8_tap", "features8_xs"):
            continue
        km, kd = timed_both(f"{name} kernel", kern)
        if name.startswith("hessian"):  # the call ms above the device ms
            say("full", f"{name} call-ms gap: [host ms, of it allocating 6 "
                f"outputs, Python objects, SM MHz, call ms again, after 1 s "
                f"idle] {call_gap(kern, img, 6)}")
        pm = timed(f"{name} plain", plain)
        rel, ab = kernel_check(f"{name} 512^3", kern(), plain())
        errs[name].append(rel)
        results[name] = dict(ms=km, device_ms=kd, plain_ms=pm, max_abs_err=ab)
        say("full", f"{name}: bit-equal to plain, rel {rel:.2e}; {km:.3f} ms "
            f"against {results[base[name]]['ms']:.3f} ms of {base[name]} "
            f"(s={REPORT_SIGMA.get(base[name], '-')})")
        torch.cuda.empty_cache()
    X, Y, _ = img.shape
    cl = [2, K.NO_FACE, -K.NO_FACE, Y - 3]
    km, kd = timed_both(
        f"features8_sweep_multi kernel with clamps, S=2 {SWEEP_SIGMAS}",
        lambda: K.fused_features8_sweep_multi(img, mask, SWEEP_SIGMAS, sp,
                                              clamps=cl))
    pm = timed("features8_sweep_multi plain with clamps, S=2",
               lambda: K.features8_sweep_multi_plain(img, mask, SWEEP_SIGMAS, sp,
                                                     clamps=cl))
    rel, ab = multi_check(
        "features8_sweep_multi_clamps 512^3",
        K.fused_features8_sweep_multi(img, mask, SWEEP_SIGMAS, sp, stack=False,
                                      clamps=cl),
        K.features8_sweep_multi_plain(img, mask, SWEEP_SIGMAS, sp, clamps=cl))
    errs["features8_sweep_multi_clamps"].append(rel)
    results["features8_sweep_multi_clamps"] = dict(ms=km, device_ms=kd,
                                                   plain_ms=pm, max_abs_err=ab)
    say("full", f"features8_sweep_multi_clamps: bit-equal to plain, rel "
        f"{rel:.2e}; {km:.3f} ms against "
        f"{results['features8_sweep_multi']['ms']:.3f} ms without clamps")
    torch.cuda.empty_cache()

    for label, axes in (("4 blocks on x", ("x",)), ("2 x 2 blocks", ("x", "y"))):
        mesh = P.make_mesh(4, axes)
        xi, mi = P.shard_volume(img, mesh), P.shard_volume(mask, mesh)
        for sigma in SIGMAS:
            one = timed(f"s={sigma} features8 pass, single device",
                        lambda: features8_auto_channels(img, mask, sigma, sp))
            blk = timed(f"s={sigma} sharded_features8, {label}, one process",
                        lambda: P.sharded_features8(xi, mi, sigma, mesh, sp,
                                                    stack=False))
            say("full", f"s={sigma} sharded_features8 {label}: {blk:.3f} ms "
                f"against {one:.3f} ms single-device ({blk / one:.2f}x)")
        one = timed("hessian_eig, single device",
                    lambda: K.fused_hessian_eig_stream(img, sp, stack=False))
        blk = timed(f"sharded_hessian_eig, {label}",
                    lambda: P.sharded_hessian_eig(xi, mesh, sp, stack=False))
        say("full", f"sharded_hessian_eig {label}: {blk:.3f} ms against "
            f"{one:.3f} ms single-device ({blk / one:.2f}x)")
        del xi, mi
        torch.cuda.empty_cache()
    print(card_line(), flush=True)


def fir_ops(sigma, axes):
    """Multiplies and adds per voxel of the Gaussian passes along `axes`
    over numerator and denominator at FULL_SPACING."""
    from ife_tpu_torch.ops.stencil import smooth_taps

    return sum(2 * 2 * len(smooth_taps(sigma, FULL_SPACING[a])[0])
               for a in axes)


def kernel_bounds(nvox, hist_work, dense_work):
    """name -> (bound_ms, bound_by): the least time the card could take for
    each kernel's work at the shape its ms was measured at. Bytes: each
    input volume read once, each output written once. Operations: the FIR's
    multiplies and adds for this run's radii, the c*f product and the divide
    where the kernel has them, TAIL_OPS for the tail. hist_work and
    dense_work: (bytes, operations) of the histogram's and the dense bag's
    shapes, counted by their phases."""
    vol, r = 4 * nvox, REPORT_SIGMA
    nc_ops = (fir_ops(r["normalized_conv"], (0, 1, 2)) + 2) * nvox
    work = {
        "hessian_eig": (7 * vol, TAIL_OPS * nvox),
        "hessian_eig_reference": (7 * vol, REFERENCE_OPS * nvox),
        "normalized_conv": (3 * vol, nc_ops),
        "features8_post": (10 * vol, TAIL_OPS * nvox),
        "features8_sweep": (10 * vol, (fir_ops(r["features8_sweep"], (0, 1, 2))
                                       + 2 + TAIL_OPS) * nvox),
        "features8_xs_stream": (11 * vol, (fir_ops(r["features8_xs_stream"],
                                                   (0,)) + 1 + TAIL_OPS) * nvox),
        "smooth_yz": (4 * vol, (fir_ops(r["smooth_yz"], (1, 2)) + 1) * nvox),
        "histogram": hist_work,
        "dense_hist": dense_work,
        "smooth_xz": (4 * vol, (fir_ops(r["smooth_xz"], (0, 2)) + 1) * nvox),
        "normalized_conv_tiled": (3 * vol, nc_ops),
        "features8_post_windowed": (10 * vol, TAIL_OPS * nvox),
        "features8_ys_multi": (
            (10 * len(YS_SIGMAS) + 1) * vol,
            sum(fir_ops(s, (1,)) + 1 + TAIL_OPS for s in YS_SIGMAS) * nvox),
        "features8_sweep_multi": (
            (8 * len(SWEEP_SIGMAS) + 2) * vol,
            sum(fir_ops(s, (0, 1, 2)) + 2 + TAIL_OPS
                for s in SWEEP_SIGMAS) * nvox),
    }
    # tap and the whole xs entry (y/z passes + its kernel) compute the
    # sweep's function: image and mask in, 8 channels out. A shard mode moves
    # its whole-volume mode's bytes, plus two halo rows or a one-voxel layer.
    X, Y, Z = FULL
    rows, layer = 2 * 4 * Y * Z, 4 * ((X + 2) * (Y + 2) - X * Y) * Z
    for name in ("features8_tap", "features8_xs"):
        work[name] = (10 * vol, (fir_ops(r[name], (0, 1, 2)) + 2 + TAIL_OPS)
                      * nvox)
    work["features8_sweep_clamps"] = work["features8_sweep"]
    work["features8_sweep_multi_clamps"] = work["features8_sweep_multi"]
    for name, extra in (("x_halo", rows), ("pre_padded", layer)):
        for kern in ("hessian_eig", "features8_post"):
            work[f"{kern}_{name}"] = (work[kern][0] + extra, work[kern][1])
    work["features8_post_windowed_pre_padded"] = (
        work["features8_post_windowed"][0] + layer,
        work["features8_post_windowed"][1])
    # the probes: their volumes moved; a multiply or add per output voxel,
    # the stencil's differences, the tap floor's clamp, product and 8 adds
    ops = {"pcopy1": 1, "trivial6": 6, "hessian_eig_copyfloor": 6,
           "hessian_eig_copy6": 0, "hessian_eig_stencil6": STENCIL6_OPS,
           "features8_tap_copyfloor": 11}
    for name, vols in PROBE_VOLUMES.items():
        work[name] = (vols * vol, ops[name] * nvox)
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def config4_inputs(img, mask):
    """bench.py config 4 (:537-574) on the card: the 8 channels of one
    features8 pass at sigma 1.2 in its order (f8[1:] + f8[0]), 31 shared
    edges linspace(-1200, 600), the mask as uint8 weights."""
    from ife_tpu_torch.ops.features import features8_auto_channels

    f8 = features8_auto_channels(img, mask, 1.2, FULL_SPACING)
    edges = torch.linspace(-1200.0, 600.0, 31, dtype=torch.float64)
    return list(f8[1:]) + [f8[0]], edges, (mask != 0).to(torch.uint8)


def conflict_free_channels(like, C, edges):
    """C channels shaped like `like` whose every run of 32 voxels puts each
    voxel in its own one of the 32 bins of the (31,) edges: voxel t takes
    bin (t mod 32) XOR a random 5-bit key of its run, at the bin's middle
    (10 beyond the end edges for the two tails)."""
    dev = like.device
    e = edges.to(device=dev, dtype=torch.float32)
    mids = torch.cat([e[:1] - 10.0, (e[:-1] + e[1:]) / 2, e[-1:] + 10.0])
    g = torch.Generator(device=dev).manual_seed(4)
    t = torch.arange(like.numel(), device=dev)
    out = []
    for _ in range(C):
        key = torch.randint(0, 32, (like.numel() // 32 + 1,), device=dev,
                            generator=g)
        out.append(mids[(t % 32) ^ key[t // 32]].reshape(like.shape))
    return out


def hist_time_shapes(img, mask, run):
    """The histogram's 512^3 shapes, each handed to run(label, kernel call,
    plain twin call, (C, E, voxels a box, the box path)) in turn: bench.py config 4 (8
    channels, 31 edges, the sphere mask), config 4 under bench.py's random
    75% mask, one channel of 4096 edges, 8 channels of 4096 edges each (the
    fine-histogram plan), config 4 at E = 1 (the load floor: one compare),
    config 4 on conflict-free values (no two lanes of a run share a bin),
    and 50 ROIs of 41^3, 8 channels, 31 edges per sigma. Inputs are freed
    between shapes."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.features import features8_auto_channels
    from ife_tpu_torch.roi import generate_random_rois

    chans, edges, w = config4_inputs(img, mask)
    n = img.numel()

    def multi(label, ch, e, ww):
        E = e.shape[-1]
        run(label, lambda: K.histogram_counts_multi(ch, e, ww),
            lambda: K.histogram_counts_multi_plain(ch, e, ww),
            (len(ch), E, n, False))

    multi("config 4", chans, edges, w)
    g = torch.Generator(device=img.device).manual_seed(2)
    wr = (torch.rand(img.shape, device=img.device, generator=g) > 0.25
          ).to(torch.uint8)
    multi("config 4, random 75% mask", chans, edges, wr)
    del wr
    inside = w != 0
    fine = torch.stack([torch.linspace(float(c[inside].min()),
                                       float(c[inside].max()), 4096,
                                       dtype=torch.float64) for c in chans])
    del inside
    multi("1 x 4096 edges", chans[-1:], fine[-1], w)
    multi("8 x 4096 edges", chans, fine, w)
    multi("config 4, E = 1", chans, torch.tensor([-600.0], dtype=torch.float64),
          w)
    del chans
    torch.cuda.empty_cache()
    free = conflict_free_channels(img, 8, edges)
    multi("config 4, conflict-free values", free, edges, w)
    del free
    torch.cuda.empty_cache()

    size = (41, 41, 41)
    rois = generate_random_rois(w.cpu().numpy(), 50, size, seed=0)
    starts = [r.index for r in rois]
    for sigma in SIGMAS:
        feats = features8_auto_channels(img, mask, sigma, FULL_SPACING)
        e = hist_edges(feats, 31)
        run(f"s={sigma} 50 boxes of 41^3",
            lambda: K.histogram_boxes(feats, w, starts, size, e),
            lambda: K.histogram_boxes_plain(feats, w, starts, size, e),
            (8, 31, 41 ** 3, True))
        del feats
        torch.cuda.empty_cache()


def host_ms(fn, calls=DEVICE_CALLS):
    """ms the host spends in a call while the card is busy: `calls` calls
    enqueued behind a long torch.cuda._sleep, timed on the host's clock (a
    call that waits for the card shows it here)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(8 * DEVICE_SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return dt


def call_gap(fn, like, outputs):
    """What stands between a call's ms and its device ms: [the host's ms a
    call with the card busy (host_ms), of it the caching allocator's ms for
    the call's `outputs` volumes like `like` (host clock, 10 rounds), the
    Python heap's tracked objects, the card's SM clock in MHz now, the call
    ms (cuda_ms) once more right away, and after the card idled 1 s]."""
    import gc

    again = cuda_ms(fn)[0]
    time.sleep(1.0)
    idle = cuda_ms(fn)[0]
    host = host_ms(fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DEVICE_CALLS):
        outs = [torch.empty_like(like) for _ in range(outputs)]
        del outs
    alloc = (time.perf_counter() - t0) / DEVICE_CALLS * 1e3
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return [round(host, 3), round(alloc, 3), len(gc.get_objects()), clock,
            round(again, 3), round(idle, 3)]


def kernel_ms(fn, match, calls=3):
    """ms a call of fn spends in the CUDA kernels whose name holds `match`
    (kernel_breakdown): the kernel alone, without the wrapper's other
    launches, its copies or the gaps a wrapper that waits for the card
    leaves. None where the profiler records no device time or loses
    events."""
    rows = kernel_breakdown(fn, calls)
    if isinstance(rows, str):
        return None
    ms = sum(t for k, _, t in rows if match in k)
    return ms if ms > 0 else None


def hist_shape_times(img, mask):
    """label -> {"call": [median, min, max], "device": [...], "host": ms,
    "kernel": ms} of every shape of hist_time_shapes (call: cuda_ms; device:
    device_ms; host: host_ms; kernel: kernel_ms, the profiler's time of the
    histogram kernel alone), each result held against its plain twin
    (counts equal); "plan": the kernel's form where the package has one."""
    from ife_tpu_torch.kernels import histogram as H

    plan = getattr(H, "HistPlan", None) and H._plan
    res = {}

    def run(label, kern, plain, dims):
        call, dev = cuda_ms(kern), device_ms(kern)
        kernel_check(f"histogram {label}", kern(), plain())
        kern_ms = kernel_ms(kern, "histogram_kernel")
        res[label] = {"call": [round(t, 4) for t in call],
                      "device": [round(t, 4) for t in dev],
                      "host": round(host_ms(kern), 4),
                      "kernel": kern_ms and round(kern_ms, 4)}
        if plan:
            C, E, n, boxes = dims
            res[label]["plan"] = list(plan(C, E, n, boxes=boxes))
        torch.cuda.empty_cache()

    hist_time_shapes(img, mask, run)
    return res


def hist_times(label):
    """`--hist-times [ROOT]`: one JSON line of the histogram shapes' 512^3
    times on both yardsticks (call ms and device ms, median / min / max of
    5) of the ife_tpu_torch package on sys.path, every result held against
    its twin. Run it on two checkouts in turns to compare them within one
    call on one card."""
    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is false")
    img, mask = _inputs(FULL, 2, "cuda")
    res = {"label": label, "card": card_line()}
    res.update(hist_shape_times(img, mask))
    print(json.dumps(res), flush=True)


def phase_full_hist(img, mask, errs, results):
    """The histogram kernel at 512^3 against its twin on every shape of
    hist_time_shapes (call ms and device ms), the config-4 twin's time,
    and the make_bag_device stages per sigma: the feature pass that feeds
    the 50 ROIs of 41^3 and their binning."""
    import numpy as np

    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.ops.features import features8_auto_channels
    from ife_tpu_torch.roi import generate_random_rois
    from ife_tpu_torch.roi.bag import roi_feature_histograms_device

    times = hist_shape_times(img, mask)
    for label, t in times.items():
        errs["histogram"].append(0.0)
        say("full", f"histogram {label}: equal to its twin; call "
            f"{t['call'][0]:.3f} ms (min {t['call'][1]:.3f}, max "
            f"{t['call'][2]:.3f}); device {t['device'][0]:.3f} ms (min "
            f"{t['device'][1]:.3f}, max {t['device'][2]:.3f}); kernel "
            f"{t['kernel']} ms; plan {t.get('plan')}")
    print(json.dumps({"hist shapes": times}), flush=True)

    chans, edges, w = config4_inputs(img, mask)
    inside = int(w.sum())
    km, kd = times["config 4"]["call"][0], times["config 4"]["device"][0]
    pm = timed("histogram plain, config 4",
               lambda: K.histogram_counts_multi_plain(chans, edges, w))
    rel, ab = kernel_check("histogram config 4",
                           K.histogram_counts_multi(chans, edges, w),
                           K.histogram_counts_multi_plain(chans, edges, w))
    errs["histogram"].append(rel)
    results["histogram"] = dict(ms=km, device_ms=kd, plain_ms=pm,
                                max_abs_err=ab)
    # bytes the kernel must move: the uint8 mask, and the 8 channels of
    # every 32-voxel run that holds a masked voxel; operations: the five
    # compares of a search over 31 edges per masked voxel and channel
    warps = int(w.view(-1, 32).any(1).sum())
    gb = (w.numel() + warps * 32 * 4 * 8) / 1e9
    hist_work = (gb * 1e9, 8 * inside * 5)
    say("full", f"histogram config 4: {inside} masked voxels, ~{gb:.2f} GB "
        f"moved -> {gb / (kd * 1e-3):.0f} GB/s on the device yardstick "
        f"({gb / (km * 1e-3):.0f} a call); "
        f"{8 * inside / (kd * 1e-3) / 1e9:.2f} G binnings/s")
    del chans
    torch.cuda.empty_cache()

    size = (41, 41, 41)
    rois = generate_random_rois(w.cpu().numpy(), 50, size, seed=0)
    starts = np.asarray([r.index for r in rois])
    for sigma in SIGMAS:
        feats = features8_auto_channels(img, mask, sigma, FULL_SPACING)
        e = hist_edges(feats, 31)
        f_ms = timed(f"s={sigma} features8 pass",
                     lambda: features8_auto_channels(img, mask, sigma,
                                                     FULL_SPACING))
        b_ms = timed(f"s={sigma} binning 50 ROIs of 41^3 "
                     "(roi_feature_histograms_device)",
                     lambda: roi_feature_histograms_device(feats, mask, starts,
                                                           e, size))
        k = times[f"s={sigma} 50 boxes of 41^3"]
        say("full", f"s={sigma} make_bag_device stages: features8 {f_ms:.3f} ms, "
            f"binning {b_ms:.3f} ms (kernel call {k['call'][0]:.3f} ms, device "
            f"{k['device'][0]:.3f} ms, equal to the twin)")
        del feats
        torch.cuda.empty_cache()
    print(card_line(), flush=True)
    return hist_work


def dense_lung(shape, device):
    """The uint8 ellipsoid of DENSE_LUNG in a volume of `shape`."""
    (cx, cy, cz), (ax, ay, az) = DENSE_LUNG
    x, y, z = (torch.arange(n, dtype=torch.float32, device=device)
               for n in shape)
    r = (((x - cx) / ax) ** 2)[:, None, None] \
        + (((y - cy) / ay) ** 2)[None, :, None] \
        + (((z - cz) / az) ** 2)[None, None, :]
    return (r <= 1).to(torch.uint8)


def phase_full_dense(img, errs, results):
    """The dense bag of one lung at 512^3, as the main path runs it:
    make_bag_dense_device with the launch counters reset first (DENSE_SIZE
    ROIs at every voxel of the DENSE_LUNG ellipsoid, SIGMAS, DENSE_BINS bins
    of edges from each scale's channels in the lung, as determine-bin-edges
    draws them from masked voxels); its starts the lung's voxels less
    half a box, in z, y, x order, as many as the lung has; at
    DENSE_CHECK_SIGMA its rows bit-equal to the plain twin's
    (dense_counts_plain's counts over the boxes' counts, divided in f32);
    then dense_hist_rows alone on the same inputs, bit-equal again, on both
    yardsticks beside the twin's call ms, with the rows kernel's plan
    (kernels.DENSE_HIST_PLAN), and once more with edges from
    the whole volume's channels, which crowd the lung's values into fewer
    bins (the fullest bin's mean frequency printed for both). Returns
    (launches, (bytes, operations) of one scale): the region's 8 f32
    channels and 1 B mask read once and the rows written once; a divide a
    frequency and a binary search a channel voxel of the region."""
    from ife_tpu_torch.kernels import (
        DENSE_HIST_PLAN, LAUNCHES, reset_launches,
    )
    from ife_tpu_torch.kernels.dense_hist import (
        dense_counts_plain, dense_hist_rows, dense_index,
    )
    from ife_tpu_torch.ops.features import features8_auto_channels
    from ife_tpu_torch.roi.bag import _edges_block, make_bag_dense_device

    dev = img.device
    lung = dense_lung(tuple(img.shape), dev)
    w = lung != 0
    voxels = int(w.sum())
    edges = []
    for sigma in SIGMAS:
        feats = features8_auto_channels(img, lung, sigma, FULL_SPACING)
        edges += list(hist_edges([c[w] for c in feats],
                                 DENSE_BINS - 1).numpy())
    del feats
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    starts, rows = make_bag_dense_device(img, lung, SIGMAS, edges, DENSE_SIZE,
                                         FULL_SPACING, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if launches["dense_hist"] != len(SIGMAS):
        raise PhaseError(f"dense bag: {launches['dense_hist']} dense_hist "
                         f"launches for {len(SIGMAS)} scales")
    n = starts.shape[0]
    half = torch.as_tensor([s // 2 for s in DENSE_SIZE], device=dev)
    centres = starts + half
    key = (centres[:, 2] * img.shape[1] + centres[:, 1]) * img.shape[0] \
        + centres[:, 0]
    if n != voxels or not bool(w[tuple(centres.T)].all()) \
            or not bool((key[1:] > key[:-1]).all()):
        raise PhaseError(f"dense bag: {n} starts for a lung of {voxels} "
                         "voxels, or starts off the lung or out of order")
    say("full", f"dense bag of one lung: {n} ROIs of {DENSE_SIZE} x "
        f"{rows.shape[1]} columns in {wall:.3f} s "
        f"(make_bag_dense_device, {len(SIGMAS)} scales, rows on the card; "
        f"the first call of the process), launches "
        f"{ {k: v for k, v in launches.items() if v} }")

    i = SIGMAS.index(DENSE_CHECK_SIGMA)
    feats = features8_auto_channels(img, lung, DENSE_CHECK_SIGMA,
                                    FULL_SPACING)
    e = _edges_block(edges, i)
    index = dense_index(w, w, DENSE_SIZE)

    def plain():
        counts = dense_counts_plain(feats, w, index.starts, DENSE_SIZE, e)
        return (counts.to(torch.float32)
                / index.totals.view(-1, 1, 1).to(torch.float32)).reshape(n, -1)

    want = plain()
    width = want.shape[1]
    got = rows[:, i * width:(i + 1) * width]
    if not torch.equal(got, want):
        raise PhaseError(f"dense bag s={DENSE_CHECK_SIGMA}: rows differ from "
                         "the plain twin's")
    del starts, rows, got
    torch.cuda.empty_cache()
    out = torch.empty_like(want)
    reset_launches()

    def kern():
        dense_hist_rows(feats, w, index, DENSE_SIZE, e, out)

    kern()
    torch.cuda.synchronize()
    if LAUNCHES["dense_hist"] != 1:
        raise PhaseError(f"dense_hist_rows: {LAUNCHES['dense_hist']} launches")
    rel, ab = kernel_check("dense_hist", out, want)
    errs["dense_hist"].append(rel)
    km, kd = timed_both(f"s={DENSE_CHECK_SIGMA} dense_hist_rows, {n} ROIs",
                        kern)
    pm = timed(f"s={DENSE_CHECK_SIGMA} dense_counts_plain and the divide",
               plain)
    plan = dict(DENSE_HIST_PLAN)
    results["dense_hist"] = dict(ms=km, device_ms=kd, plain_ms=pm,
                                 max_abs_err=ab, plan=plan)
    region = math.prod(a + s - 1 for a, s in zip(index.row_at.shape,
                                                 DENSE_SIZE))
    nbytes = region * (8 * 4 + 1) + n * width * 4
    ops = n * width + region * 8 * math.ceil(math.log2(DENSE_BINS))
    say("full", f"s={DENSE_CHECK_SIGMA} dense_hist_rows equal to its twin: "
        f"region {region} voxels, {nbytes / 1e9:.2f} GB moved -> "
        f"{nbytes / 1e6 / kd:.0f} GB/s on the device yardstick; the rows "
        f"kernel's plan {json.dumps(plan)}")

    def fullest():
        return float(out.view(n, 8, -1).mean(0).max())

    lung_share = fullest()
    e_vol = hist_edges(feats, DENSE_BINS - 1)
    _, vd = timed_both(f"s={DENSE_CHECK_SIGMA} dense_hist_rows, edges from "
                       "the whole volume's channels",
                       lambda: dense_hist_rows(feats, w, index, DENSE_SIZE,
                                               e_vol, out))
    say("full", f"the fullest bin's mean frequency: {lung_share:.3f} with the "
        f"lung's edges ({kd:.3f} device ms), {fullest():.3f} with the whole "
        f"volume's ({vd:.3f} device ms)")
    del feats, want, out, index
    torch.cuda.empty_cache()
    print(card_line(), flush=True)
    return launches, (nbytes, ops)


def probe_pairs(img, mask, width=4):
    """(name, kernel call, plain twin call, library call or None) of every
    probe kernel on these inputs; the library calls of LIBRARY."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.kernels import probes as P

    sp, sigma = FULL_SPACING, REPORT_SIGMA["features8_tap"]
    c1, c6 = P.PCOPY1_SCALE, P.TRIVIAL6_SCALES
    return [
        ("pcopy1", lambda: P.pcopy1(img, width), lambda: P.pcopy1_plain(img),
         lambda: torch.mul(img, c1)),
        ("trivial6", lambda: P.trivial6(img, width),
         lambda: P.trivial6_plain(img),
         lambda: [torch.mul(img, c) for c in c6]),
        ("hessian_eig_copyfloor", lambda: P.floor_window(img),
         lambda: P.floor_window_plain(img),
         lambda: [torch.add(img, float(k)) for k in range(6)]),
        ("hessian_eig_copy6", lambda: P.variant(img, "copy6", sp),
         lambda: P.variant_plain(img, "copy6", sp),
         lambda: [img.clone() for _ in range(6)]),
        ("hessian_eig_stencil6", lambda: P.variant(img, "stencil6", sp),
         lambda: P.variant_plain(img, "stencil6", sp), None),
        ("features8_tap_copyfloor",
         lambda: K.fused_features8_tap(img, mask, sigma, sp, stack=False,
                                       variant="copyfloor"),
         lambda: K.features8_tap_copyfloor_plain(img, mask), None),
    ]


def bitwise_check(name, got, ref):
    """Raise unless every output equals its twin's bit for bit (the sign of
    a zero included; NaN where the twin is NaN)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    if len(got) != len(ref) or not all(
            g.shape == r.shape and bool(
                ((g.view(torch.int32) == r.view(torch.int32))
                 | (torch.isnan(g) & torch.isnan(r))).all())
            for g, r in zip(got, ref)):
        raise PhaseError(f"{name}: kernel differs from its plain twin")


def probe_path(img, mask):
    """The probe path at 512^3: every entry of kernels/probes.py and the two
    copy-floor variants called once, the counters reset before and read
    after, each output held bitwise against its twin in between (the twins
    launch nothing)."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.kernels import probes as P

    sp = FULL_SPACING
    entries = [(name, kern, plain) for name, kern, plain, _ in
               probe_pairs(img, mask)]
    entries += [
        ("fused_hessian_eig copyfloor",
         lambda: K.fused_hessian_eig(img, sp, stack=False, variant="copyfloor"),
         lambda: K.hessian_eig_copyfloor_plain(img)),
        ("variant full", lambda: P.variant(img, "full", sp),
         lambda: P.variant_plain(img, "full", sp))]
    torch.cuda.synchronize()
    K.reset_launches()
    for name, kern, plain in entries:
        got = kern()
        torch.cuda.synchronize()
        bitwise_check(f"probe path {name} 512^3", got, plain())
        del got
        torch.cuda.empty_cache()
    launches = dict(K.LAUNCHES)
    missing = [k for k in PROBE_PATH if launches[k] < 1]
    if missing:
        raise PhaseError(f"probe path launched no {missing} kernel")
    say("probes", "probe path at 512^3: every output bitwise equal to its "
        "twin; launches " + ", ".join(f"{k} {launches[k]}" for k in PROBE_PATH)
        + f", hessian_eig {launches['hessian_eig']}")
    return launches


def probe_checks(errs):
    """Every probe kernel bitwise against its twin at (128, 124, 120) and on
    an odd shape whose voxel count leaves a float4 tail, both widths."""
    for shape in ((128, 124, 120), (5, 7, 9)):
        img, mask = _inputs(shape, 0, "cuda")
        for width in (4, 1):
            for name, kern, plain, _ in probe_pairs(img, mask, width):
                if width == 1 and name not in ("pcopy1", "trivial6"):
                    continue
                bitwise_check(f"{name} {shape} width {width}", kern(), plain())
                errs[name].append(0.0)
        torch.cuda.synchronize()
        say("probes", f"{shape}: every probe kernel bitwise equal to its twin "
            "(pcopy1 and trivial6 at widths 4 and 1)")


def launches_ms(fn, n):
    """ms a launch of n launches of fn between one event pair."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def sass_op_counts(match, ops):
    """mangled kernel name -> {op: n}: how many SASS instructions of each
    opcode in `ops` (an opcode with its modifiers: LDS.128 counts as LDS)
    the code of every function of the built library whose name holds one of
    `match` has (cuobjdump -sass; static counts), or None without
    cuobjdump."""
    from pathlib import Path

    from ife_tpu_torch.kernels import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    res = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise PhaseError(f"cuobjdump failed: {res.stderr.strip()[:400]}")
    pattern = re.compile(r"\b(" + "|".join(ops) + r")[.\s]")
    counts, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if any(m in name for m in match) else None
            if name:
                counts[name] = dict.fromkeys(ops, 0)
        elif name:
            op = pattern.search(line)
            if op:
                counts[name][op.group(1)] += 1
    return counts


def nc_sass_check():
    """The normalized-convolution kernels' SASS (static counts): no FFMA in
    the walks (the build is --fmad=false; a contracted multiply-add would
    break bit-equality with the twins). FFMA appears only in the z pass
    with the divide, as the Newton steps of the correctly rounded IEEE
    divide (beside its MUFU.RCP), whose walk has the in-place form's FMUL
    count. Prints FMUL, FADD, LDS (shared loads: inputs and taps) and LDC
    (constant loads) of each."""
    counts = sass_op_counts(("fir_axis_kernel", "fir_z_kernel"),
                            ("FFMA", "FMUL", "FADD", "LDS", "LDC", "MUFU"))
    if counts is None:
        say("kernels", "nc SASS: not measured (no cuobjdump)")
        return
    fmul = {k: c["FMUL"] for k, c in counts.items()}
    for k, c in counts.items():
        if c["FFMA"] == 0:
            continue
        twin = k.replace("fir_z_kernelILb1E", "fir_z_kernelILb0E")
        if (c["MUFU"] == 0 or twin == k or twin not in fmul
                or fmul[twin] != c["FMUL"]):
            raise PhaseError(f"nc SASS: FFMA outside the divide in {k}: {c}")
    if len(counts) != 4:
        raise PhaseError(f"nc SASS: expected 4 kernels, found {counts}")
    say("kernels", "nc SASS (static counts), no FFMA in the walks: "
        + "; ".join(
            f"{k[:48]} FMUL {c['FMUL']} FADD {c['FADD']} LDS {c['LDS']} "
            f"LDC {c['LDC']} (LDS / FMUL {c['LDS'] / max(c['FMUL'], 1):.3f}, "
            f"LDC / FMUL {c['LDC'] / max(c['FMUL'], 1):.3f}), FFMA "
            f"{c['FFMA']} (MUFU {c['MUFU']})"
            for k, c in sorted(counts.items())))


def streaming_turns(name, img):
    """pcopy1 or trivial6 at both widths beside the library's calls for the
    same bytes, on the device yardstick, in turns (forward, then backward):
    one JSON line {"<name> turns": {label: [device ms of each turn]}}."""
    from ife_tpu_torch.kernels import probes as P

    if name == "pcopy1":
        c1 = P.PCOPY1_SCALE
        lib = [("torch.mul", lambda: torch.mul(img, c1)),
               ("Tensor.copy_", lambda: torch.empty_like(img).copy_(img))]
    else:
        lib = [("six torch.mul",
                lambda: [torch.mul(img, c) for c in P.TRIVIAL6_SCALES])]
    fn = getattr(P, name)
    order = [(f"{name} width 4", lambda: fn(img, 4)), *lib,
             (f"{name} width 1", lambda: fn(img, 1))]
    turns = {label: [] for label, _ in order}
    for seq in (order, order[::-1]):
        for label, f in seq:
            turns[label].append(round(device_ms(f)[0], 4))
    print(json.dumps({f"{name} turns": turns}), flush=True)
    return turns


def phase_probes(img, mask, errs, results, library, modes=PROBE_MODES):
    """The probe kernels beside their twins and library forms at 512^3."""
    import math

    nvox = img.numel()
    if "check" in modes:
        probe_checks(errs)

    def gbs(vols, ms):
        return vols * 4 * nvox / (ms * 1e-3) / 1e9

    width1 = {name: kern for name, kern, _, _ in probe_pairs(img, mask, 1)}
    want = {"pcopy1": "pcopy1", "trivial6": "trivial6",
            "hessian_eig_copyfloor": "hessian", "hessian_eig_copy6": "hessian",
            "hessian_eig_stencil6": "hessian",
            "features8_tap_copyfloor": "tap"}
    for name, kern, plain, lib in probe_pairs(img, mask):
        if want[name] not in modes:
            continue
        vols = PROBE_VOLUMES[name]
        km, kd = timed_both(f"{name} kernel", kern, "probes")
        pm = timed(f"{name} plain", plain, "probes")
        lm, ld = (timed_both(f"{name} library: {LIBRARY[name]}", lib, "probes")
                  if lib else (None, None))
        got, ref = kern(), plain()
        bitwise_check(f"{name} 512^3", got, ref)
        ab = max(_rel(g, r)[1] for g, r in zip(
            got if isinstance(got, tuple) else (got,),
            ref if isinstance(ref, tuple) else (ref,)))
        del got, ref
        errs[name].append(0.0)
        results[name] = dict(ms=km, device_ms=kd, plain_ms=pm, max_abs_err=ab)
        library[name] = (lm, ld)
        say("probes", f"{name}: device {kd:.3f} ms, {gbs(vols, kd):.0f} GB/s "
            f"touched ({vols} volumes; call {km:.3f} ms); plain {pm:.3f} ms"
            + (f"; library device {ld:.3f} ms, {gbs(vols, ld):.0f} GB/s (call "
               f"{lm:.3f})" if lm else ""))
        if name in ("pcopy1", "trivial6"):
            w1 = timed(f"{name} kernel, width 1", width1[name], "probes")
            say("probes", f"{name} width 1 (a float a thread): {w1:.3f} ms, "
                f"{gbs(vols, w1):.0f} GB/s, against width 4 {km:.3f} ms")
        if name == "pcopy1":
            cp, cd = timed_both("Tensor.copy_ of one 512^3 volume",
                                lambda: torch.empty_like(img).copy_(img),
                                "probes")
            say("probes", f"Tensor.copy_: device {cd:.3f} ms, "
                f"{gbs(2, cd):.0f} GB/s (call {cp:.3f})")
        if name in ("pcopy1", "trivial6"):
            streaming_turns(name, img)
        if name == "features8_tap_copyfloor":
            from ife_tpu_torch import kernels as K

            for sigma in (0.6, 1.2):
                fl = timed(f"s={sigma} features8_tap copy floor", lambda:
                           K.fused_features8_tap(img, mask, sigma, FULL_SPACING,
                                                 variant="copyfloor"), "probes")
                say("probes", f"s={sigma} features8_tap copy floor {fl:.3f} ms, "
                    f"{gbs(vols, fl):.0f} GB/s of its 10 volumes")
        torch.cuda.empty_cache()
    if "hessian" in modes:
        from ife_tpu_torch.kernels import probes as P

        # the Hessian kernel's time split, in turns: traffic (copy floor,
        # copy6), stencil, eigen solve (full); the first round after the
        # tap has run slower by up to 0.2 ms
        split = {}
        for _ in range(3):
            for mode, fn in (("copyfloor", lambda: P.floor_window(img)),
                             ("copy6", lambda: P.variant(img, "copy6")),
                             ("stencil6", lambda: P.variant(img, "stencil6")),
                             ("full", lambda: P.variant(img, "full"))):
                split.setdefault(mode, []).append(cuda_ms(fn)[0])
        say("probes", "hessian_eig split, ms (three rounds in turns): "
            + "; ".join(f"{m} {' / '.join(f'{t:.3f}' for t in ts)}"
                        for m, ts in split.items()))
    if "ovh" in modes:
        from ife_tpu_torch.kernels import probes as P

        t5 = launches_ms(lambda: P.trivial6(img), 5)
        t20 = launches_ms(lambda: P.trivial6(img), 20)
        say("probes", f"ovh: trivial6 {t5:.3f} ms a launch at 5 launches, "
            f"{t20:.3f} at 20")
        if not math.isclose(t5, t20, rel_tol=OVH_TOL):
            raise PhaseError(f"ovh: {t5:.3f} against {t20:.3f} ms a launch")
    if "ldg" in modes:
        # the global loads (LDG) and asynchronous global-to-shared copies
        # (LDGSTS, cp.async) of every Hessian and tap instantiation
        counts = sass_op_counts(
            ("hessian_eig_kernel", "features8_tap_kernel"), ("LDG", "LDGSTS"))
        if counts is None:
            say("probes", "LDG counts: not measured (no cuobjdump)")
        else:
            say("probes", "LDG / LDGSTS per instantiation: " + "; ".join(
                f"{k} {v['LDG']} / {v['LDGSTS']}"
                for k, v in sorted(counts.items())))
            # the copy floors (kCopyFloor, kCopy6: template outputs 1, 2)
            # keep the features' (output 0) loads, LDG and LDGSTS alike, in
            # each form of the rows (kWide: Lb1E 16-byte, Lb0E clamped)
            for wide in ("Lb1E", "Lb0E"):
                feats = [v for k, v in counts.items()
                         if f"hessian_eig_kernelILi0ELi0E{wide}" in k]
                floors = [v for k, v in counts.items()
                          if f"hessian_eig_kernelILi0ELi1E{wide}" in k
                          or f"hessian_eig_kernelILi0ELi2E{wide}" in k]
                if (len(feats) != 1 or len(floors) != 2
                        or feats[0]["LDG"] < 1
                        or any(f != feats[0] for f in floors)):
                    raise PhaseError(f"the copy floors do not keep the "
                                     f"Hessian's loads: {counts}")
            # the tap's row loads are cp.async (LDGSTS); the features (ring
            # in shared memory) add the mask's loads of the emit (LDG), the
            # copy floor has none
            tap = {flag: v for k, v in counts.items()
                   for flag in ("ILb0ELb1E", "ILb1ELb1E")
                   if "features8_tap_kernel" + flag in k}
            floor, feats = tap.get("ILb1ELb1E"), tap.get("ILb0ELb1E")
            if (floor is None or feats is None or floor["LDGSTS"] < 1
                    or floor["LDGSTS"] != feats["LDGSTS"]
                    or floor["LDG"] > feats["LDG"]):
                raise PhaseError(f"the tap's copy floor does not keep its "
                                 f"loads: {counts}")
    print(card_line(), flush=True)


def bench_run(*args):
    """(the last stdout line of `python3 bench_torch.py *args` as JSON, its
    wall s); a non-zero exit raises PhaseError with its stderr's tail."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "bench_torch.py")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, script, *args], capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise PhaseError(f"bench_torch.py {' '.join(args)} exited "
                         f"{res.returncode}: {res.stderr.strip()[-800:]}")
    return json.loads(res.stdout.strip().splitlines()[-1]), wall


def check_gate(label, report, launches):
    """Every gate entry < TOL, the dispatch entries over >= 3 branches;
    every kernel of BENCH_PATH in the mode's `launches`."""
    missing = [k for k in BENCH_PATH if launches.get(k, 0) < 1]
    if missing:
        raise PhaseError(f"bench {label}: launched no {missing} kernel "
                         f"({launches})")
    bad = {k: v for k, v in report.items() if not v < TOL}
    if bad:
        raise PhaseError(f"bench {label}: gate entries at or over {TOL}: {bad}")
    branches = {k.split("[")[1] for k in report if k.startswith("auto_s")}
    if len(branches) < 3:
        raise PhaseError(f"bench {label}: the gate reached the branches "
                         f"{branches}, fewer than 3")
    return max(report.values())


def phase_bench():
    """bench_torch.py's headline line, --verify and --all, each in a
    process of its own (the kernels come from this run's build)."""
    name = torch.cuda.get_device_name(0)
    head, head_s = bench_run()
    missing = [k for k in BENCH_PY_HEADLINE_KEYS if k not in head]
    want = f"hessian_eig_voxels_per_sec_chip_512cubed_{name.replace(' ', '_')}"
    if missing or head["metric"] != want:
        raise PhaseError(f"bench: headline keys missing {missing}, metric "
                         f"{head.get('metric')!r} (want {want!r})")
    if not (math.isfinite(head["value"]) and head["value"] > 0):
        raise PhaseError(f"bench: headline value {head['value']}")
    launches = {"headline": head.pop("launches")}
    worst = {"headline": check_gate("headline", head["verify"],
                                    launches["headline"])}
    ver, ver_s = bench_run("--verify")
    if ver.pop("verify") != "ok":
        raise PhaseError(f"bench --verify: {ver}")
    launches["verify"] = ver.pop("launches")
    worst["verify"] = check_gate("--verify", ver, launches["verify"])
    with tempfile.TemporaryDirectory(prefix="ife_bench_") as tmp:
        detail, all_s = bench_run("--all", "--out",
                                  os.path.join(tmp, "detail.json"))
    missing = [k for k in BENCH_PY_ARTIFACT_KEYS if k not in detail]
    errors = [k for k in detail if k.endswith("_error")]
    if missing or errors or detail["device"] != name:
        raise PhaseError(f"bench --all: keys missing {missing}, errors "
                         f"{errors}, device {detail.get('device')!r}")
    launches["all"] = detail.pop("launches")
    worst["all"] = check_gate("--all", detail.pop("verify_on_chip"),
                              launches["all"])
    say("bench", f"headline {head['value']:.6g} voxels/s "
        f"({head['vs_baseline']:.6g} x the pinned baseline), device ms "
        f"{head['ms']['device']}, call ms {head['ms']['call']}; worst gate "
        f"entry {max(worst.values()):.3g}; processes {head_s:.1f} / "
        f"{ver_s:.1f} / {all_s:.1f} s")
    print(json.dumps({"bench": {
        "headline": {k: head[k] for k in ("metric", "value", "vs_baseline",
                                          "spread", "ms")},
        "launches": launches,
        "configs": detail, "worst_gate_entry": worst,
        "wall_s": {"headline": head_s, "verify": ver_s, "all": all_s},
        "card": card_line()}}), flush=True)


def phase_profile(img, mask):
    """Device time per CUDA kernel of each pass (kernel_breakdown); a
    profiler that records no device time, or loses events, prints "not
    measured"."""
    from torch.profiler import ProfilerActivity, supported_activities

    from ife_tpu_torch.ops.features import (
        features8_auto_channels, hessian_eig_features_channels,
    )

    if ProfilerActivity.CUDA not in supported_activities():
        say("profile", "not measured (this torch cannot profile CUDA)")
        return

    # the route of the hessian-features CLI: the kernel and nothing else
    passes = [("hessian_eig_features_channels",
               lambda: hessian_eig_features_channels(img, FULL_SPACING))]
    passes += [(f"features8 s={s}",
                lambda s=s: features8_auto_channels(img, mask, s, FULL_SPACING))
               for s in SIGMAS]
    from ife_tpu_torch.kernels import histogram_counts_multi

    chans, edges, w = config4_inputs(img, mask)
    passes.append(("histogram config 4",
                   lambda: histogram_counts_multi(chans, edges, w)))
    from ife_tpu_torch.kernels import fused_features8_sweep_multi
    from ife_tpu_torch.ops.features import multiscale_features8_fused

    passes.append((f"multiscale_features8_fused {YS_SIGMAS}",
                   lambda: multiscale_features8_fused(img, mask, YS_SIGMAS,
                                                      FULL_SPACING)))
    passes.append((f"features8_sweep_multi {SWEEP_SIGMAS}",
                   lambda: fused_features8_sweep_multi(img, mask, SWEEP_SIGMAS,
                                                       FULL_SPACING)))
    from ife_tpu_torch import parallel as P

    mesh = P.make_mesh(4, ("x",))
    xi, mi = P.shard_volume(img, mesh), P.shard_volume(mask, mesh)
    passes += [(f"sharded_features8 4 blocks on x s={s}",
                lambda s=s: P.sharded_features8(xi, mi, s, mesh, FULL_SPACING,
                                                stack=False))
               for s in (1.2, 4.8)]
    for label, fn in passes:
        rows = kernel_breakdown(fn)
        if isinstance(rows, str):
            say("profile", f"{label}: not measured ({rows})")
            continue
        total = sum(ms for _, _, ms in rows)
        # the route launches the Hessian kernel's reference instantiation
        # (template output 4, kReference) and nothing beside it
        if label == "hessian_eig_features_channels" and (
                len(rows) != 1
                or not re.search(r"hessian_eig_kernel(<0,\s*4,|ILi0ELi4E)",
                                 rows[0][0])):
            raise PhaseError(f"{label}: not the hessian_eig kernel's "
                             f"reference output alone: {rows}")
        say("profile", f"{label}: device {total:.3f} ms per pass = "
            + "; ".join(f"{k[:60]} x{n} {ms:.3f}" for k, n, ms in
                        sorted(rows, key=lambda r: -r[2])))
        torch.cuda.empty_cache()


def kernel_breakdown(fn, calls=3, attempts=3):
    """[(kernel, launches a call, device ms a call)] of the device
    activities (kernels, copies, sets) of fn, counted one by one from
    torch.profiler's raw event list over `calls` calls, after a warm call
    and a warm-up step whose events the profiler drops by design. A string
    saying why where that cannot be had: no device time recorded, or a
    kernel whose events are not a multiple of `calls` in `attempts` tries
    (the profiler lost some; dividing would report a fraction of the
    truth)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    why = "no device time recorded"
    for _ in range(attempts):
        events = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls),
                     on_trace_ready=lambda p: events.extend(p.events())) as prof:
            for _ in range(1 + calls):
                fn()
                torch.cuda.synchronize()
                prof.step()
        counts, us = {}, {}
        for ev in events:
            # the ranges of record_function on the card are no work: the
            # steps' own and the program's spans (utils.profiling.span)
            if (ev.device_type != DeviceType.CUDA or ev.device_time_total <= 0
                    or getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith("ProfilerStep")):
                continue
            counts[ev.name] = counts.get(ev.name, 0) + 1
            us[ev.name] = us.get(ev.name, 0.0) + ev.device_time_total
        lost = {k[:60]: n for k, n in counts.items() if n % calls}
        if counts and not lost:
            return [(k, n // calls, us[k] / calls / 1e3)
                    for k, n in counts.items()]
        if lost:
            why = f"events not a multiple of {calls} calls: {lost}"
    return why


def rank_worker(rank, world, port):
    """One rank of `python3 chip_smoke.py --ranks N`: one block per rank on
    its own card. Every rank checks the gathered results against its own
    single-device pass; rank 0 prints."""
    import torch.distributed as dist

    from ife_tpu_torch import kernels as K
    from ife_tpu_torch import parallel as P
    from ife_tpu_torch.ops.features import features8_auto_channels

    P.distributed_init(f"127.0.0.1:{port}", world, rank)
    dev = P.default_device()
    if dev != torch.device("cuda", rank) or dist.get_backend() != "nccl":
        raise PhaseError(f"rank {rank}: on {dev} with {dist.get_backend()}")
    sp = FULL_SPACING
    img, mask = (v.to(dev) for v in _inputs(FULL, 2, "cpu"))
    mf = mask.clamp(0, 1)

    def slowest(fn):
        """ms of fn() on the slowest rank (median of 5 per rank)."""
        dist.barrier()
        ms = torch.tensor(cuda_ms(fn)[0], device=dev)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
        return ms.item()

    for axes in (("x",), ("x", "y")):
        mesh = P.make_mesh(world, axes)
        if len(mesh.local_blocks) != 1 or mesh.world_size != world:
            raise PhaseError(f"rank {rank}: owns blocks {mesh.local_blocks}")
        xi, mi = P.shard_volume(img, mesh), P.shard_volume(mask, mesh)
        line = []
        for sigma in SIGMAS:
            got = _gathered(P.sharded_features8(xi, mi, sigma, mesh, sp,
                                                stack=False))
            want = features8_auto_channels(img, mask, sigma, sp)
            if not takes_staged_passes(sigma):  # the xs-stream branch
                rel, _ = feature_errors(got, want, (2, 3, 4), tol=SHARD_TOL)
                if rel > SHARD_TOL:
                    raise PhaseError(f"rank {rank} s={sigma}: {rel:.2e} from "
                                     "the single-device pass")
                want = K.fused_features8_post_stream(
                    K.fused_normalized_conv_sweep(img, mf, sigma, sp), mf, sp,
                    stack=False)
            if not bit_equal(got, want):
                raise PhaseError(f"rank {rank}: sharded_features8 {mesh.dims} "
                                 f"s={sigma} differs from the single device")
            del got, want
            one = cuda_ms(lambda: features8_auto_channels(img, mask, sigma, sp))[0]
            blk = slowest(lambda: P.sharded_features8(xi, mi, sigma, mesh, sp,
                                                      stack=False))
            line.append(f"s={sigma} {blk:.3f} ms ({one:.3f} on one card)")
        got = _gathered(P.sharded_hessian_eig(xi, mesh, sp, stack=False))
        if not bit_equal(got, K.fused_hessian_eig_stream(img, sp, stack=False)):
            raise PhaseError(f"rank {rank}: sharded_hessian_eig differs")
        del got
        blk = slowest(lambda: P.sharded_hessian_eig(xi, mesh, sp, stack=False))
        one_mesh = P.BlockMesh((1,), ("x",), dev)  # this rank alone
        bounds, counts = P.masked_fine_histogram(xi, mi, mesh, 4096)
        wb, wc = P.masked_fine_histogram(
            P.ShardedVolume(one_mesh, [img]), P.ShardedVolume(one_mesh, [mask]),
            one_mesh, 4096)
        # one_mesh's all_reduce sums the ranks' identical whole-volume counts
        if not ((bounds == wb).all() and (counts * world == wc).all()):
            raise PhaseError(f"rank {rank}: fine histogram differs")
        if rank == 0:
            say("ranks", f"{world} ranks over NCCL, one block each, mesh "
                f"{mesh.dims}, 512^3, bit-equal to each rank's single-device "
                f"pass (s=2.4: to nc + post); slowest rank: " + "; ".join(line)
                + f"; hessian {blk:.3f} ms; fine histogram of "
                f"{int(counts.sum())} voxels equal")
    dist.barrier()
    P.distributed_shutdown()
    return 0


def phase_ranks(world):
    """`--ranks N`: build once, then N rank_worker processes."""
    import socket

    from ife_tpu_torch.kernels import _build

    phase_device()
    if torch.cuda.device_count() < world:
        raise PhaseError(f"--ranks {world} needs {world} cards, found "
                         f"{torch.cuda.device_count()}")
    _build.build()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-worker", str(r),
         str(world), str(port)], stdout=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print(outs[0], end="", flush=True)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise PhaseError(f"ranks {bad} failed")
    print(card_line(), flush=True)


def xs_kernel_alone(num, den, m, sigma, sp):
    """The launch of fused_features8_xs after its y/z passes: the xs kernel
    alone on fused_smooth_yz's num / den and the clamped mask m, through
    the checkout's launcher (the C entry is the same in every checkout)."""
    from ife_tpu_torch.kernels._build import launch
    from ife_tpu_torch.kernels.features8_sweep import _c_taps
    from ife_tpu_torch.kernels.hessian_eig import stencil_reciprocals
    from ife_tpu_torch.ops.stencil import smooth_taps

    tx, ntx = _c_taps(smooth_taps(float(sigma), float(sp[0]), 4.5)[0])
    X, Y, Z = num.shape
    out = torch.empty((8, X, Y, Z), dtype=num.dtype, device=num.device)
    launch("features8_xs", num.device, num.data_ptr(), den.data_ptr(),
           m.data_ptr(), out.data_ptr(), X, Y, Z, tx, ntx,
           *stencil_reciprocals(sp))
    return out


def both_ms(fn):
    """[call ms, device ms] of fn, each (median, min, max) of 5."""
    return [[round(t, 3) for t in cuda_ms(fn)],
            [round(t, 3) for t in device_ms(fn)]]


def tap_xs_times(img, mask, sp):
    """The direct entries' part of --sweep-times (both_ms each): the tap at
    sigma 0.6 and 1.2, at equal radius 8 and at the largest equal radius its
    tap_fits takes (unit spacing), its copy floor at 0.6 and 1.2, the xs
    kernel alone on precomputed fused_smooth_yz outputs at 1.2 and 4.8, and
    the whole xs entry at 1.2."""
    from ife_tpu_torch import kernels as K

    res = {}
    for s in (0.6, 1.2):
        res[f"tap {s}"] = both_ms(
            lambda: K.fused_features8_tap(img, mask, s, sp))
    unit = (1.0, 1.0, 1.0)
    for r in sorted({8, tap_max_radius(K)}):
        res[f"tap r {r}"] = both_ms(
            lambda: K.fused_features8_tap(img, mask, r / 4.5, unit))
    for s in (0.6, 1.2):
        res[f"tap copyfloor {s}"] = both_ms(lambda: K.fused_features8_tap(
            img, mask, s, sp, variant="copyfloor"))
    m = mask.clamp(0, 1)
    for s in (1.2, 4.8):
        num, den = K.fused_smooth_yz(img, m, s, sp)
        res[f"xs kernel {s}"] = both_ms(
            lambda: xs_kernel_alone(num, den, m, s, sp))
        del num, den
    res["xs 1.2"] = both_ms(lambda: K.fused_features8_xs(img, mask, 1.2, sp))
    torch.cuda.empty_cache()
    return res


def hessian_times(img, sp):
    """The Hessian kernel's part of --sweep-times (both_ms each): the whole
    volume, x_halo with the volume's face rows as halo, pre_padded on its
    edge layer, the copy floor, copy6, stencil6, the reference output where
    the checkout has it, and trivial6 (one read, six writes) beside them."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch.kernels import probes as P

    halo = (img[:1].contiguous(), img[-1:].contiguous())
    pad = edge_layer(img)
    entries = [
        ("hessian whole", lambda: K.fused_hessian_eig_stream(img, sp,
                                                             stack=False)),
        ("hessian x_halo", lambda: K.fused_hessian_eig_stream(
            img, sp, stack=False, x_halo=halo)),
        ("hessian pre_padded", lambda: K.fused_hessian_eig(
            pad, sp, stack=False, pre_padded=True)),
        ("hessian copyfloor", lambda: K.fused_hessian_eig(
            img, sp, stack=False, variant="copyfloor")),
        ("hessian copy6", lambda: P.variant(img, "copy6", sp)),
        ("hessian stencil6", lambda: P.variant(img, "stencil6", sp)),
        ("trivial6", lambda: P.trivial6(img)),
    ]
    # a checkout from before the reference output has none
    if hasattr(K, "hessian_eig_reference_features"):
        entries.insert(6, ("hessian reference",
                           lambda: K.hessian_eig_reference_features(img, sp)))
    res = {name: both_ms(fn) for name, fn in entries}
    # beside phase 5's: [host ms, of it allocating 6 outputs, Python
    # objects, SM MHz, call ms again, after 1 s idle] (call_gap)
    res["hessian x_halo call-ms gap"] = call_gap(entries[1][1], img, 6)
    del pad
    torch.cuda.empty_cache()
    return res


def clocks_under_load(fn, seconds=3.0):
    """[median SM MHz, median board W, samples] of nvidia-smi's readings
    every 100 ms while fn runs back to back on the card for `seconds`."""
    import statistics

    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(DEVICE_CALLS):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=60)[0]
    rows = [line.split(",") for line in out.splitlines() if "," in line]
    # the readings taken while the card was busy: skip the first and last
    rows = rows[2:-2] or rows
    mhz = [float(r[0]) for r in rows]
    watts = [float(r[1]) for r in rows]
    return [statistics.median(mhz), statistics.median(watts), len(rows)]


def nc_times(img, mask, sp):
    """The normalized-convolution part of --sweep-times (both_ms each):
    nc at sigma 2.4 / 4.8, its tiled entry (2 slabs) at 4.8, smooth_yz at
    2.4 (y radius 14) / 4.8 and smooth_xz at 2.4 / 4.8, then what runs them:
    features8 at 2.4 / 4.8 (features8_auto_channels), the config-3 stack in
    its one-launch form and sharded_features8 on 4 blocks on x at 4.8; for
    nc 4.8, smooth_yz 2.4 and smooth_xz 4.8 the profiler's rows per kernel
    (kernel_breakdown) and the SM clock and board power while each runs
    back to back (clocks_under_load)."""
    from ife_tpu_torch import kernels as K
    from ife_tpu_torch import parallel as P
    from ife_tpu_torch.ops.features import features8_auto_channels

    res = {}
    for s in YS_SIGMAS:
        res[f"nc {s}"] = both_ms(
            lambda: K.fused_normalized_conv_sweep(img, mask, s, sp))
    res["nc tiled 4.8"] = both_ms(lambda: K.fused_normalized_conv_sweep_tiled(
        img, mask, 4.8, sp, n_tiles=2))
    for name in ("smooth_yz", "smooth_xz"):
        fn = getattr(K, f"fused_{name}")
        for s in YS_SIGMAS:
            res[f"{name} {s}"] = both_ms(lambda: fn(img, mask, s, sp))
    for s in YS_SIGMAS:
        res[f"features8 {s}"] = both_ms(
            lambda: features8_auto_channels(img, mask, s, sp))
    res["config-3 stack one-launch"] = both_ms(
        lambda: config3_stack(img, mask, sp))
    mesh = P.make_mesh(4, ("x",))
    xi, mi = P.shard_volume(img, mesh), P.shard_volume(mask, mesh)
    res["sharded_features8 4 blocks on x 4.8"] = both_ms(
        lambda: P.sharded_features8(xi, mi, 4.8, mesh, sp, stack=False))
    del xi, mi
    # the passes each entry launches: [kernel, launches, device ms] a call
    for label, fn in (
            ("nc 4.8", lambda: K.fused_normalized_conv_sweep(img, mask, 4.8,
                                                             sp)),
            ("smooth_yz 2.4", lambda: K.fused_smooth_yz(img, mask, 2.4, sp)),
            ("smooth_xz 4.8", lambda: K.fused_smooth_xz(img, mask, 4.8, sp))):
        rows = kernel_breakdown(fn)
        res[f"{label} kernels"] = rows if isinstance(rows, str) else [
            [k[:60], n, round(ms, 3)] for k, n, ms in rows]
        # the clock the FIR's arithmetic runs at: [SM MHz, W, samples]
        res[f"{label} under load"] = clocks_under_load(fn)
    torch.cuda.empty_cache()
    return res


def sweep_times(label, groups=("sweep", "tap", "hessian", "nc")):
    """`--sweep-times [ROOT [GROUP...]]`: one JSON line of 512^3 times
    (both_ms: call ms and device ms, each median, min, max of 5) of the
    ife_tpu_torch package on sys.path. Group "sweep": the sweep at sigma
    0.6 / 1.2 / 1.7, with clamps and under a mask of ones, sweep_multi, the
    staged pair, xs_stream at x radius 11 / 14 / 17 / 20 / 24 (14 also under
    a mask of ones), ys_multi at S = 1 .. 4 (S = 2 also under a mask of
    ones); group "tap": the direct entries (tap_xs_times); group "hessian":
    the Hessian kernel in every mode and output (hessian_times); group
    "nc": the normalized-convolution kernels and what runs them (nc_times).
    Run it on two checkouts in turns to compare them within one call on one
    card."""
    from ife_tpu_torch import kernels as K

    if not torch.cuda.is_available():
        raise PhaseError("torch.cuda.is_available() is false")
    sp = FULL_SPACING
    img, mask = _inputs(FULL, 2, "cuda")
    Y = FULL[1]

    res = {"label": label, "card": card_line()}
    if "tap" in groups:
        res.update(tap_xs_times(img, mask, sp))
    if "hessian" in groups:
        res.update(hessian_times(img, sp))
    if "nc" in groups:
        res.update(nc_times(img, mask, sp))
    if "sweep" not in groups:
        print(json.dumps(res), flush=True)
        return
    for s in SWEEP_VS_STAGED:
        res[f"sweep {s}"] = both_ms(
            lambda: K.fused_features8_sweep(img, mask, s, sp))
    res["sweep 1.2 clamps"] = both_ms(lambda: K.fused_features8_sweep(
        img, mask, 1.2, sp, clamps=[2, K.NO_FACE, -K.NO_FACE, Y - 3]))
    ones = torch.ones_like(mask)
    res["sweep 1.2 mask of ones"] = both_ms(
        lambda: K.fused_features8_sweep(img, ones, 1.2, sp))
    del ones
    res[f"sweep_multi {SWEEP_SIGMAS}"] = both_ms(
        lambda: K.fused_features8_sweep_multi(img, mask, SWEEP_SIGMAS, sp))
    mf = mask.clamp(0, 1)
    for s in SWEEP_VS_STAGED:
        res[f"nc+post {s}"] = both_ms(lambda: K.fused_features8_post_stream(
            K.fused_normalized_conv_sweep(img, mf, s, sp), mf, sp))
    ones = torch.ones_like(mask)
    for rx in (11, 14, 17, 20, 24):
        sigma = round((rx - 0.5) * sp[0] / 4.5, 4)
        for label, m in (("", mask), (" mask of ones", ones))[:1 + (rx == 14)]:
            num, den = K.fused_smooth_yz(img, m, sigma, sp)
            res[f"xs_stream rx {rx}{label}"] = both_ms(
                lambda: K.fused_features8_xs_stream(num, den, m, sigma, sp))
            del num, den
    for sigmas in YS_CHECK_SIGMAS:
        for label, m in (("", mask), (" mask of ones", ones))[
                :1 + (sigmas == YS_SIGMAS)]:
            kern, _ = ys_multi_pair(img, m, sigmas, sp)
            res[f"ys_multi {sigmas}{label}"] = both_ms(kern)
            del kern
    del ones
    torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)


def import_from(checkout):
    """Make `checkout`'s ife_tpu_torch the package later imports load: the
    modules of the one loaded so far are forgotten (the yardsticks imported
    above keep theirs, so every checkout is timed by this script's), then
    the checkout goes first on sys.path."""
    for name in [m for m in sys.modules
                 if m == "ife_tpu_torch" or m.startswith("ife_tpu_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, checkout)


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "ife_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repo "
              "(ife_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--sweep-times"]:
        other = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else root
        groups = tuple(sys.argv[3:]) or ("sweep", "tap", "hessian", "nc")
        import_from(other)
        try:
            if not set(groups) <= {"sweep", "tap", "hessian", "nc"}:
                raise PhaseError(f"unknown groups {groups}: sweep, tap, "
                                 "hessian, nc")
            sweep_times(other, groups)
        except PhaseError as e:
            print(f"chip_smoke: --sweep-times failed: {e}", file=sys.stderr)
            return 1
        return 0
    if sys.argv[1:2] == ["--hist-times"]:
        other = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else root
        import_from(other)
        try:
            hist_times(other)
        except PhaseError as e:
            print(f"chip_smoke: --hist-times failed: {e}", file=sys.stderr)
            return 1
        return 0
    sys.path.insert(0, root)

    if sys.argv[1:2] == ["--dispatch-table"]:
        try:
            phase_device()
            phase_build()
            img, mask = _inputs(FULL, 2, "cuda")
            phase_dispatch(img, mask)
        except PhaseError as e:
            print(f"chip_smoke: --dispatch-table failed: {e}", file=sys.stderr)
            return 1
        return 0

    if sys.argv[1:2] == ["--dense"]:
        try:
            phase_device()
            phase_build()
            img, _ = _inputs(FULL, 2, "cuda")
            results = {}
            launches, work = phase_full_dense(img, {"dense_hist": []}, results)
            bound = kernel_bounds(img.numel(), (0, 0), work)["dense_hist"]
            print(json.dumps({"dense": dict(
                launches=launches["dense_hist"], **results["dense_hist"],
                bound_ms=bound[0], bound_by=bound[1], library_ms=None)}),
                flush=True)
        except PhaseError as e:
            print(f"chip_smoke: --dense failed: {e}", file=sys.stderr)
            return 1
        return 0

    if sys.argv[1:2] == ["--dicom"]:
        budget = Budget()
        try:
            budget.enter("device")
            phase_device()
            budget.enter("build")
            phase_build()
            budget.enter("dicom")
            with tempfile.TemporaryDirectory(prefix="ife_chip_smoke_") as tmp:
                phase_dicom(tmp, DICOM_SHAPE, None, None)
        except PhaseError as e:
            print(f"chip_smoke: --dicom failed: {e}", file=sys.stderr)
            return 1
        budget.report()
        return 0

    if sys.argv[1:2] == ["--cli-full"]:
        budget = Budget()
        try:
            budget.enter("device")
            phase_device()
            budget.enter("build")
            phase_build()
            budget.enter("main")
            with tempfile.TemporaryDirectory(prefix="ife_chip_smoke_") as tmp:
                phase_main(tmp, CLI_SHAPE)
        except PhaseError as e:
            print(f"chip_smoke: --cli-full failed: {e}", file=sys.stderr)
            return 1
        budget.report()
        return 0

    if sys.argv[1:2] == ["--profile"]:
        try:
            phase_build()
            img, mask = _inputs(FULL, 2, "cuda")
            phase_profile(img, mask)
        except PhaseError as e:
            print(f"chip_smoke: --profile failed: {e}", file=sys.stderr)
            return 1
        return 0

    if sys.argv[1:2] == ["--probes"]:
        modes = tuple(sys.argv[2:]) or PROBE_MODES
        try:
            bad = [m for m in modes if m not in PROBE_MODES]
            if bad:
                raise PhaseError(f"unknown modes {bad}; modes: {PROBE_MODES}")
            phase_device()
            phase_build()
            img, mask = _inputs(FULL, 2, "cuda")
            phase_probes(img, mask, {k: [] for k in KERNELS}, {}, {}, modes)
        except PhaseError as e:
            print(f"chip_smoke: --probes failed: {e}", file=sys.stderr)
            return 1
        return 0

    if sys.argv[1:2] in (["--ranks"], ["--rank-worker"]):
        try:
            if sys.argv[1] == "--rank-worker":
                return rank_worker(*(int(a) for a in sys.argv[2:5]))
            phase_ranks(int(sys.argv[2]))
        except PhaseError as e:
            print(f"chip_smoke: phase ranks failed: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    budget = Budget()
    phase = budget.enter("device")
    try:
        phase_device()
        phase = budget.enter("build")
        phase_build()
        errs = {k: [] for k in KERNELS}
        phase = budget.enter("kernels")
        phase_kernels(errs)
        phase = budget.enter("main")
        with tempfile.TemporaryDirectory(prefix="ife_chip_smoke_") as tmp:
            launches, img, mask = phase_main(tmp)
            phase = budget.enter("bags")
            bag_launches, host_bag_s, binning = phase_bags(tmp)
            phase = budget.enter("tools")
            tool_launches = phase_tools(tmp, img, mask)
            phase = budget.enter("dicom")
            dicom_launches = phase_dicom(tmp, DICOM_SMOKE_SHAPE, host_bag_s,
                                         binning)
            phase = budget.enter("sharded")
            cli_launches = phase_sharded_cli(tmp)
        shard_launches = phase_sharded(img, mask)
        shard_launches = {k: v + cli_launches[k]
                          for k, v in shard_launches.items()}
        missing = [k for k in SHARDED_PATH if shard_launches.get(k, 0) < 1]
        if missing:
            raise PhaseError(f"sharded path launched no {missing} kernel")
        phase = budget.enter("multiscale")
        multi_launches = phase_multiscale(img, mask)
        phase = budget.enter("graft")
        graft_launches = phase_graft()
        launches = {k: launches[k] + bag_launches[k] + tool_launches[k]
                    + dicom_launches[k] + multi_launches[k]
                    + shard_launches[k] + graft_launches[k] for k in launches}
        phase = budget.enter("full")
        results = {}
        phase_full(img, mask, errs, results)
        phase_full_sweep(img, mask, errs)
        phase = budget.enter("dispatch")
        phase_dispatch(img, mask)
        phase = budget.enter("full")
        phase_full_multi(img, mask, errs, results)
        phase_full_modes(img, mask, errs, results)
        hist_work = phase_full_hist(img, mask, errs, results)
        dense_launches, dense_work = phase_full_dense(img, errs, results)
        launches = {k: launches[k] + dense_launches[k] for k in launches}
        bounds = kernel_bounds(img.numel(), hist_work, dense_work)
        phase = budget.enter("probes")
        probe_launches = probe_path(img, mask)
        launches = {k: launches[k] + probe_launches[k] for k in launches}
        library = {}
        phase_probes(img, mask, errs, results, library)
        missing = [k for k in KERNELS if "device_ms" not in results.get(k, {})]
        if missing:
            raise PhaseError(f"no device time for {missing}")
        del img, mask
        torch.cuda.empty_cache()
        phase = budget.enter("bench")
        phase_bench()
        phase = budget.enter("profile")
        # in a process of its own: in this one, after the sharded phase's
        # NCCL group and phase 5's profiles, the profiler kept two of three
        # events of the passes of one kernel
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--profile"], capture_output=True, text=True,
                             timeout=600)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            raise PhaseError(res.stderr.strip()[-400:])
    except PhaseError as e:
        print(f"chip_smoke: phase {phase} failed: {e}", file=sys.stderr)
        return 1
    # launches: counted in phase 4 (the six paths' runs added), in phase
    # 5's dense bag and on the probe path; ms, plain_ms, max_abs_err and
    # library_ms: measured at 512^3 (at REPORT_SIGMA for the smoothing
    # kernels, YS_SIGMAS / SWEEP_SIGMAS for the multi-scale ones, the
    # config-4 shape for the histogram, one scale of the dense bag's lung
    # for dense_hist); bound_ms: computed from the same shapes;
    # max_rel_err: the worst of phases 3, 5 and probes
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **results[name],
             bound_ms=bounds[name][0], bound_by=bounds[name][1],
             library_ms=library.get(name, (None, None))[0],
             library_device_ms=library.get(name, (None, None))[1],
             library=LIBRARY.get(name, NO_LIBRARY),
             max_rel_err=max(errs[name]))
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    budget.report()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
