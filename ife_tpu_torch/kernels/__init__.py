"""Hand-written CUDA kernels for the hot passes (sources in
``ife_tpu_torch/csrc``, built with nvcc for sm_90a at first use).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch twin, in the same module, for a CPU tensor; ``LAUNCHES`` counts the
kernel launches per kernel. Counterparts of ife_tpu/kernels/fused.py:

  fused_hessian_eig_stream, fused_hessian_eig -> csrc/hessian_eig.cu
  (and hessian_eig_reference_features, the same kernel on the reference's
  eigen path: ife_tpu.ops.features.hessian_eig_features)
  fused_normalized_conv_sweep,
  fused_normalized_conv_sweep_tiled           -> csrc/normalized_conv.cu
  fused_features8_post_stream,
  fused_features8_post                        -> csrc/features8_post.cu
  fused_features8_sweep,
  fused_features8_sweep_multi,
  fused_features8_xs_stream                   -> csrc/features8_sweep.cu
  fused_features8_ys_multi                    -> csrc/features8_ys_multi.cu
  fused_features8_tap, fused_features8_xs     -> csrc/features8_tap.cu
  fused_hessian_eig(variant="copyfloor")      -> csrc/hessian_eig.cu
  fused_features8_tap(variant="copyfloor")    -> csrc/features8_tap.cu

and of ife_tpu/kernels/histogram.py:

  histogram_counts_multi, histogram_counts_pallas
  (-> histogram_counts_kernel), plus the per-ROI
  binning (-> histogram_boxes)                -> csrc/histogram.cu

and, with no ife_tpu counterpart (ife_tpu bins a dense bag box by box):

  dense_hist_rows (every ROI of MakeBagDense's
  dense grid, kernels/dense_hist.py)          -> csrc/dense_hist.cu
  (its last plan of the rows kernel in DENSE_HIST_PLAN)

of benchmarks/ (the roofline probes, kernels/probes.py):

  trivial6, pcopy1                            -> csrc/probes.cu
  floor_window, variant("copy6" / "stencil6") -> csrc/hessian_eig.cu

plus fused_smooth_yz and fused_smooth_xz (csrc/normalized_conv.cu), the y/z
passes ahead of the xs-stream kernel and the x/z passes ahead of the
ys-multi kernel. ife_tpu's fused_features8 dispatcher is torch code here:
ops.features.fused_features8. Every function of ife_tpu/kernels that reaches
a Pallas kernel has its counterpart, with the shard modes of the sharded
path (parallel/): clamps of the two sweeps, x_halo and pre_padded of the
Hessian and post kernels, and the probe outputs, each counted apart in
LAUNCHES.
"""
from ife_tpu_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401
from ife_tpu_torch.kernels.dense_hist import DENSE_HIST_PLAN  # noqa: F401
from ife_tpu_torch.kernels.features8_post import (  # noqa: F401
    features8_post_plain,
    fused_features8_post,
    fused_features8_post_stream,
)
from ife_tpu_torch.kernels.features8_sweep import (  # noqa: F401
    NO_FACE,
    SWEEP_MAX_RX,
    features8_sweep_multi_plain,
    features8_sweep_plain,
    features8_xs_stream_plain,
    fused_features8_sweep,
    fused_features8_sweep_multi,
    fused_features8_xs_stream,
    sweep_fits,
    sweep_multi_fits,
    sweep_multi_max_scales,
    xs_stream_fits,
)
from ife_tpu_torch.kernels.features8_tap import (  # noqa: F401
    features8_tap_copyfloor_plain,
    features8_tap_plain,
    features8_xs_plain,
    fused_features8_tap,
    fused_features8_xs,
    tap_fits,
    xs_fits,
)
from ife_tpu_torch.kernels.features8_ys_multi import (  # noqa: F401
    features8_ys_multi_plain,
    fused_features8_ys_multi,
)
from ife_tpu_torch.kernels.histogram import (  # noqa: F401
    histogram_boxes,
    histogram_boxes_plain,
    histogram_counts_kernel,
    histogram_counts_multi,
    histogram_counts_multi_plain,
    histogram_plain,
)
from ife_tpu_torch.kernels.hessian_eig import (  # noqa: F401
    fused_hessian_eig,
    fused_hessian_eig_stream,
    hessian_eig_copyfloor_plain,
    hessian_eig_plain,
    hessian_eig_reference_features,
    hessian_eig_reference_plain,
    hessian_plan,
)
from ife_tpu_torch.kernels.normalized_conv import (  # noqa: F401
    fused_normalized_conv_sweep,
    fused_normalized_conv_sweep_tiled,
    fused_smooth_xz,
    fused_smooth_yz,
    normalized_conv_plain,
    normalized_conv_tiled_plain,
    smooth_xz_plain,
    smooth_yz_plain,
)
from ife_tpu_torch.kernels.probes import (  # noqa: F401
    floor_window,
    floor_window_plain,
    pcopy1,
    pcopy1_plain,
    trivial6,
    trivial6_plain,
    variant,
    variant_plain,
)
