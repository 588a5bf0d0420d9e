"""ife_tpu_torch — the PyTorch/CUDA port of ife_tpu for NVIDIA Hopper.

The same dense 3D feature extraction as ``ife_tpu`` (masked Gaussian
scale-space smoothing, central-difference gradient/Hessian stencils,
closed-form 3x3 eigen features, the 8-channel features8 pass), rebuilt on
PyTorch tensors with hand-written CUDA kernels (``ife_tpu_torch/csrc``) for
the hot passes. ``ife_tpu`` stays the reference each function is tested
against; this package imports neither it nor JAX.

Index convention as in ife_tpu: volumes are (X, Y, Z) tensors indexed
[x, y, z] (z fastest in memory), spacing/origin are (sx, sy, sz) tuples.
A function runs on the device of the tensors it is given.
"""
import torch

# The reference runs its band contractions at Precision.HIGHEST
# (ife_tpu/ops/stencil.py:48); TF32 keeps ~3 decimal digits, so it is off
# for every matmul and cuDNN convolution this process runs.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from ife_tpu_torch.core.volume import Volume  # noqa: E402,F401
