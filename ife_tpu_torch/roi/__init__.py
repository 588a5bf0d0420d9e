from ife_tpu_torch.roi.generate import (  # noqa: F401
    ROI,
    generate_random_rois,
    generate_dense_rois,
)
from ife_tpu_torch.roi.bag import make_bag, make_bag_device  # noqa: F401
