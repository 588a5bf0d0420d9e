from ife_tpu_torch.roi.generate import (  # noqa: F401
    ROI,
    generate_random_rois,
    generate_dense_rois,
)
from ife_tpu_torch.roi.bag import (  # noqa: F401
    make_bag,
    make_bag_dense_device,
    make_bag_device,
)
