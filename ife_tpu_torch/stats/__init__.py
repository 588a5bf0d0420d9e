from ife_tpu_torch.stats.histogram import (  # noqa: F401
    DenseHistogram,
    histogram_counts,
    histogram_counts_plain,
    batched_histogram_counts,
)
from ife_tpu_torch.stats.equalize import (  # noqa: F401
    determine_edges_for_equalized_histogram,
    edges_from_dense_counts,
)
