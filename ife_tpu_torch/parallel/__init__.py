"""The sharded path: block meshes, halo exchange, sharded feature ops and
collective statistics (counterpart of ife_tpu/parallel)."""
from ife_tpu_torch.parallel.mesh import (  # noqa: F401
    BlockMesh,
    ShardedVolume,
    crop_from_mesh,
    default_device,
    gather_volume,
    gather_volume_to,
    make_mesh,
    mesh_dims,
    pad_to_mesh,
    shard_volume,
)
from ife_tpu_torch.parallel.halo import (  # noqa: F401
    halo_exchange,
    halo_pad,
    halo_slabs,
)
from ife_tpu_torch.parallel.features import (  # noqa: F401
    features8_sharded_auto,
    features8_sharded_channels_to,
    sharded_features8,
    sharded_hessian_eig,
    sharded_multiscale_features,
)
from ife_tpu_torch.parallel.stats import (  # noqa: F401
    histogram_quantile_edges,
    masked_fine_histogram,
    masked_fine_histograms_multi,
    merge_fine_histograms,
    sharded_feature_fine_histograms,
    sharded_masked_histogram,
)
from ife_tpu_torch.parallel.launcher import (  # noqa: F401
    ShardManifest,
    distributed_init,
    distributed_init_from_args,
    distributed_shutdown,
    fetch_to_host,
    is_primary,
)
