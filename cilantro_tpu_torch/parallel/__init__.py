"""Multi-rank paths on ``torch.distributed`` (port of
``cilantro_tpu.parallel``): the ``(points, map)`` mesh, sharded ICP and the
ring NN, map-sharded fusion, point-sharded warp fields, and the runtime
entry. The collectives live in :mod:`.collectives`."""

from .sharded import (  # noqa: F401
    make_mesh,
    sharded_combined_icp,
    sharded_combined_icp_ring,
    shard_cloud_arrays,
)
from .sharded import ring_nn1  # noqa: F401
from .sharded_fusion import (  # noqa: F401
    init_sharded_map,
    sharded_fusion_step,
)
from .distributed import (  # noqa: F401
    initialize_distributed,
    process_info,
)
from .sharded_warp import (  # noqa: F401
    shard_warp_problem,
    sharded_estimate_warp_field,
    sharded_icp_warp_field,
)
