"""Fusion, keyframe SLAM and its backend (port of ``cilantro_tpu.slam``).

Re-exports what the JAX package's ``slam`` exports from the ported
modules, the landmark-sharded ``bundle_adjust_sharded`` with them."""

from .fusion import (  # noqa: F401
    FusionConfig,
    FusionMap,
    cleanup_map,
    compact_map,
    empty_map,
    fusion_step,
    init_map_from_frame,
    integrate_frame,
    localize,
    radial_weights,
)
from .pose_graph import optimize_pose_graph, pose_error  # noqa: F401
from .bundle_adjustment import bundle_adjust, bundle_adjust_sharded  # noqa: F401
from .driver import (  # noqa: F401
    FusionMetrics,
    ate_rmse,
    run_fusion_sequence,
    run_fusion_sequence_scanned,
    synthetic_panorama_sequence,
    synthetic_sequence,
)
from .slam import (  # noqa: F401
    SlamConfig,
    SlamResult,
    integrate_sequence,
    run_slam,
)
from .keyframes import (  # noqa: F401
    Keyframe,
    KeyframeGraph,
    detect_loop_closures,
    relative_pose,
    spawn_keyframe,
)
from .checkpoint import (  # noqa: F401
    FusionCheckpoint,
    load_checkpoint,
    save_checkpoint,
)
from .splat_fusion import (  # noqa: F401
    SplatConfig,
    SplatMap,
    extract_cloud,
    init_splat_map,
    run_splat_sequence,
    run_splat_sequence_scanned,
    splat_fusion_step,
    splat_integrate,
    splat_localize,
)
from .pipeline import (  # noqa: F401
    make_pipeline_mesh,
    run_fusion_sequence_pipelined,
)
from .batched_fusion import (  # noqa: F401
    BatchedFusionMetrics,
    batched_fusion_step,
    batched_integrate,
    batched_seed_localize_target,
    run_batched_fusion_sequences,
    stack_maps,
    unstack_maps,
)
