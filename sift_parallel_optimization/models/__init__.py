"""Model layer: frontend, matching, geometry, SfM, BA, PGO."""

from sift_parallel_optimization.models.ba import (  # noqa: F401
    BAState,
    Observations,
    bundle_adjust,
    bundle_adjust_lm,
    resolve_solver,
)
from sift_parallel_optimization.models.frontend import (  # noqa: F401
    Features,
    extract_features,
    sift_config,
)
from sift_parallel_optimization.models.keypoints import (  # noqa: F401
    Keypoints,
)
from sift_parallel_optimization.models.matching import (  # noqa: F401
    match_descriptors,
    ransac_fundamental,
    ransac_homography,
)
from sift_parallel_optimization.models.pose_graph import (  # noqa: F401
    PoseGraphEdges,
    Poses,
    optimize_pose_graph,
)
from sift_parallel_optimization.models.pose_graph_sim3 import (  # noqa: F401
    Sim3Edges,
    Sim3Poses,
    optimize_sim3_graph,
)
from sift_parallel_optimization.models.odometry import (  # noqa: F401
    OdometryStream,
    Trajectory,
    run_odometry,
)
from sift_parallel_optimization.models.sfm import (  # noqa: F401
    SfmMap,
    run_sfm,
)
