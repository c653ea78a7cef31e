"""Distributed layer: mesh, sharded scale space, BA, PGO, frontend."""

from sift_parallel_optimization.parallel.ba import (  # noqa: F401
    distributed_bundle_adjust,
)
from sift_parallel_optimization.parallel.frontend import (  # noqa: F401
    batched_extract_features,
)
from sift_parallel_optimization.parallel.mesh import (  # noqa: F401
    initialize_distributed,
    make_mesh,
)
from sift_parallel_optimization.parallel.matching import (  # noqa: F401
    covisibility_order,
    pairwise_match_counts,
    ring_pairwise_match_counts,
)
from sift_parallel_optimization.parallel.pose_graph import (  # noqa: F401
    distributed_pgo,
)
