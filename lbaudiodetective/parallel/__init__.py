"""Multi-chip parallelism: device meshes, sharded extraction/matching, and
ring collectives for pod-scale library search.

The reference is single-threaded and single-process (SURVEY.md §0); every
component here is new, mapping the BASELINE scale axes onto a
``("data", "library")`` jax.sharding.Mesh: clips batch over "data"
(data parallelism), the fingerprint DB shards over "library" (tensor-parallel
analog), and long-fingerprint / all-pairs work rides a ppermute ring
(sequence-parallel analog). Collectives compile to XLA ICI ops.
"""

from lbaudiodetective.parallel.mesh import make_mesh
from lbaudiodetective.parallel.long_match import match_long_time_sharded
from lbaudiodetective.parallel.sharded import (
    extract_data_parallel,
    match_library_sharded,
    ring_all_pairs_scores,
)
from lbaudiodetective.parallel.sharded_packed import (
    match_library_sharded_packed,
    ring_all_pairs_scores_packed,
    ring_dedup_topk_packed,
)
from lbaudiodetective.parallel.sharded_library import (
    ShardedFingerprintLibrary,
)

__all__ = [
    "make_mesh",
    "extract_data_parallel",
    "match_library_sharded",
    "match_library_sharded_packed",
    "match_long_time_sharded",
    "ring_all_pairs_scores",
    "ring_all_pairs_scores_packed",
    "ring_dedup_topk_packed",
    "ShardedFingerprintLibrary",
]
