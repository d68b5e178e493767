"""Index construction beyond the dense build: the block-parallel build with
checkpoints and the streaming build into a ``cobs-jax-v2`` store."""
from .build_parallel import (StreamingBuildStats, build_compact_parallel,
                             build_compact_streaming)

__all__ = ["StreamingBuildStats", "build_compact_parallel",
           "build_compact_streaming"]
