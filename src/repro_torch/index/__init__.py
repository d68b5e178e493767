"""Index construction beyond the dense build (the block-parallel build with
checkpoints and the streaming build into a ``cobs-jax-v2`` store), the
mesh-sharded ``DistributedIndex``, and the control plane of multi-host
serving: shard placement and hedged execution."""
from .distributed import DistributedIndex
from .placement import BlockPlacement, RendezvousPlacement, ShardPlacement
from .hedge import AttemptFailed, HedgedExecutor, SimClock, ShardSim
from .build_parallel import (StreamingBuildStats, build_compact_parallel,
                             build_compact_streaming)

__all__ = ["DistributedIndex", "BlockPlacement", "RendezvousPlacement", "ShardPlacement",
           "AttemptFailed", "HedgedExecutor", "SimClock", "ShardSim",
           "StreamingBuildStats", "build_compact_parallel",
           "build_compact_streaming"]
