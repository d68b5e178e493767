"""Index construction beyond the dense build (the block-parallel build with
checkpoints and the streaming build into a ``cobs-jax-v2`` store), and the
control plane of multi-host serving: shard placement and hedged
execution."""
from .placement import BlockPlacement, RendezvousPlacement, ShardPlacement
from .hedge import AttemptFailed, HedgedExecutor, SimClock, ShardSim
from .build_parallel import (StreamingBuildStats, build_compact_parallel,
                             build_compact_streaming)

__all__ = ["BlockPlacement", "RendezvousPlacement", "ShardPlacement",
           "AttemptFailed", "HedgedExecutor", "SimClock", "ShardSim",
           "StreamingBuildStats", "build_compact_parallel",
           "build_compact_streaming"]
