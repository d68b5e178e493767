"""Scoring kernels: ``bitslice_score.py`` = the CUDA kernels' wrappers and
their plain versions, ``ops.py`` = the public operations, ``ref.py`` = the
plain oracles, ``_build.py`` = the nvcc build and ctypes binding,
``autotune.py`` = the dispatch tuner and its persisted cache."""
from . import autotune, bitslice_score, ops, ref

__all__ = ["autotune", "bitslice_score", "ops", "ref"]
