"""repro_torch: COBS (compact bit-sliced signature index) in PyTorch for
NVIDIA Hopper.

The port of the JAX package ``repro``, module for module at the same
relative paths. It imports neither ``jax`` nor ``repro``: host-side helpers
are copied, not shared.

Arena words and hashes are carried as ``torch.int32`` bit patterns of the
reference's uint32 values (see ``repro_torch.core.hashing``). Every entry
point takes ``device=None``, which means the CUDA card; without one it
raises unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
