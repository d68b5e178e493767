"""Launchers: the mesh of ``DistributedIndex``, the serving CLI
(``python -m repro_torch.launch.serve``) and the worker-process cluster of
the RPC data plane."""
