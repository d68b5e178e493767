"""Launchers: the mesh of ``DistributedIndex``, the serving CLI
(``python -m repro_torch.launch.serve``), the worker-process cluster of
the RPC data plane, the training CLI and sharding rules, and the analytic
dry-run (``python -m repro_torch.launch.dryrun``)."""
