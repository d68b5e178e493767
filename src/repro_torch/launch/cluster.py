"""Multi-process worker-cluster launcher for the RPC data plane.

Spawns N ``repro_torch.launch.serve --worker`` subprocesses over one shared
v2 store, waits for their ``--port-file`` publications, and hands back the
``{node: (host, port)}`` map a ``WorkerPool`` / ``--workers`` frontend
dials:

    from repro_torch.launch.cluster import WorkerCluster
    with WorkerCluster(store_dir, ["host0", "host1", "host2"]) as cl:
        pool = WorkerPool(cl.addresses)
        ...
        cl.kill("host1")            # SIGKILL mid-load, shards fail over
        cl.restart("host1")         # same port: channels backoff-redial

Fault injection is first-class: ``kill`` SIGKILLs a worker without
cleanup (torn frames, dead peer), ``restart`` relaunches it on the SAME
port so the frontend's reconnecting channels find it again.

Every worker runs on ``device`` (None = the CUDA card; ``"cpu"`` runs
the kernels' plain versions), passed to each child as ``--device``. On one
card each worker process opens a CUDA context and a tile cache of its own.
The parent loads the kernel library before it starts a CUDA fleet, so the
children find it built instead of each running ``nvcc``.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

from ..device import resolve_device


def _repo_src_dir() -> str:
    """The directory to put on the child's PYTHONPATH so ``import
    repro_torch`` resolves to the same tree as the parent."""
    import repro_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))


def wait_port_file(path: str, proc: Optional[subprocess.Popen] = None,
                   timeout_s: float = 60.0) -> tuple[str, int]:
    """Poll for a worker's atomic 'host port' publication; fail fast
    with the child's output if it died instead of binding."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                parts = f.read().split()
            if len(parts) == 2:
                return parts[0], int(parts[1])
        except (FileNotFoundError, ValueError):
            pass
        if proc is not None and proc.poll() is not None:
            out = ""
            if proc.stdout is not None:
                out = proc.stdout.read().decode("utf-8", "replace")
            raise RuntimeError(
                f"worker exited rc={proc.returncode} before publishing "
                f"{path}:\n{out[-2000:]}")
        time.sleep(0.05)
    raise TimeoutError(f"no port file at {path} after {timeout_s:.0f}s")


class WorkerCluster:
    """N worker subprocesses over one v2 store; context manager."""

    def __init__(self, store_dir: str, nodes: list[str], *,
                 replication: int = 2, straggle_ms: dict | float = 0.0,
                 pruned: bool = False, run_dir: Optional[str] = None,
                 spawn_timeout_s: float = 60.0, device=None):
        self.store_dir = str(store_dir)
        self.nodes = list(nodes)
        self.replication = replication
        self.pruned = pruned
        self.spawn_timeout_s = spawn_timeout_s
        self.device = resolve_device(device)
        # per-node straggler injection: a float applies to every node
        self.straggle_ms = (dict(straggle_ms)
                            if isinstance(straggle_ms, dict)
                            else {n: straggle_ms for n in nodes})
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="rpc-cluster-")
        self.procs: dict[str, subprocess.Popen] = {}
        self.addresses: dict[str, tuple[str, int]] = {}

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "WorkerCluster":
        if self.device.type == "cuda":
            # one nvcc, in the parent: the children load what it built
            from ..kernels import _build
            _build.library()
        for node in self.nodes:
            self._spawn(node, port=0)
        for node in self.nodes:
            self.addresses[node] = wait_port_file(
                self._port_file(node), self.procs[node],
                self.spawn_timeout_s)
        return self

    def _port_file(self, node: str) -> str:
        return os.path.join(self.run_dir, f"{node}.port")

    def _spawn(self, node: str, port: int) -> None:
        pf = self._port_file(node)
        try:
            os.remove(pf)
        except FileNotFoundError:
            pass
        cmd = [sys.executable, "-m", "repro_torch.launch.serve",
               "--store-format", "v2", "--index-dir", self.store_dir,
               "--worker", node, "--worker-nodes", ",".join(self.nodes),
               "--replication", str(self.replication),
               "--worker-port", str(port), "--port-file", pf,
               "--device", str(self.device)]
        if self.straggle_ms.get(node):
            cmd += ["--straggle-ms", str(self.straggle_ms[node])]
        if self.pruned:
            cmd += ["--prune"]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_repo_src_dir(), env.get("PYTHONPATH")) if p)
        self.procs[node] = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            start_new_session=True)     # isolate from parent's Ctrl-C

    # -- fault injection -----------------------------------------------------
    def kill(self, node: str, sig: int = signal.SIGKILL) -> None:
        """Hard-kill one worker (no drain, no FIN ordering guarantees
        beyond the OS closing the sockets) — the dead-peer case."""
        proc = self.procs[node]
        if proc.poll() is None:
            proc.send_signal(sig)
            proc.wait(timeout=10)

    def restart(self, node: str) -> tuple[str, int]:
        """Relaunch a killed worker on the SAME port, so the frontend's
        reconnecting channels (which redial host:port) recover it."""
        self.kill(node)                 # idempotent if already dead
        host, port = self.addresses[node]
        self._spawn(node, port=port)
        self.addresses[node] = wait_port_file(
            self._port_file(node), self.procs[node], self.spawn_timeout_s)
        return self.addresses[node]

    def output(self, node: str) -> str:
        """Captured stdout+stderr of a FINISHED worker ('' if alive)."""
        proc = self.procs[node]
        if proc.poll() is None or proc.stdout is None:
            return ""
        return proc.stdout.read().decode("utf-8", "replace")

    def close(self) -> None:
        for node, proc in self.procs.items():
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
        for proc in self.procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
            if proc.stdout is not None:
                proc.stdout.close()

    def __enter__(self) -> "WorkerCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
