"""Job deployment, copied from ``distkeras_tpu/job_deployment.py`` and kept
in the port so that it imports nothing of the JAX package.

``Job``, ``LocalJobRunner``, ``SSHJobRunner`` and ``Punchcard`` are the
JAX module's, standard library only, with the same ``DISTKERAS_TPU_*``
environment contract and the same punchcard record: a record or a queue
file written by either package runs under the other.  The cross-process
parameter-server engine (``parameter_servers.run_process_ps_training``)
launches its worker and shard processes through this rail.

``initialize_from_env`` returns where the JAX one returns (no
coordinator, or a group of one process); a coordinated group of more
than one process joins a ``torch.distributed`` process group through
``parallel.mesh.initialize``, one rank a process, with the backend that
``DISTKERAS_TPU_BACKEND`` names (``Job(backend=...)`` renders it; unset,
``"nccl"`` where a card is visible, else ``"gloo"``).  Nothing the
process engine launches is coordinated.

The JAX module's description follows.

Reference being replaced: ``distkeras/job_deployment.py :: Job`` + the
"Punchcard" job-queue machinery (SURVEY.md §2.1 row 22) — experimental
SSH-based packaging and submission of training jobs to a Spark cluster, with a
secrets-file job queue.

TPU-native rework: a multi-host TPU program is one SPMD Python process per
host, all started with the same script and a shared coordinator address
(``jax.distributed.initialize``).  So deployment here means: render the
per-host environment (coordinator, process index/count), launch the script on
every host — over SSH for real pods, as local subprocesses for single-host or
testing — and collect exit status.  The punchcard survives as a file-backed
FIFO of pending jobs drained by a daemon loop.
"""

from __future__ import annotations

import contextlib
import json
import os
import shlex
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

COORDINATOR_PORT = 8476


class Job:
    """A deployable training job (reference: ``job_deployment.py :: Job``).

    Parameters
    ----------
    name: job identifier (used in logs and the punchcard queue).
    script: path to the Python training script to run on every host.
    args: extra argv passed to the script.
    hosts: hostnames of the pod slice; ``None``/empty → run locally.
    env: extra environment variables for the job processes.
    python: interpreter to use on the hosts.
    """

    def __init__(self, name: str, script: str,
                 args: Sequence[str] = (),
                 hosts: Optional[Sequence[str]] = None,
                 env: Optional[Dict[str, str]] = None,
                 python: str = sys.executable,
                 coordinator_port: int = COORDINATOR_PORT,
                 coordinated: bool = True,
                 process_ids: Optional[Sequence[int]] = None,
                 backend: Optional[str] = None):
        self.name = name
        self.script = script
        self.args = list(args)
        self.hosts = list(hosts) if hosts else []
        self.env = dict(env or {})
        self.python = python
        self.coordinator_port = int(coordinator_port)
        # process_ids: explicit id per host slot (default: the slot index).
        # Lets a supervisor respawn ONE member under a FRESH id through the
        # same runner — a single-host Job whose process_ids=[7] renders
        # DISTKERAS_TPU_PROCESS_ID=7, not 0.
        self.process_ids = (None if process_ids is None
                            else [int(i) for i in process_ids])
        # coordinated=False: processes are independent (no jax.distributed
        # group) — e.g. PS workers that only speak the socket wire; one
        # crashing must not stall the others at an init barrier
        self.coordinated = bool(coordinated)
        # the torch.distributed backend of a coordinated group (None: the
        # default of parallel.mesh.initialize)
        self.backend = backend
        self.returncodes: List[int] = []
        self.processes: List[subprocess.Popen] = []

    # -- environment rendering ----------------------------------------------
    def host_env(self, process_id: int) -> Dict[str, str]:
        """Per-host env for ``jax.distributed.initialize`` discovery (or
        just the process id when ``coordinated=False``)."""
        num = max(len(self.hosts), 1)
        coordinator = (self.hosts[0] if self.hosts else "127.0.0.1")
        env = dict(self.env)
        if self.process_ids is not None:
            process_id = self.process_ids[process_id]
        env["DISTKERAS_TPU_PROCESS_ID"] = str(process_id)
        if self.coordinated:
            env.update({
                "DISTKERAS_TPU_COORDINATOR":
                    f"{coordinator}:{self.coordinator_port}",
                "DISTKERAS_TPU_NUM_PROCESSES": str(num),
            })
            if self.backend is not None:
                env["DISTKERAS_TPU_BACKEND"] = str(self.backend)
        else:
            # explicitly blank (not merely omit): launchers overlay this on
            # os.environ, and a driver that itself runs under a coordinated
            # Job must not leak its coordinator into uncoordinated children
            # (they would try to join the parent's jax.distributed group)
            env.update({"DISTKERAS_TPU_COORDINATOR": "",
                        "DISTKERAS_TPU_NUM_PROCESSES": "1"})
        return env

    def command(self) -> List[str]:
        return [self.python, self.script] + [str(a) for a in self.args]

    # -- execution ------------------------------------------------------------
    def run(self, runner: Optional["JobRunner"] = None, wait: bool = True
            ) -> int:
        """Launch on all hosts (reference: ``Job.run``). Returns the max exit
        code (0 = every host succeeded).  With ``wait=False`` the handles stay
        in ``self.processes``; call ``wait()`` later to reap them."""
        if runner is None:
            runner = SSHJobRunner() if self.hosts else LocalJobRunner()
        self.processes = runner.launch(self)
        if not wait:
            return 0
        return self.wait()

    def wait(self) -> int:
        """Reap launched processes; returns the max exit code."""
        self.returncodes = [p.wait() for p in self.processes]
        return max(self.returncodes, default=0)

    # -- punchcard (de)serialization ------------------------------------------
    def to_record(self) -> dict:
        rec = {"name": self.name, "script": self.script, "args": self.args,
               "hosts": self.hosts, "env": self.env, "python": self.python,
               "coordinator_port": self.coordinator_port,
               "coordinated": self.coordinated,
               "process_ids": self.process_ids}
        if self.backend is not None:
            rec["backend"] = self.backend
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "Job":
        return cls(rec["name"], rec["script"], rec.get("args", ()),
                   rec.get("hosts"), rec.get("env"),
                   rec.get("python", sys.executable),
                   rec.get("coordinator_port", COORDINATOR_PORT),
                   rec.get("coordinated", True),
                   rec.get("process_ids"), rec.get("backend"))


class JobRunner:
    def launch(self, job: Job) -> List[subprocess.Popen]:  # pragma: no cover
        raise NotImplementedError


class LocalJobRunner(JobRunner):
    """Run every "host" as a local subprocess — single-host deployment and the
    test double for SSH (the reference's equivalent was Spark ``local[*]``
    mode, SURVEY.md §4)."""

    def launch(self, job: Job) -> List[subprocess.Popen]:
        n = max(len(job.hosts), 1)
        procs = []
        for pid in range(n):
            env = dict(os.environ)
            env.update(job.host_env(pid))
            procs.append(subprocess.Popen(job.command(), env=env))
        return procs


class SSHJobRunner(JobRunner):
    """Launch the job script on each pod host over SSH (reference:
    ``job_deployment.py`` SSH submission).  Assumes the repo/script path is
    visible on the hosts (shared filesystem or pre-synced image)."""

    def __init__(self, ssh_binary: str = "ssh",
                 ssh_options: Sequence[str] = ("-o", "BatchMode=yes")):
        self.ssh_binary = ssh_binary
        self.ssh_options = list(ssh_options)

    def launch(self, job: Job) -> List[subprocess.Popen]:
        if not job.hosts:
            raise ValueError("SSHJobRunner needs job.hosts")
        procs = []
        for pid, host in enumerate(job.hosts):
            env = job.host_env(pid)
            exports = " ".join(f"{k}={shlex.quote(v)}"
                               for k, v in env.items())
            remote = f"env {exports} " + " ".join(
                shlex.quote(c) for c in job.command())
            cmd = [self.ssh_binary, *self.ssh_options, host, remote]
            procs.append(subprocess.Popen(cmd))
        return procs


class Punchcard:
    """File-backed FIFO job queue (reference: the "punchcard" daemon).

    The queue file holds one JSON job record per line; ``submit`` appends,
    ``pop`` removes the head.  A daemon drains it with ``serve`` — the
    reference's punchcard loop, minus the secrets file (auth is SSH's
    problem, not the queue's).
    """

    def __init__(self, path: str):
        self.path = path
        self._lock_path = path + ".lock"

    @contextlib.contextmanager
    def _locked(self):
        """Advisory flock serializing submit/pop across processes — a
        concurrent submit during a pop must not be lost in the rewrite."""
        import fcntl  # Unix-only; keep the package importable elsewhere
        with open(self._lock_path, "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def submit(self, job: Job) -> None:
        with self._locked():
            with open(self.path, "a") as f:
                f.write(json.dumps(job.to_record()) + "\n")

    def _read(self) -> List[Job]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [Job.from_record(json.loads(line))
                    for line in f if line.strip()]

    def pending(self) -> List[Job]:
        with self._locked():
            return self._read()

    def pop(self) -> Optional[Job]:
        with self._locked():
            jobs = self._read()
            if not jobs:
                return None
            # atomic rewrite: a crash mid-pop must not lose pending jobs
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                for j in jobs[1:]:
                    f.write(json.dumps(j.to_record()) + "\n")
            os.replace(tmp, self.path)
            return jobs[0]

    def run_once(self, runner: Optional[JobRunner] = None) -> Optional[int]:
        """Pop and run the head job; None if the queue is empty."""
        job = self.pop()
        if job is None:
            return None
        return job.run(runner)

    def serve(self, runner: Optional[JobRunner] = None,
              poll_interval: float = 1.0, max_jobs: Optional[int] = None
              ) -> int:
        """Drain the queue: run jobs until it is empty or ``max_jobs`` have
        run. Returns the number of jobs executed.  ``poll_interval`` spaces
        successive jobs out (the reference punchcard daemon throttled the
        same way); an empty queue always returns."""
        done = 0
        while max_jobs is None or done < max_jobs:
            rc = self.run_once(runner)
            if rc is None:
                break
            done += 1
            if poll_interval and (max_jobs is None or done < max_jobs):
                time.sleep(poll_interval)
        return done


def initialize_from_env() -> None:
    """Join the process group from the env vars ``Job`` renders — the
    first line of a deployed training script: ``parallel.mesh.initialize``
    with the coordinator, the process count, this process's id and the
    backend ``DISTKERAS_TPU_BACKEND`` names.  An uncoordinated or
    one-process run has nothing to initialize."""
    coord = os.environ.get("DISTKERAS_TPU_COORDINATOR")
    if not coord:
        return  # single-process run; nothing to initialize
    num = int(os.environ.get("DISTKERAS_TPU_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("DISTKERAS_TPU_PROCESS_ID", "0"))
    if num <= 1:
        return
    from .parallel.mesh import initialize
    initialize(coord, num, pid,
               backend=os.environ.get("DISTKERAS_TPU_BACKEND") or None)
