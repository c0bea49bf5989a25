"""The port's job rail (``distkeras_tpu_torch/job_deployment.py``) against
the JAX package's, on the CPU.

 - The seven cases of ``tests/test_job_deployment.py`` on the port: local
   jobs and their exit codes, the rendered environment (coordinated and
   not), the SSH command, the punchcard's order and its drain.
 - Across the packages: a ``Job.to_record()`` of either package runs
   through the other's ``from_record`` with the same environment and
   command, and a punchcard queue written by the JAX package is drained by
   the port.
 - ``initialize_from_env`` returns for uncoordinated and one-process runs,
   as the JAX one does, and joins a coordinated group through
   ``parallel.mesh.initialize`` (a real 2-process group runs in
   ``tests/test_torch_collectives.py``).
"""


import pytest
import torch

import distkeras_tpu.job_deployment as jjd
import distkeras_tpu_torch.job_deployment as pjd
from distkeras_tpu_torch.job_deployment import (Job, LocalJobRunner,
                                                Punchcard, SSHJobRunner)

torch.set_num_threads(1)


def _touch_script(tmp_path, body: str) -> str:
    p = tmp_path / "job_script.py"
    p.write_text(body)
    return str(p)


def test_local_job_runs_and_reports_exit(tmp_path):
    out = tmp_path / "out.txt"
    script = _touch_script(tmp_path, f"""
import os
with open({str(out)!r}, "a") as f:
    f.write(os.environ["DISTKERAS_TPU_PROCESS_ID"] + "\\n")
""")
    job = Job("write-pid", script, hosts=["h0", "h1", "h2"])
    rc = job.run(runner=LocalJobRunner())
    assert rc == 0
    assert job.returncodes == [0, 0, 0]
    assert sorted(out.read_text().split()) == ["0", "1", "2"]


def test_job_failure_propagates(tmp_path):
    script = _touch_script(tmp_path, "import sys; sys.exit(3)")
    job = Job("fail", script)
    assert job.run(runner=LocalJobRunner()) == 3


def test_host_env_renders_coordinator():
    job = Job("j", "train.py", hosts=["tpu-a", "tpu-b"],
              coordinator_port=9999)
    env0, env1 = job.host_env(0), job.host_env(1)
    assert env0["DISTKERAS_TPU_COORDINATOR"] == "tpu-a:9999"
    assert env1["DISTKERAS_TPU_COORDINATOR"] == "tpu-a:9999"
    assert env0["DISTKERAS_TPU_PROCESS_ID"] == "0"
    assert env1["DISTKERAS_TPU_PROCESS_ID"] == "1"
    assert env1["DISTKERAS_TPU_NUM_PROCESSES"] == "2"


def test_host_env_uncoordinated_blanks_inherited_coordinator(monkeypatch):
    job = Job("j", "worker.py", hosts=["h"] * 3, coordinated=False)
    env = job.host_env(2)
    assert env["DISTKERAS_TPU_PROCESS_ID"] == "2"
    assert env["DISTKERAS_TPU_COORDINATOR"] == ""
    assert env["DISTKERAS_TPU_NUM_PROCESSES"] == "1"
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pjd.initialize_from_env()  # the blank coordinator is absent: no-op
    assert not Job.from_record(job.to_record()).coordinated


def test_ssh_command_rendering(monkeypatch):
    captured = []

    class FakePopen:
        def __init__(self, cmd, **kw):
            captured.append(cmd)

        def wait(self):
            return 0

    monkeypatch.setattr(pjd.subprocess, "Popen", FakePopen)
    job = Job("j", "train.py", args=["--epochs", "2"], hosts=["a", "b"])
    assert job.run(runner=SSHJobRunner()) == 0
    assert len(captured) == 2
    assert captured[0][0] == "ssh"
    assert captured[0][-2] == "a"
    assert "DISTKERAS_TPU_PROCESS_ID=0" in captured[0][-1]
    assert "--epochs 2" in captured[0][-1].replace("'", "")


def test_punchcard_fifo(tmp_path):
    q = Punchcard(str(tmp_path / "queue.jsonl"))
    assert q.pop() is None
    script = _touch_script(tmp_path, "pass")
    q.submit(Job("first", script))
    q.submit(Job("second", script, args=["x"], hosts=["h"]))
    assert [j.name for j in q.pending()] == ["first", "second"]
    assert q.pop().name == "first"
    assert [j.name for j in q.pending()] == ["second"]
    restored = q.pending()[0]
    assert restored.args == ["x"] and restored.hosts == ["h"]


def test_punchcard_serve_drains(tmp_path):
    marker = tmp_path / "ran.txt"
    script = _touch_script(
        tmp_path, f"open({str(marker)!r}, 'a').write('x')")
    q = Punchcard(str(tmp_path / "queue.jsonl"))
    q.submit(Job("a", script))
    q.submit(Job("b", script))
    assert q.serve(runner=LocalJobRunner()) == 2
    assert marker.read_text() == "xx"
    assert q.pending() == []


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coordinated", [True, False])
@pytest.mark.parametrize("src,dst", [(jjd, pjd), (pjd, jjd)],
                         ids=["jax_to_port", "port_to_jax"])
def test_records_cross_the_packages(src, dst, coordinated):
    job = src.Job("x", "-m", args=["pkg.main", "cfg.json", 3],
                  hosts=["127.0.0.1", "h1"], env={"A": "1"},
                  coordinator_port=9100, coordinated=coordinated,
                  process_ids=[7, 9])
    rec = job.to_record()
    other = dst.Job.from_record(rec)
    assert other.to_record() == rec
    assert other.command() == job.command()
    for slot in (0, 1):
        assert other.host_env(slot) == job.host_env(slot)


def test_a_jax_punchcard_is_drained_by_the_port(tmp_path):
    out = tmp_path / "out.txt"
    script = _touch_script(tmp_path, f"""
import os, sys
with open({str(out)!r}, "a") as f:
    f.write(os.environ["DISTKERAS_TPU_PROCESS_ID"] + " " + sys.argv[1] + "\\n")
""")
    path = str(tmp_path / "queue.jsonl")
    jq = jjd.Punchcard(path)
    jq.submit(jjd.Job("a", script, args=["first"], coordinated=False,
                      process_ids=[5]))
    jq.submit(jjd.Job("b", script, args=["second"], hosts=["h0", "h1"],
                      coordinated=False))
    q = Punchcard(path)
    assert [j.name for j in q.pending()] == ["a", "b"]
    assert q.serve(runner=LocalJobRunner(), poll_interval=0) == 2
    lines = out.read_text().splitlines()
    # job b's two processes run at once, in either order
    assert lines[0] == "5 first"
    assert sorted(lines[1:]) == ["0 second", "1 second"]
    assert jq.pending() == []


def test_initialize_from_env_refuses_a_coordinated_group(monkeypatch):
    """A coordinated group of more than one process is no longer refused:
    it joins the process group through ``parallel.mesh.initialize`` with
    the rendered coordinator, process count and id (and backend, when the
    Job names one); a group of one and an uncoordinated run do nothing."""
    from distkeras_tpu_torch.parallel import mesh as mesh_lib
    calls = []
    monkeypatch.setattr(mesh_lib, "initialize",
                        lambda *a, **k: calls.append((a, k)))
    job = Job("j", "train.py", hosts=["a", "b"])
    for k, v in job.host_env(1).items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("DISTKERAS_TPU_BACKEND", raising=False)
    pjd.initialize_from_env()
    assert calls == [((f"a:{pjd.COORDINATOR_PORT}", 2, 1),
                      {"backend": None})]
    assert "DISTKERAS_TPU_BACKEND" not in job.host_env(0)
    assert Job("j", "t.py", hosts=["a", "b"], backend="gloo").host_env(0)[
        "DISTKERAS_TPU_BACKEND"] == "gloo"
    # a coordinated group of one is a single-process run
    monkeypatch.setenv("DISTKERAS_TPU_NUM_PROCESSES", "1")
    pjd.initialize_from_env()
    monkeypatch.delenv("DISTKERAS_TPU_COORDINATOR")
    pjd.initialize_from_env()
    assert len(calls) == 1
