"""Worker processes and servers across the packages, on the CPU.

The cross-process engine's wire is the JAX package's, so its processes
and servers mix:

 - a port ``ps_worker_main`` child trains into a JAX
   ``ShardedServerGroup`` (two shards) hosted by this test, and the same
   child into a port group: the two centers are bit-identical (the
   servers apply the same commits bit for bit);
 - one JAX ``distkeras_tpu.ps_worker_main`` child trains into the port's
   socket server: its center equals the port child's within rtol 1e-5,
   atol 1e-6 (the host-PS parity tolerance), and its result file (JAX's
   ``history`` key only) reads through the port driver's reader.

Every child is one DOWNPOUR worker on the serial loop with the same
config; the three start together.  The center is read once each server's
clock has reached the child's commits (a window a commit)."""

import concurrent.futures
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from distkeras_tpu.ps_sharding import ShardedServerGroup as JaxGroup
from distkeras_tpu_torch import parameter_servers as pps
from distkeras_tpu_torch.ps_sharding import ShardedServerGroup as PortGroup
from distkeras_tpu_torch.ps_worker_main import save_model_blob

from test_torch_host_ps_parity import TOL, _jax_model, _rows, _weights

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = dict(algorithm="downpour", worker_optimizer="sgd",
              loss="categorical_crossentropy", communication_window=4,
              features_col="features", label_col="label_encoded",
              batch_size=8, num_epoch=2, learning_rate=0.05, seed=3,
              comm_overlap=False)


def _child(package, tmp, name, server, blob_path, shard_path, device):
    """Run one worker process of ``package`` against ``server`` (a socket
    server or a shard group); returns (its result file, the clocks)."""
    result = os.path.join(tmp, f"{name}_result.npz")
    cfg = dict(WORKER, model_path=blob_path, shard_paths=[shard_path],
               result_paths=[result])
    if device is not None:
        cfg["device"] = device
    if hasattr(server, "servers"):
        cfg.update(ps_host="127.0.0.1", ps_port=server.ports[0],
                   num_shards=len(server.servers),
                   shard_addrs=[["127.0.0.1", p] for p in server.ports])
    else:
        cfg.update(ps_host="127.0.0.1", ps_port=server.port)
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", f"{package}.ps_worker_main", path, "0"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return result


def _center(server, commits):
    servers = getattr(server, "servers", [server])
    deadline = time.monotonic() + 30
    while any(s.ps.num_updates < commits for s in servers):
        assert time.monotonic() < deadline
        time.sleep(0.001)
    if hasattr(server, "plan"):
        return server.plan.gather([s.ps.center for s in servers])
    return [w.copy() for w in server.ps.center]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("interop"))
    blob = _jax_model(_weights()).serialize()
    blob_path = os.path.join(tmp, "model.npz")
    save_model_blob(blob_path, blob)
    rows = _rows()
    shard_path = os.path.join(tmp, "shard.npz")
    np.savez(shard_path, x=rows["features"], y=rows["label_encoded"])
    servers = {
        "port_into_jax": JaxGroup("downpour", blob, 1, 2),
        "port_into_port": PortGroup("downpour", blob, 1, 2),
        "jax_into_port": pps.make_socket_server(
            pps.allocate_parameter_server("downpour", blob, 1)),
    }
    for s in servers.values():
        s.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            futures = {
                name: pool.submit(
                    _child,
                    "distkeras_tpu" if name == "jax_into_port"
                    else "distkeras_tpu_torch", tmp, name, server,
                    blob_path, shard_path,
                    None if name == "jax_into_port" else "cpu")
                for name, server in servers.items()}
            results = {k: f.result() for k, f in futures.items()}
        out = {}
        for name, path in results.items():
            child = pps._ChildResult(0, path)
            out[name] = (child, _center(servers[name], len(child.history)))
    finally:
        for s in servers.values():
            s.stop()
    return out


def test_a_port_worker_process_trains_into_a_jax_shard_group(runs):
    (a, ca), (b, cb) = runs["port_into_jax"], runs["port_into_port"]
    # 160 rows / (window 4 x batch 8): 5 windows an epoch, 2 epochs
    assert len(a.history) == len(b.history) == 10
    assert a.history == b.history
    for x, y in zip(ca, cb):
        np.testing.assert_array_equal(x, y)
    # the child counted its commits by (shard, generation)
    assert a.sent_by_gen == b.sent_by_gen == {(0, 0): 10, (1, 0): 10}


def test_a_jax_worker_process_trains_into_the_port_server(runs):
    (j, cj), (p, cp) = runs["jax_into_port"], runs["port_into_port"]
    # a JAX result file holds its history only; the port's reader takes it
    assert len(j.history) == 10 and j.sent_by_gen == {} and not j.launches
    np.testing.assert_allclose(j.history, p.history, **TOL)
    for x, y in zip(cj, cp):
        np.testing.assert_allclose(x, y, **TOL)
