"""The host-PS wire between the two packages, on the CPU.

 - A JAX ``ADAGWorker`` pulls, commits (``'c'``) and updates (``'u'``)
   against a port server, and a port worker against a JAX server: on both
   server cores, with f32, bf16 and int8 commits, the replies carry the
   center the ADAG rule gives and the clock each commit advanced.
 - One JAX worker thread and one port worker thread train one model into
   one port PS: both losses fall, and the center they built predicts.
 - The commit frames a JAX worker and a port worker encode for the same
   delta are byte-identical, in every dense coding.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import networking as jnet
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu import workers as jworkers
from distkeras_tpu.core import layers as jl
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu_torch import networking as pnet
from distkeras_tpu_torch import parameter_servers as pps
from distkeras_tpu_torch import workers as pworkers

torch.set_num_threads(1)

D, C = 8, 3


def _blob(seed=0):
    model = JaxSequential([jl.Dense(16, activation="relu"),
                           jl.Dense(C, activation="softmax")],
                          input_shape=(D,), compute_dtype="float32")
    shapes = [w.shape for w in
              model.get_weights(model.init(jax.random.PRNGKey(0)))]
    rng = np.random.default_rng(seed)
    return {"model": model.to_json(),
            "weights": [(0.3 * rng.standard_normal(s)).astype(np.float32)
                        for s in shapes]}


def _server(pkg, core, blob, workers=2):
    mod = jps if pkg == "jax" else pps
    server = mod.make_socket_server(mod.ADAGParameterServer(blob, workers),
                                    ps_core=core)
    server.start()
    return server


def _worker(pkg, blob, port, wire_dtype, **kw):
    if pkg == "jax":
        return jworkers.ADAGWorker(blob, "sgd", "categorical_crossentropy",
                                   "127.0.0.1", port, wire_dtype=wire_dtype,
                                   **kw)
    return pworkers.ADAGWorker(blob, "sgd", "categorical_crossentropy",
                               "127.0.0.1", port, wire_dtype=wire_dtype,
                               device="cpu", **kw)


@pytest.mark.parametrize("wire_dtype", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("core", ["event", "threaded"])
@pytest.mark.parametrize("server_pkg,worker_pkg",
                         [("torch", "jax"), ("jax", "torch")],
                         ids=["jax_worker-port_server",
                              "port_worker-jax_server"])
def test_worker_against_the_other_packages_server(server_pkg, worker_pkg,
                                                  core, wire_dtype):
    blob = _blob()
    server = _server(server_pkg, core, blob)
    try:
        wk = _worker(worker_pkg, blob, server.port, wire_dtype)
        wk.connect()
        center = [np.array(w, np.float32) for w in wk.pull()]
        for c, w in zip(center, blob["weights"]):
            np.testing.assert_array_equal(c, w)
        rng = np.random.default_rng(1)
        want = [c.copy() for c in center]
        for step in range(3):
            delta = [(0.1 * rng.standard_normal(c.shape)).astype(np.float32)
                     for c in center]
            if step == 1:  # 'c' then a 'p'
                applied = wk.commit(delta, 0)
                got = wk.pull()
            else:          # one combined 'u'
                applied, got = wk.update(delta, 0)
            # the ADAG rule: center += applied / 2, applied as f32 axpys
            for w, a in zip(want, applied):
                w += np.float32(0.5) * np.asarray(a, np.float32)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(np.asarray(g), w)
            assert wk._last_clock == step + 1
        wk.disconnect()
        assert server.ps.num_updates == 3
    finally:
        server.stop()


def _rows(n=512, seed=2):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(-1, 1, (C, D))
    labels = rng.integers(0, C, n)
    x = (protos[labels] + 0.3 * rng.standard_normal((n, D))).astype(
        np.float32)
    return x, np.eye(C, dtype=np.float32)[labels], labels


@pytest.mark.parametrize("core", ["event", "threaded"])
def test_jax_and_port_workers_train_one_ps(core):
    """One JAX worker thread and one port worker thread, 4 epochs each on
    their halves of the rows, commit into one port PS."""
    blob = _blob()
    server = _server("torch", core, blob)
    x, y, labels = _rows()
    kw = dict(communication_window=4, batch_size=16, num_epoch=4,
              learning_rate=0.1, comm_overlap=True)
    workers = [_worker("jax", blob, server.port, None, **kw),
               _worker("torch", blob, server.port, None, **kw)]
    results, errors = [None, None], []

    def run(i):
        try:
            results[i] = workers[i].train(
                i, {"features": x[i::2], "label": y[i::2]})
        except BaseException as e:  # surfaced below
            errors.append(e)

    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        fitted = server.get_model(device="cpu")
    finally:
        server.stop()
    for w in workers:
        hist = w.history
        assert len(hist) == 4 * 4  # 256 rows / (4 x 16) x 4 epochs
        assert np.mean(hist[-4:]) < np.mean(hist[:4])
    assert server.ps.num_updates == 32
    acc = float(np.mean(np.argmax(fitted.predict(x), axis=1) == labels))
    assert acc > 0.8


@pytest.mark.parametrize("wire_dtype", [None, "bfloat16", "float16", "int8"])
def test_commit_frames_byte_identical(wire_dtype):
    blob = _blob()
    jw = _worker("jax", blob, 1, wire_dtype)
    pw = _worker("torch", blob, 1, wire_dtype)
    rng = np.random.default_rng(3)
    for clock in (0, 5):  # two windows: int8's error feedback carries over
        jw._last_clock = pw._last_clock = clock
        delta = [rng.standard_normal(w.shape).astype(np.float32)
                 for w in blob["weights"]]
        jmsg, _ = jw._prepare_commit([d.copy() for d in delta], 1)
        pmsg, _ = pw._prepare_commit([d.copy() for d in delta], 1)
        frame = pnet.encode_message(pmsg)
        assert jnet.encode_message(jmsg) == frame
        # and each package decodes the other's frame to the same values
        back = jnet.decode_message(frame)["delta"]
        for a, b in zip(back, jmsg["delta"]):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))
