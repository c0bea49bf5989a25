"""The cases of tests/test_host_ps.py on the port: the wire protocol, the
PS apply rules over sockets and against ``parallel/rules.py``, and
end-to-end ``execution="host_ps"`` training on the CPU (each worker a
thread training its own copy of the model, true hogwild interleaving on
loopback).  bf16 leaves are CPU ``torch.bfloat16`` tensors on the port's
wire (no ``ml_dtypes``)."""

import socket
import threading

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import (ADAG, AEASGD, DOWNPOUR, EAMSGD, Dataset,
                                 Dense, DynSGD, OneHotTransformer,
                                 Sequential, networking)
from distkeras_tpu_torch.core.model import serialize_model
from distkeras_tpu_torch.parameter_servers import (
    ADAGParameterServer, DeltaParameterServer, DynSGDParameterServer,
    SocketParameterServer)
from distkeras_tpu_torch.workers import DOWNPOURWorker

torch.set_num_threads(1)

NUM_CLASSES = 4


def make_dataset(n=2048, d=16, seed=0):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(-1, 1, (NUM_CLASSES, d))
    labels = rng.integers(0, NUM_CLASSES, n)
    x = (protos[labels] + 0.3 * rng.standard_normal((n, d))).astype(
        np.float32)
    ds = Dataset({"features": x, "label": labels.astype(np.int64)})
    return OneHotTransformer(NUM_CLASSES, input_col="label",
                             output_col="label_encoded").transform(ds)


def make_model():
    return Sequential([Dense(32, activation="relu"),
                       Dense(NUM_CLASSES, activation="softmax")],
                      input_shape=(16,), compute_dtype="float32",
                      device="cpu")


def _accuracy(fitted, ds, rows=256):
    preds = fitted.predict(ds["features"][:rows])
    return float(np.mean(np.argmax(preds, axis=1) == ds["label"][:rows]))


# ---------------------------------------------------------------------------
# wire protocol
# ---------------------------------------------------------------------------

def test_wire_roundtrip_structures():
    msg = {
        "weights": [np.arange(6, dtype=np.float32).reshape(2, 3),
                    np.ones((4,), np.float64)],
        "clock": 7,
        "name": "worker-0",
        "nested": {"t": (1, 2.5, None), "flag": True},
    }
    out = networking.decode_message(networking.encode_message(msg))
    assert out["clock"] == 7 and out["name"] == "worker-0"
    assert out["nested"]["t"] == (1, 2.5, None)
    assert out["nested"]["flag"] is True
    np.testing.assert_array_equal(out["weights"][0], msg["weights"][0])
    assert out["weights"][1].dtype == np.float64


def test_wire_rejects_garbage():
    with pytest.raises(ValueError):
        networking.decode_message(b"XXXX" + b"\x00" * 16)
    with pytest.raises(TypeError):
        networking.encode_message({"bad": object()})


def test_wire_rejects_mismatched_buffer_length():
    # a frame whose u64 buffer length disagrees with the header's
    # dtype*shape must be rejected before allocation
    good = networking.encode_message({"w": np.zeros((4,), np.float32)})
    tampered = bytearray(good)
    off = len(good) - 16 - 8  # u64 length prefix of the single buffer
    tampered[off:off + 8] = (1 << 60).to_bytes(8, "little")
    with pytest.raises(ValueError, match="expects|Truncated"):
        networking.decode_message(bytes(tampered))


def test_wire_rejects_mismatched_buffer_length_python_path(monkeypatch):
    """The same guard through the pure-Python decode path (the port's
    only codec)."""
    monkeypatch.setattr(networking, "_native", None)
    good = networking.encode_message({"w": np.zeros((4,), np.float32)})
    tampered = bytearray(good)
    off = len(good) - 16 - 8
    tampered[off:off + 8] = (64).to_bytes(8, "little")  # wrong, in range
    tampered += b"\x00" * 48  # pad so the lie is physically satisfiable
    with pytest.raises(ValueError, match="expects"):
        networking.decode_message(bytes(tampered))


def test_send_recv_over_socketpair():
    a, b = socket.socketpair()
    payload = {"delta": [np.random.default_rng(0).standard_normal((128, 64))]}
    t = threading.Thread(target=networking.send_data, args=(a, payload))
    t.start()
    out = networking.recv_data(b)
    t.join(timeout=10)
    assert not t.is_alive()
    np.testing.assert_array_equal(out["delta"][0], payload["delta"][0])
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# PS apply rules over real sockets
# ---------------------------------------------------------------------------

def _tiny_blob():
    return {"model": make_model().to_json(),
            "weights": [np.zeros((3,), np.float32)] * 1}


def test_socket_ps_pull_commit_delta():
    ps = DeltaParameterServer(_tiny_blob())
    server = SocketParameterServer(ps)
    server.start()
    try:
        sock = networking.connect("127.0.0.1", server.port)
        networking.send_opcode(sock, b"p")
        msg = networking.recv_data(sock)
        assert msg["clock"] == 0
        np.testing.assert_array_equal(msg["weights"][0], np.zeros(3))

        networking.send_opcode(sock, b"c")
        networking.send_data(sock, {"delta": [np.ones(3, np.float32)],
                                    "worker_id": 0, "clock": 0})
        networking.send_opcode(sock, b"p")
        msg = networking.recv_data(sock)
        assert msg["clock"] == 1
        np.testing.assert_array_equal(msg["weights"][0], np.ones(3))
        sock.close()
    finally:
        server.stop()


def test_adag_ps_normalizes_by_workers():
    ps = ADAGParameterServer(_tiny_blob(), num_workers=4)
    ps.handle_commit({"delta": [np.full(3, 8.0, np.float32)], "clock": 0})
    np.testing.assert_allclose(ps.center[0], np.full(3, 2.0))


def test_ps_applies_match_shared_rules():
    """The PS numpy commit loops agree with the port's parallel/rules.py —
    the single source of algorithm semantics both engines implement."""
    from distkeras_tpu_torch.parallel import rules
    rng = np.random.default_rng(3)
    w0 = [rng.standard_normal((5,)).astype(np.float32),
          rng.standard_normal((2, 3)).astype(np.float32)]
    delta = [rng.standard_normal(a.shape).astype(np.float32) for a in w0]
    t0 = [torch.from_numpy(a.copy()) for a in w0]
    td = [torch.from_numpy(a.copy()) for a in delta]

    def blob():
        return {"model": make_model().to_json(),
                "weights": [a.copy() for a in w0]}

    cases = [(DeltaParameterServer(blob()), 0, 0,
              rules.delta_commit(t0, td)),
             (ADAGParameterServer(blob(), num_workers=4), 0, 0,
              rules.adag_commit(t0, td, 4)),
             # worker pulled at clock 1, the PS is at 3 -> staleness 2
             (DynSGDParameterServer(blob()), 3, 1,
              rules.dynsgd_commit(t0, td, 2.0))]
    for ps, updates, clock, expect in cases:
        ps.num_updates = updates
        ps.handle_commit({"delta": delta, "clock": clock})
        for got, want in zip(ps.center, expect):
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-6)


def test_dynsgd_ps_staleness_scaling():
    ps = DynSGDParameterServer(_tiny_blob())
    # first commit: staleness 0 → full apply
    ps.handle_commit({"delta": [np.ones(3, np.float32)], "clock": 0})
    np.testing.assert_allclose(ps.center[0], np.ones(3))
    # second commit still claims clock 0 → staleness 1 → halved
    ps.handle_commit({"delta": [np.ones(3, np.float32)], "clock": 0})
    np.testing.assert_allclose(ps.center[0], np.full(3, 1.5))


# ---------------------------------------------------------------------------
# end-to-end host_ps training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls,kw", [
    (ADAG, {"communication_window": 4, "learning_rate": 0.1}),
    (DOWNPOUR, {"communication_window": 4, "learning_rate": 0.02}),
    (DynSGD, {"communication_window": 4, "learning_rate": 0.05}),
    (AEASGD, {"communication_window": 8, "rho": 1.0, "learning_rate": 0.05}),
    (EAMSGD, {"communication_window": 8, "rho": 1.0, "learning_rate": 0.05,
              "momentum": 0.9}),
])
def test_host_ps_training_learns(cls, kw):
    ds = make_dataset()
    t = cls(make_model(), num_workers=2, batch_size=32, num_epoch=2,
            label_col="label_encoded", execution="host_ps", device="cpu",
            **kw)
    fitted = t.train(ds)
    assert t.get_training_time() > 0
    hist = t.get_history()
    assert len(hist) > 0
    # async scheduling is nondeterministic; assert learning, not curves
    assert np.mean(hist[-5:]) < np.mean(hist[:5])
    assert _accuracy(fitted, ds) > 0.6
    # two workers, two models: distinct parameter tensors
    a, b = t._ps_workers
    assert a._model is not b._model
    assert all(p is not q for p, q in zip(a._params.values(),
                                          b._params.values()))


def test_host_ps_rejects_non_ps_trainer():
    from distkeras_tpu_torch import AveragingTrainer
    ds = make_dataset(n=256)
    t = AveragingTrainer(make_model(), num_workers=2, batch_size=32,
                         label_col="label_encoded", execution="host_ps",
                         device="cpu")
    with pytest.raises(ValueError, match="host_ps"):
        t.train(ds)


def test_wire_dtype_bfloat16_roundtrip():
    """bf16 leaves survive the codec as CPU torch.bfloat16 tensors (the
    JAX package's wire name ``"bfloat16"``)."""
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16)
    out = networking.decode_message(networking.encode_message({"d": a}))
    assert out["d"].dtype == torch.bfloat16
    torch.testing.assert_close(out["d"], a, rtol=0, atol=0)


def test_host_ps_bf16_wire_compression_learns():
    """ADAG over host_ps with bf16-compressed commits still trains, and the
    PS center stays f32."""
    ds = make_dataset()
    t = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=2,
             communication_window=4, label_col="label_encoded",
             learning_rate=0.1, execution="host_ps", wire_dtype="bfloat16",
             device="cpu")
    fitted = t.train(ds)
    assert _accuracy(fitted, ds) > 0.6
    assert all(w.dtype == np.float32 for w in fitted.get_weights())
    assert all(w.dtype == np.float32 for w in t._ps_server.ps.center)


def _worker(wire_dtype):
    m = Sequential([Dense(2)], input_shape=(3,), compute_dtype="float32",
                   device="cpu")
    return DOWNPOURWorker(serialize_model(m), "sgd", "mse", "127.0.0.1", 1,
                          wire_dtype=wire_dtype, device="cpu")


def test_int8_commit_quantizes_with_error_feedback(monkeypatch):
    """commit(wire_dtype='int8') ships int8 codes + f32 scales, returns the
    as-applied delta, and carries the quantization error into the next
    window (EF-SGD): eff = delta + prev_residual == applied + new_residual
    exactly, and |residual| <= scale/2 elementwise."""
    wk = _worker("int8")
    sent = []
    wk._sock = object()  # never touched by the stubs below
    monkeypatch.setattr(networking, "send_opcode", lambda s, op: None)
    monkeypatch.setattr(networking, "send_data",
                        lambda s, msg, pool=None: sent.append(msg))
    rng = np.random.default_rng(3)
    d1 = [rng.standard_normal((3, 2)).astype(np.float32) * 0.01,
          rng.standard_normal((2,)).astype(np.float32) * 0.01]
    a1 = wk.commit(d1, 0)
    assert all(c.dtype == np.int8 for c in sent[0]["delta"])
    for d, a, r, s in zip(d1, a1, wk._residual, sent[0]["scales"]):
        np.testing.assert_allclose(d, a + r, atol=1e-7)
        assert np.all(np.abs(r) <= s / 2 + 1e-7)
    r1 = [r.copy() for r in wk._residual]
    d2 = [rng.standard_normal((3, 2)).astype(np.float32) * 0.01,
          rng.standard_normal((2,)).astype(np.float32) * 0.01]
    a2 = wk.commit(d2, 0)
    for d, p, a, r in zip(d2, r1, a2, wk._residual):
        np.testing.assert_allclose(d + p, a + r, atol=1e-7)
    # a quarter of the f32 bytes on the wire (the scales ride the header)
    assert wk.commit_bytes == sum(d.size for d in d1 + d2)


def test_host_ps_int8_wire_compression_learns():
    """ADAG over host_ps with int8-quantized commits still trains — error
    feedback keeps the center honest."""
    ds = make_dataset()
    t = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=2,
             communication_window=4, label_col="label_encoded",
             learning_rate=0.1, execution="host_ps", wire_dtype="int8",
             device="cpu")
    fitted = t.train(ds)
    assert _accuracy(fitted, ds) > 0.6
    assert all(w.dtype == np.float32 for w in fitted.get_weights())


def test_host_ps_trains_transformer_lm():
    """The socket-PS engine handles the sequence-model family too: a
    RoPE/GQA causal LM's loss drops through true hogwild training (the
    wire carries the full transformer weight list)."""
    from distkeras_tpu_torch import transformer_lm

    model = transformer_lm(vocab_size=16, seq_len=12, d_model=32,
                           num_heads=4, num_layers=1, mlp_dim=64,
                           compute_dtype="float32", num_kv_heads=2,
                           positional="rope", device="cpu")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 16, (128, 12)).astype(np.int32)
    y = (x + 1) % 16
    tr = ADAG(model, num_workers=2, batch_size=16, num_epoch=8,
              communication_window=2, execution="host_ps",
              loss="sparse_categorical_crossentropy_from_logits",
              worker_optimizer="adam", learning_rate=3e-3, device="cpu")
    tr.train(Dataset({"features": x, "label": y}), shuffle=True)
    hist = tr.get_history()
    assert len(hist) > 0
    first, last = np.mean(hist[:4]), np.mean(hist[-4:])
    assert last < 0.5 * first, (first, last)


def test_wire_dtype_resolves_eagerly():
    """float16 (numpy-native) and bad names resolve/fail at construction;
    bfloat16 resolves to the torch dtype the port's wire carries; "topk"
    resolves to a density and no dense coding."""
    assert _worker("float16").wire_dtype == np.dtype(np.float16)
    assert _worker("bfloat16").wire_dtype == torch.bfloat16
    with pytest.raises((TypeError, AttributeError)):
        _worker("not_a_dtype")
    topk = _worker("topk")
    assert topk._topk_density == 0.01 and topk.wire_dtype is None


def test_workers_own_their_models():
    """share_compiled_state shares only the stateless update rule: two
    workers built from one blob train one window each on their own rows,
    and their parameter tensors are distinct objects holding different
    values (a shared module would be two threads on one set of
    weights)."""
    from distkeras_tpu_torch.workers import ADAGWorker, share_compiled_state
    blob = serialize_model(make_model())
    a, b = (ADAGWorker(blob, "sgd", "categorical_crossentropy",
                       "127.0.0.1", 1, communication_window=2,
                       batch_size=16, learning_rate=0.1, device="cpu")
            for _ in range(2))
    share_compiled_state([a, b])
    assert a._tx is b._tx and a._model is not b._model
    ds = make_dataset(n=128)
    for i, w in enumerate((a, b)):
        xw, yw, mw = w._shard_to_windows(
            {"features": ds["features"][i::2],
             "label": ds["label_encoded"][i::2]}, 2, i)
        xd, yd = w._to_device(xw, yw)
        params = w._params
        opt = w._tx.init(list(params.values()))
        w._build_window_fn()(params, opt, xd[0], yd[0], mw[0],
                             w._generator(i))
    pa, pb = list(a._params.values()), list(b._params.values())
    assert all(p is not q for p, q in zip(pa, pb))
    assert any(not torch.equal(p, q) for p, q in zip(pa, pb))
    # both started from the blob and moved away from it
    for w in (a, b):
        assert any(not np.array_equal(p, q) for p, q in
                   zip(w._params_to_weights(), blob["weights"]))
