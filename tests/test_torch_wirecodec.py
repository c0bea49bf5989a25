"""The port's native wire codec (its own build of ``csrc/wirecodec.cpp``)
against its pure-Python codec and against the JAX package's two codecs.

The ``codec`` fixture runs the port's contract on both implementations,
as ``tests/test_wirecodec.py`` does for the JAX module: setting
``networking._native = None`` pins the pure-Python codec for encode,
decode and the pooled payload split.  Across the packages, every payload
kind — f32, int8 codes with scales and bf16 leaves (the port's CPU
``torch.bfloat16`` tensors, the JAX package's ``ml_dtypes`` arrays of the
same bits), ``SparseDelta`` with f32, bf16 and int8 values,
``RowSparseDelta`` and ``KVBlocks`` (f32, int8, bf16) — encodes to the
same bytes under each of the four pairs of codecs, and each package
decodes the other's frames to the same bits.  The JAX package's native
codec is its ``csrc/wirecodec.cpp`` built for these tests
(``torch_jax_native``), whatever the checkout's in-place builds hold."""

import socket
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from distkeras_tpu import networking as jnet
from distkeras_tpu_torch import native, networking
from test_torch_networking import _as_jax, _assert_same_blocks, _bits, _kvb
from torch_jax_native import load as load_jax_native

torch.set_num_threads(1)


def _jax_native():
    return load_jax_native("wirecodec")


@pytest.fixture(params=["python", "native"])
def codec(request, monkeypatch):
    """The port's codec for this test: 'python' pins the pure-Python path,
    'native' the port's build."""
    monkeypatch.setattr(networking, "_native", None
                        if request.param == "python"
                        else native.load("wirecodec"))
    return request.param


@pytest.fixture(params=["jax-python", "jax-native"])
def jax_codec(request, monkeypatch):
    monkeypatch.setattr(jnet, "_native", None
                        if request.param == "jax-python" else _jax_native())
    return request.param


MESSAGE = {
    "weights": [np.arange(12, dtype=np.float32).reshape(3, 4),
                np.ones((5,), np.float64), np.zeros((0, 3), np.float32)],
    "clock": 7,
    "tag": "commit",
    "nested": {"t": (1, 2.5, None), "flag": True},
}


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_the_native_codec_is_the_ports_own_build():
    mod = native.load("wirecodec")
    assert mod.__name__ == "distkeras_tpu_torch._wirecodec"
    assert mod is not jnet._native


def test_native_and_python_bytes_identical(monkeypatch):
    monkeypatch.setattr(networking, "_native", native.load("wirecodec"))
    enc_native = networking.encode_message(MESSAGE)
    monkeypatch.setattr(networking, "_native", None)
    assert enc_native == networking.encode_message(MESSAGE)


def test_cross_decoding(monkeypatch):
    """Python-encoded → native-decoded and back."""
    monkeypatch.setattr(networking, "_native", None)
    blob_py = networking.encode_message(MESSAGE)
    monkeypatch.setattr(networking, "_native", native.load("wirecodec"))
    blob_native = networking.encode_message(MESSAGE)
    _same(networking.decode_message(blob_py), MESSAGE)
    monkeypatch.setattr(networking, "_native", None)
    _same(networking.decode_message(blob_native), MESSAGE)


def test_roundtrip_either_codec(codec):
    _same(networking.decode_message(networking.encode_message(MESSAGE)),
          MESSAGE)


def test_payload_decode_either_codec(codec):
    payload = b"".join(len(x).to_bytes(8, "little") + x
                       for x in (b"abc", b"", b"0123456789"))
    assert [bytes(v) for v in networking.decode_payload(payload)] == [
        b"abc", b"", b"0123456789"]
    with pytest.raises(ValueError):
        networking.decode_payload(payload[:-3])


@pytest.mark.parametrize("how", ["magic", "truncated", "length-lie"])
def test_rejects_corrupt_frames_either_codec(codec, how):
    good = networking.encode_message({"w": np.zeros((4,), np.float32)})
    if how == "magic":
        bad = b"XXXX" + good[4:]
    elif how == "truncated":
        bad = good[:-5]
    else:
        tampered = bytearray(good)
        off = len(good) - 16 - 8
        tampered[off:off + 8] = (1 << 60).to_bytes(8, "little")
        bad = bytes(tampered)
    with pytest.raises(ValueError):
        networking.decode_message(bad)


def test_encode_pool_bytes_identical_either_codec(codec):
    pool = networking.BufferPool()
    want = networking.encode_message(MESSAGE)
    for _ in range(2):
        assert bytes(networking.encode_message_into(MESSAGE, pool)) == want


def test_pooled_recv_either_codec(codec):
    """Through a socket with pooled receive, twice: one buffer, reused."""
    pool = networking.BufferPool()
    a, b = socket.socketpair()
    try:
        for _ in range(2):
            t = threading.Thread(target=networking.send_data,
                                 args=(a, MESSAGE))
            t.start()
            out = networking.recv_data(b, pool=pool)
            t.join()
            _same(out, MESSAGE)
            assert not out["weights"][0].flags["OWNDATA"]
    finally:
        a.close()
        b.close()
    assert pool.misses == 1 and pool.hits == 1


def test_bf16_leaves_come_back_writable_from_either_decoder(codec):
    """A bf16 leaf goes out as int16 bytes under ``"bfloat16"`` and comes
    back as a CPU ``torch.bfloat16`` tensor; over the native decoder's
    read-only views it is a copy, so it can be written."""
    w = torch.linspace(-3, 3, 10).to(torch.bfloat16)
    blob = networking.encode_message({"w": [w]})
    assert b'"dtype": "bfloat16"' in blob
    got = networking.decode_message(blob)["w"][0]
    assert got.dtype == torch.bfloat16 and torch.equal(got, w)
    got.add_(1)  # writable
    assert not torch.equal(got, w)


# ---------------------------------------------------------------------------
# across the packages: every payload kind, every pair of codecs
# ---------------------------------------------------------------------------

def _dense(mode, rng):
    w = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    if mode == "f32":
        return {"delta": w, "clock": 2}, {"delta": w, "clock": 2}
    if mode == "int8":
        codes = [rng.integers(-127, 128, x.shape).astype(np.int8) for x in w]
        msg = {"delta": codes, "scales": [0.5, 0.25], "clock": 2}
        return msg, msg
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in w]
    jbf = [x.view(torch.int16).numpy().view(ml_dtypes.bfloat16) for x in bf]
    return {"delta": bf, "clock": 2}, {"delta": jbf, "clock": 2}


def _sparse(mode, rng):
    idx = np.sort(rng.choice(100, 9, replace=False)).astype(np.int32)
    vals = rng.standard_normal(9).astype(np.float32)
    if mode == "sparse-f32":
        return (networking.SparseDelta(idx, vals, 100),
                jnet.SparseDelta(idx, vals, 100))
    if mode == "sparse-int8":
        codes = rng.integers(-127, 128, 9).astype(np.int8)
        return (networking.SparseDelta(idx, codes, 100, 0.125),
                jnet.SparseDelta(idx, codes, 100, 0.125))
    bf = torch.from_numpy(vals).to(torch.bfloat16)
    return (networking.SparseDelta(idx, bf, 100),
            jnet.SparseDelta(idx, bf.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16), 100))


def _case(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind in ("f32", "int8", "bf16"):
        return _dense(kind, rng)
    if kind.startswith("sparse"):
        mine, theirs = _sparse(kind, rng)
        return {"delta": mine, "clock": 1}, {"delta": theirs, "clock": 1}
    if kind == "row-sparse":
        rows = np.array([1, 4, 6], np.int32)
        vals = rng.standard_normal((3, 8)).astype(np.float32)
        return ({"delta": [networking.RowSparseDelta(rows, vals, 10)]},
                {"delta": [jnet.RowSparseDelta(rows, vals, 10)]})
    mode = kind.split("-")[1]
    kvb = _kvb(mode, seed=3)
    return {"blocks": kvb, "first_token": 5}, {"blocks": _as_jax(kvb),
                                                "first_token": 5}


KINDS = ["f32", "int8", "bf16", "sparse-f32", "sparse-bf16", "sparse-int8",
         "row-sparse", "kvb-f32", "kvb-int8", "kvb-bf16"]


@pytest.mark.parametrize("kind", KINDS)
def test_identical_bytes_across_packages(kind, codec, jax_codec):
    mine, theirs = _case(kind)
    assert bytes(networking.encode_message(mine)) == bytes(
        jnet.encode_message(theirs))


def _leaf_bits(v):
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy()
    v = np.asarray(v)
    return v.view(np.int16) if v.dtype == ml_dtypes.bfloat16 else v


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_decodes_the_others_frames(kind, codec, jax_codec):
    mine, theirs = _case(kind)
    from_jax = networking.decode_message(jnet.encode_message(theirs))
    from_port = jnet.decode_message(networking.encode_message(mine))
    if kind.startswith("kvb"):
        _assert_same_blocks(from_jax["blocks"], mine["blocks"])
        _assert_same_blocks(from_port["blocks"], mine["blocks"])
        return
    for got, want in ((from_jax["delta"], mine["delta"]),
                      (from_port["delta"], mine["delta"])):
        if kind.startswith("sparse"):
            np.testing.assert_array_equal(got.indices, want.indices)
            np.testing.assert_array_equal(got.f32_values(),
                                          want.f32_values())
            continue
        for g, w in zip(got, want):
            if kind == "row-sparse":
                np.testing.assert_array_equal(g.rows, w.rows)
                np.testing.assert_array_equal(g.values, w.values)
            else:
                np.testing.assert_array_equal(_leaf_bits(g), _bits(w))
