"""The port's copy of the socket transport (``distkeras_tpu_torch.
networking``) held to the JAX package's wire, byte for byte.

The contract pinned here:

 - the serving frames and the ``KVBlocks`` node (``'k'``,
   ``SERVING_OP_KVBLOCKS``) round-trip through the port's one codec (the
   pure-Python one: the port builds no native codec yet), plain and
   through a pooled socket receive, and ``validate()`` rejects every
   hostile geometry with the typed ``ProtocolError`` — the serving and
   KV-block cases of ``tests/test_wirecodec.py`` on the port;
 - a bfloat16 payload needs no ``ml_dtypes``: it is a CPU
   ``torch.bfloat16`` tensor, framed as its raw bytes under the wire name
   ``"bfloat16"``, and a pooled view of one aliases the receive buffer
   until ``decoded()`` detaches it;
 - the same trees encoded by the JAX package's ``encode_message`` (its
   native codec where it is built) and by the port's give identical
   bytes — serving frames and ``KVBlocks`` with f32, bf16 and int8 +
   scale payloads, ``None`` layers and a ``uint32`` key — and each package
   decodes the other's frames to equal bits;
 - in a process where ``ml_dtypes`` cannot be imported the port still
   encodes and decodes a bf16 ``KVBlocks``;
 - a top-k ``SparseDelta`` with f32, bf16 or int8 values encodes to the
   same bytes in both packages and each decodes the other's frame to the
   same f32 values (a bf16 one as a CPU ``torch.bfloat16`` tensor), and a
   JAX worker's ``wire_topk_dtype="bfloat16"`` commits apply in a port
   parameter server (both cores) exactly as in a JAX one.
"""

import socket
import subprocess
import sys
import threading
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from distkeras_tpu import networking as jnet
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu import workers as jworkers
from distkeras_tpu.core import layers as jl
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu_torch import networking
from distkeras_tpu_torch import parameter_servers as pps

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

SERVING_FRAMES = [
    {"prompt": np.array([3, 4, 5, 6], np.int32), "num_steps": 16,
     "temperature": 0.7, "top_k": 5, "top_p": 0.9, "eos_id": 2,
     "pad_id": 0, "seed": 11},
    {"prompt": np.array([1], np.int32), "num_steps": 1},  # minimal request
    {"ok": True, "id": 7},
    {"ok": False, "error": "queue full"},                 # backpressure
    {"id": 7, "tokens": np.array([9, 4, 1], np.int32), "done": False},
    {"id": 7, "tokens": np.array([], np.int32), "done": True,
     "finish": "eos", "row": np.array([3, 4, 5, 6, 9, 4, 1, 2], np.int32)},
]


def test_the_port_has_no_native_codec():
    assert networking._native is None


def test_serving_frames_roundtrip():
    assert len(networking.SERVING_OP_ENQUEUE) == 1
    assert len(networking.SERVING_OP_STREAM) == 1
    for frame in SERVING_FRAMES:
        out = networking.decode_message(networking.encode_message(frame))
        assert out.keys() == frame.keys()
        for key, want in frame.items():
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(out[key], want)
                assert out[key].dtype == want.dtype
            else:
                assert out[key] == want and type(out[key]) is type(want)


def test_serving_frames_pooled_socket_roundtrip():
    """Every frame kind through a socket with pooled receive and pooled
    send, twice (buffer reuse)."""
    recv_pool = networking.BufferPool()
    send_pool = networking.BufferPool()
    a, b = socket.socketpair()
    try:
        for _ in range(2):
            for frame in SERVING_FRAMES:
                t = threading.Thread(target=networking.send_data,
                                     args=(a, frame),
                                     kwargs={"pool": send_pool})
                t.start()
                out = networking.recv_data(b, pool=recv_pool)
                t.join()
                assert out.keys() == frame.keys()
    finally:
        a.close()
        b.close()
    assert recv_pool.hits > 0 and send_pool.hits > 0


def _layers(mode, bs, nb, hkv, dh, rng):
    """Two KV layers after a cache-less one: ``mode`` "f32", "bf16" (CPU
    torch tensors) or "int8" (codes and per-entry f32 scales)."""
    rows = nb * bs
    layers = [None]
    for _ in range(2):
        if mode == "int8":
            c = {"k": rng.integers(-127, 128, (rows, hkv, dh)).astype(
                     np.int8),
                 "v": rng.integers(-127, 128, (rows, hkv, dh)).astype(
                     np.int8),
                 "ks": rng.random((rows, hkv)).astype(np.float32),
                 "vs": rng.random((rows, hkv)).astype(np.float32)}
        else:
            c = {k: rng.standard_normal((rows, hkv, dh)).astype(np.float32)
                 for k in ("k", "v")}
            if mode == "bf16":
                c = {k: torch.from_numpy(v).to(torch.bfloat16)
                     for k, v in c.items()}
        layers.append(c)
    return layers


def _kvb(mode="f32", bs=4, nb=2, hkv=2, dh=3, seed=0, mod=networking):
    rng = np.random.default_rng(seed)
    return mod.KVBlocks(_layers(mode, bs, nb, hkv, dh, rng), bs, nb,
                        positions=nb * bs - 1,
                        key=np.array([0, 11], np.uint32))


def _as_jax(kvb):
    """The JAX package's KVBlocks of the same payload (bf16 leaves as
    ``ml_dtypes`` arrays over the same bits)."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return v
    return jnet.KVBlocks(
        [None if c is None else {k: leaf(v) for k, v in c.items()}
         for c in kvb.layers],
        kvb.block_size, kvb.num_blocks, kvb.positions, kvb.key)


def _bits(v):
    """A payload leaf's bits, whatever its package."""
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy()
    if v.dtype == ml_dtypes.bfloat16:
        return v.view(np.int16)
    return v


def _assert_same_blocks(got, want):
    assert got.block_size == want.block_size
    assert got.num_blocks == want.num_blocks
    assert got.positions == want.positions
    np.testing.assert_array_equal(got.key, want.key)
    assert got.key.dtype == np.uint32
    assert len(got.layers) == len(want.layers)
    assert got.layers[0] is None
    for mine, ref in zip(got.layers[1:], want.layers[1:]):
        assert sorted(mine) == sorted(ref)
        for k in ref:
            assert tuple(mine[k].shape) == tuple(ref[k].shape)
            np.testing.assert_array_equal(_bits(mine[k]), _bits(ref[k]))
    assert got.nbytes == want.nbytes


def test_kvblocks_opcode_distinct():
    ops = (networking.SERVING_OP_ENQUEUE, networking.SERVING_OP_STREAM,
           networking.SERVING_OP_CANCEL, networking.SERVING_OP_KVBLOCKS)
    assert len(networking.SERVING_OP_KVBLOCKS) == 1
    assert len(set(ops)) == len(ops)


@pytest.mark.parametrize("mode", ["f32", "int8", "bf16"],
                         ids=["dense", "int8-scales", "bf16"])
def test_kvblocks_roundtrip(mode):
    """``__kvb__`` survives the codec bit for bit: block geometry,
    positions, key, per-layer payloads (int8 codes and scales; bf16 as
    torch tensors), ``None`` layers kept in place."""
    kvb = _kvb(mode)
    frame = {"blocks": kvb, "prompt": np.array([1, 2, 3], np.int32),
             "first_token": 9, "num_steps": 4}
    got = networking.decode_message(networking.encode_message(frame))[
        "blocks"]
    assert isinstance(got, networking.KVBlocks)
    _assert_same_blocks(got, kvb)
    for mine, want in zip(got.layers[1:], kvb.layers[1:]):
        for k in want:
            assert type(mine[k]) is type(want[k])
            assert mine[k].dtype == want[k].dtype
    got.validate()  # a clean round trip must stay admissible


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_kvblocks_pooled_recv_decoded(mode):
    """Through the pooled receive the payloads are views into the reused
    buffer (a bf16 tensor too, over the same memory); ``decoded()``
    detaches them, so a later receive cannot overwrite them."""
    pool = networking.BufferPool()
    a, b = socket.socketpair()
    kept = []
    try:
        for seed in range(2):
            sent = _kvb(mode, seed=seed)
            t = threading.Thread(target=networking.send_data,
                                 args=(a, {"blocks": sent}))
            t.start()
            out = networking.recv_data(b, pool=pool)
            t.join()
            got = out["blocks"]
            k = got.layers[1]["k"]
            if mode == "bf16":
                assert isinstance(k, torch.Tensor)
                assert k.dtype == torch.bfloat16
            else:
                assert not k.flags["OWNDATA"]
            det = got.validate().decoded()
            if mode != "bf16":
                assert det.layers[1]["k"].flags["OWNDATA"]
            kept.append((det, got, sent))
        assert pool.misses == 1 and pool.hits == 1
    finally:
        a.close()
        b.close()
    (det0, view0, sent0), (_, _, sent1) = kept
    # the detached copy holds the first frame; the pooled view of the
    # first frame was overwritten by the second receive
    _assert_same_blocks(det0, sent0)
    np.testing.assert_array_equal(_bits(view0.layers[1]["k"]),
                                  _bits(sent1.layers[1]["k"]))


def _corrupt(kvb, how):
    if how == "zero-blocks":
        kvb.num_blocks = 0
    elif how == "positions-zero":
        kvb.positions = 0
    elif how == "positions-overflow":
        kvb.positions = kvb.num_blocks * kvb.block_size + 1
    elif how == "missing-v":
        del kvb.layers[1]["v"]
    elif how == "unknown-payload":
        kvb.layers[1]["evil"] = kvb.layers[1]["k"]
    elif how == "row-count-lie":
        kvb.layers[1]["k"] = kvb.layers[1]["k"][:-1]
        kvb.layers[1]["v"] = kvb.layers[1]["v"][:-1]
    elif how == "kv-dtype-split":
        kvb.layers[1]["v"] = kvb.layers[1]["v"].astype(np.float64)
    elif how == "half-scales":
        del kvb.layers[1]["vs"]
    elif how == "scales-on-dense":
        kvb.layers[1]["ks"] = np.ones(kvb.layers[1]["k"].shape[:2],
                                      np.float32)
        kvb.layers[1]["vs"] = kvb.layers[1]["ks"]
    elif how == "scale-shape-lie":
        kvb.layers[1]["ks"] = kvb.layers[1]["ks"][:, :1]
    elif how == "no-layers":
        kvb.layers = [None, None, None]
    elif how == "signed-key":
        kvb.key = np.array([-1, 2], np.int64)
    return kvb


@pytest.mark.parametrize("how", [
    "zero-blocks", "positions-zero", "positions-overflow", "missing-v",
    "unknown-payload", "row-count-lie", "kv-dtype-split", "no-layers",
    "signed-key"])
def test_kvblocks_hostile_rejects(how):
    """Hostile or torn block frames survive the codec (it frames buffers,
    it does not interpret them) but ``validate()`` rejects them with the
    typed ``ProtocolError``, the serving server's shed path."""
    kvb = _corrupt(_kvb(), how)
    out = networking.decode_message(
        networking.encode_message({"blocks": kvb}))["blocks"]
    with pytest.raises(networking.ProtocolError):
        out.validate()


@pytest.mark.parametrize("how", ["half-scales", "scales-on-dense",
                                 "scale-shape-lie"])
def test_kvblocks_hostile_scale_rejects(how):
    kvb = _corrupt(_kvb("int8" if how != "scales-on-dense" else "f32"),
                   how)
    out = networking.decode_message(
        networking.encode_message({"blocks": kvb}))["blocks"]
    with pytest.raises(networking.ProtocolError):
        out.validate()


def test_kvblocks_bf16_hostile_and_device_payloads_reject():
    """A bf16 payload whose k and v disagree (a tensor beside an array)
    is a lie, and a payload that is not in host memory is refused."""
    kvb = _kvb("bf16")
    kvb.layers[1]["v"] = kvb.layers[1]["v"].float().numpy()
    with pytest.raises(networking.ProtocolError):
        kvb.validate()
    meta = _kvb("bf16")
    meta.layers[1] = {k: v.to("meta") for k, v in meta.layers[1].items()}
    with pytest.raises(networking.ProtocolError, match="host memory"):
        meta.validate()
    with pytest.raises(ValueError, match="host tensors"):
        networking.encode_message({"blocks": meta})


# ---------------------------------------------------------------------------
# across the packages: identical bytes, each decodes the other's frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(SERVING_FRAMES)))
def test_serving_frames_identical_bytes_across_packages(i):
    frame = SERVING_FRAMES[i]
    mine = networking.encode_message(frame)
    assert bytes(mine) == bytes(jnet.encode_message(frame))
    back = jnet.decode_message(mine)
    assert back.keys() == frame.keys()


@pytest.mark.parametrize("mode", ["f32", "int8", "bf16"])
def test_kvblocks_identical_bytes_across_packages(mode):
    """One shipped frame (``'k'``'s payload) from each package: the same
    bytes, pooled encode included, and each package decodes the other's
    to equal bits (bf16: a torch tensor here, an ``ml_dtypes`` array
    there)."""
    kvb = _kvb(mode, seed=3)
    jkvb = _as_jax(kvb)
    frame = {"blocks": kvb, "prompt": np.array([5, 6, 7], np.int32),
             "first_token": 4, "num_steps": 9, "temperature": 0.7,
             "seed": 2}
    jframe = dict(frame, blocks=jkvb)
    mine = networking.encode_message(frame)
    theirs = jnet.encode_message(jframe)
    assert bytes(mine) == bytes(theirs)
    assert bytes(networking.encode_message_into(
        frame, networking.BufferPool())) == bytes(theirs)
    from_jax = networking.decode_message(theirs)["blocks"]
    _assert_same_blocks(from_jax, kvb)
    from_port = jnet.decode_message(mine)["blocks"]
    _assert_same_blocks(from_port, jkvb)
    if mode == "bf16":
        assert from_port.layers[1]["k"].dtype == ml_dtypes.bfloat16
        assert from_jax.layers[1]["k"].dtype == torch.bfloat16
    from_port.validate()
    from_jax.validate()
    assert from_jax.nbytes == jkvb.nbytes == kvb.nbytes


def test_kvblocks_cross_package_socket_roundtrip():
    """A JAX sender and a port receiver on one socket, and back: the
    pooled receive of either package takes the other's frames."""
    kvb = _kvb("bf16", seed=5)
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=jnet.send_data,
                             args=(a, {"blocks": _as_jax(kvb)}))
        t.start()
        got = networking.recv_data(b, pool=networking.BufferPool())
        t.join()
        _assert_same_blocks(got["blocks"].validate().decoded(), kvb)
        t = threading.Thread(target=networking.send_data,
                             args=(b, {"blocks": kvb}))
        t.start()
        back = jnet.recv_data(a, pool=jnet.BufferPool())
        t.join()
        _assert_same_blocks(back["blocks"].validate().decoded(),
                            _as_jax(kvb))
    finally:
        a.close()
        b.close()


def test_bf16_kvblocks_without_ml_dtypes():
    """In a process where ``ml_dtypes`` cannot be imported the port still
    encodes, decodes and validates a bf16 ``KVBlocks``, and its frame is
    the one the JAX package makes (checked here against the bytes)."""
    kvb = _kvb("bf16", seed=7)
    want = bytes(jnet.encode_message({"blocks": _as_jax(kvb)}))
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import numpy as np, torch\n"
        "from distkeras_tpu_torch import networking as n\n"
        "rng = np.random.default_rng(7)\n"
        "layers = [None]\n"
        "for _ in range(2):\n"
        "    layers.append({k: torch.from_numpy(rng.standard_normal("
        "(8, 2, 3)).astype(np.float32)).to(torch.bfloat16) "
        "for k in ('k', 'v')})\n"
        "kvb = n.KVBlocks(layers, 4, 2, positions=7, "
        "key=np.array([0, 11], np.uint32))\n"
        "raw = n.encode_message({'blocks': kvb})\n"
        "got = n.decode_message(raw)['blocks'].validate().decoded()\n"
        "assert got.layers[1]['k'].dtype == torch.bfloat16\n"
        "assert torch.equal(got.layers[2]['v'], layers[2]['v'])\n"
        "assert 'ml_dtypes' not in {m for m, v in sys.modules.items() "
        "if v is not None}\n"
        "sys.stdout.write(bytes(raw).hex())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert bytes.fromhex(out.stdout) == want


# ---------------------------------------------------------------------------
# bf16 sparse values on the wire
# ---------------------------------------------------------------------------

def _sparse_pair(code, rng, n=200, k=17):
    idx = np.sort(rng.choice(n, k, replace=False)).astype(np.int32)
    vals = rng.standard_normal(k).astype(np.float32)
    if code == "bfloat16":
        return (jnet.SparseDelta(idx, vals.astype(ml_dtypes.bfloat16), n),
                networking.SparseDelta(
                    idx, torch.from_numpy(vals).to(torch.bfloat16), n))
    if code == "int8":
        scale = float(np.max(np.abs(vals)) / 127.0)
        q = np.clip(np.rint(vals / scale), -127, 127).astype(np.int8)
        return (jnet.SparseDelta(idx, q, n, scale),
                networking.SparseDelta(idx, q.copy(), n, scale))
    return (jnet.SparseDelta(idx, vals, n),
            networking.SparseDelta(idx, vals, n))


def _mlp_blob(d=16, hidden=32, classes=4, seed=0):
    model = JaxSequential([jl.Dense(hidden, activation="relu"),
                           jl.Dense(classes, activation="softmax")],
                          input_shape=(d,), compute_dtype="float32")
    rng = np.random.default_rng(seed)
    shapes = [(hidden,), (d, hidden), (classes,), (hidden, classes)]
    return {"model": model.to_json(),
            "weights": [(0.3 * rng.standard_normal(s)).astype(np.float32)
                        for s in shapes]}


def _mlp_rows(n=64, d=16, classes=4, seed=1):
    rng = np.random.default_rng(seed)
    protos = rng.uniform(-1, 1, (classes, d))
    labels = rng.integers(0, classes, n)
    x = (protos[labels] + 0.3 * rng.standard_normal((n, d))).astype(
        np.float32)
    return {"features": x, "label": np.eye(classes, dtype=np.float32)[labels]}


@pytest.mark.parametrize("code", [None, "bfloat16", "int8"])
def test_sparse_frames_byte_identical_both_ways(code):
    jsp, psp = _sparse_pair(code, np.random.default_rng(5))
    msg = {"worker_id": 1, "clock": 4}
    jframe = jnet.encode_message(dict(msg, delta=jsp))
    pframe = networking.encode_message(dict(msg, delta=psp))
    assert jframe == pframe
    np.testing.assert_array_equal(psp.f32_values(), jsp.f32_values())
    from_jax = networking.decode_message(jframe)["delta"]
    from_port = jnet.decode_message(pframe)["delta"]
    np.testing.assert_array_equal(from_jax.indices, jsp.indices)
    np.testing.assert_array_equal(from_jax.f32_values(), jsp.f32_values())
    np.testing.assert_array_equal(from_port.f32_values(), psp.f32_values())
    assert networking.encode_message(dict(msg, delta=from_jax)) == jframe
    if code == "bfloat16":
        assert from_jax.values.dtype == torch.bfloat16
        np.testing.assert_array_equal(from_jax.to_dense(), jsp.to_dense())
        twin = from_jax.decoded()
        assert twin.values.dtype == np.float32
        np.testing.assert_array_equal(twin.values, jsp.f32_values())


@pytest.mark.parametrize("core", ["event", "threaded"])
def test_jax_bf16_topk_worker_commits_into_port_ps(core):
    """A JAX DOWNPOUR worker with wire_topk_dtype="bfloat16" trains into a
    port server; the same worker (its compiled state shared) trains into a
    JAX server: the two centers and clocks are identical."""
    blob, rows = _mlp_blob(), _mlp_rows()
    kw = dict(wire_dtype="topk", wire_topk=0.05, wire_topk_dtype="bfloat16",
              communication_window=2, batch_size=8, learning_rate=0.1,
              comm_overlap=True)
    servers = [mod.make_socket_server(mod.DeltaParameterServer(blob),
                                      ps_core=core) for mod in (pps, jps)]
    try:
        for s in servers:
            s.start()
        workers = [jworkers.DOWNPOURWorker(
            blob, "sgd", "categorical_crossentropy", "127.0.0.1", s.port,
            **kw) for s in servers]
        jworkers.share_compiled_state(workers)
        for w in workers:
            w.train(0, rows)
    finally:
        for s in servers:
            s.stop()
    port_ps, jax_ps = (s.ps for s in servers)
    assert port_ps.num_updates == jax_ps.num_updates == 4  # 64 / (2 x 8)
    for a, b in zip(port_ps.center, jax_ps.center):
        np.testing.assert_array_equal(a, b)
    assert workers[0].history == workers[1].history
