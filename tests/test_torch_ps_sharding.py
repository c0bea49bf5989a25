"""The cases of tests/test_ps_sharding.py on the port: the deterministic
shard plan, the scatter/gather ``ShardedPSClient``, the shard server
group against the single PS, and ``ps_shards=N`` through the trainer on
the CPU (bit-identical single-worker runs, one ``'u'`` per window per
shard, ``PSShardDown`` on a dead shard).

The two fault-tolerance legs of the JAX file (a worker death under
sharding, a shard death overriding ``fault_tolerance``) need
``fault_tolerance`` on host_ps, which waits for ROADMAP queue A item 6:
here they assert that refusal.  The JAX file's ``BufferPool`` eviction
cases run here too (no other port file holds them)."""

import socket

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import ADAG, AEASGD, DOWNPOUR, networking
from distkeras_tpu_torch.parameter_servers import (DeltaParameterServer,
                                                   DynSGDParameterServer,
                                                   _scatter_add)
from distkeras_tpu_torch.ps_sharding import (PSShardDown, ShardedPSClient,
                                             ShardedServerGroup,
                                             make_shard_plan)
from distkeras_tpu_torch.workers import DOWNPOURWorker

from test_torch_host_ps import make_dataset, make_model
from test_torch_host_ps_overlap import _OpcodeRecorder, _free_port, \
    _tiny_blob

torch.set_num_threads(1)


def _accuracy(fitted, ds):
    preds = fitted.predict(ds["features"])
    return float(np.mean(np.argmax(preds, axis=1) == ds["label"]))


# ---------------------------------------------------------------------------
# the shard plan
# ---------------------------------------------------------------------------

SHAPES = [(16, 32), (32,), (32, 4), (4,), ()]


def _rand_weights(shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]


def test_shard_plan_covers_every_row_exactly_once():
    plan = make_shard_plan(SHAPES, [np.float32] * len(SHAPES), 3)
    for t, shape in enumerate(SHAPES):
        rows = shape[0] if shape else 1
        pieces = sorted(s for a in plan.assignments for s in a
                        if s.tensor == t)
        assert pieces[0].start == 0 and pieces[-1].stop == rows
        for a, b in zip(pieces, pieces[1:]):
            assert a.stop == b.start  # contiguous, no overlap, no gap
    ws = _rand_weights()
    out = plan.gather(plan.scatter(ws))
    for a, b in zip(ws, out):
        assert np.array_equal(a, b) and a.dtype == b.dtype


def test_shard_plan_is_deterministic():
    a = make_shard_plan(SHAPES, [np.float32] * len(SHAPES), 4)
    b = make_shard_plan(SHAPES, [np.float32] * len(SHAPES), 4)
    assert a.assignments == b.assignments


def test_shard_plan_n1_is_identity():
    plan = make_shard_plan(SHAPES, [np.float32] * len(SHAPES), 1)
    assert plan.num_shards == 1
    assert [s.tensor for s in plan.assignments[0]] == list(range(len(SHAPES)))
    ws = _rand_weights()
    sc = plan.scatter(ws)[0]
    # whole tensors, original order, zero-copy views
    for v, w in zip(sc, ws):
        assert np.array_equal(v, w) and (v is w or v.base is w)


def test_shard_plan_splits_oversized_tensor():
    """One embedding-sized tensor can't unbalance the ring: anything larger
    than total/N is split row-wise and the split pieces cover it exactly."""
    shapes = [(1024, 256), (64,), (32, 8), ()]
    plan = make_shard_plan(shapes, [np.float32] * 4, 4)
    emb = sorted(s for a in plan.assignments for s in a if s.tensor == 0)
    assert len(emb) >= 4  # row-wise split, not one shard holding it whole
    assert emb[0].start == 0 and emb[-1].stop == 1024
    for a, b in zip(emb, emb[1:]):
        assert a.stop == b.start
    loads = plan.shard_bytes()
    assert max(loads) <= 2 * (sum(loads) // 4)  # reasonably balanced


def test_plan_slices_torch_bf16_leaves():
    """The port's bf16 wire leaves are CPU torch tensors: ``take`` slices
    them as tensors (views), and ``scatter`` keeps each slice's bytes."""
    plan = make_shard_plan(SHAPES, [np.float32] * len(SHAPES), 3)
    ws = [torch.from_numpy(w).to(torch.bfloat16) for w in _rand_weights()]
    for pieces, parts in zip(plan.assignments, plan.scatter(ws)):
        for s, part in zip(pieces, parts):
            assert isinstance(part, torch.Tensor)
            want = ws[s.tensor] if ws[s.tensor].ndim == 0 else \
                ws[s.tensor][s.start:s.stop]
            assert torch.equal(part, want)


# ---------------------------------------------------------------------------
# sharded client vs the single PS — same applies, bit for bit
# ---------------------------------------------------------------------------

def _blob(weights):
    return {"model": make_model().to_json(),
            "weights": [np.asarray(w, np.float32) for w in weights]}


def test_sharded_delta_applies_match_single_ps():
    rng = np.random.default_rng(1)
    w0 = _rand_weights(seed=2)
    single = DeltaParameterServer(_blob(w0))
    group = ShardedServerGroup("downpour", _blob(w0), num_workers=2,
                               num_shards=3)
    group.start()
    try:
        client = ShardedPSClient(group.plan, group.addrs)
        client.connect()
        for k in range(3):
            delta = [np.asarray(rng.standard_normal(w.shape), np.float32)
                     for w in w0]
            single.handle_update({"delta": delta, "worker_id": 0,
                                  "clock": k})
            center = client.update({"delta": delta, "worker_id": 0,
                                    "clock": k})
        client.disconnect()
    finally:
        group.stop()
    gathered, clocks = group.snapshot()
    for a, b, c in zip(single.center, gathered, center):
        assert np.array_equal(a, b)
        assert np.array_equal(a, np.asarray(c))
    assert clocks == [3] * 3  # every shard saw every commit


def test_dynsgd_staleness_is_per_shard_identical():
    """Two workers interleaving through the sharded client price staleness
    exactly as the single DynSGD PS does: B commits against a clock one
    behind on EVERY shard, so every slice gets the same 1/(staleness+1)."""
    w0 = _rand_weights(seed=3)
    d1 = [np.ones_like(w) for w in w0]
    d2 = [np.full_like(w, 2.0) for w in w0]

    single = DynSGDParameterServer(_blob(w0))
    single.handle_update({"delta": d1, "worker_id": 0, "clock": 0})
    single.handle_update({"delta": d2, "worker_id": 1, "clock": 0})

    group = ShardedServerGroup("dynsgd", _blob(w0), num_workers=2,
                               num_shards=2)
    group.start()
    try:
        a = ShardedPSClient(group.plan, group.addrs)
        b = ShardedPSClient(group.plan, group.addrs)
        a.connect()
        b.connect()
        a.pull()
        b.pull()  # both see clock 0 on every shard
        a.update({"delta": d1, "worker_id": 0, "clock": 0})
        b.update({"delta": d2, "worker_id": 1, "clock": 0})  # staleness 1
        a.disconnect()
        b.disconnect()
    finally:
        group.stop()
    gathered, _ = group.snapshot()
    for s, g in zip(single.center, gathered):
        assert np.array_equal(s, g)


# ---------------------------------------------------------------------------
# end-to-end: ps_shards through the trainer
# ---------------------------------------------------------------------------

def _train_weights(cls=ADAG, n=512, **kw):
    ds = make_dataset(n=n)
    kw.setdefault("learning_rate", 0.1)
    t = cls(make_model(), num_workers=1, batch_size=32, num_epoch=2,
            communication_window=4, label_col="label_encoded",
            execution="host_ps", device="cpu", **kw)
    fitted = t.train(ds)
    return [np.asarray(w) for w in fitted.get_weights()], t


def test_ps_shards_bit_identical_to_single_ps():
    """ps_shards=1 reproduces the plain single-PS path bit for bit, and —
    the apply rules being elementwise — so does a single-worker
    ps_shards=4 run (same training, the center merely partitioned)."""
    ref, _ = _train_weights()
    one, _ = _train_weights(ps_shards=1)
    four, t4 = _train_weights(ps_shards=4)
    for a, b in zip(ref, one):
        assert np.array_equal(a, b)
    for a, b in zip(ref, four):
        assert np.array_equal(a, b)
    # the sharded transport really engaged: 4 messages per logical op
    w = t4._ps_workers[0]
    assert w._shard_client is not None
    assert w.transport_ops == 4 * (1 + w._commits)


def test_ps_shards_serial_path_bit_identical():
    """The overlap-off 'c'+'p' loop rides the sharded client too."""
    kw = dict(cls=DOWNPOUR, comm_overlap=False, learning_rate=0.02)
    ref, _ = _train_weights(**kw)
    sh, t = _train_weights(ps_shards=3, **kw)
    for a, b in zip(ref, sh):
        assert np.array_equal(a, b)
    w = t._ps_workers[0]
    assert w.transport_ops == 3 * (1 + 2 * w._commits)


@pytest.mark.parametrize("wire_dtype", ["int8", "bfloat16"])
def test_ps_shards_int8_wire_bit_identical(wire_dtype):
    """int8 quantization happens on the FULL tensor before the scatter (one
    scale per parent tensor, shipped alongside each slice), so the
    as-applied delta — and with one worker the whole run — is independent
    of the sharding; so are the port's bf16 tensor leaves, sliced as
    tensors."""
    ref, _ = _train_weights(wire_dtype=wire_dtype)
    sh, _ = _train_weights(ps_shards=2, wire_dtype=wire_dtype)
    for a, b in zip(ref, sh):
        assert np.array_equal(a, b)


def test_split_sparse_bisection_matches_dense_scatter():
    """A flat sparse commit split by index bisection lands every coordinate
    on its owning shard in slice-local coordinates: applying each shard's
    split to its center slices and gathering equals the dense scatter —
    across tensor boundaries, row-split tensors, and 0-d scalars."""
    shapes = [(64, 8), (16, 32), (32,), (32, 4), (4,), ()]
    plan = make_shard_plan(shapes, [np.float32] * len(shapes), 3)
    total = sum(int(np.prod(s)) for s in shapes)
    assert plan.flat_elements() == total
    assert sum(plan.shard_elements()) == total
    rng = np.random.default_rng(7)
    idx = np.sort(rng.choice(total, 101, replace=False)).astype(np.int32)
    vals = rng.standard_normal(101).astype(np.float32)
    parts = plan.split_sparse(idx, vals)
    owner = plan.shard_of_flat(idx)
    assert all((owner == j).sum() == len(parts[j][0]) for j in range(3))
    shard_centers = [[np.array(a, copy=True) for a in sl]
                     for sl in plan.scatter([np.zeros(s, np.float32)
                                             for s in shapes])]
    for j, (li, lv) in enumerate(parts):
        assert np.all(np.diff(li) > 0)  # stays sorted per shard
        _scatter_add(shard_centers[j],
                     networking.SparseDelta(li, lv,
                                            plan.shard_elements()[j]), 1.0)
    gathered = plan.gather(shard_centers)
    dense = np.zeros(total, np.float32)
    dense[idx] = vals
    flat = np.concatenate([g.reshape(-1) for g in gathered])
    np.testing.assert_array_equal(flat, dense)
    # bf16 values (CPU torch tensors) split with the same owners
    bf = torch.from_numpy(vals).to(torch.bfloat16)
    for (li, lv), (bi, bv) in zip(parts, plan.split_sparse(idx, bf)):
        np.testing.assert_array_equal(li, bi)
        assert bv.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            bv.float().numpy(),
            torch.from_numpy(np.asarray(lv)).to(torch.bfloat16).float())
    # out-of-range indices are rejected, not mis-binned
    with pytest.raises(ValueError, match="range"):
        plan.split_sparse(np.array([total], np.int64),
                          np.array([1.0], np.float32))


def test_ps_shards_topk_wire_bit_identical():
    """Top-k selection runs on the FULL flat delta before the scatter (one
    selection, one value scale), so — as with int8 — a single-worker
    sharded run is bit-identical to the single-PS run."""
    kw = dict(wire_dtype="topk", wire_topk=0.05)
    ref, _ = _train_weights(**kw)
    sh, t = _train_weights(ps_shards=3, **kw)
    for a, b in zip(ref, sh):
        assert np.array_equal(a, b)
    assert t._ps_workers[0]._shard_client is not None


def test_ps_shards_4_adag_converges_one_rtt_per_window_per_shard():
    """A ps_shards=4 ADAG run converges, and the opcode stream shows exactly
    one 'u' round trip per communication window PER SHARD — the overlap
    property end to end through the sharded client."""
    ds = make_dataset(n=1024)
    t = ADAG(make_model(), num_workers=2, batch_size=32, num_epoch=3,
             communication_window=4, learning_rate=0.1,
             label_col="label_encoded", execution="host_ps", ps_shards=4,
             device="cpu")
    assert t.comm_overlap  # ADAG's default: the pipelined 'u' path
    with _OpcodeRecorder() as rec:
        fitted = t.train(ds)
    # 1024 rows / 2 workers = 512 each; window*batch = 128 → 4 windows per
    # epoch per worker × 3 epochs × 2 workers = 24 windows
    windows = 24
    assert rec.count(b"u") == windows * 4
    assert rec.count(b"c") == 0
    assert rec.count(b"p") == 2 * 4  # one initial pull per worker per shard
    assert rec.count(b"q") == 2 * 4
    for w in t._ps_workers:
        assert w.transport_ops == 4 * (1 + w._commits)
        pools = w._shard_client.pools
        assert len(pools) == 4
        for p in pools:  # per-shard pools: every reply reused one buffer
            assert p.misses == 1 and p.hits == w._commits
    assert _accuracy(fitted, ds) > 0.8
    # the group's drain counters sum over the shards
    stats = t.ps_coalesce_stats
    assert stats["commits_applied"] == windows * 4


def test_aeasgd_overlap_through_sharded_client():
    """Elastic-family opt-in overlap composes with sharding: AEASGD with
    comm_overlap=True through 2 shards still converges and pays exactly one
    'u' RTT per window per shard."""
    ds = make_dataset()
    t = AEASGD(make_model(), num_workers=2, batch_size=32, num_epoch=2,
               communication_window=8, rho=1.0, learning_rate=0.05,
               label_col="label_encoded", execution="host_ps",
               comm_overlap=True, ps_shards=2, device="cpu")
    with _OpcodeRecorder() as rec:
        fitted = t.train(ds)
    # 2048 rows / 2 workers = 1024 each; window*batch = 256 → 4 windows per
    # epoch per worker × 2 epochs × 2 workers = 16 windows
    windows = 16
    assert rec.count(b"u") == windows * 2
    assert rec.count(b"c") == 0
    assert rec.count(b"p") == 2 * 2
    hist = t.get_history()
    assert np.mean(hist[-5:]) < np.mean(hist[:5])
    preds = fitted.predict(ds["features"][:256])
    acc = float(np.mean(np.argmax(preds, axis=1) == ds["label"][:256]))
    assert acc > 0.6, acc


def test_sharded_run_tolerates_worker_death():
    """The JAX case kills a worker under sharding with fault_tolerance on;
    fault_tolerance/fault_injection on host_ps wait for ROADMAP queue A
    item 6, and the sharded trainer refuses them at train()."""
    ds = make_dataset(n=1024)
    t = ADAG(make_model(), num_workers=4, batch_size=16, num_epoch=3,
             communication_window=4, label_col="label_encoded",
             worker_optimizer="adam", learning_rate=2e-3,
             execution="host_ps", ps_shards=2, fault_tolerance=True,
             fault_injection={1: 2}, device="cpu")
    assert t.ps_shards == 2
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        t.train(ds)


def test_ps_shards_knob_validation():
    m = make_model()
    kw = dict(num_workers=2, label_col="label_encoded", device="cpu")
    assert ADAG(m, execution="host_ps", ps_shards=4, **kw).ps_shards == 4
    with pytest.raises(ValueError, match="ps_shards"):
        ADAG(m, execution="host_ps", ps_shards=0, **kw)
    with pytest.raises(ValueError, match="ps_shards"):
        ADAG(m, ps_shards=2, num_workers=1, label_col="label_encoded",
             device="cpu")  # SPMD: no PS to shard
    # the JAX class shards process_ps too; the process engine waits
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        ADAG(m, execution="process_ps", ps_shards=2, **kw)


# ---------------------------------------------------------------------------
# shard death → PSShardDown
# ---------------------------------------------------------------------------

def test_dead_shard_raises_shard_down_with_id():
    group = ShardedServerGroup("downpour", _tiny_blob(), num_workers=1,
                               num_shards=2)
    group.start()
    client = ShardedPSClient(group.plan, group.addrs)
    client.connect()
    try:
        client.pull()  # both shards alive
        group.servers[1].stop()  # joined: its socket is closed
        with pytest.raises(PSShardDown, match="shard 1") as err:
            for _ in range(3):  # first op may still drain a buffered reply
                client.pull()
        assert err.value.shard_id == 1
        assert isinstance(err.value, ConnectionError)  # generic handlers OK
    finally:
        client.abort()
        group.stop()


def test_shard_connect_failure_is_shard_down():
    plan = make_shard_plan([(3,)], [np.float32], 2)
    addrs = [("127.0.0.1", _free_port()), ("127.0.0.1", _free_port())]
    client = ShardedPSClient(plan, addrs)
    with pytest.raises(PSShardDown, match="shard 0"):
        client.connect(attempts=2, backoff=0.01)


def test_shard_down_overrides_fault_tolerance(monkeypatch):
    """The JAX case: a dead shard re-raises PSShardDown even under
    fault_tolerance=True.  fault_tolerance on host_ps waits for ROADMAP
    queue A item 6; without it a shard death still surfaces as itself."""
    from distkeras_tpu_torch import ps_sharding

    def dying(self):
        raise PSShardDown(1, detail="injected shard death")

    monkeypatch.setattr(ps_sharding.ShardedPSClient, "recv_update", dying)
    ds = make_dataset(n=512)
    kw = dict(num_workers=2, batch_size=32, num_epoch=1,
              communication_window=4, learning_rate=0.1,
              label_col="label_encoded", execution="host_ps", ps_shards=2,
              device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        ADAG(make_model(), fault_tolerance=True, **kw).train(ds)
    with pytest.raises(PSShardDown, match="shard 1"):
        ADAG(make_model(), **kw).train(ds)


# ---------------------------------------------------------------------------
# connect() retries reset/timeout handshake faults
# ---------------------------------------------------------------------------

def test_connect_retries_reset_and_timeout(monkeypatch):
    """A shard mid-start() can accept then reset (or stall): the worker's
    bounded retry covers ConnectionResetError and socket.timeout, not just
    ConnectionRefusedError."""
    a, b = socket.socketpair()
    try:
        faults = [ConnectionResetError("peer reset mid-handshake"),
                  socket.timeout("handshake stalled")]

        def flaky(host, port, **kw):
            if faults:
                raise faults.pop(0)
            return a

        monkeypatch.setattr(networking, "connect", flaky)
        wk = DOWNPOURWorker(_tiny_blob(), "sgd", "mse", "127.0.0.1",
                            _free_port(), device="cpu")
        wk.connect(attempts=5, backoff=0.001)
        assert wk._sock is a and not faults  # both faults were retried
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# BufferPool growth cap
# ---------------------------------------------------------------------------

def test_buffer_pool_evicts_stale_sizes():
    """A buffer unused for max_idle acquisitions is evicted, so a pull-size
    change doesn't pin the old full-weight-sized buffer forever."""
    pool = networking.BufferPool(max_idle=2)
    pool.get(100)
    pool.get(200)
    assert pool.evictions == 0  # 100 idle for 1 acquisition: kept
    pool.get(200)
    assert pool.evictions == 1 and 100 not in pool._bufs
    assert 200 in pool._bufs  # the live size survives
    pool.get(100)  # comes back as a fresh allocation
    assert pool.misses == 3 and pool.hits == 1


def test_buffer_pool_steady_state_unaffected_by_cap():
    pool = networking.BufferPool()  # default cap
    for _ in range(100):
        pool.get(4096)
    assert pool.misses == 1 and pool.hits == 99 and pool.evictions == 0
