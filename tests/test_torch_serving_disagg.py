"""The port's disaggregated serving (``ServingEngine(role="prefill" |
"decode")``, ``submit_prefilled``, ``DisaggPair``) against the JAX
package on the CPU.

The contract pinned here, on the JAX disaggregation tests' tiny LM (vocab
17, seq 32, d_model 16, 2 heads, 2 layers, f32; 2 slots, max_len 24,
blocks of 4, 30 blocks), one numpy weight set in both packages:

 - a prefill→decode pair emits the unified paged engine's rows, greedy and
   sampled, f32 and int8 KV; its greedy rows and its shipped and ingested
   blocks and bytes equal the JAX pair's (sampled rows are held to the
   port's own unified rows: the two packages draw other bits);
 - no block leaks on either engine across completion, cancel and death
   interleavings; a prefill death re-routes with the original key; a
   decode death is terminal and typed;
 - the wire path (``'k'`` through the port's ``ServingServer``, both
   cores) streams the same rows, and a torn or hostile ``'k'`` frame is
   shed with the decode pool untouched, a geometry lie refused typed;
 - across the packages: a JAX prefill engine's block set, shipped by a
   JAX ``ServingClient``, decodes on a port decode server into the JAX
   unified rows, and a port prefill engine's into a JAX decode server.

The supervisor leg and the JAX load generator's builder wait for the
supervisors' slice (ROADMAP queue A item 4).
"""

import time

import numpy as np
import pytest
import torch

import distkeras_tpu.serving as jserving
import distkeras_tpu_torch.serving as pserving
from distkeras_tpu_torch import networking
from distkeras_tpu_torch.networking import ChaosFault, ChaosProxy
from distkeras_tpu_torch.serving import (DisaggPair, EngineDead,
                                         ServingClient, ServingEngine,
                                         ServingServer)
from test_torch_serving_fastpath import RecordingGraph, graphed  # noqa: F401
from test_torch_serving_wire import models, server_core  # noqa: F401

pytestmark = pytest.mark.disagg

torch.set_num_threads(1)

PROMPT = np.array([3, 4, 5, 6], np.int32)
REQS = [
    {"prompt": PROMPT, "num_steps": 8},                           # greedy
    {"prompt": np.arange(1, 8, dtype=np.int32), "num_steps": 6,
     "temperature": 0.7, "seed": 11},
    {"prompt": np.array([2, 9], np.int32), "num_steps": 5,
     "temperature": 0.7, "top_k": 5, "top_p": 0.9, "seed": 23},
    {"prompt": np.array([7, 1, 4, 4, 2, 9, 11, 3, 5], np.int32),
     "num_steps": 7},                                             # greedy
]
GREEDY = [0, 3]
#: the counters a pair must book alike in both packages
TRANSFER = ("kv_blocks_shipped", "kv_block_bytes_shipped",
            "kv_blocks_ingested", "kv_block_bytes_ingested")


@pytest.fixture(scope="module")
def fitted(models):
    return models[1]


def _mk(f, role, mod=pserving, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", 24)
    kw.setdefault("block_size", 4)
    kw.setdefault("kv_blocks", 30)
    return mod.ServingEngine(f, paged=True, role=role, **kw)


def _unified_rows(f, reqs, mod=pserving, **ekw):
    """Reference rows from a unified paged engine (inline scheduler)."""
    eng = _mk(f, "unified", mod=mod, **ekw)
    hs = [eng.submit(**r) for r in reqs]
    eng.run_until_idle()
    assert eng.kv_blocks_in_use == 0
    return [h.result() for h in hs]


def _pair_run(f, reqs, mod=pserving, **ekw):
    pair = mod.DisaggPair([_mk(f, "prefill", mod=mod, **ekw)],
                          decode=_mk(f, "decode", mod=mod, **ekw),
                          poll_s=0.005)
    with pair:
        hs = [pair.submit(**r) for r in reqs]
        rows = [h.result(timeout=60.0) for h in hs]
    return pair, rows


def _assert_zero_leak(pair):
    assert pair.kv_blocks_in_use == 0
    for e in pair.engines:
        assert e.kv_blocks_in_use == 0, f"leak on role={e.role} engine"
        assert e._pool.check_conservation()
        assert not e._plans


@pytest.fixture(scope="module")
def jax_pairs(models):
    """The JAX pair over ``REQS`` per KV dtype: its rows and counters."""
    out = {}
    for kv_dtype in (None, "int8"):
        ekw = {} if kv_dtype is None else {"kv_dtype": kv_dtype}
        pair, rows = _pair_run(models[0], REQS, mod=jserving, **ekw)
        out[kv_dtype] = (rows, {k: pair.stats[k] for k in TRANSFER})
    return out


# ---------------------------------------------------------------------------
# rows: pair vs unified (port) and vs the JAX pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"],
                         ids=["kv-f32", "kv-int8"])
def test_pair_token_identical_to_unified_and_jax(fitted, jax_pairs,
                                                 kv_dtype):
    """The hand-off changes no token: every row equals the port's unified
    paged engine, greedy rows equal the JAX pair's, and the shipped and
    ingested blocks and bytes equal the JAX pair's (int8 ships codes and
    scales)."""
    ekw = {} if kv_dtype is None else {"kv_dtype": kv_dtype}
    want = _unified_rows(fitted, REQS, **ekw)
    pair, rows = _pair_run(fitted, REQS, **ekw)
    for got, ref in zip(rows, want):
        np.testing.assert_array_equal(got, ref)
    j_rows, j_stats = jax_pairs[kv_dtype]
    for i in GREEDY:
        np.testing.assert_array_equal(rows[i], j_rows[i])
    s = pair.stats
    assert {k: s[k] for k in TRANSFER} == j_stats
    assert s["kv_blocks_shipped"] == sum(-(-len(r["prompt"]) // 4)
                                         for r in REQS)
    assert s["kv_block_bytes_shipped"] == s["kv_block_bytes_ingested"]
    _assert_zero_leak(pair)
    assert s["requests_completed"] == len(REQS)
    # one extraction sample and one ingest sample per request
    assert len(s["transfer_ms"]) == 2 * len(REQS)
    pre, dec = pair.engines
    assert pre.stats["graph_captures"] == 0 == pre.stats["decode_steps"]
    assert dec.stats["prefills"] == 0


def test_pair_zero_steps_completes_on_prefill_side(fitted):
    """num_steps=0 never crosses: the prefill engine completes it in
    place and the pair books it."""
    pair = DisaggPair([_mk(fitted, "prefill")],
                      decode=_mk(fitted, "decode"), poll_s=0.005)
    with pair:
        h = pair.submit(PROMPT, 0)
        assert h.wait(timeout=30.0)
    assert h.finish == "empty"
    assert pair.counters["requests_completed"] == 1
    _assert_zero_leak(pair)


def test_one_step_and_eos_first_token_complete_at_admission(models):
    """A shipped first token that already ends the row (``num_steps``
    1, or the eos) completes in ``submit_prefilled`` without a slot, as
    in the JAX engine."""
    rows = []
    for mod, f in ((jserving, models[0]), (pserving, models[1])):
        pre = _mk(f, "prefill", mod=mod)
        h = pre.submit(PROMPT, 5)
        pre.run_until_idle()
        assert h.finish == "prefilled" and pre.kv_blocks_in_use == 0
        first = int(h.tokens[0])
        dec = _mk(f, "decode", mod=mod)
        one = dec.submit_prefilled(h.kvblocks, PROMPT, first, 1)
        eos = dec.submit_prefilled(h.kvblocks, PROMPT, first, 5,
                                   eos_id=first)
        assert (one.finish, eos.finish) == ("length", "eos")
        assert dec.kv_blocks_in_use == 0 and dec.queue_depth == 0
        rows.append((one.result(), eos.result(), dec.stats[
            "requests_completed"], dec.stats["tokens_generated"]))
    for a, b in zip(*rows):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# zero block leak across cancel interleavings
# ---------------------------------------------------------------------------

def test_cancel_mid_decode_reclaims_blocks_both_sides(fitted):
    pair = DisaggPair([_mk(fitted, "prefill")],
                      decode=_mk(fitted, "decode"), poll_s=0.005)
    with pair:
        doomed = pair.submit(PROMPT, 18)
        keeper = pair.submit(np.array([5, 6, 7], np.int32), 4)
        chunk, done = doomed.next_chunk(timeout=30.0)
        assert chunk, "no first token within timeout"
        assert pair.cancel(doomed) or doomed.done
        assert doomed.wait(timeout=30.0)
        assert keeper.wait(timeout=30.0)
        assert pair.drain(timeout=30.0)
    assert doomed.finish in ("cancel", "length", "eos")  # cancel can race
    assert keeper.finish in ("length", "eos")
    _assert_zero_leak(pair)
    c = pair.counters
    assert c["requests_submitted"] == 2
    assert c["requests_completed"] + c["requests_cancelled"] == 2


def test_cancel_queued_before_prefill(fitted):
    """A cancel that lands while the request waits in the prefill
    engine's queue never touches the decode side."""
    pre = _mk(fitted, "prefill")
    dec = _mk(fitted, "decode")
    pair = DisaggPair([pre], decode=dec, poll_s=0.005)
    try:
        h = pair.submit(PROMPT, 8)
        assert pair.cancel(h)
        pre.run_until_idle()
        assert h.wait(timeout=30.0)
        assert h.finish == "cancel"
    finally:
        pair.stop()
    _assert_zero_leak(pair)
    assert dec.stats["requests_submitted"] == 0
    assert pair.counters["requests_cancelled"] == 1


# ---------------------------------------------------------------------------
# prefill death re-routes; decode death is terminal
# ---------------------------------------------------------------------------

def test_prefill_death_reroutes_with_original_key(fitted):
    """pre1 never runs, so the request waits in its queue; its death
    fails the upstream handle and the pair resubmits to pre2 with the
    original key: one client request, the unified row, no leak."""
    req = {"prompt": PROMPT, "num_steps": 6, "temperature": 0.6,
           "seed": 7}
    (want,) = _unified_rows(fitted, [req])
    pre1 = _mk(fitted, "prefill")
    pre2 = _mk(fitted, "prefill")
    dec = _mk(fitted, "decode")
    pair = DisaggPair([pre1, pre2], decode=dec, poll_s=0.005)
    try:
        pre2.start()
        dec.start()
        h = pair.submit(**req)  # round-robin lands on (unstarted) pre1
        assert pre1.stats["requests_submitted"] == 1
        pre1.declare_dead("chaos: prefill killed mid-flight")
        row = h.result(timeout=60.0)
    finally:
        pair.stop()
    np.testing.assert_array_equal(row, want)
    assert pair.counters["prefill_reroutes"] == 1
    assert pair.counters["requests_completed"] == 1
    assert pair.counters["requests_failed"] == 0
    assert pre2.stats["requests_submitted"] == 1
    _assert_zero_leak(pair)


def test_every_prefill_dead_fails_typed(fitted):
    pre = _mk(fitted, "prefill")
    dec = _mk(fitted, "decode")
    pair = DisaggPair([pre], decode=dec, poll_s=0.005)
    try:
        dec.start()
        h = pair.submit(PROMPT, 6)
        pre.declare_dead("chaos: the only prefill engine died")
        assert h.wait(timeout=30.0)
    finally:
        pair.stop()
    assert isinstance(h.error, EngineDead)
    with pytest.raises(EngineDead):
        h.result()
    assert pair.counters["requests_failed"] == 1
    _assert_zero_leak(pair)


def test_decode_death_is_terminal_no_reroute(fitted):
    pre = _mk(fitted, "prefill")
    dec = _mk(fitted, "decode")
    pair = DisaggPair([pre], decode=dec, poll_s=0.005)
    try:
        pre.start()  # decode not started: the hand-off waits in its queue
        h = pair.submit(PROMPT, 8)
        assert h.next_chunk(timeout=30.0)[0], "prefill token not relayed"
        deadline = time.monotonic() + 30.0
        while dec.queue_depth == 0 and time.monotonic() < deadline:
            time.sleep(0.005)   # the relay loop queues the hand-off
        dec.declare_dead("chaos: decode engine killed")
        assert h.wait(timeout=30.0)
    finally:
        pair.stop()
    assert isinstance(h.error, EngineDead)
    assert pair.counters["prefill_reroutes"] == 0
    assert pair.counters["requests_failed"] == 1
    assert pair.dead is not None
    _assert_zero_leak(pair)


# ---------------------------------------------------------------------------
# the wire path: 'k' through the port's ServingServer
# ---------------------------------------------------------------------------

def test_pair_over_wire_token_identical(fitted, server_core):
    reqs = [REQS[0], {"prompt": np.array([2, 9, 4], np.int32),
                      "num_steps": 5, "temperature": 0.7, "seed": 5}]
    want = _unified_rows(fitted, reqs)
    with ServingServer(_mk(fitted, "decode"), poll_s=0.005) as srv:
        pair = DisaggPair([_mk(fitted, "prefill")], decode_addr=srv.addr,
                          poll_s=0.005)
        with pair:
            rows = [pair.submit(**r).result(timeout=60.0) for r in reqs]
        for got, ref in zip(rows, want):
            np.testing.assert_array_equal(got, ref)
        assert srv.engine.kv_blocks_in_use == 0
        assert (srv.engine.stats["kv_block_bytes_ingested"]
                == pair.stats["kv_block_bytes_shipped"] > 0)
    _assert_zero_leak(pair)
    assert pair.counters["requests_completed"] == len(reqs)


def _prefilled(f, num_steps=6, mod=pserving):
    """Run a real prefill half inline; its shipped block set and token."""
    pre = _mk(f, "prefill", mod=mod)
    h = pre.submit(PROMPT, num_steps)
    pre.run_until_idle()
    assert h.finish == "prefilled"
    assert pre.kv_blocks_in_use == 0
    return h.kvblocks, int(h.tokens[0])


def test_hostile_kvblocks_frame_sheds_pool_untouched(fitted, server_core):
    """A ``'k'`` frame whose payload lies about its own geometry dies in
    ``validate()`` before any engine call: ``protocol_errors`` counts
    it, the decode pool never allocates, and the server keeps serving."""
    kvb, first = _prefilled(fitted)
    torn = kvb.decoded()
    for c in torn.layers:
        if c is not None:
            for k in list(c):
                c[k] = c[k][:-1]
    with ServingServer(_mk(fitted, "decode"), poll_s=0.005) as srv:
        with ServingClient(*srv.addr) as c:
            with pytest.raises((ConnectionError, OSError)):
                c.submit_prefilled(torn, PROMPT, first, 6)
                c.sock.recv(1)  # the shed path drops the connection
        assert srv.protocol_errors == 1
        assert srv.engine.kv_blocks_in_use == 0
        assert srv.engine.stats["kv_blocks_ingested"] == 0
        with ServingClient(*srv.addr) as c:
            rid = c.submit_prefilled(kvb, PROMPT, first, 6)
            toks = []  # the stream starts at the prefill token
            for chunk, done in c.stream(rid):
                toks.extend(int(t) for t in chunk)
                if done is not None:
                    assert done["finish"] in ("length", "eos")
                    break
        (want,) = _unified_rows(fitted, [{"prompt": PROMPT,
                                          "num_steps": 6}])
        np.testing.assert_array_equal(np.asarray(toks, np.int32),
                                      want[len(PROMPT):])
        assert srv.engine.kv_blocks_in_use == 0


def test_geometry_mismatch_rejected_typed(fitted, server_core):
    """A self-consistent block set that does not fit the decode engine's
    arena is a typed ``bad_request``, not a dropped connection."""
    kvb, first = _prefilled(fitted)
    with ServingServer(_mk(fitted, "decode", block_size=8, kv_blocks=16),
                       poll_s=0.005) as srv:
        with ServingClient(*srv.addr) as c:
            with pytest.raises(ValueError):
                c.submit_prefilled(kvb, PROMPT, first, 6)
        assert srv.protocol_errors == 0
        assert srv.engine.kv_blocks_in_use == 0


def test_torn_kvblocks_transfer_decode_pool_untouched(fitted, server_core):
    """The port's ``ChaosProxy`` tears the ``'k'`` frame mid-transfer
    (half the payload, then RST): the decode server sheds it with its
    pool untouched and serves the next, intact transfer."""
    kvb, first = _prefilled(fitted)
    with ServingServer(_mk(fitted, "decode"), poll_s=0.005) as srv:
        with ChaosProxy(*srv.addr, protocol="serving",
                        faults=[ChaosFault(0, 0, "tear")]) as px:
            with ServingClient(*px.addr) as c:
                with pytest.raises((ConnectionError, OSError)):
                    c.submit_prefilled(kvb, PROMPT, first, 6)
                    c.sock.recv(1)
            deadline = time.monotonic() + 10.0
            while (srv.protocol_errors + srv.disconnects == 0
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            assert srv.protocol_errors + srv.disconnects >= 1
            assert srv.engine.kv_blocks_in_use == 0
            assert srv.engine.stats["kv_blocks_ingested"] == 0
        with ServingClient(*srv.addr) as c:
            rid = c.submit_prefilled(kvb, PROMPT, first, 6)
            for chunk, done in c.stream(rid):
                if done is not None:
                    assert done["finish"] in ("length", "eos")
                    break
        assert srv.engine.kv_blocks_in_use == 0


# ---------------------------------------------------------------------------
# role admission contracts
# ---------------------------------------------------------------------------

def test_role_admission_contracts(fitted):
    with pytest.raises(ValueError):
        _mk(fitted, "decode").submit(PROMPT, 4)  # decode refuses submit
    with pytest.raises(ValueError):
        ServingEngine(fitted, num_slots=2, max_len=24, role="prefill")
    with pytest.raises(ValueError):
        DisaggPair([_mk(fitted, "unified")], decode=_mk(fitted, "decode"))
    with pytest.raises(ValueError):
        DisaggPair([_mk(fitted, "prefill")])  # neither decode nor addr
    with pytest.raises(ValueError, match="role='decode'"):
        _mk(fitted, "prefill").submit_prefilled(None, PROMPT, 1, 2)
    assert networking.SERVING_OP_KVBLOCKS == b"k"


# ---------------------------------------------------------------------------
# across the packages over the wire
# ---------------------------------------------------------------------------

def test_jax_prefill_into_port_decode_server(models, server_core):
    """A JAX prefill engine's block set, shipped by a JAX
    ``ServingClient`` to a port decode-role ``ServingServer``, decodes
    into the JAX unified row."""
    (want,) = _unified_rows(models[0], [REQS[3]], mod=jserving)
    pre = _mk(models[0], "prefill", mod=jserving)
    h = pre.submit(**REQS[3])
    pre.run_until_idle()
    assert h.finish == "prefilled"
    with ServingServer(_mk(models[1], "decode"), poll_s=0.005) as srv:
        with jserving.ServingClient(*srv.addr) as c:
            rid = c.submit_prefilled(h.kvblocks, REQS[3]["prompt"],
                                     int(h.tokens[0]),
                                     REQS[3]["num_steps"])
            row = None
            for _, done in c.stream(rid):
                if done is not None:
                    row = done["row"]
        np.testing.assert_array_equal(row, want)
        assert srv.engine.kv_blocks_in_use == 0
        assert (srv.engine.stats["kv_block_bytes_ingested"]
                == pre.stats["kv_block_bytes_shipped"])


def test_port_prefill_into_jax_decode_server(models):
    """A port prefill engine's block set, shipped by a port
    ``ServingClient`` to a JAX decode-role server, decodes into the JAX
    unified row."""
    (want,) = _unified_rows(models[0], [REQS[3]], mod=jserving)
    kvb_pre = _mk(models[1], "prefill")
    h = kvb_pre.submit(**REQS[3])
    kvb_pre.run_until_idle()
    assert h.finish == "prefilled"
    with jserving.ServingServer(_mk(models[0], "decode", mod=jserving),
                                poll_s=0.005) as srv:
        with ServingClient(*srv.addr) as c:
            rid = c.submit_prefilled(h.kvblocks, REQS[3]["prompt"],
                                     int(h.tokens[0]),
                                     REQS[3]["num_steps"])
            row = None
            for _, done in c.stream(rid):
                if done is not None:
                    row = done["row"]
        np.testing.assert_array_equal(row, want)
        assert srv.engine.kv_blocks_in_use == 0


# ---------------------------------------------------------------------------
# port cases: admission geometry, blocks running out, the graph, warmup
# ---------------------------------------------------------------------------

def _geometry_errors(mod, f, kvb, first):
    """The ValueError messages ``submit_prefilled`` gives for each kind of
    block set or request that does not fit (module ``mod``'s engine)."""
    dec = _mk(f, "decode", mod=mod)
    bad = {
        "block_size": (_mk(f, "decode", mod=mod, block_size=8,
                           kv_blocks=16), kvb, PROMPT, 6),
        "positions": (dec, kvb, PROMPT[:3], 6),
        "max_len": (dec, kvb, PROMPT, 40),
        "num_steps": (dec, kvb, PROMPT, 0),
        "int8": (_mk(f, "decode", mod=mod, kv_dtype="int8"), kvb,
                 PROMPT, 6),
    }
    out = {}
    for name, (eng, blocks, prompt, steps) in bad.items():
        with pytest.raises(ValueError) as err:
            eng.submit_prefilled(blocks, prompt, first, steps)
        out[name] = str(err.value)
    assert dec.kv_blocks_in_use == 0 and dec.queue_depth == 0
    return out


def test_submit_prefilled_geometry_errors_match_jax(models):
    """Every geometry lie is refused before the request counts, with the
    JAX engine's message."""
    j = _geometry_errors(jserving, models[0],
                         *_prefilled(models[0], mod=jserving))
    p = _geometry_errors(pserving, models[1], *_prefilled(models[1]))
    assert p == j


def test_submit_prefilled_backpressure_draining_and_death(fitted):
    """Admission of a shipped set behaves as ``submit`` does: a full
    queue sheds (``QueueFull`` with ``block=False``), a draining engine
    refuses, a dead one raises ``EngineDead``; each shed is counted."""
    kvb, first = _prefilled(fitted)
    dec = _mk(fitted, "decode", queue_capacity=1)
    dec.submit_prefilled(kvb, PROMPT, first, 6)
    with pytest.raises(pserving.QueueFull):
        dec.submit_prefilled(kvb, PROMPT, first, 6, block=False)
    assert dec.stats["requests_rejected"] == 1
    assert dec.drain(timeout=30.0)
    with pytest.raises(pserving.Draining):
        dec.submit_prefilled(kvb, PROMPT, first, 6)
    dead = _mk(fitted, "decode")
    dead.declare_dead("chaos")
    with pytest.raises(EngineDead):
        dead.submit_prefilled(kvb, PROMPT, first, 6)
    assert dec.kv_blocks_in_use == 0


def test_decode_role_requeues_at_front_when_blocks_run_out(models):
    """A decode arena that holds one request's chain at a time: the
    second shipped request waits at the front of the queue until the
    first retires, and both rows and every counter equal the JAX decode
    engine's."""
    got = []
    for mod, f in ((jserving, models[0]), (pserving, models[1])):
        kvb, first = _prefilled(f, mod=mod)
        dec = _mk(f, "decode", mod=mod, kv_blocks=6)
        a = dec.submit_prefilled(kvb, PROMPT, first, 20)
        b = dec.submit_prefilled(kvb, PROMPT, first, 20)
        dec.step()
        assert a.slot is not None and b.slot is None
        assert dec.queue_depth == 1 and dec.kv_blocks_in_use == 6
        dec.run_until_idle()
        assert dec.kv_blocks_in_use == 0 and not dec._plans
        got.append((a.result(), b.result(),
                    {k: dec.stats[k] for k in TRANSFER + (
                        "requests_completed", "tokens_generated",
                        "decode_steps", "slot_requests")}))
    (ja, jb, js), (pa, pb, ps) = got
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pa, pb)
    assert ps == js


def test_roles_graph_in_place_warmup_and_respawn(fitted, graphed):
    """With the decode step standing in for a CUDA graph: a prefill-role
    engine never captures (not at warmup, not serving); a decode-role
    engine captures once at warmup, ingests every shipped set into its
    static tensors in place (their storages unchanged, so the graph
    replays over them), replays once a decode step, and a decode-only
    iteration uploads nothing and reads back one row.  Warmup leaves no
    trace on either role, and a respawned clone keeps its role."""
    pre = _mk(fitted, "prefill").warmup()
    dec = _mk(fitted, "decode").warmup()
    assert pre.stats["graph_captures"] == 0 and pre._graph is None
    assert dec.stats["graph_captures"] == 1
    for eng in (pre, dec):
        assert eng.kv_blocks_in_use == 0 and not eng._active.any()
        assert not eng._dev_act.any()
        assert (eng._dev_bt == eng.kv_blocks).all()
    static = {n: getattr(dec, n).data_ptr() for n in (
        "_dev_bt", "_dev_tok", "_dev_pos", "_dev_act", "_dev_temp",
        "_dev_topk", "_dev_topp", "_dev_keys")}
    static.update({f"arena{i}.{k}": v.data_ptr()
                   for i, c in enumerate(dec.caches) if c is not None
                   for k, v in c.items()})
    reqs = [REQS[0], REQS[1], REQS[3]]
    want = _unified_rows(fitted, reqs)
    captures = graphed.captures     # the warmups' and the unified engine's
    pair = DisaggPair([pre], decode=dec, poll_s=0.005)
    keys = ("decode_steps", "kv_blocks_ingested", "h2d_transfers",
            "d2h_transfers", "graph_replays", "graph_captures")
    seen = set()
    pre.start()
    try:
        hs = [pair.submit(**r) for r in reqs]
        while not all(h.done for h in hs):
            before = [dec.stats[k] for k in keys]
            if not dec.step():
                time.sleep(0.001)
                continue
            d = [dec.stats[k] - b for k, b in zip(keys, before)]
            if d[0] == 1 and d[1] == 0:
                seen.add(tuple(d[2:]))
    finally:
        pair.stop()
    for h, ref in zip(hs, want):
        np.testing.assert_array_equal(h.result(), ref)
    assert seen == {(0, 1, 1, 0)}   # uploads, readbacks, replays, captures
    assert graphed.captures == captures      # none while serving
    assert pre.stats["graph_captures"] == 0
    assert dec.stats["graph_captures"] == 1
    assert dec.stats["graph_replays"] == dec.stats["decode_steps"] > 0
    assert static == {
        **{n: getattr(dec, n).data_ptr() for n in (
            "_dev_bt", "_dev_tok", "_dev_pos", "_dev_act", "_dev_temp",
            "_dev_topk", "_dev_topp", "_dev_keys")},
        **{f"arena{i}.{k}": v.data_ptr()
           for i, c in enumerate(dec.caches) if c is not None
           for k, v in c.items()}}
    _assert_zero_leak(pair)
    for eng in (pre, dec):
        clone = eng.respawn_clone()
        assert clone.role == eng.role and clone.kv_blocks == eng.kv_blocks
        assert clone.stats["kv_blocks_ingested"] == 0
