"""Hot weight reload of the port's ``ServingEngine`` (``attach_ps``)
against the JAX engine's contract (``tests/test_online_deployment.py``'s
attach_ps legs), on the CPU.

The tiny next-item LM of the JAX tests (vocab 16, seq 6, d_model 16, 2
heads, 1 layer, mlp 32, f32) gets numpy-drawn weight sets, loaded into
both packages.  A pull writes the center into the engine's own weights in
place: the engine then serves the center's greedy tokens exactly, as a
fresh engine built from the center does (f32, int8 and bf16 engines,
token for token), every tensor keeps its address (the decode graph reads
them at fixed addresses on a card), and neither the caller's model nor a
clone's weights move.  A failed pull (nothing listening, a PS killed
between a commit and the pull, one shard of two down, a center of
another architecture) counts ``reload_failures`` and keeps the current
weights bit for bit.  Port engines pull from JAX servers and JAX engines
from port servers over the one wire.
"""

import socket
import threading

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import parameter_servers as jps
from distkeras_tpu.core.model import FittedModel as JFitted
from distkeras_tpu.core.model import serialize_model as jserialize
from distkeras_tpu.models.zoo import transformer_lm as jax_lm
from distkeras_tpu.serving import ServingEngine as JEngine
from distkeras_tpu_torch import FittedModel, RetryPolicy, transformer_lm
from distkeras_tpu_torch import parameter_servers as pps
from distkeras_tpu_torch.core.model import load_jax_weights, serialize_model
from distkeras_tpu_torch.core.quant import QuantizedTensor
from distkeras_tpu_torch.ps_sharding import (ShardedServerGroup,
                                             make_shard_plan)
from distkeras_tpu_torch.serving import ServingEngine

torch.set_num_threads(1)

V, L = 16, 4
CFG = dict(vocab_size=V, seq_len=L + 2, d_model=16, num_heads=2,
           num_layers=1, mlp_dim=32, compute_dtype="float32")
PROBE = np.arange(V, dtype=np.int32).reshape(-1, 1)
ONE_SHOT = RetryPolicy(attempts=1, backoff=0.0, jitter=0.0, deadline=0.05)


def numpy_weights(seed, **cfg):
    shapes = [w.shape for w in transformer_lm(**{**CFG, **cfg},
                                              device="cpu").get_weights()]
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) / np.sqrt(s[0]) if len(s) == 2
             else 0.1 * rng.standard_normal(s)).astype(np.float32)
            + (len(s) == 1) * np.float32(1.0) for s in shapes]


def port_lm(seed, **cfg):
    m = transformer_lm(**{**CFG, **cfg}, device="cpu")
    return FittedModel(load_jax_weights(m, numpy_weights(seed, **cfg)))


def jax_fitted(seed):
    jm = jax_lm(**CFG)
    params = jm.init(jax.random.PRNGKey(0), (L + 2,))
    return JFitted(jm, jm.set_weights(params, numpy_weights(seed)))


def engine(seed=1, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_len", 3)
    return ServingEngine(port_lm(seed), **kw)


def port_server(seed=9, **cfg):
    ps = pps.DeltaParameterServer(serialize_model(port_lm(seed, **cfg).model))
    server = pps.make_socket_server(ps)
    server.start()
    return ps, server


def dead_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()  # nothing listens there now
    return port


def weights(eng):
    return [w.copy() for w in eng.model.get_weights()]


def greedy(eng, prompts, steps=1):
    handles = [eng.submit(p, steps) for p in prompts]
    eng.run_until_idle()
    return [h.result() for h in handles]


def test_failed_pull_counts_and_keeps_weights():
    """No PS behind the address: the one-shot dial fails, the pull counts
    a reload failure, and serving goes on bit for bit on the current
    weights."""
    f = port_lm(3)
    eng = ServingEngine(f, num_slots=1, max_len=3)
    eng.attach_ps("127.0.0.1", dead_port(), every=1, retry_policy=ONE_SHOT)
    want = f.generate(PROBE[3][None], 1, max_len=3).numpy()[0]
    (got,) = greedy(eng, [PROBE[3]])
    assert eng.stats["reload_failures"] >= 1
    assert eng.stats["reloads"] == eng.stats["weight_reloads"] == 0
    assert eng.stats["center_generation"] is None
    np.testing.assert_array_equal(got, want)


def test_center_generation_tracks_the_ps_clock():
    """A pull stamps center_generation from the PS clock and fires the
    listener; the engine then serves the center's numerics; a commit
    advances the clock and the next pull sees it."""
    ps, server = port_server(9)
    seen = []
    try:
        eng = engine(seed=1)
        eng.attach_ps("127.0.0.1", server.port, every=1)
        eng._reload_listener = lambda t, g: seen.append(g)
        greedy(eng, [PROBE[0]])
        assert eng.stats["reloads"] >= 1
        assert eng.stats["center_generation"] == ps.num_updates == 0
        center = port_lm(9)
        want = center.generate(PROBE[5][None], 1, max_len=3).numpy()[0]
        np.testing.assert_array_equal(greedy(eng, [PROBE[5]])[0], want)
        ps.handle_commit({"delta": [np.zeros_like(w) for w in ps.center],
                          "worker_id": 0, "clock": 0})
        greedy(eng, [PROBE[6]])
        assert eng.stats["center_generation"] == ps.num_updates == 1
        assert seen[0] == 0 and seen[-1] == 1
        assert eng.stats["weight_reloads"] == eng.stats["reloads"]
    finally:
        server.stop()


def test_kill_between_commit_and_pull_keeps_the_old_generation():
    ps, server = port_server(9)
    eng = engine(seed=1)
    eng.attach_ps("127.0.0.1", server.port, every=1, retry_policy=ONE_SHOT)
    greedy(eng, [PROBE[0]])
    assert eng.stats["reloads"] == 1 and eng.stats["center_generation"] == 0
    frozen = weights(eng)
    ps.handle_commit({"delta": [np.ones_like(w) for w in ps.center],
                      "worker_id": 0, "clock": 0})
    server.stop()
    greedy(eng, [PROBE[7]])
    assert eng.stats["reload_failures"] >= 1
    assert eng.stats["center_generation"] == 0
    for a, b in zip(weights(eng), frozen):
        np.testing.assert_array_equal(a, b)  # untorn


def test_sharded_pull_gathers_the_full_center():
    """A pull gathers the center across both shards, its clock is the sum
    of the shard clocks, and one shard down keeps the weights whole."""
    group = ShardedServerGroup("downpour",
                               serialize_model(port_lm(3).model), 1, 2)
    group.start()
    try:
        eng = engine(seed=4)
        pol = RetryPolicy(attempts=1, backoff=0.01, jitter=0.0,
                          deadline=0.25)
        eng.attach_ps("127.0.0.1", group.ports[0], retry_policy=pol,
                      shard_plan=group.plan,
                      shard_addrs=[("127.0.0.1", p) for p in group.ports])
        eng._pull_weights()
        assert eng.stats["reloads"] == 1
        assert eng.stats["center_generation"] == 0
        center, _ = group.snapshot()
        for a, b in zip(weights(eng), center):
            np.testing.assert_array_equal(a, b)
        bumped = [w + 1.0 for w in center]
        group.restore_state(bumped, [5, 7])
        eng._pull_weights()
        assert eng.stats["reloads"] == 2
        assert eng.stats["center_generation"] == 12
        for a, b in zip(weights(eng), bumped):
            np.testing.assert_array_equal(a, b)
        frozen = weights(eng)
        group.servers[1].stop()
        eng._pull_weights()
        assert eng.stats["reload_failures"] >= 1
        assert eng._reload_client is None
        for a, b in zip(weights(eng), frozen):
            np.testing.assert_array_equal(a, b)
    finally:
        group.stop()


@pytest.mark.parametrize("kw,match", [
    (dict(every=0), "every"),
    (dict(shard_addrs=[("127.0.0.1", 1)]), "pair"),
    (dict(shard_plan=make_shard_plan([(2, 2)], [np.float32], 2)), "pair"),
])
def test_attach_knobs_refused_as_jax(kw, match):
    """The port's refusals carry the JAX engine's messages."""
    eng = engine()
    jeng = JEngine((jax_fitted(1).model, jax_fitted(1).params),
                   num_slots=4, max_len=3)
    for e in (eng, jeng):
        with pytest.raises(ValueError, match=match):
            e.attach_ps("127.0.0.1", 1, **kw)
    assert eng._ps_addr is None


def test_one_shard_plan_is_the_plain_attachment():
    eng = engine()
    plan = make_shard_plan([(2, 2)], [np.float32], 1)
    eng.attach_ps("127.0.0.1", 1, shard_plan=plan,
                  shard_addrs=[("127.0.0.1", 1)])
    assert eng._ps_shard_addrs is None and eng._ps_shard_plan is None
    assert eng._ps_addr == ("127.0.0.1", 1)


def test_respawn_clone_carries_the_attachment_and_listener():
    pol = RetryPolicy(attempts=2, backoff=0.01, jitter=0.0, deadline=0.2)
    seen = []
    eng = engine(seed=1)
    eng.attach_ps("127.0.0.1", 1, every=3, retry_policy=pol)
    eng._reload_listener = seen.append
    clone = eng.respawn_clone()
    assert clone._ps_addr == eng._ps_addr
    assert clone._reload_every == 3
    assert clone._reload_policy is pol
    assert clone._reload_listener is eng._reload_listener
    assert clone._owns_weights and clone.model is not eng.model
    plan = make_shard_plan([(4, 4)], [np.float32], 2)
    eng2 = engine(seed=1)
    eng2.attach_ps("127.0.0.1", 1, shard_plan=plan,
                   shard_addrs=[("127.0.0.1", 1), ("127.0.0.1", 2)])
    clone2 = eng2.respawn_clone()
    assert clone2._ps_shard_plan is plan
    assert clone2._ps_shard_addrs == eng2._ps_shard_addrs
    # a never-attached engine's clone shares its model, as before
    eng3 = engine(seed=1)
    assert eng3.respawn_clone().model is eng3.model


@pytest.mark.parametrize("quantize", [None, "int8", "bf16"])
def test_pulled_engine_serves_as_a_fresh_engine_over_the_center(quantize):
    """After one pull the engine's greedy tokens equal, token for token,
    a fresh engine's built from the center with the same quantization
    (int8: requantized into the engine's own codes and scales)."""
    ps, server = port_server(9)
    try:
        eng = engine(seed=1, quantize=quantize, max_len=6)
        eng.attach_ps("127.0.0.1", server.port, every=1)
        eng._pull_weights()
        assert eng.stats["reloads"] == 1
        fresh = ServingEngine(port_lm(9), num_slots=4, max_len=6,
                              quantize=quantize)
        prompts = [PROBE[i][0] + np.arange(2, dtype=np.int32) % V
                   for i in (1, 4, 7, 11)]
        eng._reload_every = 0  # no further pulls: compare one generation
        got, want = greedy(eng, prompts, 4), greedy(fresh, prompts, 4)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        if quantize == "int8":
            qs = [m for m in eng.model.modules()
                  if isinstance(m, QuantizedTensor)]
            fq = [m for m in fresh.model.modules()
                  if isinstance(m, QuantizedTensor)]
            assert qs and len(qs) == len(fq)
            for a, b in zip(qs, fq):
                assert torch.equal(a.q, b.q) and torch.equal(a.scale,
                                                             b.scale)
    finally:
        server.stop()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _addresses(eng):
    """The data pointers of every tensor the decode step reads: the
    weights, the KV pool, the device-resident slot state."""
    return [t.data_ptr() for t in (*eng.model.parameters(),
                                   *eng.model.buffers(),
                                   *_tensors(eng.caches),
                                   eng._dev_tok, eng._dev_pos)]


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_pulls_keep_every_tensor_address(quantize):
    ps, server = port_server(9)
    try:
        eng = engine(seed=1, quantize=quantize)
        eng.attach_ps("127.0.0.1", server.port, every=1)
        before = _addresses(eng)
        for i in range(3):
            ps.handle_commit({"delta": [np.full_like(w, 0.01)
                                        for w in ps.center],
                              "worker_id": 0, "clock": i})
            greedy(eng, [PROBE[i]])
        assert eng.stats["reloads"] == 3
        assert eng.stats["center_generation"] == 3
        assert _addresses(eng) == before
    finally:
        server.stop()


def test_a_pull_leaves_the_callers_model_and_a_clone_untouched():
    """An attached engine owns its weights: the caller's model and a
    clone taken before the pull keep theirs, bit for bit."""
    ps, server = port_server(9)
    try:
        f = port_lm(1)
        caller = [w.copy() for w in f.get_weights()]
        plain = ServingEngine(f, num_slots=2, max_len=3)
        assert plain.model is f.model  # never attached: shared, as before
        eng = ServingEngine(f, num_slots=2, max_len=3)
        eng.attach_ps("127.0.0.1", server.port, every=1)
        assert eng.model is not f.model
        clone = eng.respawn_clone()
        cloned = weights(clone)
        eng._pull_weights()
        assert eng.stats["reloads"] == 1
        for a, b in zip(weights(eng), ps.center):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(f.get_weights(), caller):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(weights(clone), cloned):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(weights(plain), caller):
            np.testing.assert_array_equal(a, b)
    finally:
        server.stop()


def test_pull_cadence_follows_every():
    """A pull after every ``every``-th decode step, as the JAX engine."""
    ps, server = port_server(9)
    try:
        eng = engine(seed=1, max_len=6, num_slots=1)
        eng.attach_ps("127.0.0.1", server.port, every=2)
        greedy(eng, [PROBE[2]], 5)
        steps = eng.stats["decode_steps"]
        assert steps >= 4
        assert eng.stats["reloads"] == steps // 2
    finally:
        server.stop()


def test_a_center_of_another_architecture_fails_the_pull_whole():
    ps, server = port_server(9, mlp_dim=16)
    try:
        eng = engine(seed=1)
        frozen = weights(eng)
        eng.attach_ps("127.0.0.1", server.port, every=1)
        eng._pull_weights()
        assert eng.stats["reload_failures"] == 1
        assert eng.stats["reloads"] == 0
        for a, b in zip(weights(eng), frozen):
            np.testing.assert_array_equal(a, b)
    finally:
        server.stop()


def test_detach_waits_for_the_pull_in_flight_and_ends_pulling():
    """``detach_ps`` returns only once no pull is in flight (it takes the
    pull's lock), closes the reload socket, and a later step pulls
    nothing: the engine serves the last center it pulled."""
    ps, server = port_server(9)
    try:
        eng = engine(seed=1)
        eng.attach_ps("127.0.0.1", server.port, every=1)
        eng._pull_weights()
        assert eng.stats["reloads"] == 1 and eng._reload_sock is not None
        pulled = weights(eng)
        eng._reload_lock.acquire()  # a pull in flight
        done = threading.Event()
        t = threading.Thread(target=lambda: (eng.detach_ps(), done.set()))
        t.start()
        assert not done.wait(0.2) and eng._ps_addr is not None
        eng._reload_lock.release()
        t.join(timeout=30.0)
        assert done.is_set() and eng._ps_addr is None
        assert eng._reload_sock is None and eng._reload_every == 0
    finally:
        server.stop()
    greedy(eng, [PROBE[2]])
    eng._pull_weights()
    assert eng.stats["reloads"] == 1 and eng.stats["reload_failures"] == 0
    for a, b in zip(weights(eng), pulled):
        np.testing.assert_array_equal(a, b)
    assert eng.respawn_clone()._ps_addr is None


class _DetachOnCadenceRead(ServingEngine):
    """An engine whose cadence read, once armed, lets ``detach_ps`` run on
    another thread at that very moment (as far as the pull lock allows):
    the interleaving of a deployment detaching the engine while its
    scheduler ends a decode step."""

    armed = False

    @property
    def _reload_every(self):
        value = self._every
        if self.armed:
            self.armed = False
            self.detacher = threading.Thread(target=self.detach_ps)
            self.detacher.start()
            self.detacher.join(timeout=0.3)
        return value

    @_reload_every.setter
    def _reload_every(self, value):
        self._every = value


def test_detach_racing_the_steps_cadence_read_leaves_the_step_whole():
    """The step reads the pull cadence once, under the pull lock, so a
    ``detach_ps`` that lands on that read waits for it instead of zeroing
    the cadence between two reads of it (a division by zero in the
    scheduler thread)."""
    eng = _DetachOnCadenceRead(port_lm(1), num_slots=1, max_len=6)
    eng.attach_ps("127.0.0.1", dead_port(), every=1, retry_policy=ONE_SHOT)
    pulls = []
    eng._pull_locked = lambda: pulls.append(eng._ps_addr)
    h = eng.submit(PROBE[2], 4)
    while eng.stats["decode_steps"] == 0:
        eng.step()
    assert len(pulls) == 1 and not h.done
    eng.armed = True                  # the next step decodes, then reads
    eng.step()
    eng.detacher.join(timeout=30.0)
    assert not eng.detacher.is_alive()
    # the step pulled before the detach or not at all, never from half
    # an attachment
    assert len(pulls) in (1, 2) and None not in pulls
    assert eng._ps_addr is None and eng._reload_every == 0
    pulled = len(pulls)
    eng.run_until_idle()
    assert len(pulls) == pulled and h.done


def test_a_port_engine_pulls_from_a_jax_server():
    """The JAX socket PS answers the port engine's 'p': the engine then
    serves the JAX center's greedy tokens, as the JAX engine does."""
    jc = jax_fitted(9)
    ps = jps.DeltaParameterServer(jserialize(jc.model, jc.params))
    server = jps.make_socket_server(ps)
    server.start()
    try:
        eng = engine(seed=1)
        eng.attach_ps("127.0.0.1", server.port, every=1)
        eng._pull_weights()
        assert eng.stats["reloads"] == 1
        assert eng.stats["center_generation"] == 0
        eng._reload_every = 0
        got = greedy(eng, list(PROBE[:6]))
        jeng = JEngine((jc.model, jc.params), num_slots=4, max_len=3)
        jh = [jeng.submit(p, 1) for p in PROBE[:6]]
        jeng.run_until_idle()
        for a, h in zip(got, jh):
            np.testing.assert_array_equal(a, np.asarray(h.result()))
    finally:
        server.stop()


def test_a_jax_engine_pulls_from_the_port_server():
    ps, server = port_server(9)
    try:
        j1 = jax_fitted(1)
        jeng = JEngine((j1.model, j1.params), num_slots=4, max_len=3)
        jeng.attach_ps("127.0.0.1", server.port, every=1)
        jeng._pull_weights()
        assert jeng.stats["reloads"] == 1
        assert jeng.stats["center_generation"] == 0
        for a, b in zip(jeng.model.get_weights(jeng.params), ps.center):
            np.testing.assert_array_equal(np.asarray(a), b)
    finally:
        server.stop()


def test_clones_taken_during_pulls_are_never_torn():
    """One thread pulls ever newer centers (each commit adds 1 to every
    weight) while another clones the engine, with a shortened switch
    interval: every clone holds one whole center, never leaves of two."""
    import sys
    import threading
    ps, server = port_server(9)
    base = [w.copy() for w in ps.center]
    eng = engine(seed=1)
    eng.attach_ps("127.0.0.1", server.port, every=1)
    eng._pull_weights()  # from here on the engine holds a center
    clones, stop = [], threading.Event()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def pull():
            for i in range(30):
                ps.handle_commit({"delta": [np.ones_like(w)
                                            for w in ps.center],
                                  "worker_id": 0, "clock": i})
                eng._pull_weights()
            stop.set()

        def clone():
            while not stop.is_set():
                clones.append(weights(eng.respawn_clone()))

        threads = [threading.Thread(target=pull),
                   threading.Thread(target=clone)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
    finally:
        sys.setswitchinterval(interval)
        server.stop()
    assert not any(t.is_alive() for t in threads)
    assert eng.stats["reloads"] == 31 and clones
    for ws in clones:
        offsets = [float(np.mean(w - b)) for w, b in zip(ws, base)]
        assert max(offsets) - min(offsets) < 0.5, offsets
