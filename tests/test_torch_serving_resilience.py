"""Failure semantics of the port's ``ServingEngine``: deadlines,
cancellation, graceful drain, a crashed or wedged loop, respawn — the
engine-only cases of the JAX package's ``tests/test_serving_resilience.py``
(the wire server's cases are in ``tests/test_torch_serving_wire.py`` and
``tests/test_torch_serving_chaos.py``, the engine supervisor's in
``tests/test_torch_supervisors.py``).

Every request retired early returns its slot to the pool within one
scheduler iteration, no handle ever blocks forever, and the requests
left untouched stay bit-identical to the port's ``generate``.  The tests
wait for the state they assert (a slot taken, a thread blocked), never
for a fixed time, except where a deadline is the subject.
"""

import threading
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import FittedModel, transformer_lm
from distkeras_tpu_torch.serving import (Draining, EngineDead, QueueFull,
                                         ServingEngine)

torch.set_num_threads(1)

VOCAB = 17
PROMPT = np.array([3, 4, 5, 6], np.int32)
OTHER = np.array([7, 8, 9], np.int32)
LONG_PROMPT = (np.arange(1, 13, dtype=np.int32) * 3) % VOCAB  # 12 tokens


@pytest.fixture(scope="module")
def fitted():
    model = transformer_lm(vocab_size=VOCAB, seq_len=32, d_model=16,
                           num_heads=2, num_layers=2, mlp_dim=32,
                           compute_dtype="float32", device="cpu")
    rng = np.random.default_rng(0)
    weights = [(rng.standard_normal(w.shape) / np.sqrt(w.shape[0])
                if w.ndim == 2 else 0.1 * rng.standard_normal(w.shape)
                + (w == 1.0)).astype(np.float32)
               for w in model.get_weights()]
    return FittedModel(model).set_weights(weights)


def _want(fitted, prompt, steps, **kw):
    seed = kw.pop("seed", None)
    if seed is not None:
        kw["rng"] = seed
    return fitted.generate(prompt[None], steps, max_len=24,
                           **kw).numpy()[0]


def _wedge(engine):
    """Wedge an engine's decode step on an Event (released by the returned
    callable — always call it in teardown)."""
    ev = threading.Event()
    engine._decode_once = lambda: ev.wait(120.0)
    return ev.set


def _wait_for(pred, timeout=10.0, interval=0.005):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(interval)
    return True


def _assert_slots_reclaimed(engine):
    assert not engine._active.any()
    assert sorted(engine._free) == list(range(engine.num_slots))
    assert all(h is None for h in engine._handles)


def _balanced(engine):
    s = engine.stats
    return (s["requests_submitted"]
            == s["requests_completed"] + s["requests_failed"]
            + s["requests_rejected"])


# ---------------------------------------------------------------------------
# per-request deadlines
# ---------------------------------------------------------------------------

def test_deadline_queued_shed_before_prefill(fitted):
    """A queued request whose deadline expires is retired WITHOUT ever
    taking a slot; the running request is untouched."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    running = eng.submit(PROMPT, 12)
    queued = eng.submit(OTHER, 5, deadline_s=0.01)
    eng.step()          # prefills `running` only
    _wait_for(lambda: queued._expired(time.perf_counter()))
    eng.run_until_idle()
    assert queued.finish == "deadline"
    assert queued.slot is None and queued.started_at is None
    assert running.finish == "length"
    np.testing.assert_array_equal(running.result(),
                                  _want(fitted, PROMPT, 12))
    row = queued.result()  # a generate-shaped (all-pad) row
    assert row.shape == (len(OTHER) + 5,)
    np.testing.assert_array_equal(row[:len(OTHER)], OTHER)
    assert eng.stats["requests_expired"] == 1
    assert not eng.stats["slot_reclaim_ms"]  # it never held a slot
    _assert_slots_reclaimed(eng)


def test_deadline_expires_mid_run_frees_slot(fitted):
    """A running request past its deadline is retired mid-run — partial
    tokens kept, slot freed at once — while a concurrent request stays
    bit-identical to generate."""
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    doomed = eng.submit(PROMPT, 16, deadline_s=0.3)
    healthy = eng.submit(OTHER, 10, temperature=0.6, seed=5)
    eng.step()
    eng.step()  # both prefilled + decoding
    assert doomed.tokens and doomed.finish is None
    _wait_for(lambda: doomed._expired(time.perf_counter()))
    eng.run_until_idle()
    assert doomed.finish == "deadline"
    assert 1 <= len(doomed.tokens) < 16  # partial, padded by result()
    assert healthy.finish == "length"
    np.testing.assert_array_equal(
        healthy.result(), _want(fitted, OTHER, 10, temperature=0.6, seed=5))
    assert eng.stats["requests_expired"] == 1
    assert len(eng.stats["slot_reclaim_ms"]) == 1
    _assert_slots_reclaimed(eng)


@pytest.mark.parametrize("how", ["cancel", "deadline"])
def test_retire_mid_chunked_prefill_frees_slot(fitted, how):
    """A slot claimed but still prefilling chunk by chunk: cancel or
    deadline frees it before its first token, and the next occupant is
    unpolluted."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24, prefill_chunk=4)
    h = eng.submit(LONG_PROMPT, 4,
                   deadline_s=0.3 if how == "deadline" else None)
    eng.step()  # admission + first chunk: claimed, not yet decoding
    assert eng._prefilling and not eng._active.any() and not h.done
    if how == "cancel":
        eng.cancel(h)
    else:
        _wait_for(lambda: h._expired(time.perf_counter()))
    eng.step()
    assert h.finish == how and not h.tokens
    key = "requests_cancelled" if how == "cancel" else "requests_expired"
    assert eng.stats[key] == 1
    assert len(eng.stats["slot_reclaim_ms"]) == 1  # it held a KV slot
    _assert_slots_reclaimed(eng)
    h2 = eng.submit(PROMPT, 3)
    eng.run_until_idle()
    np.testing.assert_array_equal(h2.result(), _want(fitted, PROMPT, 3))


def test_engine_wide_default_deadline(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24,
                        default_deadline_s=0.02)
    h = eng.submit(PROMPT, 16)
    assert h.deadline is not None
    _wait_for(lambda: h._expired(time.perf_counter()))
    eng.run_until_idle()
    assert h.finish == "deadline"
    # an explicit per-request deadline overrides the default
    h2 = eng.submit(PROMPT, 4, deadline_s=30.0)
    eng.run_until_idle()
    assert h2.finish == "length"


def test_deadline_validation(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    with pytest.raises(ValueError, match="deadline_s"):
        eng.submit(PROMPT, 4, deadline_s=0.0)
    with pytest.raises(ValueError, match="default_deadline_s"):
        ServingEngine(fitted, num_slots=1, max_len=24,
                      default_deadline_s=-1.0)


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["bucketed", "eager"])
def test_cancel_queued_and_running(fitted, mode):
    eng = ServingEngine(fitted, num_slots=1, max_len=24, prefill_mode=mode)
    running = eng.submit(PROMPT, 16)
    queued = eng.submit(OTHER, 8)
    eng.step()  # prefill `running`
    assert eng.cancel(queued)
    eng.step()
    assert queued.finish == "cancel" and queued.slot is None
    assert eng.cancel(running)
    eng.step()  # the reap retires it before any further decode
    assert running.finish == "cancel"
    assert not eng.cancel(running)  # already finished
    assert eng.stats["requests_cancelled"] == 2
    # only the RUNNING cancel samples slot_reclaim_ms
    assert len(eng.stats["slot_reclaim_ms"]) == 1
    _assert_slots_reclaimed(eng)
    assert _balanced(eng)


# ---------------------------------------------------------------------------
# graceful drain
# ---------------------------------------------------------------------------

def test_drain_finishes_inflight_then_stops(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24).start()
    h1 = eng.submit(PROMPT, 8)
    h2 = eng.submit(OTHER, 5)  # queued behind h1 on the lone slot
    assert eng.drain(timeout=60.0) is True
    assert h1.finish == "length" and h2.finish == "length"
    np.testing.assert_array_equal(h1.result(), _want(fitted, PROMPT, 8))
    np.testing.assert_array_equal(h2.result(), _want(fitted, OTHER, 5))
    with pytest.raises(Draining):
        eng.submit(PROMPT, 4)
    assert eng._thread is None  # stopped
    assert eng.load()["draining"]
    _assert_slots_reclaimed(eng)


def test_drain_inline_engine(fitted):
    """An engine never start()ed is driven to idle by drain itself."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    h = eng.submit(PROMPT, 6)
    assert eng.drain(timeout=60.0) is True
    assert h.finish == "length"


def test_drain_timeout_fails_leftovers_typed(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    h = eng.submit(PROMPT, 8)
    release = _wedge(eng)
    try:
        eng.start()
        assert _wait_for(lambda: eng._active.any())
        t0 = time.monotonic()
        assert eng.drain(timeout=0.2) is False
        assert time.monotonic() - t0 < 8.0
        assert h.finish == "drain"
        with pytest.raises(EngineDead, match="drain timed out"):
            h.result()
    finally:
        release()


def test_drain_after_backpressure_shed_returns_clean(fitted):
    """A QueueFull shed is terminal (requests_rejected): drain after one
    still finishes the real work and returns True."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24, queue_capacity=1)
    h1 = eng.submit(PROMPT, 4)
    with pytest.raises(QueueFull):
        eng.submit(OTHER, 4, block=False)
    assert eng.drain(timeout=30.0) is True
    assert h1.finish == "length"
    assert eng.dead is None
    assert _balanced(eng)


def _blocked_submitter(eng):
    """A thread submitting into a full queue; returns (thread, errors) once
    it is inside the capacity wait."""
    errs = []
    submitted = eng.stats["requests_submitted"]

    def blocked():
        try:
            eng.submit(OTHER, 4, block=True, timeout=30.0)
        except BaseException as e:  # noqa: BLE001 — recorded for assert
            errs.append(e)

    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    assert _wait_for(lambda: eng.stats["requests_submitted"] > submitted)
    return t, errs


def test_blocked_submit_raises_typed_on_death(fitted):
    """A submitter blocked on a full queue is woken by _declare_dead: it
    raises the typed EngineDead instead of enqueueing into an engine no
    scheduler will run."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24, queue_capacity=1)
    eng.submit(PROMPT, 8)
    t, errs = _blocked_submitter(eng)
    eng._declare_dead(RuntimeError("chaos: killed while submitter waits"))
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert errs and isinstance(errs[0], EngineDead)
    assert _balanced(eng)


def test_blocked_submit_raises_draining_on_drain(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24, queue_capacity=1)
    h1 = eng.submit(PROMPT, 4)
    t, errs = _blocked_submitter(eng)
    assert eng.drain(timeout=30.0) is True
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert errs and isinstance(errs[0], Draining)
    assert h1.finish == "length"


# ---------------------------------------------------------------------------
# crashed / wedged engine: typed failure, no silent hangs
# ---------------------------------------------------------------------------

def test_inline_crash_fails_handles_and_raises(fitted):
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    h1 = eng.submit(PROMPT, 8)
    h2 = eng.submit(OTHER, 8)

    def boom():
        raise RuntimeError("chaos: decode crashed")

    eng._decode_once = boom
    with pytest.raises(RuntimeError, match="chaos"):
        eng.run_until_idle()
    for h in (h1, h2):
        assert h.finish == "error"
        with pytest.raises(EngineDead):
            h.result()
    with pytest.raises(EngineDead):
        eng.submit(PROMPT, 2)
    assert eng.dead is not None and eng.load()["dead"]
    assert eng.stats["requests_failed"] == 2


def test_background_crash_fails_handles_within_deadline(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    h = eng.submit(PROMPT, 8)

    def boom():
        raise RuntimeError("chaos: decode crashed")

    eng._decode_once = boom
    eng.start()
    assert h.wait(timeout=10.0), "handle must fail, not hang"
    with pytest.raises(EngineDead, match="chaos"):
        h.result()
    eng.stop()


def test_stop_join_timeout_surfaces_wedged_thread(fitted):
    """stop() on a wedged decode thread logs, fails in-flight handles
    typed, and returns — instead of pretending a clean stop."""
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    h = eng.submit(PROMPT, 8)
    release = _wedge(eng)
    try:
        eng.start()
        assert _wait_for(lambda: eng._active.any())
        t0 = time.monotonic()
        eng.stop(join_timeout=0.2)
        assert time.monotonic() - t0 < 8.0
        assert eng.dead is not None
        with pytest.raises(EngineDead, match="wedged"):
            h.result(timeout=5.0)
    finally:
        release()


def test_declare_dead_fails_queued_and_running(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    running = eng.submit(PROMPT, 8)
    queued = eng.submit(OTHER, 4)
    eng.step()
    eng.declare_dead("supervisor: heartbeat stale")
    for h in (running, queued):
        with pytest.raises(EngineDead, match="heartbeat stale"):
            h.result(timeout=1.0)
    assert eng.queue_depth == 0 and _balanced(eng)
    eng.declare_dead("a second cause")  # idempotent: the first one wins
    assert "heartbeat stale" in str(eng.dead)


# ---------------------------------------------------------------------------
# respawn and warmup
# ---------------------------------------------------------------------------

def test_respawn_clone_preserves_knobs_and_numerics(fitted):
    eng = ServingEngine(fitted, num_slots=3, max_len=24, queue_capacity=7,
                        prefills_per_step=2, default_deadline_s=9.0)
    eng.declare_dead("restart me")
    clone = eng.respawn_clone().warmup()
    assert clone.num_slots == 3 and clone.queue_capacity == 7
    assert clone.prefills_per_step == 2
    assert clone.default_deadline_s == 9.0 and clone.dead is None
    h = clone.submit(PROMPT, 8, temperature=0.7, top_k=5, seed=11)
    clone.run_until_idle()
    np.testing.assert_array_equal(
        h.result(),
        _want(fitted, PROMPT, 8, temperature=0.7, top_k=5, seed=11))


def test_warmup_refuses_active_engine_and_keeps_bit_identity(fitted):
    eng = ServingEngine(fitted, num_slots=2, max_len=24).warmup()
    h = eng.submit(PROMPT, 8, temperature=0.7, seed=11)
    eng.step()
    with pytest.raises(RuntimeError, match="active"):
        eng.warmup()
    eng.run_until_idle()
    np.testing.assert_array_equal(
        h.result(), _want(fitted, PROMPT, 8, temperature=0.7, seed=11))
