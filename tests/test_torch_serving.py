"""The port's continuous-batching ``ServingEngine`` (``serving.py``) and
its substrate against the JAX package.

The tiny LM of the JAX serving tests (vocab 17, seq 32, d_model 16, 2
heads, 2 layers, mlp 32, f32) gets one numpy-drawn weight set, loaded
into both packages.  Greedy outputs of the port's engine must equal the
JAX engine's and both packages' ``generate``, token for token; sampled
outputs equal the port's own ``generate`` bit for bit under the same key
(the determinism contract: both draw through ``core.decode``'s one
counter-based rule, whose bits are not JAX's threefry key schedule).
Also here: the engine's slot lifecycle, backpressure, the background
thread, the engine route of ``ModelPredictor``, the per-row decode
substrate, the batched samplers and the draw rule, the in-place cache
write, the knobs still to port and the validation of the speculation
and quantization knobs, the copied ``RetryPolicy``, and C3
(``Sequential.add`` and ``FittedModel.set_weights``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from distkeras_tpu import resilience as jres
from distkeras_tpu.core import decode as jdec
from distkeras_tpu.core.layers import Dense as JDense
from distkeras_tpu.core.model import FittedModel as JFitted
from distkeras_tpu.core.model import Sequential as JSequential
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models.zoo import transformer_lm as jax_lm
from distkeras_tpu.predictors import ModelPredictor as JPredictor
from distkeras_tpu.serving import ServingEngine as JEngine
from distkeras_tpu_torch import (Dataset, Dense, FittedModel,
                                 ModelPredictor, Sequential, transformer_lm)
from distkeras_tpu_torch import resilience as pres
from distkeras_tpu_torch.core import decode as pdec
from distkeras_tpu_torch.serving import QueueFull, ServingEngine

torch.set_num_threads(1)

VOCAB = 17
CFG = dict(vocab_size=VOCAB, seq_len=32, d_model=16, num_heads=2,
           num_layers=2, mlp_dim=32, compute_dtype="float32")
PROMPT = np.array([3, 4, 5, 6], np.int32)


def numpy_weights(weights, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(w.shape) / np.sqrt(w.shape[0])
             if w.ndim == 2 else 0.1 * rng.standard_normal(w.shape)
             + (w == 1.0)).astype(np.float32) for w in weights]


def both(seed=0, **kw):
    """(JAX FittedModel, port FittedModel) holding one numpy weight set."""
    jm = jax_lm(**CFG, **kw)
    params = jm.init(jax.random.PRNGKey(0), (32,))
    weights = numpy_weights(jm.get_weights(params), seed)
    pm = FittedModel(transformer_lm(**CFG, **kw, device="cpu"))
    return JFitted(jm, jm.set_weights(params, weights)), pm.set_weights(
        weights)


@pytest.fixture(scope="module")
def pair():
    return both()


@pytest.fixture(scope="module")
def fitted(pair):
    return pair[1]


def gen(fm, prompt, steps, **kw):
    """The port's generate of one prompt row, as numpy."""
    return fm.generate(np.asarray(prompt)[None], steps, **kw).numpy()[0]


def jgen(jf, prompt, steps, **kw):
    return np.asarray(jf.generate(np.asarray(prompt)[None], steps, **kw))[0]


# ---------------------------------------------------------------------------
# C3: Sequential.add and FittedModel.set_weights against the JAX package
# ---------------------------------------------------------------------------

def test_sequential_add_matches_jax():
    """A model built by ``add`` holds the JAX model's weights and gives
    its outputs; ``add`` returns the model."""
    jm = JSequential(input_shape=(5,), compute_dtype="float32")
    assert jm.add(JDense(7, activation="relu")) is jm
    jm.add(JDense(3))
    params = jm.init(jax.random.PRNGKey(0))
    weights = numpy_weights(jm.get_weights(params), 1)
    pm = Sequential(compute_dtype="float32", device="cpu")
    assert pm.add(Dense(7, activation="relu")) is pm
    pm.add(Dense(3)).build((5,))
    pm.set_weights(weights)
    x = np.random.default_rng(2).standard_normal((4, 5)).astype(np.float32)
    want = np.asarray(jm.apply(jm.set_weights(params, weights), x))
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=1e-6, atol=1e-6)


def test_sequential_add_rebuilds_a_built_model():
    """On a model with its input shape, ``add`` rebuilds at once: the same
    parameters as the constructor given every layer."""
    grown = Sequential([Dense(4)], input_shape=(3,), device="cpu")
    grown.add(Dense(2))
    whole = Sequential([Dense(4), Dense(2)], input_shape=(3,), device="cpu")
    assert grown.output_shape == (2,)
    for a, b in zip(grown.get_weights(), whole.get_weights()):
        np.testing.assert_array_equal(a, b)


def test_fitted_model_set_weights_matches_jax():
    jf, _ = both()
    weights = numpy_weights(jf.get_weights(), 7)
    pm = FittedModel(transformer_lm(**CFG, device="cpu"))
    assert pm.set_weights(weights) is pm
    assert jf.set_weights(weights) is jf
    toks = np.random.default_rng(3).integers(0, VOCAB, (2, 9)).astype(
        np.int32)
    np.testing.assert_allclose(
        pm.model(torch.from_numpy(toks)).detach().numpy(),
        np.asarray(jf.model.apply(jf.params, toks)), atol=2e-5)


# ---------------------------------------------------------------------------
# the determinism contract
# ---------------------------------------------------------------------------

def test_lone_greedy_request_matches_jax_engine_and_both_generates(pair):
    jf, pf = pair
    eng = ServingEngine(pf, num_slots=3, max_len=24)
    h = eng.submit(PROMPT, 8)
    eng.run_until_idle()
    jeng = JEngine(jf, num_slots=3, max_len=24)
    jh = jeng.submit(PROMPT, 8)
    jeng.run_until_idle()
    want = gen(pf, PROMPT, 8, max_len=24)
    np.testing.assert_array_equal(want, jgen(jf, PROMPT, 8, max_len=24))
    np.testing.assert_array_equal(jh.result(), want)
    np.testing.assert_array_equal(h.result(), want)


@pytest.mark.parametrize("kw", [
    {"temperature": 0.7, "seed": 11},
    {"temperature": 0.7, "top_k": 5, "top_p": 0.9, "seed": 11},
])
def test_lone_sampled_request_bit_identical_to_generate(fitted, kw):
    eng = ServingEngine(fitted, num_slots=3, max_len=24)
    h = eng.submit(PROMPT, 8, **kw)
    eng.run_until_idle()
    gkw = dict(kw)
    gkw["rng"] = gkw.pop("seed")
    np.testing.assert_array_equal(h.result(),
                                  gen(fitted, PROMPT, 8, max_len=24, **gkw))


def test_eos_stopping_matches_generate(pair):
    jf, pf = pair
    greedy = gen(pf, PROMPT, 8, max_len=24)
    eos = int(greedy[len(PROMPT) + 2])  # a token greedy WILL emit
    eng = ServingEngine(pf, num_slots=2, max_len=24)
    h = eng.submit(PROMPT, 8, eos_id=eos, pad_id=1)
    eng.run_until_idle()
    want = gen(pf, PROMPT, 8, eos_id=eos, pad_id=1, max_len=24)
    np.testing.assert_array_equal(
        want, jgen(jf, PROMPT, 8, eos_id=eos, pad_id=1, max_len=24))
    np.testing.assert_array_equal(h.result(), want)
    assert h.finish == "eos"
    assert len(h.tokens) < 8  # retired early; result() pads to num_steps


def test_rolling_slots_bit_identical():
    jw, pw = both(seed=1, attention_window=6)
    eng = ServingEngine(pw, num_slots=2, max_len=24, rolling=True)
    long_p = np.arange(1, 8, dtype=np.int32) % VOCAB
    h1 = eng.submit(long_p, 10, temperature=0.6, seed=9)
    h2 = eng.submit(np.array([1, 2], np.int32), 6)
    eng.run_until_idle()
    np.testing.assert_array_equal(
        h1.result(), gen(pw, long_p, 10, temperature=0.6, rng=9,
                         rolling=True, max_len=24))
    want = jgen(jw, [1, 2], 6, rolling=True, max_len=24)
    np.testing.assert_array_equal(want, gen(pw, [1, 2], 6, rolling=True,
                                            max_len=24))
    np.testing.assert_array_equal(h2.result(), want)
    # the pool really is a ring: W slots per block, not max_len
    assert eng.caches[2]["k"].shape[1] == 6


# ---------------------------------------------------------------------------
# slot lifecycle: admission → prefill → decode → retirement → reuse
# ---------------------------------------------------------------------------

def test_mixed_length_batch_backfills_mid_run(fitted):
    """2 slots, 3 requests: the short one retires first and the queued
    third back-fills its slot while the long one is still decoding."""
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    long_h = eng.submit(np.array([1, 2, 3], np.int32), 14)
    short_h = eng.submit(np.array([4, 5], np.int32), 3)
    queued_h = eng.submit(np.array([6, 7, 8, 9], np.int32), 5)
    assert eng.queue_depth == 3 and not eng._active.any()
    eng.run_until_idle()
    for h in (long_h, short_h, queued_h):
        assert h.finish == "length"
        np.testing.assert_array_equal(
            h.result(), gen(fitted, h.prompt, h.num_steps, max_len=24))
    assert queued_h.slot == short_h.slot
    assert queued_h.started_at < long_h.finished_at
    assert all(n >= 1 for n in eng.stats["slot_requests"])
    assert eng.stats["slot_requests"][short_h.slot] == 2
    assert eng.stats["requests_completed"] == 3
    assert eng.slot_occupancy > 0.5


def test_many_requests_zero_lost_every_slot_reused(fitted):
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    rng = np.random.default_rng(0)
    handles = []
    for i in range(7):
        p_len = int(rng.integers(1, 6))
        steps = int(rng.integers(1, 8))
        prompt = rng.integers(0, VOCAB, p_len).astype(np.int32)
        handles.append(eng.submit(prompt, steps, temperature=0.5,
                                  seed=100 + i))
    eng.run_until_idle()
    assert eng.stats["requests_completed"] == 7  # zero lost
    assert all(n >= 2 for n in eng.stats["slot_requests"])  # all reused
    for h in handles:
        np.testing.assert_array_equal(
            h.result(), gen(fitted, h.prompt, h.num_steps, temperature=0.5,
                            rng=h.key, max_len=24))


def test_retired_slot_state_is_cleared(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    h = eng.submit(PROMPT, 3, temperature=0.9, top_k=3, seed=5)
    eng.run_until_idle()
    assert h.done and eng._handles[0] is None
    assert not eng._active.any() and not eng._dev_act.any()
    assert eng._temp[0] == 0.0 and eng._topk[0] == 0 and eng._topp[0] == 0.0
    assert eng._free == [0]
    # a greedy follow-up through the same slot is unpolluted by the
    # previous occupant's sampling parameters
    h2 = eng.submit(PROMPT, 4)
    eng.run_until_idle()
    np.testing.assert_array_equal(h2.result(),
                                  gen(fitted, PROMPT, 4, max_len=24))


def test_num_steps_zero_completes_without_slot(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    h = eng.submit(PROMPT, 0)
    assert h.done and h.finish == "empty"
    np.testing.assert_array_equal(h.result(), PROMPT)
    assert eng.queue_depth == 0


def test_streaming_chunks_and_listener(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    h = eng.submit(PROMPT, 6)
    fired = []
    h.set_listener(lambda: fired.append(1))
    eng.step()
    eng.step()
    chunk, done = h.next_chunk(timeout=1.0)
    assert not done and len(chunk) >= 1
    eng.run_until_idle()
    rest, done = h.next_chunk(timeout=1.0)
    assert done
    np.testing.assert_array_equal(np.concatenate([chunk, rest]),
                                  h.result()[len(PROMPT):])
    assert len(fired) >= 6  # one per token, plus the retirement
    assert h.ttft_s is not None and h.latency_s >= h.ttft_s


# ---------------------------------------------------------------------------
# admission queue + backpressure
# ---------------------------------------------------------------------------

def test_queue_backpressure_sheds(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24, queue_capacity=2)
    eng.submit(PROMPT, 4)
    eng.submit(PROMPT, 4)
    with pytest.raises(QueueFull):
        eng.submit(PROMPT, 4, block=False)
    with pytest.raises(QueueFull):
        eng.submit(PROMPT, 4, timeout=0.05)  # blocking, bounded wait
    assert eng.stats["requests_rejected"] == 2
    eng.run_until_idle()
    assert eng.stats["requests_completed"] == 2


def test_blocking_submit_unblocks_when_queue_drains(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=24, queue_capacity=1)
    eng.submit(PROMPT, 2)
    results = []

    def producer():
        results.append(eng.submit(PROMPT, 2, timeout=10.0))

    t = threading.Thread(target=producer)
    t.start()
    # wait for the state the test needs: the producer blocked on capacity
    while eng.stats["requests_submitted"] < 2:
        t.join(timeout=0.01)
    eng.run_until_idle()   # drains the queue, freeing capacity
    t.join(timeout=10.0)
    assert not t.is_alive() and len(results) == 1
    eng.run_until_idle()
    assert results[0].done


def test_submit_validation(fitted):
    eng = ServingEngine(fitted, num_slots=1, max_len=16)
    with pytest.raises(ValueError, match="exceeds the engine's max_len"):
        eng.submit(np.arange(10, dtype=np.int32) % VOCAB, 10)
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(PROMPT[None], 4)
    with pytest.raises(ValueError, match="top_k"):
        eng.submit(PROMPT, 4, temperature=0.5, top_k=0)
    with pytest.raises(ValueError, match="vocabulary"):
        eng.submit(PROMPT, 4, eos_id=VOCAB + 3)
    with pytest.raises(ValueError, match="max_len"):
        ServingEngine(fitted, num_slots=1, max_len=64)  # > positional range


def test_background_thread_drives_requests(fitted):
    with ServingEngine(fitted, num_slots=2, max_len=24) as eng:
        h = eng.submit(PROMPT, 6)
        assert h.wait(timeout=30.0)
    np.testing.assert_array_equal(h.result(),
                                  gen(fitted, PROMPT, 6, max_len=24))
    assert eng._thread is None


# ---------------------------------------------------------------------------
# the knobs of later items
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob", [
    {"role": "prefill"}, {"tenants": []},
])
def test_later_knobs_raise_their_item(pair, knob):
    """The roles are taken now and validate as the JAX engine's do: a
    prefill or decode role needs the paged arena without a rolling pool
    (``ValueError``, message for message), a bad role name raises, and a
    paged engine takes the role; tenants are taken too (an empty policy
    list is an engine without tenants)."""
    jf, fitted = pair
    if "tenants" in knob:
        eng = ServingEngine(fitted, num_slots=1, max_len=24, **knob)
        assert eng._tenants == {} and eng.stats["tenants"] == {}
        h = eng.submit(PROMPT, 3)
        eng.run_until_idle()
        np.testing.assert_array_equal(h.result(),
                                      gen(fitted, PROMPT, 3, max_len=24))
        return
    wf = both(seed=2, attention_window=6)
    for engine, f, w in ((ServingEngine, fitted, wf[1]),
                         (JEngine, jf, wf[0])):
        with pytest.raises(ValueError, match="needs the paged block arena"):
            engine(f, num_slots=1, max_len=24, **knob)
        with pytest.raises(ValueError, match="rolling pools"):
            engine(w, num_slots=1, max_len=24, paged=True, rolling=True,
                   **knob)
        with pytest.raises(ValueError, match="role must be"):
            engine(f, num_slots=1, max_len=24, paged=True, role="both")
        eng = engine(f, num_slots=1, max_len=24, paged=True, **knob)
        assert eng.role == knob["role"]


@pytest.mark.parametrize("knob,match", [
    ({"spec_len": 0, "draft": True}, "spec_len"),
    ({"quantize": "fp4"}, "quantize"),
    ({"kv_dtype": "int4"}, "kv_dtype"),
    ({"kv_dtype": "int8", "paged": True, "prefill_mode": "eager"},
     "bit-exactness reference"),
])
def test_spec_and_quant_knobs_validate_as_jax(pair, knob, match):
    """The speculation and quantization knobs are taken now (ROADMAP
    queue A item 4, its speculation slice); their bad values raise the
    JAX engine's ValueErrors, message for message."""
    jf, pf = pair
    knob = dict(knob)
    draft = knob.pop("draft", False)
    for engine, f in ((ServingEngine, pf), (JEngine, jf)):
        kw = dict(knob, spec_draft=f) if draft else knob
        with pytest.raises(ValueError, match=match):
            engine(f, num_slots=1, max_len=24, **kw)


def test_spec_draft_tenant_and_attach_ps_raise_their_items(pair):
    jf, fitted = pair
    for engine, f in ((ServingEngine, fitted), (JEngine, jf)):
        with pytest.raises(ValueError, match="does not compose with "
                                             "spec_draft"):
            engine(f, num_slots=1, max_len=24, spec_draft=f, paged=True,
                   role="decode")
    eng = ServingEngine(fitted, num_slots=1, max_len=24, spec_draft=fitted,
                        spec_len=2, quantize="int8", kv_dtype="int8")
    assert eng._draft_model is not None and eng.spec_len == 2
    # tenants are taken now: an unregistered one is booked on its own
    h = eng.submit(PROMPT, 2, tenant="gold", priority=1)
    assert (h.tenant, h.priority) == ("gold", 1)
    assert eng.stats["tenants"]["gold"]["submitted"] == 1
    eng.run_until_idle()
    assert eng.stats["tenants"]["gold"]["completed"] == 1
    # attach_ps is taken now (hot reload: tests/test_torch_attach_ps.py):
    # it records the attachment, as the JAX engine does, and the engine
    # takes a private copy of its weights
    eng.attach_ps("127.0.0.1", 1, every=2)
    assert eng._ps_addr == ("127.0.0.1", 1) and eng._reload_every == 2
    assert eng.stats["reloads"] == eng.stats["reload_failures"] == 0


# ---------------------------------------------------------------------------
# engine-backed ModelPredictor route
# ---------------------------------------------------------------------------

def test_model_predictor_engine_route_matches_jax(pair):
    jf, pf = pair
    prompts = np.stack([PROMPT, PROMPT[::-1].copy(), (PROMPT + 1) % VOCAB])
    eng = ServingEngine(pf, num_slots=2, max_len=24)
    out = ModelPredictor(pf, engine=eng, num_steps=5).predict(
        Dataset({"features": prompts}))["prediction"]
    want = JPredictor(jf, engine=JEngine(jf, num_slots=2, max_len=24),
                      num_steps=5).predict(
        JDataset({"features": prompts}))["prediction"]
    assert out.shape == (3, len(PROMPT) + 5)
    np.testing.assert_array_equal(out, want)
    assert eng._thread is None  # the predictor stopped the thread it started


def test_model_predictor_engine_route_sampled(fitted):
    prompts = np.stack([PROMPT, (PROMPT + 2) % VOCAB])
    eng = ServingEngine(fitted, num_slots=2, max_len=24)
    out = ModelPredictor(fitted, engine=eng, num_steps=5,
                         generate_kwargs={"temperature": 0.6, "seed": 3}
                         ).predict(Dataset({"features": prompts}))
    for row, prompt in zip(out["prediction"], prompts):
        np.testing.assert_array_equal(
            row, gen(fitted, prompt, 5, temperature=0.6, rng=3, max_len=24))


def test_model_predictor_default_path_and_engine_checks(fitted):
    prompts = np.stack([PROMPT, (PROMPT + 2) % VOCAB])
    out = ModelPredictor(fitted, device="cpu").predict(
        Dataset({"features": prompts}))["prediction"]
    np.testing.assert_array_equal(out, fitted.predict(prompts))
    eng = ServingEngine(fitted, num_slots=1, max_len=24)
    with pytest.raises(ValueError, match="num_steps"):
        ModelPredictor(fitted, engine=eng)
    with pytest.raises(ValueError, match="where its model lives"):
        ModelPredictor(fitted, engine=eng, num_steps=2, device="meta")


# ---------------------------------------------------------------------------
# per-row decode substrate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("positional", ["learned", "rope"])
def test_per_row_positions_match_scalar_decode(positional):
    jf, pf = both(seed=2, positional=positional)
    prompt = np.array([[3, 4, 5, 6], [7, 8, 9, 1]], np.int32)
    want = np.asarray(jf.generate(prompt, 6, max_len=16))
    np.testing.assert_array_equal(pf.generate(prompt, 6, max_len=16).numpy(),
                                  want)
    caches = pdec.init_cache(pf.model, 2, 16)
    logits, caches = pdec._forward(pf.model, caches,
                                   torch.from_numpy(prompt), 0)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    got = [tok]
    pos = torch.tensor([4, 4])   # per-row vector, equal values
    for i in range(5):
        lg, caches = pdec.decode_step(pf.model, caches, tok, pos + i)
        tok = torch.argmax(lg, -1).to(torch.int32)
        got.append(tok)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), want[:, 4:])


def test_per_row_multi_token_forward_matches_chain(fitted):
    """Per-row positions with L > 1: one forward over L tokens at each
    row's own offset gives the logits of L single-token per-row steps."""
    prompt = torch.tensor([[3, 4, 5], [9, 2, 7]], dtype=torch.int32)
    pre = pdec.init_cache(fitted.model, 2, 16)
    logits, pre = pdec._forward(fitted.model, pre, prompt, 0)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    pos = torch.tensor([3, 3])
    chain, toks = [], [tok]
    cc = [None if c is None else {n: t.clone() for n, t in c.items()}
          for c in pre]
    for i in range(3):
        lg, cc = pdec.decode_step(fitted.model, cc, toks[-1], pos + i)
        chain.append(lg)
        toks.append(torch.argmax(lg, -1).to(torch.int32))
    multi, _ = pdec._forward(fitted.model, pre, torch.stack(toks[:3], 1),
                             pos)
    for i in range(3):
        np.testing.assert_allclose(multi[:, i].numpy(), chain[i].numpy(),
                                   rtol=2e-5, atol=2e-5)


def test_in_place_kv_write_equals_the_out_of_place_form():
    """The per-row cache write is in place now (the engine's pool is a
    static tensor): bit-identical to the former out-of-place form, a
    ``torch.where`` over the whole cache per written column, drops
    included (slots past either end), for dense and int8 caches."""
    rng = np.random.default_rng(4)
    slots = torch.tensor([[2, 3, 4], [-1, 0, 1], [5, 6, 7]])
    k = torch.from_numpy(rng.standard_normal((3, 3, 2, 8)).astype(
        np.float32))
    v = k * 2.0 - 1.0
    for cache in ({"k": torch.zeros(3, 5, 2, 8), "v": torch.ones(3, 5, 2, 8)},
                  pdec.init_cache(transformer_lm(**CFG, device="cpu"), 3, 5,
                                  kv_dtype="int8")[2]):
        entries = {"k": k, "v": v}
        if pdec._kv_quantized(cache):
            from distkeras_tpu_torch.core.quant import quantize_kv
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            entries = {"k": kq, "v": vq, "ks": ks, "vs": vs}
        want = {}
        ar = torch.arange(5)
        for name, cur in cache.items():
            new = entries[name].to(cur.dtype)
            for i in range(3):
                hit = (slots[:, i, None] == ar).reshape(
                    (3, 5) + (1,) * (cur.ndim - 2))
                cur = torch.where(hit, new[:, i, None], cur)
            want[name] = cur
        before = {n: t.data_ptr() for n, t in cache.items()}
        got = pdec._kv_write(cache, slots, k, v)
        assert got is cache
        for name in want:
            assert got[name].data_ptr() == before[name]
            assert torch.equal(got[name], want[name]), name


# ---------------------------------------------------------------------------
# the batched samplers and the one draw rule
# ---------------------------------------------------------------------------

def test_filter_logits_batched_matches_jax_and_the_scalar_filter():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, VOCAB)).astype(np.float32)
    logits[2, 3] = logits[2, 5]  # a tie
    top_k = np.array([0, 4, 4, 1, 0, 99], np.int32)
    top_p = np.array([0.0, 0.0, 0.9, 0.6, 1e-9, 1.0], np.float32)
    want = np.asarray(jdec.filter_logits_batched(jnp.asarray(logits),
                                                 top_k, top_p))
    got = pdec.filter_logits_batched(torch.from_numpy(logits),
                                     torch.from_numpy(top_k),
                                     torch.from_numpy(top_p))
    np.testing.assert_array_equal(got.numpy(), want)
    for r in range(6):
        one = pdec._filter_logits(torch.from_numpy(logits[r:r + 1]),
                                  int(top_k[r]) or None,
                                  float(top_p[r]) or None)
        np.testing.assert_array_equal(got[r:r + 1].numpy(), one.numpy())


def test_batched_sampler_matches_scalar_rows():
    """sample_logits_batched row for row == sample_logits with that row's
    scalar parameters and key (the engine's bit-identity substrate)."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((4, VOCAB)).astype(
        np.float32))
    keys = torch.tensor([pdec.rng_key(i) for i in range(4)])
    positions = torch.tensor([3, 9, 1, 7])
    temp = torch.tensor([0.0, 0.5, 0.7, 1.3])
    topk = torch.tensor([0, 4, 4, 0])
    topp = torch.tensor([0.0, 0.0, 0.9, 0.6])
    got = pdec.sample_logits_batched(logits, positions, temp, keys, topk,
                                     topp)
    assert got.dtype == torch.int32
    for r in range(4):
        want = pdec.sample_logits(logits[r:r + 1], int(positions[r]),
                                  float(temp[r]), r, int(topk[r]) or None,
                                  float(topp[r]) or None)
        assert int(got[r]) == int(want[0]), f"row {r}"


def test_threefry_matches_jax_block_function():
    """The draw rule's block cipher is JAX's Threefry-2x32, bit for bit."""
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    words = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint64).astype(
        np.uint32)
    want = np.asarray(jax_prng.threefry_2x32(
        jnp.asarray(key), jnp.asarray(words.reshape(-1)))).reshape(2, 64)
    got = pdec.threefry2x32(int(key[0]), int(key[1]),
                            torch.from_numpy(words[0].astype(np.int64)),
                            torch.from_numpy(words[1].astype(np.int64)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_draw_rule_counters_keys_and_uniforms():
    """Each (key, counter, row, index) draws its own bits; the key words
    of an int seed, a generator and the words themselves agree; the
    uniforms lie strictly inside (0, 1) and are roughly uniform."""
    assert pdec.rng_key(7) == pdec.rng_key(torch.Generator().manual_seed(7))
    assert pdec.rng_key(np.array(pdec.rng_key(2 ** 40 + 3),
                                 np.uint32)) == (256, 3)
    assert pdec.rng_key(-1) == (2 ** 32 - 1, 2 ** 32 - 1)
    keys = pdec._key_rows(5, 3, "cpu")
    base = pdec.random_bits(keys, torch.tensor([4, 4, 4]),
                            torch.tensor([0, 1, 2]), 1000)
    assert len({tuple(r) for r in base.tolist()}) == 3
    again = pdec.random_bits(keys, torch.tensor([4, 4, 5]),
                             torch.tensor([0, 1, 2]), 1000)
    assert torch.equal(again[:2], base[:2]) and not torch.equal(again[2],
                                                                base[2])
    u = pdec._uniform(keys, torch.tensor([0, 1, 2]), torch.zeros(3), 20000)
    assert bool((u > 0).all() and (u < 1).all())
    counts = torch.histc(u, bins=10, min=0.0, max=1.0) / u.numel()
    assert float((counts - 0.1).abs().max()) < 0.01


def test_sampled_draws_follow_the_warped_distribution():
    """Many independent keys at one position: the drawn tokens' marginal
    is softmax(filtered logits / T) (total variation 0.03 at 8192 draws
    over a vocab of 17; a biased rule moves it by far more)."""
    rng = np.random.default_rng(6)
    row = rng.standard_normal(VOCAB).astype(np.float32)
    n = 8192
    logits = torch.from_numpy(np.tile(row, (n, 1)))
    keys = torch.stack([torch.arange(n), torch.full((n,), 99)], 1)
    full = torch.full((n,), 0.8)
    drawn = pdec.sample_logits_batched(logits, torch.full((n,), 5), full,
                                       keys, torch.full((n,), 6),
                                       torch.zeros(n))
    warped = pdec._filter_logits(torch.from_numpy(row)[None] / 0.8, 6, None)
    p = torch.softmax(warped, -1)[0].numpy()
    emp = np.bincount(drawn.numpy(), minlength=VOCAB) / n
    assert 0.5 * np.abs(emp - p).sum() < 0.03
    assert (emp[p == 0] == 0).all()


# ---------------------------------------------------------------------------
# the copied RetryPolicy
# ---------------------------------------------------------------------------

def test_retry_policy_copy_matches_jax():
    kw = dict(attempts=5, backoff=0.01, max_backoff=0.05, jitter=0.5,
              seed=3)
    assert list(pres.RetryPolicy(**kw).delays()) == list(
        jres.RetryPolicy(**kw).delays())
    from distkeras_tpu_torch.serving import DEFAULT_RELOAD_POLICY
    from distkeras_tpu.serving import DEFAULT_RELOAD_POLICY as JPOLICY
    assert dataclasses_fields(DEFAULT_RELOAD_POLICY) == dataclasses_fields(
        JPOLICY)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("down")
        return "up"

    fast = pres.RetryPolicy(attempts=4, backoff=0.0, jitter=0.0)
    assert fast.call(flaky, retry_on=(ConnectionError,)) == "up"
    with pytest.raises(ValueError, match="bound"):
        pres.RetryPolicy(attempts=None)
    calls.clear()
    with pytest.raises(ConnectionError):
        fast.replace(attempts=1).call(flaky, retry_on=(ConnectionError,))
    assert len(calls) == 1


def dataclasses_fields(policy):
    import dataclasses
    return {f.name: getattr(policy, f.name)
            for f in dataclasses.fields(policy)}
