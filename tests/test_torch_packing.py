"""The port's sequence packing against the JAX package's.

``pack_documents``, ``packed_lm_labels`` and ``packing_efficiency`` give
JAX's arrays; ``dot_product_attention(segment_ids=)`` JAX's output within
1e-6; a packed document's logits equal its unpacked forward (RoPE and the
segment mask), and without the segment ids the documents leak; a learned
position table and ``impl="pallas"`` are refused with segments, and the
dispatcher never hands a packed batch to the flash kernels; packed
``SingleTrainer`` losses, validation and weights, and the packed SPMD
engine under ``ADAG``/``DOWNPOUR``/``AEASGD`` for N in {1, 2} workers,
agree with JAX's within 1e-5.  Small f32 RoPE ``transformer_lm``s from one
numpy weight set.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distkeras_tpu as jdk
from distkeras_tpu.core import optimizers as jopt
from distkeras_tpu.core.model import FittedModel as JaxFitted
from distkeras_tpu.data import packing as jpack
from distkeras_tpu.models.zoo import transformer_lm as jax_lm
import distkeras_tpu_torch as port
from distkeras_tpu_torch import Dataset, FittedModel, transformer_lm
from distkeras_tpu_torch.core import optimizers as popt
from distkeras_tpu_torch.core.train import (TrainState, make_epoch_runner,
                                            make_packed_epoch_runner,
                                            model_params)
from distkeras_tpu_torch.data import packing as ppack
from distkeras_tpu_torch.data.pipeline import round_stream
from distkeras_tpu_torch.parallel import SPMDEngine, get_mesh, shape_epoch_data

jatt = importlib.import_module("distkeras_tpu.ops.attention")
patt = importlib.import_module("distkeras_tpu_torch.ops.attention")
flash_mod = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

V, S = 32, 16
LM = dict(vocab_size=V, seq_len=S, d_model=16, num_heads=2, num_layers=2,
          mlp_dim=32, compute_dtype="float32", positional="rope")
MASKED = "sparse_categorical_crossentropy_masked_from_logits"
TOL = dict(rtol=1e-5, atol=1e-6)


def counting_docs(seed, count):
    """The JAX tests' x+1 corpus: variable-length counting runs over the
    token ids 1..31."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(count):
        n = int(rng.integers(4, 10))
        start = int(rng.integers(1, 31))
        docs.append([(start + i) % 31 + 1 for i in range(n)])
    return docs


def packed_corpus(seed, count):
    tokens, segs = ppack.pack_documents(counting_docs(seed, count), S)
    return {"features": tokens, "label": ppack.packed_lm_labels(tokens, segs),
            "segment_ids": segs}


def numpy_weights(jm, params, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(w.shape) / np.sqrt(w.shape[0])
             if w.ndim == 2 else 0.1 * rng.standard_normal(w.shape)
             + (w == 1.0)).astype(np.float32)
            for w in jm.get_weights(params)]


def both_fitted(seed=0, **over):
    cfg = {**LM, **over}
    jm = jax_lm(**cfg)
    params = jm.init(jax.random.PRNGKey(0))
    weights = numpy_weights(jm, params, seed)
    pm = transformer_lm(**cfg, device="cpu")
    pm.set_weights(weights)
    return JaxFitted(jm, jm.set_weights(params, weights)), FittedModel(pm)


# -- the packing functions -------------------------------------------------------

@pytest.mark.parametrize("seq_len", [6, 16, 32])
def test_packing_functions_match_jax(seq_len):
    rng = np.random.default_rng(seq_len)
    docs = [list(rng.integers(1, 9, int(rng.integers(0, 7))))
            for _ in range(300)]
    got = ppack.pack_documents(docs, seq_len, pad_value=7)
    want = jpack.pack_documents(docs, seq_len, pad_value=7)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ppack.packed_lm_labels(*got),
                                  jpack.packed_lm_labels(*want))
    assert ppack.packing_efficiency(got[1]) == jpack.packing_efficiency(
        want[1])
    with pytest.raises(ValueError, match="never truncates"):
        ppack.pack_documents([[1] * (seq_len + 1)], seq_len)
    assert port.data.pack_documents is ppack.pack_documents


# -- attention -----------------------------------------------------------------

@pytest.mark.parametrize("causal,window,hkv", [(True, None, 4),
                                               (True, 3, 2),
                                               (False, None, 1)])
def test_segment_attention_matches_jax(causal, window, hkv):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 12, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 12, hkv, 8)).astype(np.float32)
    v = rng.standard_normal((2, 12, hkv, 8)).astype(np.float32)
    seg = np.array([[1] * 5 + [2] * 4 + [0] * 3, [1] * 3 + [2] * 9])
    want = jatt.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                      causal=causal, window=window,
                                      segment_ids=jnp.asarray(seg))
    got = patt.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, window=window,
                                     segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # the dispatcher's plain route is the same function
    routed = patt.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            window=window, segment_ids=torch.from_numpy(seg))
    assert torch.equal(routed, got)


def test_packed_batches_never_reach_the_flash_kernels(monkeypatch):
    """Where the kernels would take the call (a CUDA self-attention), a
    packed batch still takes the plain path; impl="pallas" is refused."""
    def refuse(*a, **kw):
        raise AssertionError("a packed batch reached the flash kernels")

    monkeypatch.setattr(patt, "_cuda_eligible", lambda q, k, v: True)
    monkeypatch.setattr(flash_mod, "flash_attention", refuse)
    q = torch.randn(1, 8, 2, 4, generator=torch.Generator().manual_seed(0))
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 2, 0]])
    out = patt.attention(q, q, q, causal=True, segment_ids=seg)
    assert torch.equal(out, patt.dot_product_attention(
        q, q, q, causal=True, segment_ids=seg))
    with pytest.raises(AssertionError, match="flash kernels"):
        patt.attention(q, q, q, causal=True)   # unpacked: the kernel route
    with pytest.raises(ValueError, match="flash kernel"):
        patt.attention(q, q, q, causal=True, impl="pallas", segment_ids=seg)
    with pytest.raises(ValueError, match="unknown attention impl"):
        patt.attention(q, q, q, causal=True, impl="palas", segment_ids=seg)
    with pytest.raises(ValueError, match="self-attention"):
        patt.dot_product_attention(q, q[:, :4], q[:, :4], segment_ids=seg)


# -- the model ---------------------------------------------------------------------

def test_packed_forward_equals_unpacked_per_document():
    jf, pf = both_fitted(seed=2, seq_len=12)
    rng = np.random.default_rng(1)
    docs = [list(rng.integers(1, V, n)) for n in (5, 4, 3, 7)]
    tokens, segs = ppack.pack_documents(docs, 12)
    packed = pf.model(torch.from_numpy(tokens),
                      segment_ids=torch.from_numpy(segs)).detach().numpy()
    want = np.asarray(jf.model.apply(jf.params, jnp.asarray(tokens),
                                     segment_ids=jnp.asarray(segs)))
    np.testing.assert_allclose(packed, want, atol=2e-5)
    found = 0
    for doc in docs:
        n = len(doc)
        solo = pf.model(torch.tensor([doc])).detach().numpy()[0]
        for r in range(tokens.shape[0]):
            for s in range(12 - n + 1):
                if ((tokens[r, s:s + n] == doc).all()
                        and len(set(segs[r, s:s + n])) == 1
                        and segs[r, s] != 0
                        and (s == 0 or segs[r, s - 1] != segs[r, s])
                        and (s + n == 12 or segs[r, s + n] != segs[r, s])):
                    np.testing.assert_allclose(packed[r, s:s + n], solo,
                                               rtol=2e-5, atol=2e-5)
                    found += 1
    assert found == len(docs)


def test_without_segment_ids_documents_leak():
    _, pf = both_fitted(seed=3, seq_len=8)
    tokens = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8]])
    segs = torch.tensor([[1, 1, 1, 1, 2, 2, 2, 2]])
    masked = pf.model(tokens, segment_ids=segs).detach()
    unmasked = pf.model(tokens).detach()
    torch.testing.assert_close(masked[0, :4], unmasked[0, :4], atol=2e-5,
                               rtol=2e-5)
    assert (masked[0, 4:] - unmasked[0, 4:]).abs().max() > 1e-3


def test_learned_positional_table_refused():
    model = transformer_lm(**{**LM, "positional": "learned"}, device="cpu")
    with pytest.raises(ValueError, match="rope"):
        model(torch.zeros(1, S, dtype=torch.int64),
              segment_ids=torch.ones(1, S, dtype=torch.int64))


# -- training ----------------------------------------------------------------------

def test_packed_runner_is_the_unpacked_runner_with_segments():
    """One segment per row is the unpacked model: the packed epoch equals
    the unpacked epoch there, and make_packed_epoch_runner is the packed
    form of make_epoch_runner."""
    corpus = packed_corpus(4, 40)
    x, y = corpus["features"], corpus["label"]
    ones = np.ones_like(corpus["segment_ids"])
    losses = []
    for packed in (False, True):
        _, pf = both_fitted(seed=5)
        model = pf.model
        tx, opt_state = popt.build("adam", model_params(model), 1e-3)
        state = TrainState(model_params(model), opt_state, 0)
        xb, yb, sb = (torch.from_numpy(a.reshape(2, 4, S))
                      for a in (x[:8], y[:8], ones[:8]))
        mb = np.ones((2, 4), np.float32)
        if packed:
            runner = make_packed_epoch_runner(model, MASKED, tx)
            args = (xb, yb, sb, mb)
        else:
            runner = make_epoch_runner(model, MASKED, tx)
            args = (xb, yb, mb)
        _, out = runner(state, *args)
        losses.append(out.detach().numpy())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


def test_packed_single_trainer_matches_jax():
    corpus = packed_corpus(5, 96)
    val = packed_corpus(6, 24)
    jf, pf = both_fitted(seed=6)
    kw = dict(batch_size=8, num_epoch=2, loss=MASKED,
              segment_col="segment_ids")
    jt = jdk.SingleTrainer(jf, worker_optimizer=jopt.Adam(3e-3,
                                                          epsilon=1e-4), **kw)
    jfit = jt.train(jdk.Dataset(corpus), shuffle=True,
                    validation_data=jdk.Dataset(val))
    pt = port.SingleTrainer(pf, worker_optimizer=popt.Adam(3e-3,
                                                           epsilon=1e-4),
                            device="cpu", **kw)
    pfit = pt.train(Dataset(corpus), shuffle=True,
                    validation_data=Dataset(val))
    assert len(pt.get_history()) == len(jt.get_history()) >= 4
    np.testing.assert_allclose(pt.get_history(), jt.get_history(), **TOL)
    np.testing.assert_allclose(pt.validation_history, jt.validation_history,
                               **TOL)
    for a, b in zip(pfit.get_weights(), jfit.get_weights()):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="segment"):
        port.SingleTrainer(pf, device="cpu", **kw).train(
            Dataset(corpus), validation_data=Dataset(
                {k: val[k] for k in ("features", "label")}))


DIST_CASES = {
    "ADAG": dict(communication_window=2, worker_optimizer="adam",
                 learning_rate=3e-3),
    "DOWNPOUR": dict(communication_window=2, worker_optimizer="sgd",
                     learning_rate=0.05),
    "AEASGD": dict(communication_window=2, rho=1.0, learning_rate=0.05),
}


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("name", sorted(DIST_CASES))
def test_packed_distributed_trainers_match_jax(name, n):
    corpus = packed_corpus(7, 96)
    jf, pf = both_fitted(seed=7)
    kw = dict(batch_size=4, num_epoch=2, loss=MASKED, seed=3,
              segment_col="segment_ids", **DIST_CASES[name])
    jt = getattr(jdk, name)(jf, num_workers=n, **kw)
    pt = getattr(port, name)(pf, mesh=get_mesh(n, devices=["cpu"] * n), **kw)
    jfit = jt.train(jdk.Dataset(corpus), shuffle=True)
    pfit = pt.train(Dataset(corpus), shuffle=True)
    assert len(pt.get_history()) == len(jt.get_history()) >= 4
    np.testing.assert_allclose(pt.get_history(), jt.get_history(), **TOL)
    for a, b in zip(pfit.get_weights(), jfit.get_weights()):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


def test_packed_engine_paths_agree_and_refuse_misuse():
    """run_epoch, run_round and the streamed epoch of a packed engine are
    one computation; a packed engine refuses a batch without segment ids
    and a stream of triples."""
    corpus = packed_corpus(8, 64)
    x, y, seg = corpus["features"], corpus["label"], corpus["segment_ids"]
    xb, yb, sb, mb, rounds = shape_epoch_data(x, y, 2, 2, 4, columns_seg=seg)
    results = []
    for how in ("epoch", "round", "stream"):
        _, pf = both_fitted(seed=8)
        engine = SPMDEngine(pf.model, MASKED, "adam", get_mesh(
            2, devices=["cpu"] * 2), "adag", 2, 1e-3, packed=True)
        state = engine.init_state()
        rngs = engine.worker_rngs(0)
        if how == "epoch":
            state, losses = engine.run_epoch(state, xb, yb, mb, rngs, sb=sb)
        elif how == "round":
            losses = []
            for r in range(rounds):
                state, loss = engine.run_round(state, xb[r], yb[r], mb[r],
                                               rngs, s=sb[r])
                losses.append(loss)
            losses = torch.stack(losses)
        else:
            state, losses = engine.run_epoch_streaming(
                state, round_stream(x, y, 2, 2, 4, seg=seg), rngs)
            losses = torch.from_numpy(losses)
        results.append((losses, state.center))
    for losses, center in results[1:]:
        assert torch.equal(losses, results[0][0])
        for k, v in center.items():
            assert torch.equal(v, results[0][1][k])
    with pytest.raises(ValueError, match="needs segment ids"):
        engine.run_epoch(state, xb, yb, mb, rngs)
    with pytest.raises(ValueError, match="expects 4"):
        engine.run_epoch_streaming(state, round_stream(x, y, 2, 2, 4), rngs)
    with pytest.raises(ValueError, match="masked"):
        port.ADAG(pf, mesh=get_mesh(2, devices=["cpu"] * 2),
                  segment_col="segment_ids",
                  loss="sparse_categorical_crossentropy")
