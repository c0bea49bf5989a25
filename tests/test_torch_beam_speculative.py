"""The port's ``beam_search`` and ``speculative_generate`` against the JAX
package's.

Beam search: tokens identical and scores within 1e-5 (plain, with eos,
with a length penalty), ``num_beams=1`` equal to greedy ``generate``, and
each beam's score its log-probability under the full forward.  Greedy
speculative decoding: tokens and stats identical to JAX's with a random
draft, a self-draft, and across step and draft lengths, and equal to
greedy ``generate``.  Sampled speculative decoding is held to its
closed-form marginals (torch's generators never draw JAX's bits).  Small
f32 ``transformer_lm``s, one numpy weight set in both packages.
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.core import decode as jdec
from distkeras_tpu.models.zoo import transformer_lm as jax_lm
from distkeras_tpu_torch import FittedModel, transformer_lm
from distkeras_tpu_torch.core import decode as pdec

torch.set_num_threads(1)

V = 16
PROMPT = np.array([[3, 4, 5], [9, 2, 7]], np.int32)


def numpy_weights(jm, params, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(w.shape) / np.sqrt(w.shape[0])
             if w.ndim == 2 else 0.1 * rng.standard_normal(w.shape)
             + (w == 1.0)).astype(np.float32)
            for w in jm.get_weights(params)]


def both(layers=2, seed=0, vocab=V, **extra):
    cfg = dict(vocab_size=vocab, seq_len=40, d_model=32, num_heads=4,
               num_layers=layers, mlp_dim=64, compute_dtype="float32",
               **extra)
    jm = jax_lm(**cfg)
    params = jm.init(jax.random.PRNGKey(0))
    weights = numpy_weights(jm, params, seed)
    pm = transformer_lm(**cfg, device="cpu")
    pm.set_weights(weights)
    return jm, jm.set_weights(params, weights), pm


@pytest.fixture(scope="module")
def target():
    return both(seed=0, num_kv_heads=2)


@pytest.fixture(scope="module")
def draft():
    return both(layers=1, seed=99)


# -- beam search --------------------------------------------------------------

BEAM_CASES = {"plain": dict(), "eos": dict(eos_id=5),
              "eos_pad_penalty": dict(eos_id=5, pad_id=0,
                                      length_penalty=0.8),
              "penalty": dict(length_penalty=1.0)}


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_search_matches_jax(target, case):
    jm, params, pm = target
    kw = BEAM_CASES[case]
    want_t, want_s = jdec.beam_search(jm, params, PROMPT, 8, num_beams=4,
                                      **kw)
    got_t, got_s = pdec.beam_search(pm, PROMPT, 8, num_beams=4, **kw)
    assert tuple(got_t.shape) == (2, 4, 11) and got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5,
                               rtol=0)
    s = got_s.numpy()
    assert (s[:, :-1] >= s[:, 1:]).all()
    if "eos_id" in kw:
        toks = got_t.numpy()[:, :, 3:]
        pad = kw.get("pad_id", kw["eos_id"])
        for row in toks.reshape(-1, 8):
            hit = np.flatnonzero(row == kw["eos_id"])
            if len(hit):
                assert (row[hit[0] + 1:] == pad).all()


def test_beam_of_one_is_greedy_and_scores_are_log_probs(target):
    _, _, pm = target
    one, _ = pdec.beam_search(pm, PROMPT, 7, num_beams=1)
    assert torch.equal(one[:, 0], pdec.generate(pm, PROMPT, 7))
    toks, scores = pdec.beam_search(pm, PROMPT, 5, num_beams=3)
    logp = torch.log_softmax(pm(toks.reshape(6, -1)).detach(), dim=-1)
    seq = toks.reshape(6, -1).long()
    want = sum(logp[:, t - 1].gather(1, seq[:, t:t + 1])[:, 0]
               for t in range(3, seq.shape[1]))
    np.testing.assert_allclose(scores.reshape(-1).numpy(), want.numpy(),
                               atol=1e-5)
    # FittedModel forwards to the same function
    ft, fs = FittedModel(pm).beam_search(PROMPT, 5, num_beams=3)
    assert torch.equal(ft, toks) and torch.equal(fs, scores)


def test_beam_search_validation(target):
    _, _, pm = target
    for kw, match in ((dict(num_beams=0), "num_beams"),
                      (dict(num_steps=0), "num_steps"),
                      (dict(length_penalty=-1.0), "length_penalty"),
                      (dict(pad_id=1), "pad_id"),
                      (dict(eos_id=V), "eos_id"),
                      (dict(num_steps=60), "positional")):
        kw = {"num_steps": 4, **kw}
        with pytest.raises(ValueError, match=match):
            pdec.beam_search(pm, PROMPT, **kw)


# -- speculative decoding -------------------------------------------------------

def spec_both(t, d, steps, **kw):
    jm, params, pm = t
    dm, dparams, pd = d
    want, wstats = jdec.speculative_generate(jm, params, dm, dparams, PROMPT,
                                             steps, return_stats=True, **kw)
    got, stats = pdec.speculative_generate(pm, pd, PROMPT, steps,
                                           return_stats=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == wstats
    return got, stats


def test_greedy_speculative_matches_jax_with_random_draft(target, draft):
    got, stats = spec_both(target, draft, 10, draft_len=3)
    assert torch.equal(got, pdec.generate(target[2], PROMPT, 10))
    assert stats["drafted"] > 0


def test_greedy_speculative_matches_jax_with_self_draft(target):
    got, stats = spec_both(target, target, 12, draft_len=3)
    assert torch.equal(got, pdec.generate(target[2], PROMPT, 12))
    assert stats["accepted"] >= stats["drafted"] // 2
    assert stats["target_calls"] < 12


@pytest.mark.parametrize("steps,k", [(1, 4), (5, 1), (7, 16)])
def test_greedy_speculative_across_lengths(target, draft, steps, k):
    got, _ = spec_both(target, draft, steps, draft_len=k)
    assert torch.equal(got, pdec.generate(target[2], PROMPT, steps))


def test_greedy_speculative_eos_matches_jax(target):
    free = pdec.generate(target[2], PROMPT, 10).numpy()
    eos = int(free[0, 5])
    got, stats = spec_both(target, target, 10, draft_len=3, eos_id=eos)
    assert torch.equal(got, pdec.generate(target[2], PROMPT, 10,
                                          eos_id=eos))


def test_sampled_speculative_matches_target_distribution():
    """With temperature and top-k warping, the committed tokens' marginals
    equal the warped target distribution computed in closed form,
    whatever the draft proposes (the JAX test's bound: 1024 rows give
    ~0.04 expected total variation at vocab 12; a systematic bias moves
    it by 0.3 or more)."""
    vocab, rows, temp, topk = 12, 1024, 1.3, 6
    _, _, model = both(seed=4, vocab=vocab)
    _, _, dm = both(layers=1, seed=5, vocab=vocab)
    prompt = np.tile(np.array([[3, 4, 5]], np.int32), (rows, 1))
    out = pdec.speculative_generate(model, dm, prompt, num_steps=2,
                                    draft_len=3, temperature=temp,
                                    top_k=topk, rng=0)
    toks = out[:, 3:].numpy()

    def warped(tok_rows):
        lg = model(torch.as_tensor(tok_rows)).detach()[:, -1]
        return torch.softmax(pdec._filter_logits(lg / temp, topk, None),
                             dim=-1).numpy()

    p1 = warped(prompt[:1])[0]
    emp1 = np.bincount(toks[:, 0], minlength=vocab) / rows
    assert 0.5 * np.abs(emp1 - p1).sum() < 0.08
    exts = np.concatenate([np.tile(prompt[:1], (vocab, 1)),
                           np.arange(vocab, dtype=np.int32)[:, None]], axis=1)
    p2 = (p1[:, None] * warped(exts)).sum(axis=0)
    emp2 = np.bincount(toks[:, 1], minlength=vocab) / rows
    assert 0.5 * np.abs(emp2 - p2).sum() < 0.08


def test_sampled_speculative_deterministic_and_validated(target, draft):
    _, _, pm = target
    pd = draft[2]
    g = torch.Generator().manual_seed(3)
    a = pdec.speculative_generate(pm, pd, PROMPT, 6, temperature=0.8,
                                  top_p=0.9, rng=g)
    b = pdec.speculative_generate(pm, pd, PROMPT, 6, temperature=0.8,
                                  top_p=0.9, rng=3)
    assert torch.equal(a, b)
    for kw, match in ((dict(temperature=0.5), "rng"),
                      (dict(top_k=5), "top_k/top_p"),
                      (dict(temperature=0.5, top_p=1.5, rng=0), "top_p"),
                      (dict(draft_len=0), "draft_len"),
                      (dict(max_len=5), "max_len")):
        with pytest.raises(ValueError, match=match):
            pdec.speculative_generate(pm, pd, PROMPT, 4, **kw)
    with pytest.raises(ValueError, match="num_steps"):
        pdec.speculative_generate(pm, pd, PROMPT, 0)
    other = both(layers=1, seed=1, vocab=V + 1)[2]
    with pytest.raises(ValueError, match="vocabularies"):
        pdec.speculative_generate(pm, other, PROMPT, 4)
    got = FittedModel(pm).speculative_generate(FittedModel(pd), PROMPT, 6,
                                               draft_len=2)
    assert torch.equal(got, pdec.generate(pm, PROMPT, 6))
