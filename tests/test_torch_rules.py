"""The port's update rules (``distkeras_tpu_torch/parallel/rules.py``)
against the JAX package's (``distkeras_tpu/parallel/rules.py``).

The same numpy-drawn f32 trees go through both, and every rule must give
the same values to the bit: each is one or two f32 elementwise operations
in the same order.  The port's rules also take numpy leaves (the host
parameter servers' form), keep the trees' structure, and never change
their inputs.
"""

from collections import OrderedDict
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.parallel import rules as jrules
from distkeras_tpu_torch.parallel import rules

torch.set_num_threads(1)

SHAPES = OrderedDict([("0/bias", (7,)), ("0/kernel", (5, 7)),
                      ("1/stats/mean", (3,)), ("2/kernel", (2, 3, 4))])


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return OrderedDict((k, (scale * rng.standard_normal(s)).astype(np.float32))
                       for k, s in SHAPES.items())


def to_port(t):
    return OrderedDict((k, torch.from_numpy(v.copy())) for k, v in t.items())


def to_jax(t):
    return {k: jnp.asarray(v) for k, v in t.items()}


def assert_same(got, want):
    assert list(got) == list(SHAPES)
    for k in SHAPES:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)
        assert g.dtype == np.float32


@pytest.mark.parametrize("name", ["tree_sub", "tree_add", "delta_commit",
                                  "easgd_worker_update",
                                  "easgd_center_update"])
def test_binary_rules_match_jax(name):
    a, b = tree(1), tree(2, 0.1)
    got = getattr(rules, name)(to_port(a), to_port(b))
    assert_same(got, getattr(jrules, name)(to_jax(a), to_jax(b)))


@pytest.mark.parametrize("s", [0.5, 1.0 / 3.0, -2.0, 1e-3])
def test_tree_scale_matches_jax(s):
    a = tree(3)
    assert_same(rules.tree_scale(to_port(a), s),
                jrules.tree_scale(to_jax(a), s))


@pytest.mark.parametrize("num_commits", [1, 2, 3, 8])
def test_adag_commit_matches_jax(num_commits):
    c, d = tree(4), tree(5, 0.01)
    assert_same(rules.adag_commit(to_port(c), to_port(d), num_commits),
                jrules.adag_commit(to_jax(c), to_jax(d), num_commits))


@pytest.mark.parametrize("alpha", [0.5, 0.05, 0.1 * 5.0])
def test_elastic_difference_matches_jax(alpha):
    x, c = tree(6), tree(7)
    assert_same(rules.elastic_difference(to_port(x), to_port(c), alpha),
                jrules.elastic_difference(to_jax(x), to_jax(c), alpha))


@pytest.mark.parametrize("staleness", [0, 1, 2, 3])
def test_dynsgd_commit_matches_jax(staleness):
    c, d = tree(8), tree(9, 0.01)
    # the SPMD engine's form: the staleness arrives as the f32 worker
    # order on the JAX side, as an int on the port's
    assert_same(rules.dynsgd_commit(to_port(c), to_port(d), staleness),
                jrules.dynsgd_commit(to_jax(c), to_jax(d),
                                     jnp.float32(staleness)))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_average_trees_matches_jax(n):
    trees = [tree(10 + i) for i in range(n)]
    assert_same(rules.average_trees([to_port(t) for t in trees]),
                jrules.average_trees([to_jax(t) for t in trees]))


def test_closed_forms():
    """The reference semantics on one scalar (the JAX package's
    tests/test_update_rules.py cases)."""
    t = lambda v: {"w": torch.tensor([v])}
    assert rules.delta_commit(t(1.0), t(0.5))["w"].item() == 1.5
    assert rules.adag_commit(t(1.0), t(0.8), 4)["w"].item() == \
        pytest.approx(1.2)
    e = rules.elastic_difference(t(3.0), t(1.0), 0.25)
    assert e["w"].item() == 0.5
    assert rules.easgd_worker_update(t(3.0), e)["w"].item() == 2.5
    assert rules.easgd_center_update(t(1.0), e)["w"].item() == 1.5
    # the elastic fixed point: x == x̃ exerts no force
    assert rules.elastic_difference(t(2.0), t(2.0), 0.9)["w"].item() == 0.0
    assert rules.dynsgd_commit(t(1.0), t(1.0), 3)["w"].item() == 1.25


@pytest.mark.parametrize("name,args", [
    ("tree_sub", 2), ("tree_add", 2), ("delta_commit", 2),
    ("adag_commit", 3), ("elastic_difference", 3),
    ("easgd_worker_update", 2), ("easgd_center_update", 2),
    ("dynsgd_commit", 3)])
def test_rules_never_change_their_inputs(name, args):
    """The host parameter servers keep the trees they pass in."""
    a, b = to_port(tree(20)), to_port(tree(21))
    before = [{k: v.clone() for k, v in t.items()} for t in (a, b)]
    extra = {3: (0.5,)}.get(args, ())
    out = getattr(rules, name)(a, b, *extra)
    for t, kept in zip((a, b), before):
        for k in SHAPES:
            assert torch.equal(t[k], kept[k])
            assert out[k].data_ptr() != t[k].data_ptr()


def test_numpy_leaves_and_structures():
    """Numpy leaves (the host PS form), lists, tuples and named tuples
    keep their structure and agree with the tensor form."""
    class Pair(NamedTuple):
        a: object
        b: object

    x = Pair([np.ones(3, np.float32), (np.full(2, 2.0, np.float32),)],
             {"k": np.zeros(1, np.float32)})
    y = rules.tree_add(x, x)
    assert isinstance(y, Pair) and isinstance(y.a, list)
    assert isinstance(y.a[1], tuple) and list(y.b) == ["k"]
    np.testing.assert_array_equal(y.a[1][0], [4.0, 4.0])
    a, b = tree(30), tree(31)
    got = rules.adag_commit(a, b, 3)
    want = rules.adag_commit(to_port(a), to_port(b), 3)
    for k in SHAPES:
        np.testing.assert_array_equal(got[k], want[k].numpy())


def test_jax_tree_leaf_order_is_the_ports():
    """A dict tree's leaves come out of JAX in sorted key order, the order
    of the port's ordered dicts (model_params): flat lists of the two agree
    position by position."""
    t = tree(40)
    jl = jax.tree_util.tree_leaves(to_jax(t))
    for (k, v), w in zip(to_port(t).items(), jl):
        np.testing.assert_array_equal(v.numpy(), np.asarray(w))
