"""The row-sparse legs of tests/test_streaming.py on the port
(``row_sparse=`` across the host-PS stack): the table detection from the
model (``streaming.resolve_row_sparse_tables``), a single-worker
``row_sparse=True`` run bit-identical to the dense run and at 3 shards to
1 shard, commit bytes that scale with the rows a window touched (≤ 5% of
dense at ~1% of rows), and the knob's validation.  The streaming legs of
that file are tests/test_torch_streaming.py and
tests/test_torch_stream_training.py."""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import (AEASGD, DOWNPOUR, Dataset, Sequential,
                                 networking, transformer_lm)
from distkeras_tpu_torch.core.layers import Dense, Embedding, Flatten
from distkeras_tpu_torch.core.model import serialize_model
from distkeras_tpu_torch.streaming import (embedding_weight_indices,
                                           resolve_row_sparse_tables)
from distkeras_tpu_torch.workers import DOWNPOURWorker

torch.set_num_threads(1)

V, D, C = 64, 8, 4


def make_mapping(seed=0):
    return np.random.default_rng(seed).integers(0, C, V)


def make_click_dataset(mapping, n=512, seed=0):
    rng = np.random.default_rng(seed)
    items = rng.integers(0, V, n).astype(np.int32).reshape(-1, 1)
    y = np.eye(C, dtype=np.float32)[mapping[items[:, 0]]]
    return Dataset({"features": items, "label": y})


def make_embedding_model(vocab=V, dim=D):
    return Sequential([Embedding(vocab, dim), Flatten(),
                       Dense(C, activation="softmax")],
                      input_shape=(1,), compute_dtype="float32",
                      device="cpu")


TINY_LM = dict(vocab_size=16, seq_len=8, d_model=8, num_heads=2,
               num_layers=1, mlp_dim=16)


# ---------------------------------------------------------------------------
# the row-sparse profile: table detection
# ---------------------------------------------------------------------------

def test_embedding_table_detection_from_model_spec():
    model = Sequential([Embedding(V, D), Flatten(),
                        Dense(16, activation="relu"),
                        Dense(C, activation="softmax")],
                       input_shape=(1,), compute_dtype="float32",
                       device="cpu")
    assert embedding_weight_indices(model) == [0]
    assert resolve_row_sparse_tables(True, model) == [0]
    assert resolve_row_sparse_tables([0], model) == [0]
    with pytest.raises(ValueError, match="weights"):
        resolve_row_sparse_tables([99], model)
    with pytest.raises(ValueError, match="rows"):
        resolve_row_sparse_tables([1], model)  # a (16,) bias is 1-D
    dense_model = Sequential([Dense(4, activation="softmax")],
                             input_shape=(3,), compute_dtype="float32",
                             device="cpu")
    with pytest.raises(ValueError, match="no Embedding"):
        resolve_row_sparse_tables(True, dense_model)
    # the LM's first layer is its token table; a later Embedding's index
    # counts every leaf before it
    lm = transformer_lm(**TINY_LM, device="cpu")
    assert resolve_row_sparse_tables(True, lm) == [0]
    two = Sequential([Dense(3), Embedding(V, D)], input_shape=(1,),
                     compute_dtype="float32", device="cpu")
    assert embedding_weight_indices(two) == [2]  # after bias and kernel


# ---------------------------------------------------------------------------
# row-sparse end to end: bit-identity + commit-byte scaling
# ---------------------------------------------------------------------------

def _run_clicks(row_sparse, shards=1, mapping=None, algorithm=DOWNPOUR):
    ds = make_click_dataset(mapping if mapping is not None
                            else make_mapping())
    t = algorithm(make_embedding_model(), num_workers=1, batch_size=16,
                  num_epoch=2, communication_window=2, learning_rate=0.5,
                  execution="host_ps", row_sparse=row_sparse,
                  ps_shards=shards, device="cpu")
    fitted = t.train(ds)
    return t, fitted.get_weights()


def test_row_sparse_run_bit_identical_to_dense():
    """A deterministic single-worker DOWNPOUR run with row_sparse=True
    produces BIT-identical weights to the dense run — the profile is exact
    (support detected from the delta itself), and a dense apply only ever
    adds exact zeros where row-sparse skips."""
    _, w_dense = _run_clicks(None)
    t, w_rs = _run_clicks(True)
    for a, b in zip(w_dense, w_rs):
        np.testing.assert_array_equal(a, b)
    w = t._ps_workers[0]
    assert w.row_sparse_tables == (0,) and not t.comm_overlap
    assert w.transport_ops == 1 + w._commits  # one 'u' a window


def test_row_sparse_lm_bit_identical_to_dense():
    """The same on the transformer LM, whose first layer is its token
    table: row_sparse=True resolves to weight 0 and equals the dense run."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 16, (32, 8)).astype(np.int32)
    ds = Dataset({"features": x, "label": ((x + 1) % 16).astype(np.int64)})

    def run(rs):
        t = DOWNPOUR(transformer_lm(**TINY_LM, device="cpu"),
                     num_workers=1, batch_size=8, num_epoch=1,
                     communication_window=2, learning_rate=0.1,
                     loss="sparse_categorical_crossentropy_from_logits",
                     execution="host_ps", row_sparse=rs, comm_overlap=False,
                     device="cpu")
        return t, t.train(ds).get_weights()

    _, dense = run(None)
    t, rs = run(True)
    assert t._ps_workers[0].row_sparse_tables == (0,)
    for a, b in zip(dense, rs):
        np.testing.assert_array_equal(a, b)


def test_row_sparse_sharded_split_bit_identical():
    """Row-range shard splitting is exact: single-worker N-shard row-sparse
    runs match the 1-shard run bit for bit (every touched row lands on
    exactly one shard, in local coordinates)."""
    _, w1 = _run_clicks(True, shards=1)
    t, w3 = _run_clicks(True, shards=3)
    for a, b in zip(w1, w3):
        np.testing.assert_array_equal(a, b)
    w = t._ps_workers[0]
    assert w.transport_ops == 3 * (1 + w._commits)


def test_row_sparse_commit_bytes_scale_with_touched_rows():
    """Embedding commit bytes scale with the rows a window touched, not the
    table size — a byte-counting double around the real worker transport
    shows row-sparse commits at ≤5% of the dense commit at ~1% row
    touch."""
    vocab = 8192  # large table; each window touches ≤ 32 rows (0.4%)
    mapping = np.random.default_rng(0).integers(0, C, vocab)
    rng = np.random.default_rng(1)
    items = rng.integers(0, vocab, 256).astype(np.int32).reshape(-1, 1)
    ds = Dataset({"features": items,
                  "label": np.eye(C, dtype=np.float32)[mapping[items[:, 0]]]})

    commit_bytes = {}

    def run(row_sparse):
        t = DOWNPOUR(make_embedding_model(vocab=vocab), num_workers=1,
                     batch_size=16, num_epoch=1, communication_window=2,
                     learning_rate=0.5, execution="host_ps",
                     row_sparse=row_sparse, comm_overlap=False,
                     device="cpu")
        sizes = []
        orig = DOWNPOURWorker._send_request

        def counting(self, op, msg):
            sizes.append(len(networking.encode_message(msg)))
            return orig(self, op, msg)

        DOWNPOURWorker._send_request = counting
        try:
            t.train(ds)
        finally:
            DOWNPOURWorker._send_request = orig
        commit_bytes[bool(row_sparse)] = sizes
        return t._ps_workers[0]

    dense_worker = run(None)
    sparse_worker = run(True)
    dense = np.mean(commit_bytes[False])
    sparse = np.mean(commit_bytes[True])
    # dense commits carry the whole (8192, 8) table every window;
    # row-sparse carries ≤ window·batch touched rows
    assert sparse <= 0.05 * dense, (sparse, dense)
    # and the dense table really dominates the dense commit
    assert dense > vocab * D * 4
    # the worker's own payload counter agrees
    assert sparse_worker.commit_bytes <= 0.05 * dense_worker.commit_bytes


def test_row_sparse_knob_validation():
    m = make_embedding_model()
    kw = dict(num_workers=1, batch_size=16, device="cpu")
    t = DOWNPOUR(m, execution="host_ps", row_sparse=True, **kw)
    assert t.row_sparse is True and t.comm_overlap is False
    assert DOWNPOUR(m, execution="host_ps", **kw).row_sparse is None
    with pytest.raises(ValueError, match="host_ps"):
        DOWNPOUR(m, row_sparse=True, **kw)  # SPMD: no PS wire
    with pytest.raises(ValueError, match="delta family"):
        AEASGD(m, execution="host_ps", row_sparse=True, **kw)
    with pytest.raises(ValueError, match="compose"):
        DOWNPOUR(m, execution="host_ps", row_sparse=True,
                 wire_dtype="topk", **kw)
    # worker-level guards (direct construction)
    blob = serialize_model(m)
    with pytest.raises(ValueError, match="row"):
        DOWNPOURWorker(blob, "sgd", "categorical_crossentropy",
                       "127.0.0.1", 1, row_sparse_tables=[1],
                       device="cpu")  # 1-D weight
    with pytest.raises(ValueError, match="comm_overlap"):
        DOWNPOURWorker(blob, "sgd", "categorical_crossentropy",
                       "127.0.0.1", 1, row_sparse_tables=[0],
                       comm_overlap=True, device="cpu")
