"""The port's SPMD engine across ranks (one worker a rank, over gloo on
the CPU) against the JAX package's ``SPMDEngine`` on the virtual CPU mesh
of tests/conftest.py and against the port's one-process engine.

Two jobs of ranks start once, together (2 and 4 ranks, tests/
torch_ranks.py), and run an epoch of every algorithm from the numpy
weight set of tests/test_torch_spmd.py, with and without
BatchNormalization, while this process runs the references:
- against JAX at N = 2 and 4: the per-round losses and the center within
  test_torch_spmd.py's ``TOL`` (``BN_TOL`` with BatchNorm);
- against the port's one-process 2-worker engine at N = 2: the losses,
  the center and every worker's params equal to the bit (a sum of two is
  the same in any order), and ``gather_workers`` gives every rank the
  one-process state;
- ``run_round`` round by round and ``run_epoch_streaming`` through
  ``prefetch_to_device(shardings=)`` equal ``run_epoch`` to the bit, the
  packed engine's three paths too and equal to the one-process packed
  engine;
- ``put_replicated``, ``put_worker_sharded`` and ``prefetch_to_device(
  shardings=)`` give each rank the JAX arrays' addressable shard of its
  device;
- ``ModelPredictor(mesh=)`` on the same ranks predicts 37 rows of
  tests/test_torch_dist_trainers.py's MLP (not a multiple of 2 or 4, so
  the tail is padded by its last row and cut) at two batch sizes, with
  ``mesh=`` the ranks' mesh and with no mesh inside the group, and the
  rows of a tiny LM: every rank holds every row in row order, within
  1e-5 of JAX's ``_predict_sharded`` at f32 and equal to the one-process
  mesh route to the bit, one ``all_gather`` a chunk.
"""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.core import layers as jl
from distkeras_tpu.core import optimizers as jopt
from distkeras_tpu.core.model import Sequential as JaxSequential
from distkeras_tpu.parallel import get_mesh as jax_mesh
from distkeras_tpu.parallel.mesh import (put_replicated as jax_put_rep,
                                         put_worker_sharded as jax_put_ws)
from distkeras_tpu.parallel.spmd import SPMDEngine as JaxEngine
from distkeras_tpu.parallel.spmd import shape_epoch_data as jax_shape
from distkeras_tpu.predictors import ModelPredictor as JaxPredictor
from distkeras_tpu_torch import Dataset, ModelPredictor
from distkeras_tpu_torch.core import optimizers as popt
from distkeras_tpu_torch.parallel import SPMDEngine, get_mesh

import torch_ranks as tr
from test_torch_dist_trainers import jax_model, numpy_weights, port_model

torch.set_num_threads(1)

ALGOS = ("adag", "downpour", "dynsgd", "aeasgd", "eamsgd", "local")
TOL = dict(rtol=1e-5, atol=1e-6)
BN_TOL = dict(rtol=1e-4, atol=2e-5)
CASE = dict(tr.ENGINE, seed=0)
PACKED_CASE = dict(window=2, batch=2, seed=5, docs=24)
PREDICT_ROWS, PREDICT_BATCHES = 37, (4, 16)
PREDICT_LM = dict(vocab_size=16, seq_len=8, d_model=8, num_heads=2,
                  num_layers=1, mlp_dim=16)
PREDICT_LM_ROWS = 5


def weights_and_data(bn):
    """test_torch_spmd.py's draw: JAX init, matrices redrawn from numpy."""
    rng = np.random.default_rng(CASE["seed"])
    jm = JaxSequential(tr.mlp_stack(jl, CASE["classes"], bn),
                       input_shape=(CASE["features"],),
                       compute_dtype="float32")
    params = jm.init(jax.random.PRNGKey(0))
    ws = [(0.3 * rng.standard_normal(w.shape)).astype(np.float32)
          if w.ndim > 1 else np.asarray(w) for w in jm.get_weights(params)]
    rows, d, c = CASE["rows"], CASE["features"], CASE["classes"]
    x = rng.standard_normal((rows, d)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, rows)]
    return jm, jm.set_weights(params, ws), ws, x, y


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The jobs of 2 and 4 ranks, started before any reference runs."""
    tmp = tmp_path_factory.mktemp("spmd_ranks")
    for bn in (False, True):
        _, _, ws, x, y = weights_and_data(bn)
        np.savez(tmp / f"data_bn{int(bn)}.npz", x=x, y=y, nw=len(ws),
                 **{f"w{i}": w for i, w in enumerate(ws)})
    rng = np.random.default_rng(9)
    np.savez(tmp / "place.npz",
             a=rng.standard_normal((4, 3, 2)).astype(np.float32),
             b=rng.standard_normal((8, 5)).astype(np.float32),
             c=rng.standard_normal((3,)).astype(np.float32))
    case = lambda name, bn, **kw: dict(
        CASE, name=name, kind="spmd", bn=bn, algos=list(ALGOS),
        data=str(tmp / f"data_bn{int(bn)}.npz"), **kw)
    place = {"name": "place", "kind": "place",
             "data": str(tmp / "place.npz")}
    weights = numpy_weights()
    np.savez(tmp / "predict.npz", x=predict_rows(), features=10, classes=3,
             nw=len(weights), **{f"w{i}": w for i, w in enumerate(weights)})
    predict = {"name": "predict", "kind": "predict",
               "data": str(tmp / "predict.npz"),
               "batch_sizes": list(PREDICT_BATCHES)}
    two = tr.Ranks(2, {"cases": [
        case("plain", False, modes=["epoch", "round", "stream"]),
        case("bn", True), dict(PACKED_CASE, name="packed",
                               kind="spmd_packed"), place,
        dict(predict, lm=PREDICT_LM, lm_rows=PREDICT_LM_ROWS)]},
        tmp / "two", timeout=240)
    four = tr.Ranks(4, {"cases": [case("plain", False), place, predict]},
                    tmp / "four", timeout=240)
    return {2: two, 4: four}


def predict_rows():
    return np.random.default_rng(4).standard_normal(
        (PREDICT_ROWS, 10)).astype(np.float32)


def run_jax(algo, n, bn):
    jm, params, _, x, y = weights_and_data(bn)
    engine = JaxEngine(jm, tr.ENGINE_LOSS,
                       tr.engine_optimizer(jopt, algo, bn), jax_mesh(n),
                       algo, CASE["window"], CASE["lr"],
                       alpha=tr.ENGINE_ALPHA.get(algo))
    state = engine.init_state(jax.random.PRNGKey(0), (CASE["features"],),
                              initial_params=params)
    xb, yb, mb, _ = jax_shape(x, y, n, CASE["window"], CASE["batch"])
    state, losses = engine.run_epoch(state, xb, yb, mb,
                                     engine.worker_rngs(1))
    return np.asarray(losses), [np.asarray(v) for v in jax.tree_util.
                                tree_leaves(jax.device_get(state.center))]


def run_one_process(algo, n, bn):
    _, _, ws, x, y = weights_and_data(bn)
    engine = SPMDEngine(tr.engine_model(dict(CASE, bn=bn)), tr.ENGINE_LOSS,
                        tr.engine_optimizer(popt, algo, bn),
                        get_mesh(n, devices=["cpu"] * n), algo,
                        CASE["window"], CASE["lr"],
                        alpha=tr.ENGINE_ALPHA.get(algo))
    losses, state = tr.run_engine(engine, ws, x, y, n, CASE)["epoch"]
    return losses, tr.state_arrays(state), engine.worker_rngs(1)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("algo", ALGOS)
def test_ranks_match_jax(ranks, algo, n):
    want_losses, want_center = run_jax(algo, n, False)
    results = ranks[n].results()
    for r, res in enumerate(results):
        got = res["plain"][algo]
        assert got["workers"] == [r] and len(got["epoch"]["local"]) == 1
        assert len(got["epoch"]["losses"]) == len(want_losses) >= 3
        np.testing.assert_allclose(got["epoch"]["losses"], want_losses,
                                   **TOL)
        for (k, v), w in zip(got["epoch"]["center"].items(), want_center):
            np.testing.assert_allclose(v, w, err_msg=k, **TOL)
    # every rank holds the same center and losses, to the bit
    for res in results[1:]:
        for k, v in res["plain"][algo]["epoch"]["center"].items():
            np.testing.assert_array_equal(
                v, results[0]["plain"][algo]["epoch"]["center"][k])


@pytest.mark.parametrize("algo", ALGOS)
def test_ranks_with_batchnorm_match_jax(ranks, algo):
    want_losses, want_center = run_jax(algo, 2, True)
    for res in ranks[2].results():
        got = res["bn"][algo]["epoch"]
        np.testing.assert_allclose(got["losses"], want_losses, **BN_TOL)
        for (k, v), w in zip(got["center"].items(), want_center):
            np.testing.assert_allclose(v, w, err_msg=k, **BN_TOL)
        stats = [k for k in got["center"] if "/stats/" in k]
        assert stats == ["1/stats/mean", "1/stats/var"]
        for k in stats:  # synced unless the workers train apart
            assert (algo == "local") != np.array_equal(
                got["local"][0][k], got["center"][k])


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("algo", ALGOS)
def test_two_ranks_equal_the_one_process_engine_to_the_bit(ranks, algo, bn):
    losses, (center, local, clock), rngs = run_one_process(algo, 2, bn)
    key = "bn" if bn else "plain"
    for r, res in enumerate(ranks[2].results()):
        got = res[key][algo]
        np.testing.assert_array_equal(got["epoch"]["losses"], losses)
        assert got["epoch"]["round_idx"] == clock
        assert got["rngs"] == [rngs[r]]
        for k, v in center.items():
            np.testing.assert_array_equal(got["epoch"]["center"][k], v)
        for k, v in local[r].items():
            np.testing.assert_array_equal(got["epoch"]["local"][0][k], v)
        # gather_workers: the one-process state's workers on every rank
        for w in range(2):
            for k, v in local[w].items():
                np.testing.assert_array_equal(got["gathered"][w][k], v)


@pytest.mark.parametrize("algo", ALGOS)
def test_round_and_streamed_epochs_equal_run_epoch_on_ranks(ranks, algo):
    for res in ranks[2].results():
        runs = res["plain"][algo]
        for mode in ("round", "stream"):
            np.testing.assert_array_equal(runs[mode]["losses"],
                                          runs["epoch"]["losses"])
            for k, v in runs["epoch"]["center"].items():
                np.testing.assert_array_equal(runs[mode]["center"][k], v)
                np.testing.assert_array_equal(runs[mode]["local"][0][k],
                                              runs["epoch"]["local"][0][k])


def test_packed_engine_paths_on_ranks(ranks):
    """run_epoch, run_round and the streamed epoch of a packed engine on 2
    ranks are one computation, equal to the one-process 2-worker packed
    engine to the bit."""
    model, toks, labels, segs = tr.packed_setup(PACKED_CASE)
    engine = SPMDEngine(model, tr.PACKED_LOSS, "adam",
                        get_mesh(2, devices=["cpu"] * 2), "adag",
                        PACKED_CASE["window"], 1e-3, packed=True)
    losses, state = tr.run_engine(engine, model.get_weights(), toks,
                                  labels, 2, PACKED_CASE, seg=segs)["epoch"]
    center, local, _ = tr.state_arrays(state)
    assert len(losses) >= 2
    for r, res in enumerate(ranks[2].results()):
        for mode in ("epoch", "round", "stream"):
            got = res["packed"][mode]
            np.testing.assert_array_equal(got["losses"], losses)
            for k, v in center.items():
                np.testing.assert_array_equal(got["center"][k], v)
            for k, v in local[r].items():
                np.testing.assert_array_equal(got["local"][0][k], v)


@pytest.mark.parametrize("n", [2, 4])
def test_placement_helpers_give_the_jax_shards(ranks, n):
    blob = np.load(ranks[n].out.parent / "place.npz")
    mesh = jax_mesh(n)
    devices = list(mesh.devices.flat)
    for r, res in enumerate(ranks[n].results()):
        # a process group of the mesh's size: one worker a rank, and
        # get_mesh() with no devices gives a worker a rank on the cards
        assert res["place"]["across"] and res["place"]["local_workers"] == [r]
        assert res["place"]["default_mesh"] == ["cuda:0"] * n
        for leaf in ("a", "b"):
            rep = jax_put_rep({"x": blob[leaf]}, mesh)["x"]
            ws = jax_put_ws({"x": blob[leaf]}, mesh)["x"]
            shard = {s.device: np.asarray(s.data)
                     for s in ws.addressable_shards}[devices[r]]
            whole = {s.device: np.asarray(s.data)
                     for s in rep.addressable_shards}[devices[r]]
            place = res["place"]
            np.testing.assert_array_equal(place["sharded"][leaf], shard)
            np.testing.assert_array_equal(place["replicated"][leaf], whole)
        part = len(blob["a"]) // n  # rows of the worker dim a rank
        assert len(res["place"]["streamed"]) == 3
        for k, (a, c) in enumerate(res["place"]["streamed"]):
            full = blob["a"][None].repeat(2, 0) + k
            np.testing.assert_array_equal(
                a, full[:, r * part:(r + 1) * part])
            np.testing.assert_array_equal(c, blob["c"] + k)


def one_process_predict(data, n, b):
    blob = np.load(data)
    p = ModelPredictor(tr.trainer_model(blob), device="cpu", batch_size=b,
                       mesh=get_mesh(n, devices=["cpu"] * n))
    return p.predict(Dataset({"features": blob["x"]}))["prediction"]


@pytest.mark.parametrize("b", PREDICT_BATCHES)
@pytest.mark.parametrize("n", [2, 4])
def test_predict_on_ranks_matches_jax_sharded(ranks, n, b):
    mesh = jax_mesh(n)
    jp = JaxPredictor(jax_model(numpy_weights()), batch_size=b, mesh=mesh)
    want = np.asarray(jp._predict_sharded(predict_rows(), mesh))
    mine = one_process_predict(ranks[n].out.parent / "predict.npz", n, b)
    assert mine.shape == want.shape == (PREDICT_ROWS, 3)
    np.testing.assert_allclose(mine, want, rtol=1e-5, atol=1e-5)
    chunks = -(-PREDICT_ROWS // (b * n))
    for r in ranks[n].results():
        for key in ("mesh", "default"):  # no mesh: the group's
            np.testing.assert_array_equal(r["predict"][(key, b)], mine)
        assert r["predict"][("default_mesh", b)] == n
        assert r["predict"][("calls", b)]["calls"] == chunks


def test_lm_rows_on_ranks_equal_one_process(ranks):
    lm, toks = tr.predict_lm({"lm": PREDICT_LM, "lm_rows": PREDICT_LM_ROWS})
    want = ModelPredictor(lm, device="cpu", batch_size=2,
                          mesh=get_mesh(2, devices=["cpu"] * 2)).predict(
        Dataset({"features": toks}))["prediction"]
    plain = ModelPredictor(lm, device="cpu", batch_size=2).predict(
        Dataset({"features": toks}))["prediction"]
    assert want.shape == (PREDICT_LM_ROWS, PREDICT_LM["seq_len"],
                          PREDICT_LM["vocab_size"])
    np.testing.assert_allclose(want, plain, rtol=1e-6, atol=1e-6)
    for r in ranks[2].results():
        np.testing.assert_array_equal(r["predict"]["lm"], want)


def test_the_mesh_route_refuses_another_device():
    weights = numpy_weights()
    with pytest.raises(ValueError, match="mesh runs"):
        ModelPredictor(port_model(weights), device="meta",
                       mesh=get_mesh(2, devices=["cpu"] * 2))
    p = ModelPredictor(port_model(weights), device="cpu")
    assert p.mesh is None  # no group: the one-device route
