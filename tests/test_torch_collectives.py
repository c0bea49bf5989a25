"""The port's collectives (``distkeras_tpu_torch/parallel/collective.py``)
and its process-group rail across CPU ranks over gloo.

Two groups of ranks start together once for the file (``torch_ranks``):
2 ranks on a 1-D mesh, and 4 ranks running the same cases on a 1-D mesh
and on a (2, 2) mesh (subgroups, sums over two axes).  Each rank runs
every collective forward and, against a seeded cotangent, backward; here
one process computes the same global function of every rank's input with
plain tensor code and autograd, and both must agree (f32 sums in other
orders: 1e-6).  The cotangent follows the layer's convention: an output
that every rank of the axes holds alike gets one cotangent for the group,
an output that differs per rank its own.  Every group is started by a
coordinated ``Job`` through ``initialize_from_env`` (the backend rendered
by ``Job(backend="gloo")``), whose rank children load no jax.  Without
ranks: the mesh's rules (rank layout, the NCCL rule, staging through host
memory), and ``initialize_from_env`` calling ``mesh.initialize``.
"""

import numpy as np
import pytest
import torch

import torch_ranks as tr
from distkeras_tpu_torch.parallel import collective
from distkeras_tpu_torch.parallel.mesh import Mesh, check_backend

torch.set_num_threads(1)

GROUPS = {2: [((2,), ("x",))], 4: [((4,), ("x",)), ((2, 2), ("a", "b"))]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    started = {}
    for n, meshes in GROUPS.items():
        cases = [{"name": f"mesh{i}", "kind": "collectives",
                  "shape": list(shape), "axis_names": list(names)}
                 for i, (shape, names) in enumerate(meshes)]
        cases.append({"name": "env", "kind": "env"})
        started[n] = tr.Ranks(n, {"cases": cases},
                              tmp_path_factory.mktemp(f"ranks{n}"))
    return {n: r.results() for n, r in started.items()}


def reference(name, op, axes, kw, same, shape, names):
    """Every rank's (output, input gradient) of one collective, computed
    in one process: the group's inputs combined as the op defines, the
    loss one <output, cotangent> per group where the output is held
    alike, one per rank otherwise."""
    n = int(np.prod(shape))
    coords = [tuple(int(i) for i in np.unravel_index(r, shape))
              for r in range(n)]
    xs = [torch.from_numpy(tr.op_inputs(name, r, coords[r], names, axes,
                                        op == "pvary")).requires_grad_()
          for r in range(n)]
    pos = {a: names.index(a) for a in names}

    def group(r):
        key = tr.group_key(coords[r], names, axes)
        return [q for q in range(n)
                if tr.group_key(coords[q], names, axes) == key]

    def index(r):  # the rank's place in its group, row-major over axes
        idx = 0
        for a in names:
            if a in axes:
                idx = idx * shape[pos[a]] + coords[r][pos[a]]
        return idx

    outs = []
    for r in range(n):
        g = group(r)
        if op == "psum":
            y = sum(xs[q] for q in g)
        elif op == "pmean":
            y = sum(xs[q] for q in g) / len(g)
        elif op == "pvary":
            y = xs[r] * 1.0
        elif op == "all_gather":
            y = torch.cat([xs[q] for q in g], dim=kw["axis"])
        elif op == "all_to_all":
            m, i = len(g), index(r)
            y = torch.cat([xs[q].chunk(m, kw["split_axis"])[i] for q in g],
                          dim=kw["concat_axis"])
        else:  # ppermute over one axis
            src = [s for s, d in tr.perm_of(kw, len(g)) if d == index(r)]
            y = (xs[g[src[0]]] * 1.0 if src
                 else torch.zeros_like(xs[r]))
        outs.append(y)
    loss, seen = 0.0, set()
    for r in range(n):
        key = tr.group_key(coords[r], names, axes) if same else (r,)
        if key in seen:
            continue
        seen.add(key)
        c = torch.from_numpy(tr.cotangent(name, r, coords[r], names, axes,
                                          same, tuple(outs[r].shape)))
        loss = loss + (outs[r] * c).sum()
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    if op == "pvary":  # one input per group, held by each of its ranks
        grads = [sum(grads[q] for q in group(r)) for r in range(n)]
    return [(o.detach().numpy(), (torch.zeros_like(xs[r]) if g is None
                                  else g).numpy())
            for r, (o, g) in enumerate(zip(outs, grads))]


CASES = [(n, i, op) for n, meshes in GROUPS.items()
         for i, (_, names) in enumerate(meshes)
         for op in (tr.ONE_AXIS_OPS if len(names) == 1
                    else tr.TWO_AXIS_OPS)]


@pytest.mark.parametrize("n,mesh_i,op", CASES,
                         ids=[f"{n}ranks-mesh{i}-{op[0]}"
                              for n, i, op in CASES])
def test_collective_forward_and_backward_match_one_process(ranks, n, mesh_i,
                                                           op):
    shape, names = GROUPS[n][mesh_i]
    name = op[0]
    want = reference(*op, shape, names)
    for r, res in enumerate(ranks[n]):
        y, g = res[f"mesh{mesh_i}"][name]
        wy, wg = want[r]
        np.testing.assert_allclose(y, wy, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} rank {r} forward")
        np.testing.assert_allclose(g, wg, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{name} rank {r} backward")


@pytest.mark.parametrize("n", sorted(GROUPS))
def test_ranks_sit_at_the_jax_mesh_positions(ranks, n):
    for i, (shape, names) in enumerate(GROUPS[n]):
        for r, res in enumerate(ranks[n]):
            got = res[f"mesh{i}"]
            want = tuple(int(c) for c in np.unravel_index(r, shape))
            assert got["rank"] == r and tuple(got["coords"]) == want
            assert got["axis_index"] == dict(zip(names, want))


@pytest.mark.parametrize("n", sorted(GROUPS))
def test_initialize_from_env_joins_a_coordinated_job(ranks, n):
    """Each group is a coordinated ``Job`` of n processes: every child
    joined through ``initialize_from_env`` over the rendered gloo backend,
    at the rank of its process id, ran one psum, and loaded no jax."""
    for r, res in enumerate(ranks[n]):
        env = res["env"]
        assert env["backend"] == "gloo" and env["world"] == n
        assert env["rank"] == r == int(env["process_id"])
        assert env["psum"] == n * (n + 1) / 2
        assert env["comm_stats"] == {"all_reduce": (1, 4)}  # one f32
        assert env["modules"] == []


def test_a_mesh_of_one_needs_no_group_and_every_collective_is_identity():
    mesh = Mesh(device="cpu")
    assert mesh.rank == 0 and mesh.coords == (0, 0, 0)
    assert mesh.axis_index("seq") == 0 and mesh.group("model") is None
    x = torch.randn(4, 4, requires_grad=True)
    for y in (collective.psum(x, "data", mesh), collective.pmean(x, (
            "data", "seq"), mesh), collective.pvary(x, "model", mesh),
              collective.all_gather(x, "model", mesh),
              collective.all_to_all(x, "seq", 0, 1, mesh),
              collective.ppermute(x, "seq", [(0, 0)], mesh)):
        assert y is x
    with pytest.raises(ValueError, match="not in mesh axes"):
        collective.psum(x, "pipe", mesh)


def test_two_ranks_on_one_card_under_nccl_raise_naming_gloo():
    one_card = [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match='backend="gloo"'):
        check_backend("nccl", one_card)
    check_backend("gloo", one_card)
    check_backend("nccl", [torch.device("cuda", 0), torch.device("cuda", 1)])
    check_backend("nccl", [torch.device("cpu")] * 2)


def test_the_mesh_checks_its_backend_before_any_collective(monkeypatch):
    """A bound mesh applies the NCCL rule to its devices before it creates
    a subgroup: with the group's backend reported as nccl, two ranks on
    one device raise."""
    import torch.distributed as dist
    mesh = Mesh(np.array(["cpu"] * 2, dtype=object), ("x",))
    mesh.devices[:] = [torch.device("cuda", 0)] * 2
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(dist, "new_group", lambda *a, **k: calls.append(a))
    with pytest.raises(ValueError, match="gloo"):
        mesh.rank
    assert calls == []


def test_staging_through_host_memory_is_a_rule_of_backend_op_and_device():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert collective.staged("ppermute", "gloo", cuda)
    for op in ("all_reduce", "all_gather", "all_to_all", "ppermute"):
        assert not collective.staged(op, "gloo", cpu)
        assert not collective.staged(op, "nccl", cuda)
    for op in collective.GLOO_DEVICE_OPS:
        assert not collective.staged(op, "gloo", cuda)


def test_initialize_from_env_calls_mesh_initialize(monkeypatch):
    from distkeras_tpu_torch import job_deployment
    from distkeras_tpu_torch.parallel import mesh as mesh_lib
    calls = []
    monkeypatch.setattr(mesh_lib, "initialize",
                        lambda *a, **k: calls.append((a, k)))
    job = job_deployment.Job("j", "train.py", hosts=["h0", "h1", "h2"],
                             coordinator_port=9999, backend="gloo")
    for k, v in job.host_env(2).items():
        monkeypatch.setenv(k, v)
    job_deployment.initialize_from_env()
    assert calls == [(("h0:9999", 3, 2), {"backend": "gloo"})]
    monkeypatch.delenv("DISTKERAS_TPU_BACKEND")
    job_deployment.initialize_from_env()
    assert calls[-1] == (("h0:9999", 3, 2), {"backend": None})
    assert job_deployment.Job.from_record(job.to_record()).backend == "gloo"
