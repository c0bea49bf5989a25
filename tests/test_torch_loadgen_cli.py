"""The port's load generator as a program: ``python -m
distkeras_tpu_torch.examples.loadgen --device cpu`` in each mode of the
JAX script (default, ``--qps-sweep``, ``--chaos``, ``--paged
--prefix-groups``, ``--router``, ``--disaggregate``, ``--tenants 3
--overload``, ``--server-core event``, ``--spec-draft self --ttft``).
The runs start together, as subprocesses.  Each exits 0, loads nothing
of jax, Keras or the JAX package, and prints the JSON lines that the JAX
script prints for those flags, by ``mode`` and in order, each with the
JAX script's keys in the JAX script's order: the keys are read from
``examples/loadgen.py``'s source (the dict literals that its ``main``
prints and that its load loops return).  The refusals exit as the JAX
script's do, with its messages."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distkeras_tpu_torch.examples import loadgen

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_SOURCE = ROOT / "examples" / "loadgen.py"
MODULE = "distkeras_tpu_torch.examples.loadgen"
PREFIX = ["--prefix-groups", "2", "--prefix-len", "8", "--block-size", "4"]
#: each run's flags and the modes of the lines it prints, in order
RUNS = {
    "default": ([], ["closed_loop", "sequential", "speedup"]),
    "qps_sweep": (["--qps-sweep", "200,1e6"],
                  ["closed_loop", "sequential", "speedup", "open_loop",
                   "open_loop"]),
    "chaos": (["--chaos", "0.3", "--steps", "24"],
              ["closed_loop", "sequential", "speedup"]),
    "paged_prefix": (["--paged", *PREFIX],
                     ["closed_loop", "paged", "sequential", "speedup"]),
    "router": (["--router", "--paged", "--affinity", "prefix", *PREFIX],
               ["closed_loop", "fleet", "paged", "sequential", "speedup"]),
    "disaggregate": (["--disaggregate", "--block-size", "4"],
                     ["closed_loop", "disagg", "sequential", "speedup"]),
    "overload": (["--tenants", "3", "--overload", "200"], ["qos_overload"]),
    "event": (["--server-core", "event"], ["wire_closed_loop"]),
    "spec_ttft": (["--spec-draft", "self", "--ttft", "--prefill-chunk", "4"],
                  ["closed_loop", "spec", "ttft", "sequential", "speedup"]),
}
CHECK = ("import runpy, sys; sys.argv = sys.argv[1:]; "
         "runpy.run_module(sys.argv[0], run_name='__main__'); "
         "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'keras', 'distkeras_tpu', 'ml_dtypes')); "
         "print('banned', bad)")
REFUSALS = {
    "router-disaggregate": ["--router", "--disaggregate"],
    "router-spec": ["--router", "--spec-draft", "self"],
    "overload-without-tenants": ["--overload", "10"],
    "tenants-disaggregate": ["--tenants", "3", "--disaggregate"],
}


def _jax_keys():
    """The keys of each line the JAX script prints, by mode, read from its
    source."""
    tree = ast.parse(JAX_SOURCE.read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def returned(name):
        for node in ast.walk(fns[name]):
            if isinstance(node, ast.Return) and isinstance(node.value,
                                                          ast.Dict):
                return [k.value for k in node.value.keys]
        raise AssertionError(f"{name} returns no dict literal")

    spreads = {"closed": returned("_metrics"),
               "wire": returned("run_wire_closed_loop"),
               "seq": returned("sequential_baseline")}
    by_mode = {"fleet": returned("fleet_report")}
    for node in ast.walk(fns["main"]):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            continue
        d = node.args[0]
        mode = next(v.value for k, v in zip(d.keys, d.values)
                    if k is not None and k.value == "mode")
        keys = []
        for k, v in zip(d.keys, d.values):
            if k is not None:
                keys.append(k.value)
            elif mode == "qos_overload":
                keys += returned("run_overload")
            elif mode == "open_loop":
                keys += returned("_metrics") + ["offered_qps"]
            else:
                keys += spreads[v.id]
        # a spread key that the literal has keeps the literal's place
        # (qos_overload's "tenants": run_overload's per-tenant counters)
        by_mode[mode] = list(dict.fromkeys(keys))
    return by_mode


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    cwd = tmp_path_factory.mktemp("loadgen")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", CHECK, MODULE, *flags, "--device", "cpu"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, (flags, _) in RUNS.items()}
    return {name: (p, *p.communicate(timeout=240))
            for name, p in procs.items()}


def test_the_jax_scripts_modes_are_all_read():
    assert sorted(_jax_keys()) == sorted(
        {"closed_loop", "open_loop", "sequential", "speedup",
         "wire_closed_loop", "qos_overload", "fleet", "spec", "disagg",
         "paged", "ttft"})


@pytest.mark.parametrize("name", sorted(RUNS))
def test_each_mode_prints_the_jax_scripts_lines(runs, name):
    proc, out, err = runs[name]
    assert proc.returncode == 0, err[-2000:]
    lines = out.strip().splitlines()
    assert lines[-1] == "banned []"
    rows = [json.loads(line) for line in lines[:-1]]
    assert [r["mode"] for r in rows] == RUNS[name][1]
    keys = _jax_keys()
    for r in rows:
        assert list(r) == keys[r["mode"]], r["mode"]
    first = rows[0]
    if first["mode"] in ("closed_loop", "wire_closed_loop"):
        assert first["completed"] == 24
    if name == "chaos":
        assert first["killed"] > 0
    if name == "qps_sweep":
        assert all(r["completed"] + r["shed"] == 24 for r in rows[3:])
    if name == "router":
        assert rows[1]["requests_failed"] == 0
    if name == "paged_prefix":
        assert rows[1]["prefix_hits"] > 0


def _jax_main(argv, monkeypatch):
    from examples import loadgen as jloadgen
    monkeypatch.setattr(sys, "argv", ["loadgen.py", *argv])
    jloadgen.main()


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_exit_as_the_jax_script(name, monkeypatch, capsys):
    argv = REFUSALS[name]
    with pytest.raises(SystemExit) as want:
        _jax_main(argv, monkeypatch)
    jax_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as got:
        loadgen.main([*argv, "--device", "cpu"])
    err = capsys.readouterr().err
    assert got.value.code == want.value.code == 2
    assert err.strip().splitlines()[-1].split("error: ")[1] == \
        jax_err.strip().splitlines()[-1].split("error: ")[1]


def test_flags_are_the_jax_scripts_and_device():
    """Every option of the JAX script, with its default, plus
    ``--device`` (``cuda`` by default)."""
    tree = ast.parse(JAX_SOURCE.read_text())
    want = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            flag = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            default = kw.get("default")
            want[flag] = (ast.literal_eval(default) if default is not None
                          else (False if "action" in kw else None))
    got = {a.option_strings[0]: a.default
           for a in loadgen._parser()._actions if a.option_strings
           and a.option_strings[0] != "-h"}
    assert got.pop("--device") == "cuda"
    assert got == want
