"""dklint (``distkeras_tpu.analysis``) over the port: the lock and wire
rules that hold the JAX package to zero unbaselined findings hold the
port too, with the JAX package's own baseline.  Each finding that the
baseline suppresses in the port is one it suppresses in the JAX package:
the same class, attribute and code, justified there."""

import pytest
import torch

from distkeras_tpu.analysis import default_baseline_path, run_analysis

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def report():
    return run_analysis(["distkeras_tpu_torch/"], default_baseline_path())


def test_the_port_has_zero_unbaselined_findings(report):
    assert report.findings, "the analyzer saw nothing"
    assert not report.unbaselined, "\n".join(
        f"{f.path}:{f.line}: [{f.rule}] {f.message}"
        for f in report.unbaselined)


def test_the_baselined_findings_are_the_jax_packages_own(report):
    jax_report = run_analysis(["distkeras_tpu/"], default_baseline_path())
    jax_ids = {f.ident for f in jax_report.suppressed}
    assert {f.ident for f in report.suppressed} <= jax_ids
    assert not jax_report.unbaselined
