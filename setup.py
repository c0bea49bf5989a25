"""Packaging for distkeras_tpu (parity with the reference's pip-installable
single package; reference: ``setup.py`` — SURVEY.md §2.1 row 24).

Builds the optional C++ wire-codec extension (``csrc/``) when a toolchain is
present; the pure-Python fallback keeps the package fully functional without
it (see ``distkeras_tpu/networking.py``).
"""

import os

from setuptools import Extension, find_packages, setup

ext_modules = []
if os.environ.get("DISTKERAS_TPU_NO_NATIVE", "0") != "1":
    ext_modules.append(Extension(
        "distkeras_tpu._wirecodec",
        sources=["csrc/wirecodec.cpp"],
        extra_compile_args=["-O3", "-std=c++17"],
        optional=True,  # fall back to pure Python if the build fails
    ))
    ext_modules.append(Extension(
        "distkeras_tpu._csvloader",
        sources=["csrc/csvloader.cpp"],
        extra_compile_args=["-O3", "-std=c++17"],
        optional=True,  # datasets.read_csv falls back to np.genfromtxt
    ))
    ext_modules.append(Extension(
        "distkeras_tpu._applykernel",
        sources=["csrc/applykernel.cpp"],
        # -ffp-contract=off: the kernel's contract is BIT-equality with the
        # numpy apply path; an FMA would round `dst + scale*src` once where
        # numpy rounds the product and the sum separately
        extra_compile_args=["-O3", "-std=c++17", "-ffp-contract=off"],
        optional=True,  # the PS apply path falls back to numpy
    ))

setup(
    name="distkeras_tpu",
    version="0.1.0",
    description=("TPU-native distributed deep-learning framework with the "
                 "capability surface of dist-keras, rebuilt on JAX/XLA"),
    license="MIT",
    # distkeras_tpu_torch: the PyTorch/CUDA port; its CUDA sources are
    # compiled by nvcc and its host C++ sources by the host compiler at
    # first use, so they ship as package data
    packages=find_packages(include=["distkeras_tpu", "distkeras_tpu.*",
                                    "distkeras_tpu_torch",
                                    "distkeras_tpu_torch.*"]),
    package_data={"distkeras_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                          "csrc/*.cpp"]},
    python_requires=">=3.10",
    # jax >= 0.9: the SPMD engine uses jax.shard_map and jax.lax.pcast
    # (older jax installs fine but AttributeErrors at runtime)
    install_requires=["jax>=0.9", "numpy", "optax"],
    extras_require={"test": ["pytest"], "keras": ["keras>=3"]},
    ext_modules=ext_modules,
)
