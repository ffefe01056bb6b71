"""catch-tpu: TPU-native probe design engine."""

from setuptools import find_packages, setup

import catch_tpu

setup(
    name="catch_tpu",
    version=catch_tpu.__version__,
    packages=find_packages(exclude=["tests", "tests.*"]),
    # The CUDA sources catch_tpu_torch builds at first use.
    package_data={"catch_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    install_requires=["numpy>=1.22", "scipy>=1.8.0", "jax>=0.4.20"],
    author="catch-tpu contributors",
    description=("TPU-native design of compact, comprehensive probe sets "
                 "for hybrid capture of diverse genomes"),
    python_requires=">=3.10",
    entry_points={
        "console_scripts": [
            "catch-design=catch_tpu.cli.design:run",
            "catch-design-large=catch_tpu.cli.design_large:run",
            "catch-design-naively=catch_tpu.cli.design_naively:run",
            "catch-analyze-probe-coverage="
            "catch_tpu.cli.analyze_probe_coverage:run",
            "catch-pool=catch_tpu.cli.pool:run",
        ],
    },
)
