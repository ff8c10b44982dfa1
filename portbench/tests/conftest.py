"""Tests of the benchmark's harness, on the CPU at tiny sizes.

    python -m pytest portbench/tests -q

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which skips them where no card is visible; whether there is one is
decided inside the fixture, never while a module is imported.
"""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def spec():
    from portbench.harness.spec import Spec

    return Spec(ROOT)


@pytest.fixture
def serving(spec):
    """The thin serving cell's configuration and traffic cut to CPU size,
    fp32."""
    c = spec.cell("serve-thin-512")
    config = copy.deepcopy(spec.config(c["config"]))
    traffic = copy.deepcopy(spec.traffic(c["traffic"]))
    config["img_size"] = 64
    config["generator"].update(base_channels=16, num_residual_blocks=3)
    config["compute_dtype"] = "float32"
    traffic.update(sizes=[5, 7, 9], chunk=4, sample=2, profile_patients=2)
    return config, traffic


@pytest.fixture
def training(spec):
    """The training cell's configuration and traffic cut to CPU size,
    fp32."""
    c = spec.cell("train-soft-512-b8")
    config = copy.deepcopy(spec.config(c["config"]))
    traffic = copy.deepcopy(spec.traffic(c["traffic"]))
    config["img_size"] = 32
    config["generator"].update(base_channels=8, num_residual_blocks=2)
    config["discriminator"]["base_channels"] = 8
    config["compute_dtype"] = "float32"
    traffic.update(batch=4, batches=4, warmup_steps=4,
                   dispatch_probe_steps=1, profile_steps=1)
    return config, traffic


@pytest.fixture
def make_ctx():
    """A run's settings on the CPU, the path checks off (the CPU runs the
    kernels' plain versions and counts no launch)."""
    import time

    from portbench.harness.common import Ctx

    def make(config, traffic, seed=2 ** 33 + 17, seconds=0.5, trace=False):
        return Ctx(seed=seed, seconds=seconds, trace=trace, config=config,
                   traffic=traffic, t0=time.perf_counter(), device="cpu",
                   check_path=False)

    return make
