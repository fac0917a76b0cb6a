"""Test configuration: JAX runs on the CPU with 8 virtual devices, so the
multi-device sharding paths run without accelerator hardware.  Tests that
need a GPU carry the `gpu` marker and take the `gpu` fixture, which skips
them when JAX outside this process finds no GPU."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import subprocess  # noqa: E402
import sys  # noqa: E402

import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; run with `python -m pytest -m gpu "
        "tests/` on a machine that has one")


def gpu_env() -> dict:
    """The environment without this suite's CPU pinning, for a child
    process that should see the machine's accelerators."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="session")
def gpu():
    """Skips the test unless a child JAX process finds a GPU (this
    process is pinned to the CPU)."""
    r = subprocess.run([sys.executable, "-c",
                        "import jax; print(jax.devices()[0].platform)"],
                       capture_output=True, text=True, env=gpu_env(),
                       timeout=300)
    if r.stdout.strip() != "gpu":
        pytest.skip("no GPU visible to JAX")
