"""Test configuration: the CPU backend with 8 virtual devices, so sharding
tests run without a card. A JAX_PLATFORMS the caller set is kept, so the
`gpu`-marked tests can see a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib

import pytest

REFERENCE_DATA = pathlib.Path("/root/reference/tests/data")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: compares a GPU result with the CPU backend; skips without a GPU",
    )


@pytest.fixture(scope="session")
def gpu():
    """The first GPU JAX sees; the test skips when there is none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX (run with JAX_PLATFORMS=cuda,cpu on a card)")


@pytest.fixture(scope="session")
def reference_corpus():
    """AVIF files from the reference test corpus (read-only), if present."""
    if not REFERENCE_DATA.is_dir():
        pytest.skip("reference corpus not available")
    return sorted(REFERENCE_DATA.glob("*.avif"))
