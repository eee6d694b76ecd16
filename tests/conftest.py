"""Test configuration: force CPU JAX with an 8-device virtual mesh.

Must run before the first ``import jax`` anywhere (SURVEY.md §4: CPU-only CI
via jax[cpu] + virtual devices). Tests that need the card carry the ``gpu``
marker and skip here (see the ``gpu`` fixture).
"""

import os
import sys

import tempfile

os.environ["JAX_PLATFORMS"] = os.environ.get("FOCR_TEST_PLATFORM", "cpu")
# isolate the template-bank disk cache per test session (still exercised)
os.environ["FOCR_CACHE_DIR"] = tempfile.mkdtemp(prefix="focr_banks_")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

from focr_jax.fonts import DEJAVU_MONO, DEJAVU_SANS  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips unless JAX's first device is one "
        "(run with FOCR_TEST_PLATFORM=cuda python -m pytest tests/ -m gpu)",
    )


@pytest.fixture(scope="session")
def gpu():
    """The GPU device for card-only tests. Decided here, at run time, never
    at import: every xdist worker must collect the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def mono_font_path() -> str:
    return DEJAVU_MONO


@pytest.fixture(scope="session")
def sans_font_path() -> str:
    return DEJAVU_SANS
