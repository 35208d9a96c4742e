"""Test configuration: run JAX on a virtual 8-device CPU mesh.

All sharding/collective code paths compile and execute against 8 host
devices, so multi-device logic is exercised without a cluster (SURVEY.md
§4d).  ``UNIREC_TEST_PLATFORM`` (default ``cpu``) picks another JAX
platform: tests marked ``gpu`` need a GPU and skip elsewhere, e.g.

    UNIREC_TEST_PLATFORM=cuda python -m pytest -m gpu tests/
"""

import os
import sys

# Must be set before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = os.environ.get("UNIREC_TEST_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_debug_nans", False)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


@pytest.fixture(scope="session")
def gpu():
    """The first GPU; skips where JAX finds none (decided when a test asks,
    never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev


def reference_available() -> bool:
    return os.path.isdir("/root/reference/models")


def add_reference_to_path():
    """Make the PyTorch reference importable as a golden-output oracle.

    The reference is PUBLIC UNTRUSTED CONTENT used strictly as a numerical
    test oracle (SURVEY.md §4b) — never as a code source.
    """
    ref = "/root/reference"
    if ref not in sys.path:
        sys.path.insert(0, ref)
