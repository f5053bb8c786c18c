"""Test harness config: run JAX on a virtual 8-device CPU mesh.

Sharding logic is tested without several accelerators on virtual CPU
devices (SURVEY.md §4: xla_force_host_platform_device_count). Tests that
need a GPU carry the ``gpu`` marker and skip, from a fixture, when JAX
finds none: run them on a GPU host with ``python -m pytest -m gpu tests/``
(and without this file's CPU pin: ``PBRJAX_TEST_GPU=1``).
"""

import os

import pytest

if os.environ.get("PBRJAX_TEST_GPU") != "1":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX finds none."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (JAX found none)")
    return devs[0]
