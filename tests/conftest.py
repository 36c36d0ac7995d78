"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding paths are
exercised without an accelerator; Pallas kernels run in interpret mode.
This must be configured before the first JAX backend initialization.
Tests that need a GPU are marked ``gpu`` and skip here (tests/test_gpu.py).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


# Inner-loop smoke tier: the semantics/parity modules that cover every
# numeric backend (limb digits, QFloat, packed int64 via the pair-parity
# tests, uint32 pairs) without the compile-heavy circuit sweeps.  Timed on
# this box at ~75 s warm — the "<2 min" inner loop the round-1 verdict asked
# for.  Full division/inversion coverage stays in core.
_SMOKE_MODULES = {
    "test_qfloat",
    "test_limbs",
    "test_radix",
    "test_pair_qfloat",
    "test_roofline",
}


def pytest_collection_modifyitems(config, items):
    """Three-tier suite: smoke < core < everything.

    ``pytest -m smoke`` = inner-loop semantics tier (~75 s warm XLA cache);
    ``pytest -m core`` = fast semantics/parity tier (~3-5 min warm XLA
    cache, longer cold);
    ``pytest -m slow`` = compile-heavy lowering/inverse/differential
    sweeps (nightly); plain ``pytest`` still runs everything.
    """
    for item in items:
        if "slow" not in item.keywords:
            item.add_marker(pytest.mark.core)
            if item.module.__name__ in _SMOKE_MODULES:
                item.add_marker(pytest.mark.smoke)


@pytest.fixture
def rng():
    return np.random.RandomState(42)
