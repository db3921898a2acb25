"""Test harness config: run JAX on a virtual 8-device CPU mesh.

Must set env vars before jax is imported anywhere.  ``SFM_TEST_PLATFORM=gpu``
(set by chip_smoke.py, which runs the card-only tests inside its own
process on the card) keeps the accelerator instead.
"""
import os
import sys

ON_CARD = os.environ.get("SFM_TEST_PLATFORM", "cpu") == "gpu"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

# repo root on sys.path so the package imports without installation
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# Measured-duration slow tier: nodeids listed in slow_tests.txt get the
# `slow` marker so `pytest -m "not slow"` is a <5 min iteration tier.
# Regenerate after behavior/coverage changes with:
#   python -m pytest tests/ -q --durations=0 2>&1 | tee /tmp/pytest_dur.log
#   python tools/gen_slow_list.py /tmp/pytest_dur.log
# New tests default to the fast tier until measured.
_slow_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "slow_tests.txt")
try:
    with open(_slow_file) as _f:
        _SLOW_IDS = {ln.strip() for ln in _f if ln.strip()}
except OSError:
    _SLOW_IDS = set()


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid in _SLOW_IDS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu():
    """Card-only tests (marker ``gpu``) take this fixture: it skips unless
    JAX's default backend is the GPU.  Decided here, at run time, never at
    import, so every pytest-xdist worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the card: the compiled Triton kernels have no CPU "
                    "lowering (run `python chip_smoke.py` on the GPU)")
