"""Test harness: run everything on CPU with 8 virtual devices.

Pallas kernels run in interpreter mode on the CPU (core/backend.py decides);
the 8-device virtual mesh exercises the multi-chip sharding path without
hardware. JAX_PLATFORMS defaults to cpu here; a process that has already
started JAX on the GPU (chip_smoke.py runs the `gpu`-marked tests in its
own process) keeps its backend, since both settings only take effect before
JAX initializes.

Tests marked `gpu` need the card: they skip with a reason unless the JAX
backend is a GPU. The decision is made in a fixture, never at import, so
every pytest-xdist worker collects the same tests.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (run on the card by chip_smoke.py)")


@pytest.fixture(autouse=True)
def _gpu_marker_gate(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a CUDA GPU; runs on the card via chip_smoke.py")

# -- memory-map budget --------------------------------------------------------
# Every XLA:CPU executable JIT-maps ~6 code/data segments that are only
# unmapped when the executable is destroyed. A full-suite run compiles
# thousands of executables in ONE process and deterministically hits the
# kernel's vm.max_map_count (default 65530) — mmap then fails inside LLVM
# and XLA segfaults (measured: crash at ~test 131 of the full suite, while
# any subset passes). Two layers of defense:
#  1. raise the limit when we can (root sandboxes),
#  2. drop compiled executables with jax.clear_caches() whenever the map
#     count nears the ceiling (measured to free the maps even while the
#     jitted wrappers stay referenced; the handful of later tests that
#     reuse a cleared signature just recompile).

try:  # best-effort: needs root, fails silently elsewhere
    with open("/proc/sys/vm/max_map_count") as _f:
        _limit = int(_f.read())
    if _limit < 262144:
        with open("/proc/sys/vm/max_map_count", "w") as _f:
            _f.write("262144")
        _limit = 262144
except OSError:
    _limit = 65530


def _n_maps() -> int:
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def _map_count_guard():
    yield
    if _n_maps() > int(_limit * 0.7):
        jax.clear_caches()
