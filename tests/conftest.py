import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def run_forced_devices(code: str, devices: int | None = None,
                       timeout: int = 1800):
    """Run `code` in a fresh interpreter with a forced host device count
    and parse its last stdout line as JSON.

    XLA's device count is process-global, so every multi-device suite goes
    through here. `devices=None` honors REPRO_TEST_DEVICES (the CI matrix
    leg; default 8); pass an explicit count for suites whose assertions
    hard-require a fixed mesh.
    """
    if devices is None:
        devices = int(os.environ.get("REPRO_TEST_DEVICES", "8"))
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = REPO_SRC
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# Single source of truth for the shared small-graph fixture set. The
# distributed suites re-build it inside fresh subprocesses (XLA's device
# count is process-global), so it is kept as exec-able source and the
# in-process fixture below is derived from the SAME string — the two can
# not diverge.
SMALL_GRAPHS_SRC = """
from repro.graphs import (barabasi_albert, barabasi_albert_hub,
                          directed_web, erdos_renyi, grid2d, ring)
graphs = dict(ring=ring(64), grid=grid2d(8, 8),
              er=erdos_renyi(96, 5.0, seed=1),
              ba=barabasi_albert(96, 3, seed=2),
              ba_hub=barabasi_albert_hub(96, 3, seed=4),
              dweb=directed_web(96, 5.0, seed=3))
"""


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def small_graphs():
    ns = {}
    exec(SMALL_GRAPHS_SRC, ns)
    return ns["graphs"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); the test "
        "skips without one")
