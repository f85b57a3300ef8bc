"""Test configuration.

x64 is enabled so exact-state-reconstruction tests run in float64 (the
paper's exactness claim is a double-precision one).  Model code declares
its dtypes explicitly (bf16/f32) and is unaffected.

NOTE: no ``xla_force_host_platform_device_count`` in THIS process —
smoke tests and benches must see 1 device.  Faked multi-device runs
live in the :func:`multi_device` fixture's subprocesses only: the XLA
flag must be set before jax imports, and this process already imported
jax, so every multi-device test ships its payload to a fresh
interpreter.  The fixture centralizes that plumbing (it used to be
copy-pasted across test_esrp_and_roofline.py / test_dryrun_small.py),
probes once per session per device count that devices can be faked at
all, and skips cleanly when they cannot.
"""
import json
import os
import subprocess
import sys

import jax
import pytest

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multi_device: runs a payload under faked XLA host devices in a "
        "subprocess (skipped when devices cannot be faked)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc (the port's hand-written "
        "kernels); skipped when no CUDA device is visible")


#: prepended to every payload — the flag must land before jax imports
_PROLOGUE = (
    "import os\n"
    "os.environ[\"XLA_FLAGS\"] = "
    "\"--xla_force_host_platform_device_count={n}\"\n")

_PROBE = """
import jax, json
print(json.dumps({"ndev": jax.device_count()}))
"""


class MultiDeviceRunner:
    """Session-wide runner for faked-multi-device payloads.

    ``run(source, ndevices)`` executes ``source`` in a subprocess that
    sees ``ndevices`` faked host devices (PYTHONPATH=src, any inherited
    XLA_FLAGS stripped), asserts it exited 0, and returns its **last
    stdout line parsed as JSON** — the payload's verdict.  The first
    use of each device count probes that XLA really fakes that many
    devices on this platform and ``pytest.skip``s the test if not.
    """

    def __init__(self):
        self._probed = {}

    @staticmethod
    def _env():
        env = dict(os.environ)
        env["PYTHONPATH"] = "src"
        env.pop("XLA_FLAGS", None)  # never inherit a stray device count
        return env

    def require(self, ndevices: int = 8) -> None:
        ok = self._probed.get(ndevices)
        if ok is None:
            res = subprocess.run(
                [sys.executable, "-c",
                 _PROLOGUE.format(n=ndevices) + _PROBE],
                capture_output=True, text=True, env=self._env(),
                timeout=240)
            ok = False
            if res.returncode == 0:
                try:
                    out = json.loads(res.stdout.strip().splitlines()[-1])
                    ok = out.get("ndev") == ndevices
                except (ValueError, IndexError):
                    ok = False
            self._probed[ndevices] = ok
        if not ok:
            pytest.skip(f"cannot fake {ndevices} XLA host devices "
                        f"on this platform")

    def run(self, source: str, ndevices: int = 8, argv=(), timeout=480):
        self.require(ndevices)
        res = subprocess.run(
            [sys.executable, "-c",
             _PROLOGUE.format(n=ndevices) + source, *map(str, argv)],
            capture_output=True, text=True, env=self._env(),
            timeout=timeout)
        assert res.returncode == 0, res.stderr[-2000:]
        return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="session")
def multi_device():
    """Centralized ``--xla_force_host_platform_device_count`` plumbing
    (see :class:`MultiDeviceRunner`)."""
    return MultiDeviceRunner()


@pytest.fixture(scope="session")
def request_trace():
    """The shared deterministic service request-trace generator
    (repro.serving.trace.generate_request_trace), exposed as a fixture
    so the service tests, the campaign-fuzz service leg, and the
    benchmark replay the SAME seeded traces.  Call it with a seed (and
    any generator kwargs) to get a tuple of ServiceRequest."""
    from repro.serving.trace import generate_request_trace

    return generate_request_trace
