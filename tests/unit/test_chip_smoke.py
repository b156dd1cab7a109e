"""chip_smoke.py refuses to run anywhere but on a GPU."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _module():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_guard_raises_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        _module().require_gpu(jax.devices())
    assert "not a GPU" in str(exc.value.code)


def _ok_line(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except ValueError:
        return False


@pytest.mark.parametrize("alone", [False, True])
def test_script_exits_nonzero_without_gpu(tmp_path, alone):
    """Run as the driver does: from the checkout, and as a lone copy."""
    script, cwd = SCRIPT, ROOT
    if alone:
        script = shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not _ok_line(out.stdout), out.stdout
