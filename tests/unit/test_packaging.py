"""What a fresh process on the GPU host needs: the package imports with only
JAX, NumPy, SciPy and the standard library (no flax, PyYAML, orbax or
matplotlib on the main path), and the persistent compile cache lands where
`tpustomp.utils.cache` says."""

import os
import subprocess
import sys

import pytest

from tpustomp.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BLOCKED = ("flax", "yaml", "orbax", "matplotlib")


def _run(code: str, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="")
    env.update(env_extra or {})
    block = (f"import sys\nfor m in {BLOCKED!r}:\n"
             "    sys.modules[m] = None  # import of m raises ImportError\n")
    return subprocess.run([sys.executable, "-c", block + code], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_main_path_imports_without_optional_packages():
    out = _run(
        "import tpustomp, tpustomp.cli, tpustomp.api.tune\n"
        "import tpustomp.engine.mpc, tpustomp.engine.distributed\n"
        "from tpustomp.api.config import load_toml\n"
        "print(load_toml('configs/config2_tabletop.toml').num_rollouts)\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "50"


def test_cli_plans_without_optional_packages(tmp_path):
    out = _run(
        "from tpustomp.cli import main\n"
        "sys.exit(main(['configs/config1_planar.toml']))\n",
        env_extra={cache.ENV_VAR: str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert '"success": true' in out.stdout.splitlines()[-1]


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, env_set):
    code = ("import jax\nfrom tpustomp.utils.cache import "
            "enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    if env_set:
        out = _run(code, env_extra={cache.ENV_VAR: str(tmp_path)})
        want = str(tmp_path)
    else:
        out = _run(code, drop=(cache.ENV_VAR,))
        want = os.path.join(ROOT, ".jax_cache")
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()
    assert returned == configured == want
    assert cache.CHECKOUT == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
