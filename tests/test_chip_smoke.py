"""chip_smoke.py refuses to run without a GPU or without the package."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _run(cwd, extra_env=None, args=()):
    env = dict(os.environ)
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, SMOKE if cwd == REPO else "chip_smoke.py", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def _assert_refused(p):
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "[phase" not in p.stdout


@pytest.mark.parametrize("args", [(), ("--four",)], ids=["one", "four"])
def test_refuses_cpu_only(args):
    """No GPU: non-zero exit before any phase, no result line, no CPU
    fallback."""
    p = _run(REPO, {"JAX_PLATFORMS": "cpu", "PBRJAX_NO_CACHE": "1"}, args)
    _assert_refused(p)
    assert "needs a GPU" in p.stderr


def test_refuses_without_the_package(tmp_path):
    """Alone in a directory (none of the repo beside it): non-zero exit."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    p = _run(str(tmp_path), env)
    _assert_refused(p)
    assert "not importable" in p.stderr
