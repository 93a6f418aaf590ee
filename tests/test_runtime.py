"""Runtime glue: the compile-cache directory, chip_smoke.py's refusal to
run anywhere but on a GPU beside the repository, and the package's former
name."""

import glob
import os
import shutil
import subprocess
import sys

import pytest

from multi_style_transfer_gan.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.compilation_cache_dir() == os.path.join(REPO,
                                                           ".jax_cache")


def test_cache_dir_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compilation_cache_dir() == str(tmp_path)


def _assert_no_result(proc):
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    _assert_no_result(proc)
    assert "needs an NVIDIA GPU" in proc.stderr


@pytest.mark.parametrize("platforms", ["cpu", ""])
def test_chip_smoke_alone_fails(tmp_path, platforms):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS=platforms)
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    _assert_no_result(proc)


# packages beside the package that only forward to it under another name
ALIASES = sorted(os.path.basename(os.path.dirname(p)) for p in glob.glob(
    os.path.join(REPO, "multi_style_transfer_gan_*", "__init__.py")))


@pytest.mark.parametrize("alias", ALIASES)
def test_former_package_name_runs_the_cli(alias):
    """``python -m <former name>.cli.<tool>`` still runs, with a warning
    that names the package to import instead."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-m", f"{alias}.cli.convert_model", "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "usage:" in proc.stdout
    assert "renamed to multi_style_transfer_gan" in proc.stderr
