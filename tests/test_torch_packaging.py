"""The port as an installed package: a wheel built offline from setup.py
holds the CUDA kernel sources, the rasterizer source and every config
template; the native build roots fall back to the user cache where the
package's parent cannot be written; init_workspace refuses a missing
template instead of skipping it."""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from augmentedautoencoder_torch import workspace
from augmentedautoencoder_torch.ops import _cuda
from augmentedautoencoder_torch.renderer.native import binding
from augmentedautoencoder_torch.utils import build_dirs

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "augmentedautoencoder_torch"
COPY_IGNORE = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "*.o", "build", "*.egg-info")


def _port_data_files():
    """The non-Python files an installed port needs, relative to the repo."""
    names = [*PORT.glob("csrc/*.cu"), PORT / "renderer" / "native" / "rasterizer.cpp",
             *PORT.glob("cfg_templates/*.cfg"), *PORT.glob("cfg_templates/cfg_m3vision/*.cfg")]
    return sorted(str(p.relative_to(REPO)) for p in names)


@pytest.fixture(scope="module")
def wheel_names(tmp_path_factory):
    """The member names of a wheel built with pip, offline, from a copy of
    setup.py and both packages (the build writes nothing into the checkout)."""
    root = tmp_path_factory.mktemp("wheel")
    src = root / "src"
    src.mkdir()
    shutil.copy(REPO / "setup.py", src / "setup.py")
    for pkg in ("augmentedautoencoder_torch", "augmentedautoencoder_tpu"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=COPY_IGNORE)
    out = root / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation", "--no-index", "-q",
         "-w", str(out), str(src)],
        capture_output=True, text=True, timeout=300, env={**os.environ, "PIP_NO_INPUT": "1"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (whl,) = out.glob("*.whl")
    with zipfile.ZipFile(whl) as zf:
        return set(zf.namelist())


def test_wheel_holds_the_kernel_and_rasterizer_sources(wheel_names):
    for name in ("augmentedautoencoder_torch/csrc/codebook_query.cu", "augmentedautoencoder_torch/csrc/icp_nn.cu",
                 "augmentedautoencoder_torch/renderer/native/rasterizer.cpp"):
        assert name in wheel_names, name


def test_wheel_holds_every_port_data_file(wheel_names):
    want = _port_data_files()
    assert len(want) >= 2 + 1 + 3 + 7
    assert not [n for n in want if n not in wheel_names]


def test_wheel_keeps_the_jax_templates_and_both_packages(wheel_names):
    assert "augmentedautoencoder_tpu/cfg_templates/train_template.cfg" in wheel_names
    assert "augmentedautoencoder_torch/__init__.py" in wheel_names
    assert "augmentedautoencoder_tpu/__init__.py" in wheel_names


def test_build_root_beside_the_package_where_writable(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build_dirs.build_root("k", parent=tmp_path / "site") == tmp_path / "site" / "build" / "k"


@pytest.mark.parametrize("xdg", [True, False], ids=["XDG_CACHE_HOME", "HOME"])
def test_build_root_falls_back_to_the_user_cache_where_read_only(tmp_path, monkeypatch, xdg):
    """A read-only package parent (an installed site-packages): the build
    goes under $XDG_CACHE_HOME/aae_torch, or ~/.cache/aae_torch."""
    site = tmp_path / "site-packages"
    site.mkdir()
    real_access = os.access

    def access(path, mode):  # the tests may run as root, who can write anywhere
        if mode & os.W_OK and Path(path).resolve().is_relative_to(site):
            return False
        return real_access(path, mode)

    monkeypatch.setattr(build_dirs.os, "access", access)
    if xdg:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        want = tmp_path / "xdg" / "aae_torch" / "aae_torch_kernels"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        want = tmp_path / "home" / ".cache" / "aae_torch" / "aae_torch_kernels"
    assert build_dirs.build_root("aae_torch_kernels", parent=site) == want


def test_the_native_builds_use_the_build_roots():
    assert _cuda.BUILD_ROOT.name == "aae_torch_kernels"
    assert binding.BUILD_ROOT.name == "aae_torch_host"
    # in a checkout (writable), beside the package, as before
    if os.access(REPO, os.W_OK):
        assert _cuda.BUILD_ROOT == REPO / "build" / "aae_torch_kernels"
        assert binding.BUILD_ROOT == REPO / "build" / "aae_torch_host"


def test_init_workspace_copies_both_templates(tmp_path):
    workspace.init_workspace(str(tmp_path / "ws"))
    assert (tmp_path / "ws" / "cfg" / "train_template.cfg").is_file()
    assert (tmp_path / "ws" / "cfg_eval" / "eval_template.cfg").is_file()


def test_init_workspace_raises_on_a_missing_template(tmp_path, monkeypatch):
    real_exists = os.path.exists

    def exists(path):
        return False if str(path).endswith(os.path.join("cfg_templates", "eval_template.cfg")) else real_exists(path)

    monkeypatch.setattr(workspace.os.path, "exists", exists)
    with pytest.raises(FileNotFoundError, match="eval_template.cfg"):
        workspace.init_workspace(str(tmp_path / "ws"))
