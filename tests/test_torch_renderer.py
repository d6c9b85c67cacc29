"""The port's host renderer (augmentedautoencoder_torch/renderer) against the
JAX package's: the same meshes and poses give the same BGR and depth bit
for bit, on the numpy rasterizer and on the native C++ one (both built
here by g++ with the same flags); and the port's native registry survives
meshes registered from 8 threads while others render."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from augmentedautoencoder_tpu.geometry import transform
from augmentedautoencoder_tpu.renderer import Renderer as JaxRenderer
from augmentedautoencoder_tpu.renderer.mesh import load_mesh as jax_load_mesh
from augmentedautoencoder_torch.renderer import Renderer, load_mesh
from augmentedautoencoder_torch.renderer.procedural import make_textured_asymmetric, save_ply

from _torch_port_ws import REPO

K = np.array([[240.0, 0, 80.0], [0, 240.0, 60.0], [0, 0, 1.0]])
POSES = [
    (np.eye(3), np.array([0.0, 0.0, 550.0])),
    (transform.rotation_matrix(0.7, [1, 2, 0])[:3, :3], np.array([100.0, 8.0, 550.0])),
    (transform.rotation_matrix(2.5, [0, 1, 1])[:3, :3], np.array([-40.0, 30.0, 300.0])),
    (np.eye(3), np.array([0.0, 0.0, -500.0])),  # behind the camera: nothing visible
]


@pytest.fixture(scope="module")
def ply(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_renderer") / "obj.ply")
    save_ply(make_textured_asymmetric(subdivisions=2, radius=45.0), path)
    return path


def test_mesh_loading_matches_jax(ply):
    got, want = load_mesh(ply, vertex_scale=1.5), jax_load_mesh(ply, vertex_scale=1.5)
    for name in ("vertices", "normals", "faces", "colors"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_render_matches_jax_bit_for_bit(ply, backend):
    mesh = load_mesh(ply)
    port = Renderer([], backend=backend, meshes=[mesh])
    ref = JaxRenderer([], backend=backend, meshes=[jax_load_mesh(ply)])
    assert port.backend == ref.backend == backend
    for R, t in POSES:
        for W, H in ((160, 120), (97, 61)):
            bgr, depth = port.render(0, W, H, K, R, t, 10, 10000, random_light=False)
            jbgr, jdepth = ref.render(0, W, H, K, R, t, 10, 10000, random_light=False)
            np.testing.assert_array_equal(depth, jdepth)
            np.testing.assert_array_equal(bgr, jbgr)
    # the random light draws the same numbers from the global stream
    np.random.seed(4)
    bgr, _ = port.render(0, 160, 120, K, *POSES[1], 10, 10000, random_light=True)
    np.random.seed(4)
    jbgr, _ = ref.render(0, 160, 120, K, *POSES[1], 10, 10000, random_light=True)
    np.testing.assert_array_equal(bgr, jbgr)


def test_native_matches_numpy_depth(ply):
    mesh = load_mesh(ply)
    native = Renderer([], backend="native", meshes=[mesh])
    plain = Renderer([], backend="numpy", meshes=[mesh])
    for R, t in POSES:
        _, a = native.render(0, 160, 120, K, R, t, 10, 10000)
        _, b = plain.render(0, 160, 120, K, R, t, 10, 10000)
        both = (a > 0) & (b > 0)
        assert (a > 0).sum() == pytest.approx((b > 0).sum(), rel=0.02, abs=2)
        np.testing.assert_allclose(a[both], b[both], rtol=1e-5)


def test_backend_is_named_not_guessed(ply):
    with pytest.raises(ValueError, match="backend"):
        Renderer([ply], backend="auto")
    assert Renderer([ply], backend="numpy").backend == "numpy"


_STRESS = textwrap.dedent(
    """
    import sys, threading
    import numpy as np
    from augmentedautoencoder_torch.renderer import Renderer, load_mesh
    from augmentedautoencoder_torch.renderer.procedural import make_icosphere

    sys.setswitchinterval(1e-6)
    K = np.array([[240.0, 0, 80.0], [0, 240.0, 60.0], [0, 0, 1.0]])
    base = Renderer([], backend="native", meshes=[load_mesh(sys.argv[1])])
    _, want = base.render(0, 160, 120, K, np.eye(3), np.array([0, 0, 550.0]), 10, 10000)
    errors = []

    def work(seed):
        try:
            for i in range(40):
                # a new registration reallocates the registry while others render
                r = Renderer([], backend="native", meshes=[make_icosphere(1, 30.0 + seed)])
                _, d = base.render(0, 160, 120, K, np.eye(3), np.array([0, 0, 550.0]), 10, 10000)
                if not np.array_equal(d, want):
                    errors.append(f"thread {seed} iteration {i}: depth changed")
                r.render(0, 64, 48, K, np.eye(3), np.array([0, 0, 400.0]), 10, 10000)
        except Exception as exc:  # reported through the exit code
            errors.append(repr(exc))

    threads = [threading.Thread(target=work, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads), "a render thread hung"
    assert not errors, errors
    print("OK")
    """
)


def test_native_registration_while_rendering_from_8_threads(ply):
    # a subprocess, so that a crash in native code fails this test alone
    proc = subprocess.run([sys.executable, "-c", _STRESS, ply], capture_output=True, text=True,
                          timeout=300, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "OK"
