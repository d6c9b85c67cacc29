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


# ------------------------------------------- the rest of the facade (embedding renders)
@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("option", ["samples2", "cad", "max_faces"])
def test_render_options_match_jax_bit_for_bit(ply, backend, option):
    """samples=2 (colour at 2x averaged as uint16, depth at 1x), the cad
    shading (CAD material, the reference's uniform-slot mismatch, its
    jittered ambient) and max_faces (decimate_mesh) as the JAX Renderer."""
    kw = {"samples2": {"samples": 2}, "cad": {"shading": "cad"}, "max_faces": {"max_faces": 300}}[option]
    port = Renderer([ply], backend=backend, **kw)
    ref = JaxRenderer([ply], backend=backend, vertex_tmp_store_folder=None, **kw)
    if option == "max_faces":
        assert 0.7 * 300 <= len(port._meshes[0].faces) <= 300
    for R, t in POSES[:3]:
        for random_light in (False, True):
            np.random.seed(11)
            bgr, depth = port.render(0, 160, 120, K, R, t, 10, 10000, random_light=random_light)
            np.random.seed(11)
            jbgr, jdepth = ref.render(0, 160, 120, K, R, t, 10, 10000, random_light=random_light)
            np.testing.assert_array_equal(bgr, jbgr)
            np.testing.assert_array_equal(depth, jdepth)
            assert (depth > 0).any()


@pytest.mark.parametrize("target", [50, 300, 1000, 5000])
def test_decimate_mesh_matches_jax(ply, target):
    from augmentedautoencoder_tpu.renderer.mesh import decimate_mesh as jax_decimate_mesh
    from augmentedautoencoder_torch.renderer.mesh import decimate_mesh

    got, want = decimate_mesh(load_mesh(ply), target), jax_decimate_mesh(jax_load_mesh(ply), target)
    for name in ("vertices", "normals", "faces", "colors"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert len(got.faces) <= target  # the mesh has 320 faces: above that it comes back unchanged


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("samples", [1, 2])
def test_render_with_bbox_matches_jax_and_the_depth(ply, backend, samples):
    """The box from the rasterizer's extents (native, one sample) or from
    the depth's nonzero pixels equals calc_2d_bbox(nonzero(depth)) and the
    JAX Renderer's; None when nothing is visible."""
    from augmentedautoencoder_torch.geometry.view_sampler import calc_2d_bbox

    port = Renderer([ply], samples=samples, backend=backend)
    ref = JaxRenderer([ply], samples=samples, backend=backend, vertex_tmp_store_folder=None)
    for R, t in POSES:
        bgr, depth, bb = port.render_with_bbox(0, 160, 120, K, R, t, 10, 10000)
        jbgr, jdepth, jbb = ref.render_with_bbox(0, 160, 120, K, R, t, 10, 10000)
        np.testing.assert_array_equal(bgr, jbgr)
        np.testing.assert_array_equal(depth, jdepth)
        if not (depth > 0).any():
            assert bb is None and jbb is None
            continue
        ys, xs = np.nonzero(depth > 0)
        assert list(map(int, bb)) == list(map(int, jbb)) == list(map(int, calc_2d_bbox(xs, ys, (160, 120))))


def test_native_binding_returns_the_pixel_extent(ply):
    r = Renderer([ply], backend="native")
    light = (np.array([400.0, 400.0, 400.0]), 0.4, 0.8, 0.3)
    for R, t in POSES:
        bgr, depth, px = r._native[0].render(160, 120, K, R, t, 10, 10000, *light, return_px_bbox=True)
        ys, xs = np.nonzero(depth > 0)
        if len(xs) == 0:
            assert px is None
        else:
            assert px.dtype == np.int32 and px.tolist() == [xs.min(), ys.min(), xs.max(), ys.max()]
        b2, d2 = r._native[0].render(160, 120, K, R, t, 10, 10000, *light)
        np.testing.assert_array_equal(b2, bgr)
        np.testing.assert_array_equal(d2, depth)


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("random_light", [False, True])
def test_render_many_and_normals_match_jax(ply, backend, random_light):
    meshes = [make_textured_asymmetric(subdivisions=2, radius=r) for r in (45.0, 30.0)]
    port = Renderer([], backend=backend, meshes=meshes)
    ref = JaxRenderer([], backend=backend, meshes=meshes)
    Rs = [POSES[1][0], POSES[2][0], np.eye(3)]
    ts = [np.array([-30.0, 0.0, 500.0]), np.array([20.0, 10.0, 450.0]), np.array([0.0, -20.0, 480.0])]
    np.random.seed(3)
    got = port.render_many([0, 1, 0], 160, 120, K, Rs, ts, 10, 10000, random_light=random_light)
    np.random.seed(3)
    want = ref.render_many([0, 1, 0], 160, 120, K, Rs, ts, 10, 10000, random_light=random_light)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert [list(map(int, b)) for b in got[2]] == [list(map(int, b)) for b in want[2]]
    for a, b in zip(port.render_normals(1, 97, 61, K, *POSES[1], 10, 10000),
                    ref.render_normals(1, 97, 61, K, *POSES[1], 10, 10000)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mesh_cache_is_shared_with_jax_and_written_atomically(ply, tmp_path):
    """The cache file has the JAX package's name and fields: each package
    reads what the other wrote; the port leaves no temporary file."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    fresh = load_mesh(ply, vertex_scale=1.5, cache_dir=str(port_dir), recalculate_normals=True)
    jax_load_mesh(ply, vertex_scale=1.5, cache_dir=str(jax_dir), recalculate_normals=True)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) and len(os.listdir(port_dir)) == 1
    from_jax = load_mesh(ply, vertex_scale=1.5, cache_dir=str(jax_dir), recalculate_normals=True)
    from_port = jax_load_mesh(ply, vertex_scale=1.5, cache_dir=str(port_dir), recalculate_normals=True)
    for name in ("vertices", "normals", "faces", "colors"):
        np.testing.assert_array_equal(getattr(from_jax, name), getattr(fresh, name))
        np.testing.assert_array_equal(getattr(from_port, name), getattr(fresh, name))
    # a second load reads the cache
    cached = load_mesh(ply, vertex_scale=1.5, cache_dir=str(port_dir), recalculate_normals=True)
    np.testing.assert_array_equal(cached.vertices, fresh.vertices)
    no_colors = tmp_path / "plain.ply"
    from augmentedautoencoder_torch.renderer.procedural import make_icosphere

    save_ply(make_icosphere(1, 20.0, colored=False), str(no_colors))
    assert load_mesh(str(no_colors), cache_dir=str(port_dir)).colors is None
    assert load_mesh(str(no_colors), cache_dir=str(port_dir)).colors is None  # from the cache
    assert not [f for f in os.listdir(port_dir) if not f.endswith(".npz")]
