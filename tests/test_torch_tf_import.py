"""`ae_import_tf` in the port: TensorFlow's V2 checkpoints read with numpy
(training/tf_bundle.py), mapped as the JAX package maps them
(training/tf_interop.py), written as the port's checkpoint by the CLI.

Without TensorFlow (these count wherever it is absent), on the committed
fixture tests/fixtures/torch_port/tf_ckpt (make_tf_fixture.py: the
reference graph at 32x32x3, filters [8, 16], latent 8, a 50-row codebook):
every variable's name, dtype, shape and bytes against the manifest
TensorFlow's checkpoint_utils wrote, the imported model's codes against
TensorFlow's within 1e-5 (f32 on both sides, convolutions summed in other
orders) and its reconstructions within 1e-3 (stored as f16), the CLI flow
ending in estimates, the variational checks, and the refusals. With
TensorFlow (importorskip): the reader against checkpoint_utils bit for bit
on fresh checkpoints (a VAE, one with Adam's slots and the global step, and
one at the template's full width), and the port's import against the JAX
package's import of the same checkpoint, state dicts equal.
"""

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from augmentedautoencoder_torch import factory
from augmentedautoencoder_torch import workspace as ws
from augmentedautoencoder_torch.cli import ae_import_tf
from augmentedautoencoder_torch.convert import params_from_jax
from augmentedautoencoder_torch.models import AAE
from augmentedautoencoder_torch.training import CheckpointManager
from augmentedautoencoder_torch.training import tf_interop
from augmentedautoencoder_torch.training.tf_bundle import (
    CheckpointFormatError,
    TFCheckpointReader,
    _entry,
    load_tf_checkpoint_variables,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port", "tf_ckpt")
PREFIX = os.path.join(FIXTURE, "chkpt-77")
SCOPE = "tf_exp"
CODE_ATOL = 1e-5
RECON_ATOL = 1e-3


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_tf_fixture", os.path.join(REPO, "tests", "fixtures", "torch_port", "make_tf_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _fixture_module()


def _cfg():
    from augmentedautoencoder_torch.config import load_train_config

    return load_train_config(os.path.join(FIXTURE, "train.cfg"))


def _imported_model():
    payload = tf_interop.reference_params_to_flax(load_tf_checkpoint_variables(PREFIX, SCOPE),
                                                  num_filters=tuple(FX.FILTERS))
    model = AAE.from_config(_cfg(), train=True)
    model.load_state_dict(params_from_jax(payload["params"], None, decoder=True))
    return model.eval(), payload


# ------------------------------------------------------------------ without TensorFlow

def test_reader_matches_the_manifest():
    with open(os.path.join(FIXTURE, "manifest.json")) as fh:
        manifest = json.load(fh)
    reader = TFCheckpointReader(PREFIX)
    assert reader.names() == sorted(manifest) and reader.num_shards == 1
    for name, want in manifest.items():
        got = reader.tensor(name)
        assert (str(got.dtype), list(got.shape)) == (want["dtype"], want["shape"]), name
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], name
    scoped = load_tf_checkpoint_variables(PREFIX, SCOPE)
    assert set(scoped) == {n[len(SCOPE) + 1:] for n in manifest}
    assert load_tf_checkpoint_variables(FIXTURE + os.sep + "chkpt-77", "other_scope") == {}


def test_forward_matches_tensorflow():
    """The imported weights' codes and reconstructions of the 4 test inputs
    against TensorFlow's, and the codebook carried over."""
    model, payload = _imported_model()
    x = torch.from_numpy(FX.images(FX.N_TEST + FX.N_ROWS)[:FX.N_TEST].astype(np.float32) / 255.0)
    with torch.no_grad():
        out = model(x, x)
    np.testing.assert_allclose(out.z.numpy(), np.load(os.path.join(FIXTURE, "codes.npy")), atol=CODE_ATOL, rtol=0)
    np.testing.assert_allclose(out.reconstruction.numpy(), np.load(os.path.join(FIXTURE, "recon.npy")).astype(np.float32),
                               atol=RECON_ATOL, rtol=0)
    assert payload["embedding_normalized"].shape == (FX.N_ROWS, FX.LATENT)
    assert payload["embed_obj_bbs"].shape == (FX.N_ROWS, 4) and payload["embed_obj_bbs"].dtype == np.int32


def test_reads_and_imports_with_tensorflow_blocked(tmp_path):
    """In a process where `import tensorflow` fails (as on the card's
    machine): the reader, the import and the codes."""
    script = textwrap.dedent(f"""
        import sys
        for m in ("tensorflow", "jax", "augmentedautoencoder_tpu"):
            sys.modules[m] = None
        import os
        import numpy as np
        import torch
        os.environ["AE_WORKSPACE_PATH"] = {str(tmp_path)!r}
        from augmentedautoencoder_torch import factory, workspace
        from augmentedautoencoder_torch.cli import ae_import_tf
        workspace.init_workspace({str(tmp_path)!r})
        ae_import_tf.main([{PREFIX!r}, "imp", "--cfg", {os.path.join(FIXTURE, "train.cfg")!r}, "--scope", "tf_exp"])
        _, _, model, payload = factory.restore_experiment("imp", device="cpu")
        sys.path.insert(0, {os.path.dirname(FIXTURE)!r})
        from make_tf_fixture import images
        x = torch.from_numpy(images(54)[:4].astype(np.float32) / 255.0)
        with torch.no_grad():
            z = model.encode(x).numpy()
        err = np.abs(z - np.load({os.path.join(FIXTURE, "codes.npy")!r})).max()
        assert err <= {CODE_ATOL}, err
        assert payload["step"] == 77 and payload["embedding_normalized"].shape == (50, 8)
        assert sys.modules.get("tensorflow") is None
        print("OK", err)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("OK")


@pytest.fixture
def imported(tmp_path, monkeypatch):
    """The fixture imported by the port's CLI into a fresh workspace."""
    root = str(tmp_path / "ws")
    monkeypatch.setenv(ws.WORKSPACE_ENV_VAR, root)
    ws.init_workspace(root)
    path = ae_import_tf.main([PREFIX, "imported_exp", "--cfg", os.path.join(FIXTURE, "train.cfg"),
                              "--scope", SCOPE])
    return {"root": root, "path": path}


def test_import_cli_full_flow(imported, tmp_path):
    """ae_import_tf -> build_codebook_from_name -> the codebook's rows
    retrieve their own images -> AePoseEstimator estimates on a frame of
    them, as after a local training (the JAX package's
    tests/test_tf_parity.py::test_import_cli_full_flow, through the port)."""
    from augmentedautoencoder_torch.pose import AePoseEstimator, BoundingBox

    from _torch_port_ws import write_test_cfg

    payload = torch.load(imported["path"], map_location="cpu", weights_only=True)
    assert payload["step"] == 77 and set(payload) >= {"params", "decoder", "embedding_normalized", "embed_obj_bbs"}
    paths = factory.experiment_paths("imported_exp")
    assert os.path.exists(paths["cfg_file"]) and os.path.exists(paths["exp_cfg_file"])

    codebook = factory.build_codebook_from_name("imported_exp", device="cpu")
    imgs = FX.images(FX.N_TEST + FX.N_ROWS)
    z = codebook.test_embedding(imgs[0], normalized=False)
    np.testing.assert_allclose(z, np.load(os.path.join(FIXTURE, "codes.npy"))[0], atol=CODE_ATOL, rtol=0)
    rows = [0, 17, 33, 49]
    idcs = codebook.nearest_rotation(imgs[[FX.N_TEST + r for r in rows]], return_idcs=True)
    np.testing.assert_array_equal(np.asarray(idcs).ravel(), rows)

    # a 128x128 frame holding those images in 32x32 boxes (PAD_FACTOR 1 crops them unchanged)
    frame = np.zeros((128, 128, 3), np.uint8)
    boxes = []
    for k, r in enumerate(rows):
        x0, y0 = 32 * k, 32 * (k % 2) + 16
        frame[y0:y0 + 32, x0:x0 + 32] = imgs[FX.N_TEST + r]
        boxes.append(BoundingBox(x0 / 128, y0 / 128, (x0 + 32) / 128, (y0 + 32) / 128, {"cls": 1.0}))
    est = AePoseEstimator(write_test_cfg(tmp_path / "test.cfg", {"cls": "imported_exp"}), device="cpu")
    poses = est.process(bboxes=boxes, color_img=frame, camK=np.array([[100.0, 0, 64], [0, 100.0, 64], [0, 0, 1]]))
    assert len(poses) == len(rows) and all(np.isfinite(p.trafo).all() for p in poses)


def test_import_without_codebook_and_step_from_the_prefix(tmp_path, monkeypatch):
    """A checkpoint without the codebook variables imports the weights
    alone; --step overrides the prefix's step."""
    reader_vars = {k: v for k, v in load_tf_checkpoint_variables(PREFIX, SCOPE).items()
                   if k not in ("embedding_normalized", "embed_obj_bbs_var")}
    monkeypatch.setattr(tf_interop, "load_tf_checkpoint_variables", lambda path, scope: reader_vars)
    path = tf_interop.import_reference_checkpoint(PREFIX, SCOPE, str(tmp_path / "ckpt"), step=5,
                                                  num_filters=tuple(FX.FILTERS))
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert payload["step"] == 5 and "embedding_normalized" not in payload and "decoder" in payload
    root = str(tmp_path / "ws")
    monkeypatch.setenv(ws.WORKSPACE_ENV_VAR, root)
    ws.init_workspace(root)
    out = ae_import_tf.main([PREFIX, "grp/exp", "--cfg", os.path.join(FIXTURE, "train.cfg"), "--scope", SCOPE,
                             "--step", "9"])
    assert out == CheckpointManager(factory.experiment_paths("exp", "grp")["checkpoint_dir"]).path_for_step(9)


def _vae_vars(with_sigma):
    """The JAX test's dict of a (variational) reference checkpoint."""
    rng = np.random.RandomState(0)
    v = {
        "conv2d/kernel": rng.randn(5, 5, 3, 8).astype(np.float32), "conv2d/bias": np.zeros(8, np.float32),
        "conv2d_1/kernel": rng.randn(5, 5, 8, 16).astype(np.float32), "conv2d_1/bias": np.zeros(16, np.float32),
        "dense/kernel": rng.randn(1024, 8).astype(np.float32), "dense/bias": np.zeros(8, np.float32),
    }
    dec = "dense_2" if with_sigma else "dense_1"
    if with_sigma:
        v["dense_1/kernel"] = rng.randn(1024, 8).astype(np.float32)
        v["dense_1/bias"] = np.full(8, 0.5, np.float32)
    v[f"{dec}/kernel"] = rng.randn(8, 1024).astype(np.float32)
    v[f"{dec}/bias"] = np.zeros(1024, np.float32)
    v["dense/kernel/Adam"] = np.ones((1024, 8), np.float32)  # an optimizer slot, skipped
    for i, (cin, cout) in enumerate([(16, 8), (8, 3)]):
        v[f"conv2d_{2 + i}/kernel"] = rng.randn(5, 5, cin, cout).astype(np.float32)
        v[f"conv2d_{2 + i}/bias"] = np.zeros(cout, np.float32)
    return v


@pytest.mark.parametrize("with_sigma,variational,raises", [
    (True, True, None), (False, False, None), (True, False, "q_sigma dense"), (False, True, "no q_sigma dense"),
], ids=["vae", "plain", "vae_without_flag", "flag_without_sigma"])
def test_variational_split_as_the_jax_package(with_sigma, variational, raises):
    """reference_params_to_flax on the same variables as the JAX package's
    (numpy on both sides): the same tree, or the same refusal."""
    from augmentedautoencoder_tpu.training import tf_interop as jax_interop

    tf_vars = _vae_vars(with_sigma)
    if raises:
        for mod in (tf_interop, jax_interop):
            with pytest.raises(ValueError, match=raises):
                mod.reference_params_to_flax(tf_vars, num_filters=(8, 16), variational=variational)
        return
    got = tf_interop.reference_params_to_flax(tf_vars, num_filters=(8, 16), variational=variational)
    want = jax_interop.reference_params_to_flax(tf_vars, num_filters=(8, 16), variational=variational)
    flat_got, flat_want = params_from_jax(got["params"], None, decoder=True), params_from_jax(want["params"], None,
                                                                                             decoder=True)
    assert set(flat_got) == set(flat_want)
    assert all(torch.equal(flat_got[k], flat_want[k]) for k in flat_want)
    assert ("encoder.latent_sigma.weight" in flat_got) == with_sigma
    model = AAE(input_shape=(32, 32, 3), latent_space_size=8, num_filters=(8, 16), strides=(2, 2),
                variational=0.5 if with_sigma else 0.0, decoder=True)
    model.load_state_dict(flat_got)  # every key and shape the port's model has


def _index_bytes():
    with open(PREFIX + ".index", "rb") as fh:
        return bytearray(fh.read())


def _first_data_block(data):
    """(offset, size) of the index's first data block (footer -> index block)."""
    from augmentedautoencoder_torch.training import tf_bundle

    footer = bytes(data[-tf_bundle.FOOTER_BYTES:])
    _, pos = tf_bundle._handle(footer)
    (offset, size), _ = tf_bundle._handle(footer, pos)
    _, handle = next(tf_bundle._entries(tf_bundle._block(bytes(data), offset, size)))
    return tf_bundle._handle(handle)[0]


def _corrupt(kind):
    data = _index_bytes()
    if kind == "truncated":
        return data[:-7]
    if kind == "compressed":
        offset, size = _first_data_block(data)
        data[offset + size] = 1  # the trailer's compression type: snappy
        return data
    if kind == "bad_handle":  # the index block's offset (after the 3-byte metaindex handle) -> 16,383
        assert data[-45:-42] == b"\x95\x04\x0f"
        data[-45], data[-44] = 0xFF, 0x7F
        return data
    if kind == "bool_tensor":  # conv2d/bias's dtype field 1 -> 10 (DT_BOOL)
        at = bytes(data).index(b"tf_exp/conv2d/bias") + len("tf_exp/conv2d/bias")
        assert data[at:at + 2] == b"\x08\x01"
        data[at + 1] = 10
        return data
    if kind == "wrong_size":  # conv2d/bias's size field 32 -> 36 bytes
        at = bytes(data).index(b"tf_exp/conv2d/bias") + len("tf_exp/conv2d/bias")
        at = bytes(data).index(b"( ", at)
        data[at + 1] = 36
        return data
    raise ValueError(kind)


@pytest.mark.parametrize("kind,match", [
    ("truncated", "magic"), ("compressed", "compressed"), ("bad_handle", "runs past"),
    ("bool_tensor", "dtype 10"), ("wrong_size", "36 bytes"),
])
def test_bad_checkpoints_raise(kind, match, tmp_path):
    prefix = str(tmp_path / "chkpt-77")
    shutil.copy(PREFIX + ".data-00000-of-00001", prefix + ".data-00000-of-00001")
    with open(prefix + ".index", "wb") as fh:
        fh.write(bytes(_corrupt(kind)))
    with pytest.raises(CheckpointFormatError, match=match):
        load_tf_checkpoint_variables(prefix, SCOPE)


def test_sliced_and_truncated_data_raise(tmp_path):
    """A BundleEntryProto with slices (field 7) is refused; a data file that
    ends before a tensor's bytes too."""
    entry = _entry("t", bytes([0x08, 0x01, 0x12, 0x04, 0x12, 0x02, 0x08, 0x02, 0x28, 0x08, 0x3A, 0x00]))
    assert entry["sliced"] and entry["shape"] == [2] and entry["size"] == 8
    reader = TFCheckpointReader(PREFIX)
    reader._entries["tf_exp/conv2d/bias"]["sliced"] = True
    with pytest.raises(CheckpointFormatError, match="sliced"):
        reader.tensor("tf_exp/conv2d/bias")
    prefix = str(tmp_path / "chkpt-77")
    shutil.copy(PREFIX + ".index", prefix + ".index")
    with open(PREFIX + ".data-00000-of-00001", "rb") as fh:
        data = fh.read()
    with open(prefix + ".data-00000-of-00001", "wb") as fh:
        fh.write(data[:len(data) // 2])
    with pytest.raises(CheckpointFormatError, match="ends before"):
        load_tf_checkpoint_variables(prefix)


def test_directory_resolves_to_its_newest_checkpoint(tmp_path):
    for suffix in (".index", ".data-00000-of-00001"):
        shutil.copy(PREFIX + suffix, str(tmp_path / ("chkpt-77" + suffix)))
    (tmp_path / "checkpoint").write_text('model_checkpoint_path: "chkpt-77"\nall_model_checkpoint_paths: "chkpt-77"\n')
    got = load_tf_checkpoint_variables(str(tmp_path), SCOPE)
    want = load_tf_checkpoint_variables(PREFIX, SCOPE)
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)


# ------------------------------------------------------------------ with TensorFlow

def _tf_checkpoint(kind, tmp_path):
    """A fresh TF1 checkpoint (graph mode, tf.layers' names under `exp`)."""
    tf_root = pytest.importorskip("tensorflow")
    tf = tf_root.compat.v1
    import _tf_refgraph

    dims = {"vae": ([8, 16], 32, 8), "adam": ([8, 16], 32, 8), "full_width": ([128, 256, 512, 512], 128, 128)}[kind]
    filters, hw, latent = dims
    graph = tf.Graph()
    with graph.as_default():
        tf.set_random_seed(3)
        with tf.variable_scope("exp"):
            x = tf.placeholder(tf.float32, [None, hw, hw, 3])
            if kind == "vae":  # dense (z), dense_1 (q_sigma), then the decoder's dense_2
                _tf_refgraph._counters.clear()
                net = x
                for f in filters:
                    net = _tf_refgraph._conv2d(net, f, 2, tf.nn.relu)
                net = tf.reshape(net, [-1, int(np.prod(net.shape[1:]))])
                z = _tf_refgraph._dense(net, latent)
                _tf_refgraph._dense(net, latent, tf.nn.softplus)
                d = tf.reshape(_tf_refgraph._dense(z, 8 * 8 * filters[-1], tf.nn.relu), [-1, 8, 8, filters[-1]])
                d = _tf_refgraph._conv2d(tf.image.resize(d, [16, 16], method="nearest"), filters[0], 1, tf.nn.relu)
                recon = _tf_refgraph._conv2d(tf.image.resize(d, [hw, hw], method="nearest"), 3, 1, tf.nn.sigmoid)
            else:
                z, recon = _tf_refgraph.build_reference_graph(x, filters, [2] * len(filters), latent, hw, hw)
            tf.Variable(np.random.RandomState(0).rand(50, latent).astype(np.float32), trainable=False,
                        name="embedding_normalized")
            tf.Variable(np.random.RandomState(1).randint(0, 99, (50, 4)).astype(np.int32), trainable=False,
                        name="embed_obj_bbs_var")
        train_op = None
        if kind == "adam":
            step = tf.train.get_or_create_global_step()
            loss = tf.reduce_mean((recon - x) ** 2)
            train_op = tf.train.AdamOptimizer(1e-3).minimize(loss, global_step=step)
        saver = tf.train.Saver()
        with tf.Session(graph=graph) as sess:
            sess.run(tf.global_variables_initializer())
            if train_op is not None:
                sess.run(train_op, {x: np.random.RandomState(2).rand(2, hw, hw, 3).astype(np.float32)})
            return saver.save(sess, str(tmp_path / "chkpt"), global_step=11, write_meta_graph=False)


@pytest.mark.parametrize("kind", ["vae", "adam", "full_width"])
def test_reader_equals_tensorflow(kind, tmp_path):
    """Every variable TensorFlow lists, bit for bit (names, dtypes, shapes,
    bytes); the Adam checkpoint holds its slots, beta powers and the int64
    global step."""
    prefix = _tf_checkpoint(kind, tmp_path)
    from tensorflow.python.training import checkpoint_utils

    reader = TFCheckpointReader(prefix)
    names = [n for n, _ in checkpoint_utils.list_variables(prefix)]
    assert reader.names() == sorted(names)
    for name in names:
        want, got = checkpoint_utils.load_variable(prefix, name), reader.tensor(name)
        assert got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes(), name
    if kind == "adam":
        assert "exp/conv2d/kernel/Adam" in names and reader.tensor("global_step").dtype == np.int64
    if kind == "full_width":
        assert reader.tensor("exp/dense/kernel").shape == (8 * 8 * 512, 128)


@pytest.mark.parametrize("kind", ["fixture", "vae", "adam"])
def test_import_equals_the_jax_import(kind, tmp_path):
    """The port's import_reference_checkpoint against the JAX package's on
    the same checkpoint: the same state dict and codebook."""
    pytest.importorskip("tensorflow")
    from augmentedautoencoder_tpu.training.checkpoint import CheckpointManager as JaxCheckpoints
    from augmentedautoencoder_tpu.training.tf_interop import import_reference_checkpoint as jax_import

    prefix, scope = (PREFIX, SCOPE) if kind == "fixture" else (_tf_checkpoint(kind, tmp_path), "exp")
    kw = dict(step=11, num_filters=(8, 16), variational=kind == "vae")
    jax_import(prefix, scope, str(tmp_path / "jax"), **kw)
    want = JaxCheckpoints(str(tmp_path / "jax")).restore()
    got = torch.load(tf_interop.import_reference_checkpoint(prefix, scope, str(tmp_path / "port"), **kw),
                     map_location="cpu", weights_only=True)
    want_state = params_from_jax(want["params"], None, decoder=True)
    got_state = {**got["params"], **got["batch_stats"], **got["decoder"]}
    assert set(got_state) == set(want_state)
    assert all(torch.equal(got_state[k], want_state[k]) for k in want_state)
    np.testing.assert_array_equal(got["embedding_normalized"].numpy(), np.asarray(want["embedding_normalized"]))
    np.testing.assert_array_equal(got["embed_obj_bbs"].numpy(), np.asarray(want["embed_obj_bbs"]))
