"""Writes the TF1-layout checkpoint fixture into tf_ckpt/ beside this file.

    python tests/fixtures/torch_port/make_tf_fixture.py

needs TensorFlow (tf.compat.v1). The reference AAE's graph at 32x32x3,
filters [8, 16], stride 2, kernel 5, latent 8 (tests/_tf_refgraph.py:
tf.layers' variable names under the scope `tf_exp`), with the codebook in
the checkpoint as the reference keeps it: `embedding_normalized` (50, 8),
the unit-length TF codes of `images(54)[4:]`, and `embed_obj_bbs_var`
(50, 4) int32. Saved by `tf.train.Saver` (V2 format, no .meta graph) as
tf_ckpt/chkpt-77.{index,data-00000-of-00001}, beside:

  * codes.npy   (4, 8) f32, TensorFlow's latent codes of `images(54)[:4]`
    / 255 (the 4 test inputs);
  * recon.npy   (4, 32, 32, 3) f16, TensorFlow's reconstructions of them;
  * manifest.json  each variable's dtype, shape and the sha256 of its
    bytes, as TensorFlow's checkpoint_utils reads them;
  * train.cfg   the experiment's cfg for ae_import_tf (PAD_FACTOR 1, so
    a 32x32 box crops an image unchanged; 12 x 5 = 60 codebook rotations,
    the first 50 of which the rows index).

`images` is importable without TensorFlow: the port's tests and
chip_smoke.py regenerate the test inputs and the 50 codebook images from it.
"""

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "tf_ckpt")
SCOPE = "tf_exp"
HW, FILTERS, STRIDES, LATENT, KERNEL = 32, [8, 16], [2, 2], 8, 5
STEP = 77
N_TEST, N_ROWS = 4, 50

TRAIN_CFG = f"""[Paths]
MODEL_PATH: /nonexistent/model.ply
BACKGROUND_IMAGES_GLOB: /nonexistent/*.jpg

[Dataset]
MODEL: reconst
H: {HW}
W: {HW}
C: 3
RADIUS: 700
RENDER_DIMS: (128, 96)
K: [100, 0, 64, 0, 100, 48, 0, 0, 1]
VERTEX_SCALE: 1
ANTIALIASING: 1
PAD_FACTOR: 1.0
CLIP_NEAR: 10
CLIP_FAR: 10000
NOOF_TRAINING_IMGS: 4
NOOF_BG_IMGS: 0

[Embedding]
EMBED_BB: True
MIN_N_VIEWS: 12
NUM_CYCLO: 5

[Network]
BATCH_NORMALIZATION: False
AUXILIARY_MASK: False
VARIATIONAL: 0
LOSS: L2
BOOTSTRAP_RATIO: 4
NORM_REGULARIZE: 0
LATENT_SPACE_SIZE: {LATENT}
NUM_FILTER: {FILTERS}
STRIDES: {STRIDES}
KERNEL_SIZE_ENCODER: {KERNEL}
KERNEL_SIZE_DECODER: {KERNEL}

[Training]
OPTIMIZER: Adam
NUM_ITER: 10
BATCH_SIZE: 8
LEARNING_RATE: 1e-3
SAVE_INTERVAL: 10
"""


def images(n: int, seed: int = 12) -> np.ndarray:
    """(n, 32, 32, 3) uint8: blocky colour fields (4x4 cells of 8x8 pixels)
    plus noise, each image with its own brightness, so their codes differ."""
    rng = np.random.RandomState(seed)
    cells = rng.randint(0, 256, (n, 4, 4, 3)) * rng.uniform(0.3, 1.0, (n, 1, 1, 1))
    img = np.repeat(np.repeat(cells, 8, axis=1), 8, axis=2) + rng.randint(-20, 21, (n, HW, HW, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    import tensorflow as tf_root

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from _tf_refgraph import build_reference_graph

    tf = tf_root.compat.v1
    tf.disable_eager_execution()
    os.makedirs(OUT, exist_ok=True)
    imgs = images(N_TEST + N_ROWS)
    x_val = imgs.astype(np.float32) / 255.0
    rng = np.random.RandomState(STEP)
    graph = tf.Graph()
    with graph.as_default():
        tf.set_random_seed(STEP)
        with tf.variable_scope(SCOPE):
            x = tf.placeholder(tf.float32, [None, HW, HW, 3])
            z, recon = build_reference_graph(x, FILTERS, STRIDES, LATENT, HW, HW, kernel=KERNEL)
            emb = tf.Variable(np.zeros((N_ROWS, LATENT), np.float32), trainable=False, name="embedding_normalized")
            bbs = tf.Variable(rng.randint(0, 100, (N_ROWS, 4)).astype(np.int32), trainable=False,
                              name="embed_obj_bbs_var")
        saver = tf.train.Saver()
        with tf.Session(graph=graph) as sess:
            sess.run(tf.global_variables_initializer())
            z_val, recon_val = sess.run([z, recon], {x: x_val})
            rows = z_val[N_TEST:] / np.linalg.norm(z_val[N_TEST:], axis=1, keepdims=True)
            sess.run(emb.assign(rows))
            saver.save(sess, os.path.join(OUT, "chkpt"), global_step=STEP, write_meta_graph=False)
    os.remove(os.path.join(OUT, "checkpoint"))  # the prefix is given by name
    from tensorflow.python.training import checkpoint_utils

    prefix = os.path.join(OUT, f"chkpt-{STEP}")
    manifest = {}
    for name, _ in checkpoint_utils.list_variables(prefix):
        value = checkpoint_utils.load_variable(prefix, name)
        manifest[name] = {"dtype": str(value.dtype), "shape": list(value.shape),
                          "sha256": hashlib.sha256(value.tobytes()).hexdigest()}
    with open(os.path.join(OUT, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    cos = rows @ rows.T
    np.fill_diagonal(cos, -1.0)
    np.save(os.path.join(OUT, "codes.npy"), z_val[:N_TEST])
    np.save(os.path.join(OUT, "recon.npy"), recon_val[:N_TEST].astype(np.float16))
    with open(os.path.join(OUT, "train.cfg"), "w") as fh:
        fh.write(TRAIN_CFG)
    size = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"wrote {OUT} ({size} bytes; tensorflow {tf_root.__version__}); the rows' largest cosine to another "
          f"row {cos.max():.6f}")


if __name__ == "__main__":
    main()
