"""Typed training configuration, loaded from the reference's .cfg grammar.

Covers every key in the reference train template
(auto_pose/ae/cfg/train_template.cfg, documented README.md:246-345).
Section/key names and defaults are preserved so reference config files load
unchanged; values are parsed with `safe_eval` instead of `eval`.
"""

from __future__ import annotations

import configparser
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..data import augment_spec
from .safe_eval import safe_eval


def _aug_env():
    return {name: ctor for name, ctor in augment_spec.DSL_CONSTRUCTORS.items()}


@dataclasses.dataclass
class TrainConfig:
    # [Paths]
    model_path: str = ""
    background_images_glob: str = ""

    # [Dataset]
    model: str = "reconst"  # 'cad' | 'reconst'
    h: int = 128
    w: int = 128
    c: int = 3
    radius: float = 700.0
    render_dims: Tuple[int, int] = (720, 540)
    k: Tuple[float, ...] = (1075.65, 0, 360, 0, 1073.90, 270, 0, 0, 1)
    vertex_scale: float = 1.0
    antialiasing: int = 1
    # LOD for the offline CPU renderer: decimate meshes above this face
    # count before rendering (0 = off). New capability — the reference's GL
    # path has hardware per-face setup and needs no LOD.
    max_render_faces: int = 0
    pad_factor: float = 1.2
    clip_near: float = 10.0
    clip_far: float = 10000.0
    noof_training_imgs: int = 20000
    noof_bg_imgs: int = 15000

    # [Augmentation]
    realistic_occlusion: float = 0.0
    square_occlusion: float = 0.0
    # probability of pasting another sample's render into the background
    # (neighbor clutter for multi-instance robustness; new, no reference
    # equivalent — the reference relies on tight detector boxes)
    neighbor_clutter: float = 0.0
    # number of independent neighbor pastes per image and the relative
    # shift range (fraction of crop size) each paste is rolled by; the
    # defaults reproduce the round-2 single-neighbor stream bit-for-bit
    neighbor_clutter_count: int = 1
    neighbor_clutter_shift: Tuple[float, float] = (0.35, 0.9)
    max_rel_offset: float = 0.20
    code: Optional[augment_spec.AugSpec] = None

    # [Embedding]
    embed_bb: bool = True
    min_n_views: int = 2562
    num_cyclo: int = 36

    # [Network]
    batch_normalization: bool = False
    auxiliary_mask: bool = False
    variational: float = 0.0
    loss: str = "L2"
    bootstrap_ratio: int = 4
    norm_regularize: float = 0.0
    latent_space_size: int = 128
    num_filter: List[int] = dataclasses.field(default_factory=lambda: [128, 256, 512, 512])
    strides: List[int] = dataclasses.field(default_factory=lambda: [2, 2, 2, 2])
    kernel_size_encoder: int = 5
    kernel_size_decoder: int = 5

    # [Training]
    optimizer: str = "Adam"
    num_iter: int = 30000
    batch_size: int = 64
    learning_rate: float = 2e-4
    save_interval: int = 10000
    precision: str = "float32"  # activation compute dtype: float32 | bfloat16
    topk_mode: str = "exact"  # bootstrapped-loss top-k: exact | sort | approx

    # [Queue] — host prefetch depth in the TPU build (reference used a
    # tf.FIFOQueue + 10 threads, auto_pose/ae/queue.py:27-74)
    num_threads: int = 10
    queue_size: int = 50

    # raw parser kept around for cache keys & round-tripping
    _raw: Optional[configparser.ConfigParser] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    # ------------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.h, self.w, self.c)

    @property
    def model_paths(self) -> List[str]:
        """The meshes of `[Paths] MODEL_PATH`: one path, or a list of paths
        (`['a.ply', 'b.ply', ...]`), one object each. A list of n_o > 1
        meshes trains one multi-path model: a shared encoder and a decoder
        for each object (Sundermeyer et al., CVPR 2020)."""
        if self.model_path.lstrip().startswith("["):
            return [str(p) for p in safe_eval(self.model_path)]
        return [self.model_path]

    @property
    def n_objects(self) -> int:
        return len(self.model_paths)

    def for_object(self, index: int) -> "TrainConfig":
        """This configuration for object `index` of MODEL_PATH alone (itself
        where there is one object): its mesh as MODEL_PATH, so its renders
        are cached under the key a one-object cfg of that mesh has."""
        if self.n_objects == 1:
            return self
        path = self.model_paths[index]
        raw = None
        if self._raw is not None:
            raw = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
            raw.read_dict({s: dict(self._raw.items(s, raw=True)) for s in self._raw.sections()})
            raw.set("Paths", "MODEL_PATH", path)
        return dataclasses.replace(self, model_path=path, _raw=raw)

    @property
    def K(self) -> np.ndarray:
        return np.asarray(self.k, dtype=np.float64).reshape(3, 3)

    @property
    def embedding_size(self) -> int:
        # views from hinter sampling can exceed min_n_views; resolved lazily
        # by the Dataset. This is the nominal 2562*36 = 92,232 figure.
        return self.min_n_views * self.num_cyclo

    def dataset_cache_items(self) -> str:
        """String keyed into the md5 dataset cache (reference keys on the
        raw (Dataset + Paths) section items, auto_pose/ae/dataset.py:83-84)."""
        if self._raw is not None:
            items = list(self._raw.items("Dataset")) + list(self._raw.items("Paths"))
            return str(items)
        return str(
            [
                ("model", self.model),
                ("h", self.h),
                ("w", self.w),
                ("c", self.c),
                ("radius", self.radius),
                ("render_dims", self.render_dims),
                ("k", self.k),
                ("vertex_scale", self.vertex_scale),
                ("antialiasing", self.antialiasing),
            ]
            + (
                # only keyed when on, so existing caches stay valid
                [("max_render_faces", self.max_render_faces)]
                if self.max_render_faces
                else []
            )
            + [
                ("pad_factor", self.pad_factor),
                ("clip_near", self.clip_near),
                ("clip_far", self.clip_far),
                ("noof_training_imgs", self.noof_training_imgs),
                ("model_path", self.model_path),
                ("background_images_glob", self.background_images_glob),
            ]
        )


def _get(cp: configparser.ConfigParser, section: str, option: str, default):
    if not cp.has_option(section, option):
        return default
    raw = cp.get(section, option)
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(default, int) and not isinstance(default, bool):
        return int(float(safe_eval(raw)))
    if isinstance(default, float):
        v = safe_eval(raw)
        return float(v)
    if isinstance(default, str):
        return raw
    return safe_eval(raw)


def load_train_config(path_or_parser) -> TrainConfig:
    """Load a TrainConfig from a .cfg path or a prepared ConfigParser."""
    if isinstance(path_or_parser, configparser.ConfigParser):
        cp = path_or_parser
    else:
        cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        with open(path_or_parser) as fh:
            cp.read_string(fh.read())

    cfg = TrainConfig(_raw=cp)

    cfg.model_path = _get(cp, "Paths", "MODEL_PATH", cfg.model_path)
    cfg.background_images_glob = _get(
        cp, "Paths", "BACKGROUND_IMAGES_GLOB", cfg.background_images_glob
    )

    cfg.model = _get(cp, "Dataset", "MODEL", cfg.model)
    cfg.h = _get(cp, "Dataset", "H", cfg.h)
    cfg.w = _get(cp, "Dataset", "W", cfg.w)
    cfg.c = _get(cp, "Dataset", "C", cfg.c)
    cfg.radius = _get(cp, "Dataset", "RADIUS", cfg.radius)
    if cp.has_option("Dataset", "RENDER_DIMS"):
        cfg.render_dims = tuple(safe_eval(cp.get("Dataset", "RENDER_DIMS")))
    if cp.has_option("Dataset", "K"):
        cfg.k = tuple(safe_eval(cp.get("Dataset", "K")))
    cfg.vertex_scale = _get(cp, "Dataset", "VERTEX_SCALE", cfg.vertex_scale)
    cfg.antialiasing = _get(cp, "Dataset", "ANTIALIASING", cfg.antialiasing)
    cfg.max_render_faces = _get(
        cp, "Dataset", "MAX_RENDER_FACES", cfg.max_render_faces
    )
    cfg.pad_factor = _get(cp, "Dataset", "PAD_FACTOR", cfg.pad_factor)
    cfg.clip_near = _get(cp, "Dataset", "CLIP_NEAR", cfg.clip_near)
    cfg.clip_far = _get(cp, "Dataset", "CLIP_FAR", cfg.clip_far)
    cfg.noof_training_imgs = _get(
        cp, "Dataset", "NOOF_TRAINING_IMGS", cfg.noof_training_imgs
    )
    cfg.noof_bg_imgs = _get(cp, "Dataset", "NOOF_BG_IMGS", cfg.noof_bg_imgs)

    # REALISTIC_OCCLUSION / SQUARE_OCCLUSION are bool-or-float in the
    # reference (False, or a max-occlusion fraction; dataset.py:470-474)
    for attr, key in (
        ("realistic_occlusion", "REALISTIC_OCCLUSION"),
        ("square_occlusion", "SQUARE_OCCLUSION"),
        ("neighbor_clutter", "NEIGHBOR_CLUTTER"),
    ):
        if cp.has_option("Augmentation", key):
            v = safe_eval(cp.get("Augmentation", key))
            setattr(cfg, attr, float(v) if v else 0.0)
    cfg.neighbor_clutter_count = _get(
        cp, "Augmentation", "NEIGHBOR_CLUTTER_COUNT", cfg.neighbor_clutter_count
    )
    if cp.has_option("Augmentation", "NEIGHBOR_CLUTTER_SHIFT"):
        lo, hi = safe_eval(cp.get("Augmentation", "NEIGHBOR_CLUTTER_SHIFT"))
        cfg.neighbor_clutter_shift = (float(lo), float(hi))
    cfg.max_rel_offset = _get(cp, "Augmentation", "MAX_REL_OFFSET", cfg.max_rel_offset)
    if cp.has_option("Augmentation", "CODE"):
        cfg.code = safe_eval(
            cp.get("Augmentation", "CODE"), callables=_aug_env()
        )

    cfg.embed_bb = _get(cp, "Embedding", "EMBED_BB", cfg.embed_bb)
    cfg.min_n_views = _get(cp, "Embedding", "MIN_N_VIEWS", cfg.min_n_views)
    cfg.num_cyclo = _get(cp, "Embedding", "NUM_CYCLO", cfg.num_cyclo)

    cfg.batch_normalization = _get(
        cp, "Network", "BATCH_NORMALIZATION", cfg.batch_normalization
    )
    cfg.auxiliary_mask = _get(cp, "Network", "AUXILIARY_MASK", cfg.auxiliary_mask)
    cfg.variational = _get(cp, "Network", "VARIATIONAL", cfg.variational)
    cfg.loss = _get(cp, "Network", "LOSS", cfg.loss)
    cfg.bootstrap_ratio = _get(cp, "Network", "BOOTSTRAP_RATIO", cfg.bootstrap_ratio)
    cfg.norm_regularize = _get(cp, "Network", "NORM_REGULARIZE", cfg.norm_regularize)
    cfg.latent_space_size = _get(
        cp, "Network", "LATENT_SPACE_SIZE", cfg.latent_space_size
    )
    if cp.has_option("Network", "NUM_FILTER"):
        cfg.num_filter = [int(v) for v in safe_eval(cp.get("Network", "NUM_FILTER"))]
    if cp.has_option("Network", "STRIDES"):
        cfg.strides = [int(v) for v in safe_eval(cp.get("Network", "STRIDES"))]
    cfg.kernel_size_encoder = _get(
        cp, "Network", "KERNEL_SIZE_ENCODER", cfg.kernel_size_encoder
    )
    cfg.kernel_size_decoder = _get(
        cp, "Network", "KERNEL_SIZE_DECODER", cfg.kernel_size_decoder
    )

    cfg.optimizer = _get(cp, "Training", "OPTIMIZER", cfg.optimizer)
    cfg.num_iter = _get(cp, "Training", "NUM_ITER", cfg.num_iter)
    cfg.batch_size = _get(cp, "Training", "BATCH_SIZE", cfg.batch_size)
    cfg.learning_rate = _get(cp, "Training", "LEARNING_RATE", cfg.learning_rate)
    cfg.save_interval = _get(cp, "Training", "SAVE_INTERVAL", cfg.save_interval)
    cfg.precision = _get(cp, "Training", "PRECISION", cfg.precision)
    cfg.topk_mode = _get(cp, "Training", "TOPK_MODE", cfg.topk_mode)

    cfg.num_threads = _get(cp, "Queue", "NUM_THREADS", cfg.num_threads)
    cfg.queue_size = _get(cp, "Queue", "QUEUE_SIZE", cfg.queue_size)

    if cfg.batch_size % cfg.n_objects:
        raise ValueError(
            f"BATCH_SIZE {cfg.batch_size} does not divide by the {cfg.n_objects} objects of MODEL_PATH: "
            "a multi-path step draws BATCH_SIZE / n_objects rows of each object"
        )
    return cfg
