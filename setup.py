"""Packaging for aae_tpu (TPU-native Augmented Autoencoder framework).

Console scripts mirror the reference CLI surface (reference setup.py:11-16).
"""

from setuptools import find_packages, setup

setup(
    name="augmentedautoencoder_tpu",
    version="0.1.0",
    description="TPU-native Augmented Autoencoder: implicit 3D orientation "
    "learning for 6D object detection (JAX/XLA/Pallas rebuild)",
    packages=find_packages(exclude=("tests",)),
    package_data={
        "augmentedautoencoder_tpu": [
            "cfg_templates/*.cfg",
            "cfg_templates/cfg_m3vision/*.cfg",
        ],
        "augmentedautoencoder_torch": [
            "csrc/*.cu",
            "csrc/*.cuh",
            "csrc/*.h",
            "renderer/native/*.cpp",
            "renderer/native/*.h",
            "cfg_templates/*.cfg",
            "cfg_templates/cfg_m3vision/*.cfg",
        ],
    },
    python_requires=">=3.10",
    entry_points={
        "console_scripts": [
            "ae_init_workspace = augmentedautoencoder_tpu.cli.ae_init_workspace:main",
            "ae_train = augmentedautoencoder_tpu.cli.ae_train:main",
            "ae_embed = augmentedautoencoder_tpu.cli.ae_embed:main",
            "ae_eval = augmentedautoencoder_tpu.cli.ae_eval:main",
            "aae_image = augmentedautoencoder_tpu.cli.aae_image:main",
            "aae_webcam = augmentedautoencoder_tpu.cli.aae_webcam:main",
            "detector_webcam_pose = augmentedautoencoder_tpu.cli.detector_webcam_pose:main",
            "generate_syn_det_train = augmentedautoencoder_tpu.cli.generate_syn_det_train:main",
            "generate_sixd_train = augmentedautoencoder_tpu.cli.generate_sixd_train:main",
            "compute_bop_results = augmentedautoencoder_tpu.cli.compute_bop_results:main",
            "compute_eval_errors = augmentedautoencoder_tpu.cli.compute_eval_errors:main",
            "ae_import_tf = augmentedautoencoder_tpu.cli.ae_import_tf:main",
        ]
    },
)
