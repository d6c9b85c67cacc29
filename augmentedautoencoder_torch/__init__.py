"""augmentedautoencoder_torch -- the PyTorch / CUDA (Hopper) port of aae_tpu.

A second package beside `augmentedautoencoder_tpu`, which stays the
reference. Module names mirror the JAX package's, so each counterpart is
found at the same path. This slice serves RGB poses from a converted
checkpoint:

  PoseServer / AePoseEstimator -> crop -> Encoder -> codebook top-1 / top-k
  (hand-written CUDA kernels, csrc/codebook_query.cu) -> projective 6D pose

Importing the package loads no kernel and needs neither jax nor OpenCV;
kernels are compiled with nvcc on first use on a GPU (ops/_cuda.py).
"""

__version__ = "0.1.0"
