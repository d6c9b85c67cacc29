"""augmentedautoencoder_torch -- the PyTorch / CUDA (Hopper) port of aae_tpu.

A second package beside `augmentedautoencoder_tpu`, which stays the
reference. Module names mirror the JAX package's, so each counterpart is
found at the same path; the framework-neutral modules it needs (config,
workspace, geometry, the renderer) are copied, since the port imports
nothing of the JAX package. It serves poses from a converted checkpoint:

  PoseServer / AePoseEstimator -> crop -> Encoder -> codebook top-1 / top-k
  (hand-written CUDA kernels, csrc/codebook_query.cu) -> projective 6D pose
  [-> with a depth image: depth re-scoring and/or 3-stage ICP, whose
  nearest-neighbour step is csrc/icp_nn.cu]

Importing the package loads no kernel and needs neither jax nor OpenCV;
kernels are compiled with nvcc on first use on a GPU (ops/_cuda.py), the
host rasterizer with g++ on first use (renderer/native). Entry points run
on the GPU unless given device="cpu".
"""

__version__ = "0.1.0"
