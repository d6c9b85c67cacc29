"""The benchmark of the PyTorch port (`augmentedautoencoder_torch`) on an
NVIDIA H100: `run.py` runs one cell of BENCHMARK.json (README.md)."""
