"""Generic helpers (copy of the part of augmentedautoencoder_tpu/utils/misc.py
the codebook embedding uses).

  * batch_iteration_indices -- auto_pose/ae/utils.py:20-26
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def batch_iteration_indices(n: int, batch_size: int) -> Iterator[Tuple[int, int]]:
    """Yield (start, end) index pairs covering [0, n) in batch_size chunks."""
    num = int(np.ceil(float(n) / float(batch_size)))
    for i in range(num):
        start = i * batch_size
        end = min(start + batch_size, n)
        yield (start, end)
