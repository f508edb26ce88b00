"""Shape padding helpers.

Index capacities and query batches are padded to aligned sizes and masked with
sentinels, as in the JAX package, so both packages see the same shapes.
"""

from __future__ import annotations

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_to(arr: np.ndarray, n: int, fill, axis: int = 0) -> np.ndarray:
    """Pad `arr` along `axis` up to length `n` with `fill`."""
    cur = arr.shape[axis]
    if cur == n:
        return arr
    if cur > n:
        raise ValueError(f"cannot pad axis {axis} from {cur} down to {n}")
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, n - cur)
    return np.pad(arr, widths, constant_values=fill)
