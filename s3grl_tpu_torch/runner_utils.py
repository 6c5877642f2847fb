"""Small shared runner helpers (a copy of ``s3grl_tpu/runner_utils.py``)."""
from __future__ import annotations


def round_up_pow2(x: int) -> int:
    """Smallest power of two >= x (minimum 8)."""
    x = max(int(x), 8)
    return 1 << (x - 1).bit_length()
