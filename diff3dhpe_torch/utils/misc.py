"""Small host-side utilities (reference: common/utils.py:46-49)."""
from __future__ import annotations

import hashlib


def deterministic_random(min_value: int, max_value: int, data: str) -> int:
    """Seed-free deterministic integer in [min_value, max_value) derived from
    a SHA-256 hash of ``data`` — used for reproducible dataset subsetting."""
    digest = hashlib.sha256(data.encode()).digest()
    raw_value = int.from_bytes(digest[:4], byteorder="little", signed=False)
    return int(raw_value / (2 ** 32 - 1) * (max_value - min_value)) + min_value
