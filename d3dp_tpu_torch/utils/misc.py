"""Small utilities. Counterpart of d3dp_tpu/utils/misc.py (reference:
common/utils.py:37-40)."""

import hashlib


def deterministic_random(min_value, max_value, data):
    """SHA256-seeded deterministic subset sampling."""
    digest = hashlib.sha256(data.encode()).digest()
    raw_value = int.from_bytes(digest[:4], byteorder="little", signed=False)
    return int(raw_value / (2**32 - 1) * (max_value - min_value)) + min_value
