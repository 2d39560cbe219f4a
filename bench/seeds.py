"""Seeds of everything a run makes, derived from ``--seed``."""
from __future__ import annotations

import hashlib


def derive(seed: int, *path) -> int:
    """A 63-bit seed for the stream named by ``path`` under ``seed`` (any
    whole number): the first 8 bytes of BLAKE2b over both, so streams of one
    run never share a seed and the same arguments always give the same one."""
    text = repr((int(seed),) + tuple(path)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1
