"""Reference-compatible pickle I/O.

The reference stores daily-gridded data and results as protocol-2 pickles,
writing in < 2 GiB chunks to dodge an old macOS ``fwrite`` bug
(``read_and_bin.py:15-21``) and reading
with a plain ``pickle.load`` (``GPR_CS2S3.py:36-46``). Same wire format here
so datasets interchange freely.

Copy of ``optimalinterpolation_tpu/io/pickles.py``, kept
until the JAX package's ``__init__`` is lazy (importing any module of it
imports jax today).
"""

from __future__ import annotations

import pickle

_MAX_CHUNK = 2**31 - 1


def save_pickle(obj, path: str, protocol: int = 2) -> None:
    """Chunked protocol-2 pickle write (read_and_bin.py:15-21 semantics)."""
    payload = pickle.dumps(obj, protocol=protocol)
    with open(path, "wb") as f:
        for start in range(0, len(payload), _MAX_CHUNK):
            f.write(payload[start : start + _MAX_CHUNK])


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)
