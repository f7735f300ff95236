"""Serialization helpers: JSON files with atomic writes.

Role parity: [U] falcon_unzip/io.py::serialize/deserialize (msgpack or
json chosen by filename extension) used for read_to_contig_map,
rawread_to_contigs and friends (SURVEY.md §2a IO utils).  This program
writes and reads JSON whatever the extension, so it needs no package
beyond the standard library; columnar numpy payloads travel as ``.npz``
bytes (parallel.distributed.pack_arrays).  Atomic write-tmp-then-rename
matches the reference's crash-safety convention (SURVEY.md §5 race
detection).
"""
from __future__ import annotations

import json
import os

import numpy as np


def _to_plain(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    return obj


def serialize(path: str, obj) -> None:
    """Write obj to path as JSON, atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(_to_plain(obj), fh)
    os.replace(tmp, path)


def deserialize(path: str):
    with open(path) as fh:
        return json.load(fh)
