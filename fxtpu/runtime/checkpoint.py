"""Checkpoint / resume for long integrations.

The reference has no checkpointing (SURVEY.md §5.4); its only durability is
the 0.1 s append-to-CSV stream.  We keep that stream (a crash still loses at
most the in-flight queue) and add periodic snapshots of the correlator's
streaming state — PFB tap history, calibrated delays, visibility
accumulator, and the block counter — so a long integration resumes exactly
where it stopped (replay sources seek to the saved block index).

Format: a single ``.npz`` (atomic rename on write).  Orbax is available in
the image but is oversized for four small arrays; npz keeps resume
dependency-free and inspectable.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np

from fxtpu.ops.cplx import Cplx, from_complex, to_complex

STATE_VERSION = 1


def save_state(path: str, *, history, delays, blocks_processed: int,
               accumulator=None, accumulated: int = 0, meta: Optional[dict] = None):
    """Atomically snapshot streaming state.  ``history``/``accumulator`` may
    be Cplx planes or complex arrays."""
    payload = {
        "version": STATE_VERSION,
        "delays": np.asarray(delays, dtype=np.float64),
        "blocks_processed": np.int64(blocks_processed),
        "accumulated": np.int64(accumulated),
    }
    payload["history"] = _as_complex(history)
    if accumulator is not None:
        payload["accumulator"] = _as_complex(accumulator)
    if meta:
        for k, v in meta.items():
            payload[f"meta_{k}"] = v
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        # pass the open handle: np.savez would append '.npz' to a filename
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str) -> dict:
    """Load a snapshot; history/accumulator come back as Cplx planes."""
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != STATE_VERSION:
            raise ValueError(f"unknown checkpoint version {z['version']}")
        out = {
            "history": from_complex(np.ascontiguousarray(z["history"])),
            "delays": z["delays"],
            "blocks_processed": int(z["blocks_processed"]),
            "accumulated": int(z["accumulated"]),
            "accumulator": (from_complex(np.ascontiguousarray(z["accumulator"]))
                            if "accumulator" in z else None),
            "meta": {k[5:]: z[k] for k in z.files if k.startswith("meta_")},
        }
    return out


def _as_complex(x) -> np.ndarray:
    if isinstance(x, Cplx):
        return to_complex(x)
    return np.asarray(x, dtype=np.complex64)
