"""Round-granular checkpoint and resume: the JAX package's
``utils/checkpoint.py``, kept as the port's own copy.

The all-kNN carry (per-query top-k dists and ids) and the cursor of
completed rounds are saved every R rounds; a restarted run checks the
fingerprint (shapes, config, a strided content sample) and continues from
the saved round instead of recomputing. Files are NPZ, written atomically
(tmp + rename), so a crash mid-save leaves the previous checkpoint intact;
an unreadable file means a clean restart.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from mpi_knn_tpu_torch.config import KNNConfig

_STATE_FILE = "knn_state.npz"
log = logging.getLogger("mpi_knn_tpu_torch")


def _array_signature(arr) -> bytes:
    """Full shape + dtype + a strided ~4096-element content sample covering
    the whole array. A tensor is sampled where it lies and only the sample
    moves to the host; its dtype is written as numpy writes it
    ("float32"), so a numpy corpus and the same corpus on a card
    fingerprint alike."""
    shape = tuple(arr.shape)
    n = 1
    for dim in shape:
        n *= dim
    step = max(1, n // 4096)
    if isinstance(arr, torch.Tensor):
        dtype = str(arr.dtype).removeprefix("torch.")
        sample = arr.reshape(-1)[::step].cpu()
        if sample.dtype == torch.bfloat16:
            sample = sample.view(torch.int16)
        sample = sample.contiguous().numpy()
    else:
        dtype = str(arr.dtype)
        sample = np.ascontiguousarray(
            np.ascontiguousarray(arr).reshape(-1)[::step])
    return str(shape).encode() + dtype.encode() + sample.tobytes()


def fingerprint(corpus, queries, cfg: KNNConfig) -> str:
    """Cheap, stable identity of (data, config): full shapes + strided
    content samples + config fields. Not cryptographic — it guards against
    resuming with the wrong data or config, not against adversaries."""
    h = hashlib.sha256()
    h.update(json.dumps(dataclasses.asdict(cfg), sort_keys=True).encode())
    for arr in (corpus, queries):
        h.update(_array_signature(arr))
    return h.hexdigest()


@dataclasses.dataclass
class KNNCheckpoint:
    carry_d: np.ndarray
    carry_i: np.ndarray
    tiles_done: int  # corpus tiles (serial) or ring rounds already merged
    fingerprint: str


def save_checkpoint(ckpt_dir, state: KNNCheckpoint):
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / (_STATE_FILE + ".tmp")
    np.savez(
        tmp,
        carry_d=state.carry_d,
        carry_i=state.carry_i,
        tiles_done=np.int64(state.tiles_done),
        fingerprint=np.frombuffer(state.fingerprint.encode(), dtype=np.uint8),
    )
    # np.savez appends .npz to the filename it is given
    os.replace(str(tmp) + ".npz", d / _STATE_FILE)


def load_checkpoint(ckpt_dir, expect_fingerprint: str) -> Optional[KNNCheckpoint]:
    """The saved state, or None if absent, of another run, or unreadable
    (a torn or truncated file restarts the run from zero)."""
    path = Path(ckpt_dir) / _STATE_FILE
    if not path.exists():
        return None
    try:
        with np.load(path) as z:
            fp = z["fingerprint"].tobytes().decode()
            if fp != expect_fingerprint:
                return None
            return KNNCheckpoint(
                carry_d=z["carry_d"],
                carry_i=z["carry_i"],
                tiles_done=int(z["tiles_done"]),
                fingerprint=fp,
            )
    except Exception as e:  # any unreadable state -> clean restart
        log.warning("ignoring unreadable checkpoint %s (%s); restarting "
                    "from zero", path, e)
        return None


def clear_checkpoint(ckpt_dir):
    path = Path(ckpt_dir) / _STATE_FILE
    if path.exists():
        path.unlink()
