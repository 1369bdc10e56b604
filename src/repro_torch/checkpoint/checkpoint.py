"""Fault-tolerant checkpointing: the port of the JAX package's
``checkpoint/checkpoint.py``, with its on-disk layout.

Layout: ``<dir>/step_<N>/{manifest.json, arr_<i>.npy...}`` written via a
temp directory + atomic rename, so a crash mid-write never corrupts the
latest valid checkpoint; the three newest steps are kept.  Leaves are
visited and named as the reference's (:mod:`repro_torch.tree`: dict keys
sorted, ``.field`` for a NamedTuple field), so a checkpoint of the same
tree is file for file the reference's.  bfloat16 leaves are written as the
reference's are (their bits, ``np.dtype("V2")``; the manifest says
``bfloat16``) and come back as bfloat16 tensors.  The manifest also
records ``extra`` (the data-pipeline cursor) so training resumes
exactly-once.  The LM train state is saved in the reference's stacked
layout (``models/convert.py`` :func:`stack_state`), so a checkpoint written
by either package restores in the other.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import tree as T
from ..models.convert import to_numpy, to_torch


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the array to save and the manifest's dtype name."""
    if isinstance(leaf, torch.Tensor):
        arr = to_numpy(leaf)
        return arr, ("bfloat16" if leaf.dtype == torch.bfloat16
                     else str(arr.dtype))
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``; bfloat16 bits under the header ``ml_dtypes`` gives them
    (``'<V2'``; numpy alone would write ``'|V2'``)."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        np.ascontiguousarray(arr).tofile(f)


def save_checkpoint(directory: str, step: int, state: Any,
                    extra: Optional[Dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        for i, (path, leaf) in enumerate(T.flatten_with_paths(state)):
            arr, dtype = _host(leaf)
            fname = f"arr_{i:05d}.npy"
            _save(os.path.join(tmp, fname), arr, dtype)
            manifest["leaves"].append({"path": T.path_str(path),
                                       "file": fname, "dtype": dtype,
                                       "shape": list(arr.shape)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc_old(directory, keep=3)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, state_like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``state_like``: every leaf comes back
    as a tensor with the saved dtype and shape, on the device of the
    matching ``state_like`` leaf where that is a tensor (else the CPU)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {rec["path"]: rec for rec in manifest["leaves"]}

    def load(path, like):
        rec = by_path.get(T.path_str(path))
        if rec is None:
            raise KeyError(f"checkpoint missing leaf {T.path_str(path)}")
        device = like.device if isinstance(like, torch.Tensor) else "cpu"
        return to_torch(np.load(os.path.join(d, rec["file"])), device)

    return (T.map_with_path(load, state_like), step,
            manifest.get("extra", {}))


def _gc_old(directory: str, keep: int) -> None:
    steps = sorted([d for d in os.listdir(directory) if d.startswith("step_")])
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
