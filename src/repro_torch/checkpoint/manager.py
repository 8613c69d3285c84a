"""Checkpointing with atomic commit and keep-N (``repro.checkpoint``).

Layout (the reference's, so each package reads the other's checkpoints):

    <dir>/step_<n>/   arrays.npz    ("/"-joined tree path → array)
                      manifest.json (paths, shapes, dtypes, step)
    <dir>/step_<n>.COMMITTED        (marker, written last)

bf16 leaves are widened to f32 on disk (exact); restore casts each leaf to
the dtype and device of the ``like`` tree.  Restoring onto another layout
of devices (the reference's ``reshard_restore``) waits for tensor
parallelism (ROADMAP A10 (d)).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch._tree import tree_leaves_with_path


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _host(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _marker(self, step: int) -> str:
        return self._step_dir(step) + ".COMMITTED"

    def save(self, step: int, tree) -> str:
        arrays = {_key(p): _host(v) for p, v in tree_leaves_with_path(tree)}
        tmp = tempfile.mkdtemp(dir=self.dir)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                        # atomic on one fs
        with open(self._marker(step), "w") as f:
            f.write("ok")                            # commit marker last
        self._gc()
        return final

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".COMMITTED"):
                s = int(name.split("_")[1])
                if os.path.exists(self._marker(s)):
                    out.append(s)
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like):
        """The checkpoint at ``step`` in the nesting, dtypes and devices of
        ``like`` (new tensors)."""
        with np.load(os.path.join(self._step_dir(step), "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_like(like, flat)

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            try:
                os.remove(self._marker(s))
            except OSError:
                pass


def _unflatten_like(like, flat: dict, path=()):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, path + (k,))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, flat, path + (i,))
                          for i, v in enumerate(like))
    return torch.from_numpy(np.array(flat[_key(path)])).to(
        device=like.device, dtype=like.dtype)
