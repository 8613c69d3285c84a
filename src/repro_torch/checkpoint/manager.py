"""Checkpointing with atomic commit and keep-N (``repro.checkpoint``).

Layout (the reference's, so each package reads the other's checkpoints):

    <dir>/step_<n>/   arrays.npz    ("/"-joined tree path → array)
                      manifest.json (paths, shapes, dtypes, step)
    <dir>/step_<n>.COMMITTED        (marker, written last)

bf16 leaves are widened to f32 on disk (exact); restore casts each leaf to
the dtype and device of the ``like`` tree.  Under a mesh the arrays on
disk are still the global ones: ``save(shardings=)`` gathers each leaf
from every rank's slice (``parallel.NamedSharding.gather``) and rank 0
writes, and :func:`reshard_restore` gives each rank its slice of every
leaf on a mesh of any shape (the reference's elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile

from typing import Optional

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_leaves_with_path
from repro_torch.parallel import comm


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _host(t) -> np.ndarray:
    """A host copy, bf16 widened to f32 (exact); a CUDA tensor comes
    through pinned memory (a pageable copy runs at a tenth of the rate)."""
    t = torch.as_tensor(t).detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    if not t.is_cuda:
        return t.numpy()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h.numpy().copy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _marker(self, step: int) -> str:
        return self._step_dir(step) + ".COMMITTED"

    def save(self, step: int, tree, shardings=None) -> Optional[str]:
        """Write ``tree`` as step ``step``.  ``shardings`` (a tree of
        ``NamedSharding`` mirroring ``tree``): every leaf is this rank's
        slice; every rank of the mesh calls save, the leaves are gathered
        whole one by one, rank 0 of the mesh writes (the others return
        None) and all wait until it has committed."""
        if shardings is None:
            return self._write(step, {_key(p): _host(v)
                                      for p, v in tree_leaves_with_path(tree)})
        pctx = tree_leaves(shardings)[0].pctx
        writer = pctx.rank == 0 and pctx.dp_rank == 0
        arrays = {}
        for (p, v), sh in zip(tree_leaves_with_path(tree),
                              tree_leaves(shardings)):
            whole = sh.gather(v)
            if writer:
                arrays[_key(p)] = _host(whole)
            del whole
        out = self._write(step, arrays) if writer else None
        comm.barrier(pctx)
        return out

    def _write(self, step: int, arrays: dict) -> str:
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


def reshard_restore(manager: CheckpointManager, step: int, like_tree,
                    target_shardings):
    """Elastic scaling: the checkpoint at ``step`` restored onto another
    mesh.  ``target_shardings`` mirrors ``like_tree`` with
    ``parallel.NamedSharding`` leaves (a spec read on the new mesh's
    context; None for a whole leaf); each rank gets its slice of every
    global array on disk, in the dtype and on the device of its ``like``
    leaf.  Each array is mapped from the file (:func:`_stored`), so a
    rank reads its slice only."""
    path = os.path.join(manager._step_dir(step), "arrays.npz")
    return _restore_like(like_tree, target_shardings, path, ())


def _stored(path: str, key: str) -> np.ndarray:
    """A read-only memory map of the array ``key`` of an ``.npz`` whose
    members are stored uncompressed, as ``np.savez`` writes them (either
    package's checkpoints): the member's local zip header and ``.npy``
    header are read, the data mapped in place."""
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(key + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{path}: {key} is compressed; checkpoints are "
                         f"written by np.savez, uncompressed")
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(30)                        # the local file header
        f.seek(info.header_offset + 30 + int.from_bytes(head[26:28], "little")
               + int.from_bytes(head[28:30], "little"))
        version = np.lib.format.read_magic(f)
        read = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}[version]
        shape, fortran, dtype = read(f)
        offset = f.tell()
    return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape,
                     order="F" if fortran else "C")


def _restore_like(like, shard, path, keys):
    if isinstance(like, dict):
        return {k: _restore_like(v, shard[k], path, keys + (k,))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_restore_like(v, s, path, keys + (i,))
                          for i, (v, s) in enumerate(zip(like, shard)))
    whole = _stored(path, _key(keys))
    part = np.array(whole if shard is None else whole[shard.index(
        whole.shape)])
    return torch.from_numpy(part).to(device=like.device, dtype=like.dtype)


def _unflatten_like(like, flat: dict, path=()):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, path + (k,))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(v, flat, path + (i,))
                          for i, v in enumerate(like))
    return torch.from_numpy(np.array(flat[_key(path)])).to(
        device=like.device, dtype=like.dtype)
