"""Mesh construction — the one place the port creates a process group.

``make_mesh(data, model)`` joins this process to a (data, model) group of
``torch.distributed`` and returns a :class:`~repro_torch.parallel.Mesh`;
``make_ctx`` wraps it in a ``ParallelCtx``.  A process learns its rank
and the rendezvous from the environment :func:`spawn` sets (``RANK``,
``WORLD_SIZE``, ``TTQ_MESH_STORE``: a ``FileStore`` path under a fresh
temporary directory, so concurrent test workers never contend for a TCP
port).  A one-rank mesh needs no environment.

The backend is chosen here, by one rule: on the CPU, gloo; on CUDA, NCCL
when the world has at most one rank per visible GPU, else gloo with the
ranks sharing the cards (NCCL refuses two ranks on one device), each
collective staged through a pinned host buffer
(:mod:`repro_torch.parallel.comm`).  The kernels launch on the card either
way.  Ranks lie on the (data, model) mesh as ``jax.make_mesh((data,
model))`` lays out devices: global rank d·model + m is model rank m of
data row d, so a model group is a run of consecutive ranks (the
training's data parallelism, ROADMAP A10 (d), adds the data groups).
"""
from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.parallel import Mesh, ParallelCtx


def choose_backend(device: str, world: int) -> str:
    """gloo on the CPU; on CUDA, NCCL when world ≤ the visible GPUs."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def make_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    """A (data, model) mesh over this process's group.  Inside a larger
    world (:func:`spawn`'s), ranks below ``data·model`` form the mesh;
    every rank of the world must call it (each creates every group, in
    the same order), and the others get a mesh with rank -1 that they do
    not use.  The mesh's ``group`` is this rank's model group (ranks
    d·model .. d·model + model − 1), its ``dp_group`` its data group
    (ranks m, model + m, ...; None at ``data == 1``)."""
    world = data * model
    device = device or os.environ.get("TTQ_MESH_DEVICE", "cuda")
    rank = int(os.environ.get("RANK", "0"))
    backend = choose_backend(device, int(os.environ.get("WORLD_SIZE",
                                                         world)))
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1)
                           if backend == "nccl" else (dev.index or 0))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        path = os.environ.get("TTQ_MESH_STORE")
        if path is None:
            if world != 1:
                raise RuntimeError(
                    f"make_mesh({data}, {model}) needs the rendezvous of "
                    f"repro_torch.launch.mesh.spawn (TTQ_MESH_STORE unset)")
            path = os.path.join(tempfile.mkdtemp(prefix="ttq_mesh_"), "store")
        size = int(os.environ.get("WORLD_SIZE", world))
        dist.init_process_group(backend, store=dist.FileStore(path, size),
                                rank=rank, world_size=size)
    size = dist.get_world_size()
    if world > size:
        raise ValueError(f"a mesh of {world} ranks in a world of {size}")

    def group(ranks):
        return dist.group.WORLD if len(ranks) == size else dist.new_group(
            ranks=ranks, backend=backend)
    model_groups = [group([d * model + m for m in range(model)])
                    for d in range(data)]
    data_groups = [group([d * model + m for d in range(data)])
                   for m in range(model)] if data > 1 else [None] * model
    rank = dist.get_rank()
    if rank >= world:
        return Mesh(shape={"data": data, "model": model}, backend=backend,
                    device=str(dev), rank=-1)
    d, m = divmod(rank, model)
    return Mesh(group=model_groups[d], shape={"data": data, "model": model},
                backend=backend, device=str(dev),
                stage=backend == "gloo" and dev.type == "cuda", rank=m,
                dp_group=data_groups[m], dp_rank=d)


def make_ctx(mesh: Mesh, *, moe_impl: str = "a2a") -> ParallelCtx:
    data_axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return ParallelCtx(mesh=mesh, data_axes=data_axes, model_axis="model",
                       moe_impl=moe_impl)


def make_test_mesh(data: int = 1, model: int = 2) -> Mesh:
    """A CPU mesh for tests (inside :func:`spawn`'s processes)."""
    return make_mesh(data, model, device="cpu")


def close_mesh():
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank, world, store, device, args, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      TTQ_MESH_STORE=store, TTQ_MESH_DEVICE=device)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        out.put((rank, True, fn(*args)))
    except BaseException:       # noqa: BLE001 — reported to the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        close_mesh()


def spawn(fn, world: int, *args, device: str = "cuda",
          timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world`` new processes, ranks 0..world-1 of one
    group (each calls :func:`make_mesh` itself), and return their results
    in rank order.  ``fn`` must be importable and its results picklable.
    A rank that raises, dies or outlives ``timeout`` seconds (a collective
    that never completes: ranks that disagree) fails the call and every
    rank is stopped."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ttq_mesh_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, store, device, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, end = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                r, ok, val = out.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in results]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died (exit codes "
                                       f"{[procs[i].exitcode for i in dead]})")
                if time.monotonic() > end:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(results))} "
                        f"did not finish in {timeout:.0f} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{val}")
            results[r] = val
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
