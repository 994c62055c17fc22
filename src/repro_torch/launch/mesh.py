"""Meshes over ``torch.distributed`` for the sharded engine.

Port of ``repro/launch/mesh.py:28-42`` (``make_host_mesh``,
``fl_axis_name``).  A :class:`Mesh` is a process group laid out as
("data", "model"); each rank owns the tensors on its ``device``.  The
sharded engine spreads the FL-device axis over the ranks, and only the
server aggregation crosses it, through the two collectives here:
:func:`all_gather_rows` (tiled on dim 0, as ``lax.all_gather(...,
tiled=True)``) and :func:`psum`.  Both call the mesh's group directly, so
nothing depends on the default group or on the names of newer
``torch.distributed`` wrappers.

With no default group present, :func:`make_host_mesh` builds a one-rank
group of its own (gloo for CPU tensors, NCCL for CUDA ones) and leaves the
default group alone.  :func:`spawn` starts ``world`` ranks in fresh
processes (the ``spawn`` start method, a ``FileStore`` in a temporary
directory, one intra-op thread each) and returns each rank's result.

Transports: CPU tensors go over gloo; CUDA tensors over NCCL (one rank per
card) or over gloo, which stages them through host memory itself (two
ranks sharing one card: NCCL refuses that).  The mesh's ``transport``
names the one in use; nothing switches on its own.

The model axis (tensor parallelism, ROADMAP A12): a mesh of ``model`` =
P > 1 is one row, ("data", "model") = (1, P), whose ``model_group`` is
the whole group (the FL devices stay rows on every rank); its collectives
are in :mod:`repro_torch.parallel`; every family trains and serves on
it.  A mesh with both axes above 1 is not ported (ROADMAP
A12c).

The production meshes of the reference (256 / 512 chips,
``make_production_mesh``) belong to its dry-run tooling and are not
ported here.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("data", "model")


class Mesh:
    """``torch.distributed`` group ``group`` seen as a ("data", "model")
    mesh of ``shape`` (axis name -> size); this process is rank ``rank`` of
    ``size`` and holds its tensors on ``device``.  ``model_group`` is the
    group of the model axis (``group`` itself: the mesh is one row; None
    when the model axis is 1)."""

    def __init__(self, group, shape: dict, rank: int, device: torch.device,
                 transport: str, model_group=None):
        self.group = group
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.rank = rank
        self.size = math.prod(shape.values())
        self.device = device
        self.transport = transport
        self.model_group = model_group

    @property
    def model_size(self) -> int:
        return int(self.shape.get("model", 1))

    @property
    def model_rank(self) -> int:
        """This rank's index along the model axis."""
        return self.rank % self.model_size

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"device={self.device}, transport={self.transport!r})")


def _own_group(device: torch.device):
    """A one-rank group that is not the default group: gloo for the CPU,
    NCCL for the card."""
    store = dist.HashStore()
    if device.type == "cuda":
        return dist.ProcessGroupNCCL(store, 0, 1), "nccl"
    return dist.ProcessGroupGloo(store, 0, 1), "gloo"


def make_host_mesh(n_devices: int | None = None, model: int = 1,
                   device: str | torch.device | None = None) -> Mesh:
    """Mesh over the ranks present: the default group's, or with none a
    one-rank group of this process.  ``device=None`` is the card (raises
    without CUDA); with NCCL each rank takes the card of its rank."""
    device = resolve_device(device)
    if dist.is_initialized():
        group, backend = dist.group.WORLD, dist.get_backend()
        present, rank = dist.get_world_size(), dist.get_rank()
    else:
        group = backend = None
        present, rank = 1, 0
    n = n_devices or present
    check_factors(n, model)
    if n != present:
        raise ValueError(f"make_host_mesh: {n} devices asked for, "
                         f"{present} ranks present")
    if group is None:
        group, backend = _own_group(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("make_host_mesh: NCCL needs CUDA tensors")
        device = torch.device("cuda", rank)
    if model > 1 and n > model:
        raise NotImplementedError(
            f"make_host_mesh: a ({n // model}, {model}) mesh has both axes "
            f"above 1; the model axis runs on one row, the FL devices as "
            f"rows on every rank (ROADMAP A12c)")
    return Mesh(group, dict(zip(AXES, (n // model, model))), rank, device,
                backend, group if model > 1 else None)


def check_factors(n: int, model: int) -> None:
    """The reference's ``make_host_mesh`` refusal: ``n`` devices must be a
    positive multiple of ``model``."""
    if model < 1 or n % model != 0:
        raise ValueError(
            f"make_host_mesh: {n} devices do not factor into a "
            f"(data={n}/{model}, model={model}) mesh; n_devices must be a "
            f"positive multiple of model")


def fl_axis_name(mesh: Mesh) -> str:
    """The slow axis LGC compresses over: 'pod' when present, else 'data'."""
    return "pod" if "pod" in mesh.axis_names else "data"


def fl_shards(mesh: Mesh) -> int:
    """The number of ranks the FL-device axis spreads over, for the
    simulator's engines.  They take no model axis (nor do the reference's
    engines in its tests): the model axis trains and serves the
    transformers of every family (``launch.steps``), and a model axis
    under the engines stays open (ROADMAP A12c)."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            "the simulator's engines take no model axis: a mesh with a "
            "model axis > 1 runs only the transformers' training and "
            "serving (launch.steps; the engines under it are ROADMAP A12c)")
    return int(mesh.shape[fl_axis_name(mesh)])


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (n, ...) concatenated on dim 0 in rank order:
    (size * n, ...), the same on every rank."""
    src = x.contiguous()
    outs = [torch.empty_like(src) for _ in range(mesh.size)]
    mesh.group.allgather([outs], [src]).wait()
    return torch.cat(outs)


def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x``, the same on every rank."""
    out = x.clone()
    mesh.group.allreduce([out]).wait()
    return out


# ---------------------------------------------------------------------------
# ranks in fresh processes
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, backend: str, store_path: str,
               results, args: tuple, timeout: float) -> None:
    try:
        torch.set_num_threads(1)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend,
                                store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, backend: str = "gloo", args: tuple = (),
          timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world`` fresh processes joined in one
    ``backend`` group and return each rank's result, in rank order.

    ``fn`` must be importable (a module-level function): the children
    import it, ``torch`` and ``repro_torch``.  As multiprocessing's spawn
    does, each child imports the caller's ``__main__`` module again, so a
    script keeps its work under ``if __name__ == "__main__":``.  A rank
    that raises, dies or outlives ``timeout`` seconds (also the group's
    collective timeout) stops every rank and raises here."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, world, backend,
                                   os.path.join(tmp, "store"), results,
                                   args, timeout))
                 for rank in range(world)]
        for p in procs:
            p.start()
        out: dict = {}
        end = time.monotonic() + timeout
        try:
            while len(out) < world:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"spawn: rank(s) {dead} exited with "
                            f"{[procs[r].exitcode for r in dead]} and no "
                            f"result") from None
                    if time.monotonic() > end:
                        raise TimeoutError(
                            f"spawn: {world - len(out)} rank(s) gave no "
                            f"result within {timeout:.0f} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n"
                                       f"{payload}")
                out[rank] = payload
            for p in procs:
                p.join(timeout=max(end - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(world)]
