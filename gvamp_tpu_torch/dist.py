"""The marker mesh of the PyTorch port (``gvamp_tpu/dist.py``'s counterpart).

The reference distributes the markers over MPI ranks; the JAX package over
the devices of a ``jax.sharding.Mesh`` (``shard_map`` with ``psum``).  The
port splits the packed operator only and keeps every marker-space vector
replicated:

  * a mesh is an ordered list of K marker shards; shard s owns the padded
    word columns [s Mpad/K, (s+1) Mpad/K), with Mpad rounded to
    ``marker_align * K`` as in the JAX package, so the slabs are the equal
    ones JAX's mesh induces and each slab's right-hand side is quantised
    where JAX's ``shard_map`` quantises it;
  * a forward product runs the kernel on each local slab against its rows
    of the replicated right-hand side, sums the partials in shard order
    and all-reduces them over the processes (``Mesh.all_reduce_sum``, the
    reference's ``MPI_Allreduce`` of data.cpp:928);
  * a transposed product runs per slab and all-gathers the slabs into a
    replicated [Mpad, B] (``Mesh.all_gather_m``);
  * the engines, CG, SLQ, EM and the p-value tests then run unchanged on
    every process, on identical inputs; ``Mesh.assert_replicated`` checks
    at the end of a run that the processes still agree.

Under a profiler each of the three collectives is a span
(``all_reduce`` / ``all_gather``, with the local bytes it sends;
``gvamp_tpu_torch.trace``).

Processes: :func:`initialize` joins a ``torch.distributed`` process group
(``nccl`` for a CUDA run, ``gloo`` on the CPU); each process owns
``n_local`` consecutive shards, rank-major, as JAX's global mesh orders its
devices by process.  Within a process the shards sit on the one CPU device
(the counterpart of the JAX tests' virtual CPU devices, which is what lets
one process hold K shards against a K-device JAX mesh), on the process's
card in a multi-process CUDA run, and round-robin over the visible cards
in a single-process CUDA run.  Unlike JAX's CLI, which truncates the
visible devices to ``--devices``, the port has no virtual devices: K is
what the caller asks for.

Each process reads only its shards' byte ranges of the ``.bed``
(:func:`read_bed_slabs`, the reference's per-rank slab read of
data.cpp:201-234).  ``divide_work`` is the reference's unequal block
partition (utilities.cpp:259-291); the mesh does not use it (an all-gather
needs equal slabs), as JAX's does not.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from gvamp_tpu_torch import native
from gvamp_tpu_torch.data import require_device
from gvamp_tpu_torch.io import plink
from gvamp_tpu_torch.ops.layout import PlanarLayout
from gvamp_tpu_torch.trace import span


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> int:
    """Join the process group; returns this process's rank.

    Explicit arguments come first, then the ``GVAMP_COORDINATOR`` /
    ``GVAMP_NPROCS`` / ``GVAMP_PROC_ID`` variables, else ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the
    counterpart of ``jax.distributed``'s discovery
    (``gvamp_tpu/dist.py:39-69``).  The backend is ``nccl`` for a CUDA
    ``device`` and ``gloo`` on the CPU; a CUDA process takes card
    ``LOCAL_RANK`` where that is set, else ``process_id % device_count``."""
    if tdist.is_initialized():
        return tdist.get_rank()
    coordinator = coordinator or os.environ.get("GVAMP_COORDINATOR")
    num_processes = num_processes or _env_int("GVAMP_NPROCS")
    if process_id is None:
        process_id = _env_int("GVAMP_PROC_ID")
    device = torch.device(device)
    kw = {}
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs the process count "
                             "and this process's id")
        kw["init_method"] = f"tcp://{coordinator}"
    else:
        kw["init_method"] = "env://"
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a distributed CUDA run needs a CUDA device; "
                               "pass --device cpu to run over gloo")
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = int(process_id or _env_int("RANK") or 0)
        torch.cuda.set_device(local % torch.cuda.device_count())
    tdist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                             **kw)
    return tdist.get_rank()


def finalize() -> None:
    """Leave the process group (the end of a distributed run)."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def backend() -> Optional[str]:
    return tdist.get_backend() if tdist.is_initialized() else None


def barrier() -> None:
    """Wait for every process (``MPI_Barrier``); nothing without a group."""
    if not tdist.is_initialized():
        return
    if tdist.get_backend() == "nccl":
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()


def process_device(device) -> torch.device:
    """The device of this process's replicated vectors: on CUDA the card
    :func:`initialize` selected, else ``device`` as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def divide_work(mt: int, nranks: int):
    """Contiguous block partition of mt markers over nranks (reference
    utilities.cpp:259-291): rank i gets mt // nranks markers, one more for
    the first mt % nranks ranks.  Returns (starts, counts) int64 arrays."""
    base, rem = divmod(mt, nranks)
    counts = np.full(nranks, base, dtype=np.int64)
    counts[:rem] += 1
    starts = np.zeros(nranks, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    return starts, counts


def _placement(device: torch.device, n_local: int, distributed: bool):
    """The device of each local shard (see the module docstring)."""
    if device.type != "cuda" or distributed:
        return [device] * n_local
    n = torch.cuda.device_count()
    first = device.index or 0
    return [torch.device("cuda", (first + i) % n) for i in range(n_local)]


class Mesh:
    """K = ``n_local`` x (process count) marker shards; this process owns
    ``shards``, on ``devices``, and keeps its replicated vectors on
    ``device``: the card unless the caller names another (without a card
    a CUDA mesh raises).  With a process group (``distributed``) the
    collectives run over it, even for one process, where they are
    copies."""

    def __init__(self, n_local: int = 1, device="cuda"):
        if n_local < 1:
            raise ValueError(f"a mesh needs at least one shard per process, "
                             f"got {n_local}")
        require_device(device)
        self.distributed = tdist.is_initialized()
        self.world = world_size()
        self.rank = rank()
        self.n_local = int(n_local)
        self.n_shards = self.n_local * self.world
        self.shards = tuple(range(self.rank * self.n_local,
                                  (self.rank + 1) * self.n_local))
        self.device = process_device(device)
        self.devices = _placement(self.device, self.n_local, self.distributed)
        # calls of each function mapped over the slabs, by name: a kernel
        # wrapper's launches are n_local times its calls
        self.calls = {}

    def __repr__(self) -> str:
        return (f"Mesh(shards {self.shards[0]}..{self.shards[-1]} of "
                f"{self.n_shards}, rank {self.rank}/{self.world})")

    # ------------------------------------------------------------ layout

    def slab_width(self, mpad: int) -> int:
        if mpad % self.n_shards:
            raise ValueError(f"Mpad={mpad} does not split into "
                             f"{self.n_shards} equal shards")
        return mpad // self.n_shards

    def cols(self, mpad: int) -> list:
        """[(c0, c1)] of the local shards' padded columns."""
        w = self.slab_width(mpad)
        return [(s * w, (s + 1) * w) for s in self.shards]

    def split(self, x, dim: int = 1) -> tuple:
        """The local shards' slabs of a full array along ``dim`` (a numpy
        array or a tensor), each contiguous on its shard's device."""
        out = []
        for (c0, c1), dev in zip(self.cols(x.shape[dim]), self.devices):
            idx = [slice(None)] * x.ndim
            idx[dim] = slice(c0, c1)
            part = x[tuple(idx)]
            if isinstance(part, np.ndarray):
                part = torch.from_numpy(np.ascontiguousarray(part))
            out.append(part.to(dev).contiguous())
        return tuple(out)

    def _on(self, dev: torch.device):
        """The CUDA device context of a shard on another card."""
        if dev.type == "cuda" and dev != self.device:
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    # -------------------------------------------------------- collectives

    def all_reduce_sum(self, parts: list) -> torch.Tensor:
        """The local partials summed in shard order on ``device``, then
        summed over the processes."""
        with span("all_reduce", bytes=_nbytes(parts[0])):
            total = parts[0].to(self.device)
            for p in parts[1:]:
                total = total + p.to(self.device)
            if self.distributed:
                total = total.contiguous()
                tdist.all_reduce(total)
        return total

    def all_gather_m(self, parts: list, dim: int = 0) -> torch.Tensor:
        """The local slabs along ``dim`` (the marker axis), then every
        process's in rank order: the replicated full array on ``device``."""
        with span("all_gather", bytes=sum(_nbytes(p) for p in parts)):
            local = (parts[0].to(self.device) if len(parts) == 1 else
                     torch.cat([p.to(self.device) for p in parts], dim=dim))
            if not self.distributed:
                return local
            local = local.contiguous()
            out = [torch.empty_like(local) for _ in range(self.world)]
            tdist.all_gather(out, local)
            return out[0] if self.world == 1 else torch.cat(out, dim=dim)

    def shard_map(self, fn, in_specs, out: str, m_axis: int = 1, dims=0):
        """``fn(slab, *args)`` over the local slabs, the counterpart of a
        ``jax.shard_map`` over the marker axis: each ``in_specs`` entry is
        ``"m"`` (the argument's rows of the slab's columns) or None (the
        argument whole); ``out`` is ``"sum"`` (``all_reduce_sum``) or
        ``"m"`` (``all_gather_m`` of each output, along ``dims``: one axis
        or one per output).  The slabs' marker axis is ``m_axis``; each
        call adds one to ``calls[fn.__name__]``."""
        name = getattr(fn, "__name__", "fn")

        def run(slabs, *args):
            self.calls[name] = self.calls.get(name, 0) + 1
            w = slabs[0].shape[m_axis]
            parts = []
            for s, g in zip(self.shards, slabs):
                dev = g.device
                sub = [a[s * w:(s + 1) * w].to(dev) if spec == "m"
                       else a.to(dev) for a, spec in zip(args, in_specs)]
                with self._on(dev):
                    parts.append(fn(g, *sub))
            if out == "sum":
                return self.all_reduce_sum(parts)
            if isinstance(parts[0], tuple):
                ds = dims if isinstance(dims, tuple) else (dims,) * len(
                    parts[0])
                return tuple(self.all_gather_m([p[i] for p in parts], d)
                             for i, d in enumerate(ds))
            return self.all_gather_m(parts, dims)

        return run

    def assert_replicated(self, *tensors) -> int:
        """Raise if the processes hold different bits in ``tensors``: one
        all-gather of a position-weighted checksum of each tensor's bytes.
        Returns the number of tensors checked."""
        sums = [_checksum(t, self.device) for t in tensors]
        if not self.distributed or not sums:
            return len(sums)
        local = torch.stack(sums)
        with span("all_gather", bytes=_nbytes(local)):
            out = [torch.empty_like(local) for _ in range(self.world)]
            tdist.all_gather(out, local)
            allv = torch.stack(out).cpu()
        bad = [i for i in range(allv.shape[1])
               if not bool((allv[:, i] == allv[0, i]).all())]
        if bad:
            raise RuntimeError(
                f"the {self.world} processes disagree on tensors {bad} of "
                f"{len(sums)} (checksums by rank: "
                f"{[allv[:, i].tolist() for i in bad]}): a replicated vector "
                f"diverged")
        return len(sums)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _checksum(t: torch.Tensor, device) -> torch.Tensor:
    """int64 checksum of a tensor's bytes: sum of the 16-bit halves of its
    32-bit words, each weighted by its position mod 65521, plus 1."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 4:
        b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
    v = b.view(torch.int32).to(torch.int64)
    lo, hi = v & 0xFFFF, (v >> 16) & 0xFFFF
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) % 65521
    return ((lo * (w + 1)).sum() + (hi * (w + 2)).sum()).to(device)


def read_bed_slabs(bed_path: str, N: int, M: int, S: int, n_words: int,
                   mpad: int, n_shards: int, shards, devices) -> tuple:
    """The word slabs of ``shards`` (of ``n_shards``) read from the
    ``.bed``: shard s's columns [c0, c1) cover the real markers
    [S + c0, S + min(c1, M)) and only those byte ranges are read; columns
    past M get 0x55 padding (decoding to zero).  The counterpart of
    ``gvamp_tpu.dist.load_bed_words_global`` (``dist.py:132-155``)."""
    w = mpad // n_shards
    out = []
    for s, dev in zip(shards, devices):
        c0 = s * w
        m_real = max(0, min(M, c0 + w) - c0)
        words = None
        if m_real:
            words = native.read_bed_words(bed_path, N, m_real, S + c0,
                                          n_words, w)
        if words is None:
            words = np.full((n_words, w), 0x55555555, dtype=np.uint32)
            if m_real:
                lay = PlanarLayout(N=N, n_words=n_words)
                bed = plink.read_bed_slab(bed_path, N, m_real, S + c0)
                words[:, :m_real] = lay.pack_words(bed).T
        out.append(torch.from_numpy(
            np.ascontiguousarray(words).view(np.int32)).to(dev))
    return tuple(out)
