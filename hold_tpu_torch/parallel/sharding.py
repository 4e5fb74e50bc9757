"""Data parallelism over the ray axis with torch.distributed (counterpart of
hold_tpu/parallel/sharding.py).

The JAX package runs one SPMD program over a device mesh: the rays are
sharded, per-frame quantities replicated, and the scalar loss makes XLA sum
the gradients.  The port runs one process per card (or, with gloo, per CPU
worker), each with its own device:

- every rank draws the identical global batch from the same seed and keeps
  a contiguous, equal slice of each frame's rays (``shard_batch``); every
  per-ray random draw is drawn for the whole batch and sliced the same way
  (``RankDraws``, ``ray_rand``), so that a ray meets the numbers it meets in
  one process;
- after the backward pass the gradients are summed over the ranks in one
  flattened bucket and divided by the world size (``average_gradients``);
- a mean over the rays of a step that every rank holds an equal share of
  is the mean of the ranks' means, so it needs no collective; a masked mean
  does: its denominator is summed over the ranks (``models/losses.py``);
- a validation frame's render chunk is split over the ranks and the slices
  gathered (``split_chunk_renderer``).

The backend is NCCL for CUDA tensors and gloo for CPU ones; gloo also runs
ranks that share one card (NCCL refuses two ranks on one GPU), its
collectives then staged through host memory.
"""

from __future__ import annotations

import pickle
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

def init_url(coordinator: str) -> str:
    """``host:port`` (the JAX flag's form) or a URL -> an init_method URL."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(coordinator: str = "", num_processes: int = 0, process_id: int = -1,
                     device=None) -> bool:
    """Join the default process group at ``coordinator`` (``host:port``) as
    rank ``process_id`` of ``num_processes``: NCCL when ``device`` is a
    CUDA device, else gloo.  Does nothing without a coordinator, so a
    single-process run never pays for it.  Returns whether it joined."""
    if not coordinator:
        return False
    device = torch.device(device or "cuda")
    if device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_url(coordinator), world_size=num_processes,
                            rank=process_id)
    return True


def local_device(process_id: int, device_type: str) -> torch.device:
    """The device of global rank ``process_id`` on its host: the card
    ``process_id`` mod the host's card count, or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", process_id % max(torch.cuda.device_count(), 1))


class RaySplit(NamedTuple):
    """This process's share of a step's rays: rank ``rank`` of ``world``
    over the default process group; tensors live on ``device``."""

    rank: int
    world: int
    device: torch.device
    staged: bool  # gloo on CUDA tensors: collectives through host memory

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        if self.staged and t.is_cuda:
            host = t.cpu()
            dist.all_reduce(host)
            t.copy_(host)
        else:
            dist.all_reduce(t)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place; returns it."""
        if self.staged and t.is_cuda:
            host = t.cpu()
            dist.broadcast(host, src)
            t.copy_(host)
        else:
            dist.broadcast(t, src)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor, no gradient)."""
        return self.all_reduce_(t.detach().clone())

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src)
        return box[0]

    def mean_of(self, scalars: dict) -> dict:
        """Each 0-d tensor of ``scalars`` averaged over the ranks (float32)."""
        keys = sorted(scalars)
        stacked = torch.stack([scalars[k].float() for k in keys])
        self.all_reduce_(stacked)
        stacked /= self.world
        return dict(zip(keys, stacked.unbind()))

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        return bool(self.broadcast_(torch.tensor([int(flag)], device=self.device)).item())

    def broadcast_tensors_(self, tensors: list, src: int = 0) -> None:
        """Rank ``src``'s values of ``tensors`` (same shapes and dtypes on every
        rank) on every rank, in place, one flattened bucket a dtype."""
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            self.broadcast_(flat, src)
            off = 0
            with torch.no_grad():
                for t in group:
                    t.copy_(flat[off:off + t.numel()].view_as(t))
                    off += t.numel()

    def gather_rows(self, local: torch.Tensor, sizes: list) -> torch.Tensor:
        """Every rank's ``local`` rows (rank r holds ``sizes[r]``), concatenated
        in rank order, on every rank (an all-reduce over a zero buffer)."""
        start = sum(sizes[: self.rank])
        full = torch.zeros((sum(sizes),) + tuple(local.shape[1:]), dtype=local.dtype,
                           device=local.device)
        full[start:start + local.shape[0]] = local
        return self.all_reduce_(full)


def current_split(device) -> RaySplit | None:
    """The default process group's split for tensors on ``device``, or None
    when there is no group (one process: every path as it is without the
    split).  A group of one process gives a split of world 1."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    device = torch.device(device)
    staged = device.type == "cuda" and dist.get_backend() == "gloo"
    return RaySplit(dist.get_rank(), dist.get_world_size(), device, staged)


def ray_slice(x, frames: int, rank: int, world: int):
    """Rows of ``x`` (frame-major, ``frames`` x rays-a-frame, numpy or torch)
    that rank ``rank`` of ``world`` holds: a contiguous, equal slice of
    each frame's rays."""
    n = x.shape[0] // frames
    if n % world:
        raise ValueError(f"{n} rays a frame do not split over {world} ranks")
    per = n // world
    x = x.reshape((frames, n) + tuple(x.shape[1:]))[:, rank * per:(rank + 1) * per]
    return x.reshape((frames * per,) + tuple(x.shape[2:]))


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """This rank's part of a global training batch: ``uv`` (B, P, 2),
    ``gt_rgb`` (B*P, 3) and ``gt_mask`` (B*P,) sliced to ``P / world`` rays a
    frame (``ray_slice``), the per-frame fields replicated.  P must divide."""
    if world == 1:
        return batch
    B, P = batch["uv"].shape[:2]
    out = dict(batch)
    out["uv"] = ray_slice(batch["uv"].reshape(B * P, 2), B, rank, world).reshape(B, -1, 2)
    for k in ("gt_rgb", "gt_mask"):
        out[k] = ray_slice(batch[k], B, rank, world)
    return out


class RankDraws(NamedTuple):
    """A training step's generator on one rank of a split over ``frames``
    frames: per-ray draws (``ray_rand``) are made for every rank's rays and
    sliced to this rank's; every other draw is made from ``gen`` as it is,
    the same on every rank."""

    gen: torch.Generator
    rank: int
    world: int
    frames: int


def generator_of(gen):
    """The torch.Generator behind ``gen`` (a generator, RankDraws or None)."""
    return gen.gen if isinstance(gen, RankDraws) else gen


def ray_rand(gen, shape: tuple, device) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` whose first axis is this process's rays."""
    if not isinstance(gen, RankDraws):
        return torch.rand(shape, generator=gen, device=device)
    full = torch.rand((shape[0] * gen.world,) + tuple(shape[1:]), generator=gen.gen,
                      device=device)
    return ray_slice(full, gen.frames, gen.rank, gen.world)


def average_gradients(params: list, split: RaySplit) -> None:
    """Each gradient of ``params`` summed over the ranks and divided by the
    world size, in one flattened bucket.  Every rank holds gradients for the
    same tensors (the same graph)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    split.all_reduce_(flat)
    flat /= split.world
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def split_chunk_renderer(chunk_fn: Callable, split: RaySplit) -> Callable:
    """``chunk_fn`` (``render.renderer.make_chunk_renderer``'s) with each
    chunk's pixels split over the ranks, nearly equal and in rank order, and
    the rows gathered on every rank (the JAX package's
    ``shard_render_chunk``).  A chunk of fewer pixels than ranks is rendered
    whole on every rank."""

    def render(params, batch, packs=None):
        P = batch["uv"].shape[1]
        if P < split.world:
            return chunk_fn(params, batch, packs)
        sizes = [P // split.world + (r < P % split.world) for r in range(split.world)]
        start = sum(sizes[: split.rank])
        local = chunk_fn(params, {**batch, "uv": batch["uv"][:, start:start + sizes[split.rank]]},
                         packs)
        return {k: split.gather_rows(v, sizes) for k, v in local.items()}

    return render


# --------------------------------------------------------------------------
# The local launcher
# --------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(fn, rank, world, port, backend, device, args, results):
    try:
        device = torch.device(device)
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        try:
            out = fn(rank, world, device, *args)
        finally:
            dist.destroy_process_group()
        # plain pickle: tensors by value (the queue's own pickler would share
        # their storage by file descriptor, gone once this process exits)
        results.put((rank, True, pickle.dumps(out)))
    except Exception:  # the parent raises it
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, world: int, devices: list, args: tuple = (), backend: str | None = None,
           timeout: float | None = None) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes
    (spawned), rank r on ``devices[r]``, each in the default process group
    (``backend``: NCCL when every device is a distinct card, else gloo).
    ``fn`` must be importable by name, its arguments and result picklable.
    Returns the ranks' results in rank order.  A rank that raises, a rank
    that dies, or ``timeout`` seconds passing ends every rank (killed) and
    raises here."""
    import torch.multiprocessing as mp

    devs = [str(torch.device(d)) for d in devices]
    if backend is None:
        cuda = all(d.startswith("cuda") for d in devs)
        backend = "nccl" if cuda and len(set(devs)) == len(devs) else "gloo"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(fn, r, world, port, backend, devs[r], args,
                                                 results))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    got: dict = {}
    try:
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks not done within {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = pickle.loads(out)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        results.close()
    return [got[r] for r in range(world)]


def local_process_count(num_devices: int, device_type: str) -> int:
    """``--num_devices`` -> processes to start on this host: 0 means every
    card (one process on the CPU)."""
    if num_devices > 0:
        return num_devices
    return max(torch.cuda.device_count(), 1) if device_type == "cuda" else 1


def rank_devices(n: int, device_type: str) -> list:
    """Rank r's device for ``n`` local processes: ``cuda:r``, or the CPU."""
    if device_type == "cuda":
        if n > torch.cuda.device_count():
            raise RuntimeError(f"{n} processes asked for, {torch.cuda.device_count()} cards")
        return [f"cuda:{r}" for r in range(n)]
    return ["cpu"] * n

