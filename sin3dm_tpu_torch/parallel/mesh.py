"""Data groups over `torch.distributed` (counterpart of
`sin3dm_tpu/parallel/mesh.py`).

JAX runs one process per host over a mesh of its chips and lets XLA
insert the collectives; here one rank is one process on one device, and
every collective is an explicit call.  A `DataGroup` names a rank's place
in the group (rank, size, device, backend, process group).

- `spawn(fn, n, ...)` starts `n` ranks (start method `spawn`) that meet
  through a `FileStore` in a temporary directory, calls `fn(group,
  *args)` in each and returns the ranks' return values in rank order; a
  rank that fails makes it raise with that rank's traceback.
- Rank r computes on `cuda:(r % device_count)`, or on the CPU where the
  caller asks for it.  Before the group forms, each rank puts its place
  (host name, card) into the store and reads every other rank's; the
  backend is NCCL where no two ranks share a card (on one host or on
  several), gloo where two do (NCCL refuses two ranks on one device) or
  the ranks run on the CPU.  Every rank computes on its device all the
  same; gloo only carries the collectives through the host.
- The one collective is `all_reduce` (gloo runs only it and `broadcast`
  on CUDA tensors).  A gather is an `all_reduce` of a zero-filled
  `[size, ...]` buffer in which each rank fills its own slot
  (`gather_rows`): adding zeros leaves every value's bits as they were.
  Each adds one to `COUNTS`.
- `maybe_initialize_distributed()` is the env-gated bootstrap of
  processes started by hand (JAX's variables: `SIN3DM_DIST=1`,
  `SIN3DM_COORDINATOR` host:port, `SIN3DM_NUM_PROCESSES`,
  `SIN3DM_PROCESS_ID`), which meet through a `TCPStore` that process 0
  serves at the coordinator's address.  A JAX process is a host with its
  chips; a process here is one device, so the process count is the
  device count.  A process takes the card its launcher names on its host
  (`SIN3DM_LOCAL_RANK`, else torchrun's `LOCAL_RANK`), else card r % (the
  host's cards), which needs a host's processes to have consecutive ids.
  JAX's TPU-pod auto-detection has no counterpart: the coordinator must
  be given.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pickle
import queue
import shutil
import socket
import tempfile
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, \
    Tuple

import torch
import torch.distributed as dist

# collectives issued by this process, by kind
COUNTS = {"all_reduce": 0}

_ON = ("1", "true", "yes", "on")


class DataGroup(NamedTuple):
    """A rank's place in a group of processes: `device` is where it
    computes, `pg` the process group (None: the default group)."""
    rank: int
    size: int
    device: torch.device
    backend: str
    pg: Any = None


LOCAL_RANK_VARS = ("SIN3DM_LOCAL_RANK", "LOCAL_RANK")


def local_rank() -> Optional[Tuple[str, int]]:
    """(variable, value) of this process's card index on its host where
    its launcher gives one (`SIN3DM_LOCAL_RANK`, else torchrun's
    `LOCAL_RANK`), else None."""
    for name in LOCAL_RANK_VARS:
        v = os.environ.get(name, "")
        if v:
            return name, int(v)
    return None


def rank_device(rank: int, device: str = "cuda",
                local: Optional[int] = None) -> torch.device:
    """Rank r's device: `cuda:local` where a local index is given, else
    `cuda:(r % device_count)`; the CPU for `device="cpu"`.  Asking for the
    card where there is none, or a local index past the host's cards,
    raises."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"unknown device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    n = torch.cuda.device_count()
    if local is None:
        return torch.device("cuda", rank % n)
    if not 0 <= local < n:
        raise ValueError(f"local index {local}: this host has {n} card(s)")
    return torch.device("cuda", local)


Place = Tuple[str, Optional[str]]


def place_of(dev: torch.device) -> Place:
    """Where a rank computes: (host name, the card's UUID), the card None
    on the CPU.  The UUID names the physical card whatever
    `CUDA_VISIBLE_DEVICES` numbers it."""
    card = (str(torch.cuda.get_device_properties(dev).uuid)
            if dev.type == "cuda" else None)
    return socket.gethostname(), card


def backend_for(places: Sequence[Place]) -> str:
    """The group's backend from every rank's place: NCCL where each rank
    has a card and no two ranks share one (on one host or across hosts),
    else gloo (ranks that share a card, or the CPU)."""
    if (any(card is None for _, card in places)
            or len(set(places)) < len(places)
            or not dist.is_nccl_available()):
        return "gloo"
    return "nccl"


def _exchange_places(store, rank: int, size: int,
                     place: Place) -> List[Place]:
    """Every rank's place, in rank order, through `store` (each rank sets
    its own key; `get` waits for the others')."""
    store.set(f"sin3dm/place/{rank}", json.dumps(place))
    return [tuple(json.loads(store.get(f"sin3dm/place/{r}")))
            for r in range(size)]


def init_group(rank: int, size: int, device: str, store,
               local: Optional[int] = None) -> DataGroup:
    """Join the default process group as `rank` of `size` through
    `store`, on `rank_device(rank, device, local)` and the backend
    `backend_for` picks from the ranks' places (NCCL binds the rank's
    card at init); rank 0 prints the choice."""
    dev = rank_device(rank, device, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    places = _exchange_places(store, rank, size, place_of(dev))
    backend = backend_for(places)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rank, world_size=size,
                            store=store, **kw)
    if rank == 0:
        hosts = len({h for h, _ in places})
        cards = len({p for p in places if p[1] is not None})
        why = ("no two ranks share a card" if backend == "nccl" else
               "ranks share a card" if cards else "ranks on the CPU")
        print(f"data group: {size} ranks on {hosts} host(s), "
              f"{f'{cards} card(s)' if cards else 'the CPU'}: backend "
              f"{backend} ({why})", flush=True)
    return DataGroup(rank, size, dev, backend)


def maybe_initialize_distributed(device: str = "cuda"
                                 ) -> Optional[DataGroup]:
    """The env-gated bootstrap: with `SIN3DM_DIST=1`, join the group as
    rank `$SIN3DM_PROCESS_ID` of `$SIN3DM_NUM_PROCESSES` through a
    `TCPStore` at `$SIN3DM_COORDINATOR` (host:port; rank 0 serves it),
    on the card `local_rank()` names (else rank % the host's cards), and
    print the process's line; None without `SIN3DM_DIST`.  ValueError
    names the variables that are missing."""
    if os.environ.get("SIN3DM_DIST", "").lower() not in _ON:
        return None
    names = ("SIN3DM_COORDINATOR", "SIN3DM_NUM_PROCESSES",
             "SIN3DM_PROCESS_ID")
    missing = [n for n in names if not os.environ.get(n)]
    if missing:
        raise ValueError(
            f"SIN3DM_DIST=1 needs {', '.join(missing)}: the port has no "
            "auto-detection of a cluster (give the coordinator's "
            "host:port, the process count and this process's id)")
    rank = int(os.environ["SIN3DM_PROCESS_ID"])
    size = int(os.environ["SIN3DM_NUM_PROCESSES"])
    host, port = os.environ["SIN3DM_COORDINATOR"].rsplit(":", 1)
    store = dist.TCPStore(host, int(port), size, is_master=rank == 0)
    local = local_rank() if device == "cuda" else None
    group = init_group(rank, size, device, store,
                       local[1] if local else None)
    where = (f"local index {local[1]} (${local[0]})" if local else
             "no local index: rank % the host's cards" if device == "cuda"
             else "the CPU")
    print(f"process {rank} of {size}: {group.device} ({where})", flush=True)
    return group


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def all_reduce(group: DataGroup, t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the group, in place; returns it."""
    COUNTS["all_reduce"] += 1
    dist.all_reduce(t, group=group.pg)
    return t


def all_reduce_many(group: DataGroup,
                    tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sums over the group of several tensors through one `all_reduce` in
    fp32 (fp64 where an input is; a bf16 value is exact in fp32, and a
    gather's zeros add nothing); new tensors in the inputs' dtypes."""
    if not tensors:
        return []
    dt = torch.float32
    for t in tensors:
        dt = torch.promote_types(dt, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dt) for t in tensors])
    all_reduce(group, flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def gather_slot(group: DataGroup, local: torch.Tensor) -> torch.Tensor:
    """The zero-filled `[size, *local.shape]` buffer with this rank's slot
    filled: summed over the group it is every rank's `local`."""
    buf = local.new_zeros((group.size,) + tuple(local.shape))
    buf[group.rank] = local
    return buf


def gather_rows(group: DataGroup, local: torch.Tensor,
                dim: int = 0) -> torch.Tensor:
    """Every rank's `local` (one shape on every rank) concatenated along
    `dim` in rank order, on every rank."""
    (buf,) = all_reduce_many(group, [gather_slot(group, local)])
    return torch.cat(list(buf.unbind(0)), dim=dim)


def barrier(group: DataGroup) -> None:
    """Wait until every rank reaches this call (an `all_reduce`)."""
    all_reduce(group, torch.zeros(1, device=group.device))


def close_group(group: DataGroup) -> None:
    """Wait for every rank (`barrier`), then leave the default process
    group: the end of a bootstrapped CLI run."""
    barrier(group)
    dist.destroy_process_group()


def shard_range(total: int, rank: int, size: int) -> Tuple[int, int]:
    """(first, count) of rank's contiguous block of `total` items: the
    first `total % size` ranks take one more."""
    base, extra = divmod(total, size)
    first = rank * base + min(rank, extra)
    return first, base + (1 if rank < extra else 0)


def local_rows(group: DataGroup, x: torch.Tensor,
               dim: int = 0) -> torch.Tensor:
    """This rank's equal share of `x` along `dim` (which must divide)."""
    n = x.shape[dim]
    if n % group.size:
        raise ValueError(f"{n} rows do not divide over {group.size} ranks")
    k = n // group.size
    return x.narrow(dim, group.rank * k, k)


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------

def _rank_entry(fn, rank: int, size: int, device: str, store_path: str,
                threads: int, tf32: Tuple[bool, bool], results,
                args) -> None:
    try:
        if device == "cpu":
            torch.set_num_threads(threads)
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
        group = init_group(rank, size, device,
                           dist.FileStore(store_path, size))
        out = fn(group, *args)
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, device: str = "cuda") -> List[Any]:
    """Run `fn(group, *args)` in `n` new processes, one rank each, and
    return their return values in rank order.  `fn` and `args` must
    pickle (a module-level function).  The ranks take this process's TF32
    flags (cuDNN's and matmul's); on the CPU they share its intra-op
    threads.  A rank that raises or dies makes this
    raise RuntimeError with its traceback (or exit code), after the
    other ranks are stopped."""
    if n < 1:
        raise ValueError(f"spawn needs at least one rank, got {n}")
    rank_device(0, device)          # no card where one is asked: raise here
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="sin3dm_group_")
    results = ctx.Queue()
    threads = max(1, torch.get_num_threads() // n)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    procs = [ctx.Process(target=_rank_entry, args=(
        fn, r, n, device, os.path.join(tmp, "store"), threads, tf32,
        results, args)) for r in range(n)]
    got, failed = {}, None
    try:
        for p in procs:
            p.start()
        while len(got) < n and failed is None:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    # a report it put before dying may still be in the pipe
                    try:
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        failed = (dead[0][0], f"exited with code "
                                  f"{dead[0][1]} without a report")
                        break
                else:
                    continue
            if ok:
                got[rank] = payload
            else:
                failed = (rank, payload)
    finally:
        if len(got) < n:            # a rank failed, or this process did
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed is not None:
        rank, what = failed
        raise RuntimeError(f"rank {rank} of {n} failed:\n{what}")
    return [pickle.loads(got[r]) for r in range(n)]
