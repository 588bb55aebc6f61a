"""Launch the ranks of a mesh: one process per position.

Counterpart of the JAX package's ``initialize_distributed``
(``edge_sharding.py:212``): :func:`run_ranks` spawns this launcher's ranks
with ``torch.multiprocessing`` (``spawn``: each starts a fresh interpreter,
so no CUDA state is inherited), which join one gloo process group with a
timeout. Each rank calls ``fn(mesh, *args)`` on its device,
``cuda:(local rank % device_count)`` unless ``device`` is "cpu", with one
intra-op thread on the CPU and float32 as torch's default dtype; its return
value comes back to the caller in rank order. A rank that raises stops
every rank, and the launcher raises with that rank's traceback.

On one host one launcher spawns all ``n_data * n_edge`` ranks, which meet
on a ``FileStore`` in a temporary directory (no network, no port to pick).
Across hosts (``distributed``, :class:`~gasfm_tpu_torch.parallel.edge_sharding.Distributed`)
one launcher runs on each host and spawns its ``n_data * n_edge /
num_processes`` local ranks, global ranks ``process_id x local`` onwards;
every rank meets on a ``TCPStore`` at the coordinator's address, which
process 0's launcher hosts until every launcher is done. The launchers
watch the store while their ranks run: the first rank that fails writes
its traceback there, and every launcher then stops its ranks and raises
with it, instead of leaving the other hosts' ranks to wait out their
collectives' timeout. A launcher that cannot reach the coordinator raises
after the store's timeout.

On the card the kernels are built in each launcher first
(``ops/kernels/build.build_all``): ranks that each found the build
directory empty would run nvcc into it at once.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, List, Sequence

import torch

TIMEOUT_S = 900  # a collective, or the coordinator's store, that waits longer fails
POLL_S = 0.2  # a multi-host launcher's look at the store for another host's failure
FAILED = "launch/failed"  # the first failing rank's traceback, in the coordinator's store
GRACE_S = 10  # how long the coordinator's store outlives a failure, for the others to read it


def _rank_device(local_rank: int, device: str) -> torch.device:
    """The device of a launcher's ``local_rank``: the CPU when asked, else
    ``cuda:(local_rank % device_count)`` (a host's ranks share its cards
    round robin)."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=TIMEOUT_S)


def _client_store(spec):
    import torch.distributed as dist

    return dist.TCPStore(spec.host, spec.port, is_master=False, timeout=_timeout())


def _rank_main(local_rank: int, n_data: int, n_edge: int, device: str, tmp: str,
               spec=None) -> None:
    import traceback

    import torch.distributed as dist

    from gasfm_tpu_torch.parallel.edge_sharding import make_mesh

    fn, args = torch.load(os.path.join(tmp, "call.pt"), weights_only=False)
    torch.set_default_dtype(torch.float32)
    dev = _rank_device(local_rank, device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    world = n_data * n_edge
    if spec is None:
        rank, store = local_rank, dist.FileStore(os.path.join(tmp, "store"), world)
    else:
        rank = spec.local_ranks(world)[local_rank]
        coordinator = _client_store(spec)
        store = dist.PrefixStore("mesh", coordinator)
    try:
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=_timeout())
        mesh = make_mesh(n_data, n_edge, dev)
        result = fn(mesh, *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        if spec is not None:  # the mesh's first failure, for every launcher, before
            # this rank's connections close and its peers fail in their collectives
            coordinator.compare_set(FAILED, "", f"rank {rank} (process {spec.process_id}):\n"
                                    f"{traceback.format_exc()}")
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, n_data: int, n_edge: int, args: Sequence[Any] = (),
              device: str = "cuda", distributed=None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of an ``[n_data, n_edge]`` mesh
    (``fn`` importable by name: a module-level function) and return the
    ranks' results, in rank order. With ``distributed`` (this host's
    :class:`~gasfm_tpu_torch.parallel.edge_sharding.Distributed`) only this
    launcher's ranks run here, and only their results come back. On a CUDA
    device the kernels are built here first."""
    import torch.multiprocessing as mp

    world = n_data * n_edge
    ranks = range(world) if distributed is None else distributed.local_ranks(world)
    store = None if distributed is None else _launcher_store(distributed)
    tmp = tempfile.mkdtemp(prefix="gasfm_mesh_")
    try:
        if torch.device(device).type == "cuda":
            from gasfm_tpu_torch.ops.kernels import build as kb

            kb.build_all()
        # the call goes through a file: arguments larger than a pipe's buffer
        # would make each process's start wait for the one before to boot
        torch.save((fn, tuple(args)), os.path.join(tmp, "call.pt"))
        context = mp.spawn(_rank_main, nprocs=len(ranks), join=False,
                           args=(n_data, n_edge, device, tmp, distributed))
        _join(context, store)
        results = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                   for r in ranks]
    except Exception as e:
        if store is None:
            if isinstance(e, (mp.ProcessRaisedException, mp.ProcessExitedException)):
                raise RuntimeError(f"a rank of the [{n_data}, {n_edge}] mesh failed:\n{e}") \
                    from None
            raise
        # the mesh's first failure, wherever it was: this launcher's own
        # error when no rank wrote one (a failure before the spawn, or a rank
        # killed without a traceback)
        store.compare_set(FAILED, "", f"process {distributed.process_id}'s launcher:\n{e}")
        first = store.get(FAILED).decode()
        _finish(store, distributed, failed=True)
        raise RuntimeError(f"a rank of the [{n_data}, {n_edge}] mesh failed: {first}") from None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if store is not None:
        _finish(store, distributed)
    return results


def _launcher_store(spec):
    """This launcher's handle on the coordinator's store: process 0's
    launcher hosts it (binding ``spec.port``), the others connect and wait
    for it up to the store's timeout."""
    import torch.distributed as dist

    if spec.process_id == 0:
        return dist.TCPStore(spec.host, spec.port, is_master=True, timeout=_timeout(),
                             wait_for_workers=False)
    return _client_store(spec)


def _join(context, store) -> None:
    """Wait for a launcher's ranks; with a coordinator's ``store``, stop
    them as soon as a rank of another launcher has failed, or the store
    is lost."""
    try:
        while not context.join(timeout=POLL_S if store is not None else None):
            if store is not None and store.check([FAILED]):
                raise RuntimeError("another launcher's rank failed")
    except BaseException:
        for p in context.processes:
            if p.is_alive():
                p.kill()
        for p in context.processes:
            p.join()
        raise


def _finish(store, spec, failed: bool = False) -> None:
    """A launcher whose ranks are done, or stopped after a failure, says so;
    process 0's, which hosts the store, waits until every launcher has
    before the store goes with it: up to the store's timeout after its
    ranks succeeded (raising if a rank elsewhere failed meanwhile), up to
    ``GRACE_S`` after a failure, for the others to read it."""
    store.set(f"launch/done/{spec.process_id}", "1")
    if spec.process_id != 0:
        return
    keys = [f"launch/done/{p}" for p in range(spec.num_processes)]
    deadline = time.monotonic() + (GRACE_S if failed else TIMEOUT_S)
    while True:
        done = store.check(keys)  # a launcher writes its failure before this key
        if not failed and store.check([FAILED]):
            raise RuntimeError(f"a rank of the mesh failed after this launcher's ranks were "
                               f"done: {store.get(FAILED).decode()}")
        if done or failed and time.monotonic() > deadline:
            return
        if time.monotonic() > deadline:
            raise RuntimeError("the other launchers did not finish within the store's timeout")
        time.sleep(POLL_S)
