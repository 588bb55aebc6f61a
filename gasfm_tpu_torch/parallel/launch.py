"""Launch the ranks of a mesh: one process per position.

Counterpart of the JAX package's ``initialize_distributed``
(``edge_sharding.py:212``) for one host: :func:`run_ranks` spawns ``n_data *
n_edge`` processes with ``torch.multiprocessing`` (``spawn``: each starts a
fresh interpreter, so no CUDA state is inherited), which meet on a
``FileStore`` in a temporary directory (no network, no port to pick) and
join one gloo process group with a timeout. Each rank calls ``fn(mesh,
*args)`` on its device, ``cuda:(rank % device_count)`` unless ``device`` is
"cpu", with one intra-op thread on the CPU and float32 as torch's default
dtype; its return value comes back to the caller in rank order. A rank that
raises stops every rank, and the launcher raises with that rank's
traceback.

On the card the kernels are built in the launching process first
(``ops/kernels/build.build_all``): ranks that each found the build
directory empty would run nvcc into it at once.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, List, Sequence

import torch

TIMEOUT_S = 900  # a collective that waits longer fails its rank


def _rank_device(rank: int, device: str) -> torch.device:
    """The device of ``rank``: the CPU when asked, else ``cuda:(rank %
    device_count)`` (ranks share the cards round robin)."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, n_data: int, n_edge: int, device: str, tmp: str) -> None:
    import torch.distributed as dist

    from gasfm_tpu_torch.parallel.edge_sharding import make_mesh

    fn, args = torch.load(os.path.join(tmp, "call.pt"), weights_only=False)
    torch.set_default_dtype(torch.float32)
    dev = _rank_device(rank, device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    world = n_data * n_edge
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_mesh(n_data, n_edge, dev)
        result = fn(mesh, *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n_data: int, n_edge: int, args: Sequence[Any] = (),
              device: str = "cuda") -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of an ``[n_data, n_edge]`` mesh
    (``fn`` importable by name: a module-level function) and return the
    ranks' results, in rank order. On a CUDA device the kernels are built
    here first."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        from gasfm_tpu_torch.ops.kernels import build as kb

        kb.build_all()
    tmp = tempfile.mkdtemp(prefix="gasfm_mesh_")
    try:
        world = n_data * n_edge
        # the call goes through a file: arguments larger than a pipe's buffer
        # would make each process's start wait for the one before to boot
        torch.save((fn, tuple(args)), os.path.join(tmp, "call.pt"))
        mp.spawn(_rank_main, nprocs=world, join=True, args=(n_data, n_edge, device, tmp))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise RuntimeError(f"a rank of the [{n_data}, {n_edge}] mesh failed:\n{e}") from None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
