"""Process groups for the port's parallel paths.

Port of ``surfacenet_tpu/parallel/distributed.py`` on ``torch.distributed``:
one process per rank, launched as ``torchrun`` launches it (``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), or with the reference's ``COORDINATOR_ADDRESS``,
``NUM_PROCESSES`` and ``PROCESS_ID``.  Every rank calls
``init_distributed()`` before its first device touch; rank ``r`` then
works on ``cuda:(LOCAL_RANK % device_count)``, or on the CPU.

The backend follows from the layout, never from a failure: ``nccl`` when
the device is CUDA and every rank of the host has a card of its own,
``gloo`` otherwise (the CPU, or ranks sharing a card).  A failed NCCL
start raises; nothing retries on gloo.  The group's timeout (120 s) makes
a dead rank fail its peers instead of hanging them.

Gloo reduces CUDA tensors only through the host and sends point to point
only CPU tensors, so the collectives here stage a card tensor through a
host copy under gloo (``all_reduce_``, and the halo exchange's sends).

``launch_local`` starts the ranks of one host as subprocesses with that
environment, the way ``python -m torch.distributed.run --nproc_per_node
N`` does, and fails when one rank fails or the time runs out (the tests
and ``chip_smoke.py`` use it).
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from surfacenet_tpu_torch.device import resolve_device

TIMEOUT_S = 120


def _int_env(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v is not None:
            return int(v)
    return None


def choose_backend(device, local_world: int) -> str:
    """``nccl`` for CUDA ranks that each have a card of their own on the
    host, ``gloo`` for the CPU or for ranks sharing a card."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= local_world):
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Join the process group; True if one is (or already was) set up.

    Returns False, touching nothing, when neither the arguments nor the
    environment ask for one.  On CUDA it first makes
    ``cuda:(LOCAL_RANK % device_count)`` this process's current device.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    addr = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if addr is None and "MASTER_ADDR" in env:
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = num_processes or _int_env("WORLD_SIZE", "NUM_PROCESSES")
    rank = process_id if process_id is not None else _int_env(
        "RANK", "PROCESS_ID")
    if addr is None and world is None:
        return False
    if addr is None or world is None or rank is None:
        raise ValueError(
            f"incomplete process-group request: address {addr!r}, world "
            f"{world}, rank {rank} (set MASTER_ADDR/MASTER_PORT, WORLD_SIZE "
            "and RANK, as torchrun does)")
    dev = resolve_device(device)
    local_rank = _int_env("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    backend = choose_backend(dev, _int_env("LOCAL_WORLD_SIZE") or world)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"process group: {world} rank(s), backend {backend}, device "
              f"{dev.type}", flush=True)
    return True


def process_info():
    """(rank, world size): (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (through the host under gloo)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_object(obj, src: int = 0, group=None):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src, group=group)
    return box[0]


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def launch_local(argv: Sequence[str], world: int, timeout_s: float,
                 env: Optional[dict] = None, cwd: Optional[str] = None
                 ) -> List[str]:
    """Run ``argv`` as ``world`` ranks on this host, as torchrun would.

    Each rank gets the torchrun variables (one free port on 127.0.0.1).
    Returns the ranks' combined stdout and stderr once all exit 0; raises
    with every rank's output when one exits otherwise or when
    ``timeout_s`` passes, after killing the ranks still running.
    """
    with socket.socket() as s:  # a free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = dict(os.environ if env is None else env)
    procs, logs = [], []
    try:
        for r in range(world):
            e = dict(base, RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(list(argv), env=e, cwd=cwd,
                                          stdout=log,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        failed = None
        while failed is None:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0][0]} exited with {bad[0][1]}"
            elif time.monotonic() > deadline:
                failed = f"timed out after {timeout_s} s"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed is not None:
        text = "\n".join(f"--- rank {r} ---\n{o}" for r, o in enumerate(outs))
        raise RuntimeError(f"{' '.join(argv)}: {failed}\n{text}")
    return outs
