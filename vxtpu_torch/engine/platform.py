"""Platform discovery, start-up checks and the process group
(counterpart of ``vxtpu/engine/platform.py``).

vxtpu asks JAX for its devices, checks that the scene fits a chip's HBM
and that the mesh fits the devices, and joins a multi-host job with
``jax.distributed.initialize``. Here the devices come from
``torch.cuda.get_device_properties``, the kernels are built for sm_90a
(so any other card is refused), and a job is a ``torch.distributed``
process group: NCCL between GPUs, gloo between CPU processes (or between
ranks that share one GPU, which NCCL cannot). ``run_local`` spawns n such
ranks on one machine, the counterpart of vxtpu's 8 virtual CPU devices.

vxtpu's ``enable_compilation_cache`` (a persistent XLA cache) has no
counterpart: the CUDA sources build in seconds at first use.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import tempfile
import traceback

import torch
import torch.distributed as dist

from vxtpu_torch.device import DEFAULT, resolve

# the compute capability the CUDA kernels are built for (sm_90a)
KERNEL_CAPABILITY = (9, 0)
# the budget of a CPU "device", as vxtpu's table gives it
CPU_BYTES = 8 * 1024 ** 3

# how long a collective (and the group's start) waits for every rank
GROUP_TIMEOUT = datetime.timedelta(seconds=300)
# the device this process's rank works on, set by init_multihost
_rank_device: torch.device | None = None


@dataclasses.dataclass(frozen=True)
class PlatformInfo:
    backend: str                    # "cuda" or "cpu"
    device_kind: str                # the card's name, or "cpu"
    num_devices: int                # cards visible to this process
    num_hosts: int                  # ranks of the process group (1 if none)
    hbm_bytes: int                  # device memory of one card
    capability: tuple | None        # (major, minor) of a card


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def platform_info(device=DEFAULT) -> PlatformInfo:
    device = resolve(device)
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return PlatformInfo("cuda", props.name, torch.cuda.device_count(),
                            world_size(), int(props.total_memory),
                            (props.major, props.minor))
    return PlatformInfo("cpu", "cpu", 1, world_size(), CPU_BYTES, None)


def platform_report(device=DEFAULT) -> dict:
    """JSON-friendly platform summary (the CLI's ``info``)."""
    return dataclasses.asdict(platform_info(device))


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a dataclass / list / tuple / dict tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tensor_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def validate_platform(scene_tree=None, mesh_devices: int | None = None,
                      hbm_headroom: float = 0.75,
                      device=DEFAULT) -> PlatformInfo:
    """Fail fast before any work: the card is the one the kernels are
    built for, the scene (replicated on every rank) fits
    ``hbm_headroom`` of one card's memory, and the requested mesh fits
    the process group."""
    info = platform_info(device)
    if info.backend == "cuda" and info.capability != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"{info.device_kind} has compute capability "
            f"{info.capability}; vxtpu_torch's CUDA kernels are built for "
            f"sm_90a (capability {KERNEL_CAPABILITY}, an H100)")
    if mesh_devices is not None and mesh_devices > info.num_hosts:
        raise RuntimeError(
            f"requested a mesh of {mesh_devices} ranks but the process "
            f"group has {info.num_hosts}")
    if scene_tree is not None:
        need = tensor_bytes(scene_tree)
        budget = int(info.hbm_bytes * hbm_headroom)
        if need > budget:
            raise RuntimeError(
                f"scene needs {need / 1e9:.2f} GB but the per-device "
                f"budget is {budget / 1e9:.2f} GB ({info.device_kind}); "
                "shrink the grid or drop per-voxel attributes")
    return info


def rank_device() -> torch.device:
    """The device init_multihost gave this rank."""
    if _rank_device is None:
        raise RuntimeError("no process group: call init_multihost first")
    return _rank_device


def init_multihost(init_method: str | None = None,
                   world_size: int | None = None, rank: int | None = None,
                   backend: str | None = None,
                   device=DEFAULT) -> PlatformInfo:
    """Join the process group (vxtpu's ``jax.distributed.initialize``).

    With no arguments it reads what ``torchrun`` sets (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK); with no launcher environment
    either it starts a 1-rank group, the single-process run. The backend
    is NCCL on ``cuda`` and gloo on ``cpu`` unless given; a rank's device
    is ``cuda:LOCAL_RANK`` (or ``device`` when it names an index).
    Idempotent: a second call returns at once. Any failure re-raises: a
    job whose ranks each went on alone would train divergent copies and
    report success."""
    global _rank_device
    device = resolve(device)
    if dist.is_initialized():
        return platform_info(_rank_device or device)
    env = os.environ
    launched = "WORLD_SIZE" in env and "RANK" in env
    if device.type == "cuda" and device.index is None:
        local = int(env.get("LOCAL_RANK", 0)) if launched else 0
        device = torch.device("cuda", local % torch.cuda.device_count())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = dict(backend=backend, timeout=GROUP_TIMEOUT)
    if init_method is not None or world_size is not None:
        kw.update(init_method=init_method, world_size=world_size, rank=rank)
    elif not launched:
        # nothing to join: a group of this process alone
        kw.update(store=dist.HashStore(), world_size=1, rank=0)
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(**kw)
    except Exception as e:
        raise RuntimeError(
            "torch.distributed.init_process_group() failed — refusing to "
            "continue as independent single-host replicas (each would "
            f"train a divergent copy and report success): {e}") from e
    _rank_device = device
    return platform_info(device)


def shutdown() -> None:
    """Leave the process group (if any)."""
    global _rank_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device = None


def _local_rank(rank, n, store, backend, device, fn, args, queue):
    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        init_multihost(init_method=store, world_size=n, rank=rank,
                       backend=backend, device=dev)
        out = fn(*args)
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def run_local(n: int, fn, backend: str = "gloo", device="cpu",
              timeout: float = 60.0, args: tuple = ()) -> list:
    """Run ``fn(*args)`` on n ranks of one process group, each a process
    started by the ``spawn`` context, joined through a ``file://`` store
    in a temporary directory (no port to collide). ``fn`` must be a
    module-level function; it finds its rank with
    ``torch.distributed.get_rank()``. Returns each rank's result, by rank
    (results cross a process boundary: return CPU tensors or numbers).
    Raises if any rank fails or the ranks do not finish within
    ``timeout`` seconds; every process is ended either way."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="vxtpu_run_local_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_local_rank,
                             args=(r, n, store, backend, str(device), fn,
                                   args, queue), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        results, errors = {}, {}
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout)
        try:
            while len(results) + len(errors) < n:
                left = (deadline - datetime.datetime.now()).total_seconds()
                if left <= 0:
                    break
                try:
                    r, ok, out = queue.get(timeout=min(left, 1.0))
                except Exception:
                    if any(p.exitcode not in (None, 0) for p in procs) \
                            and queue.empty():
                        break
                    continue
                (results if ok else errors)[r] = out
            for p in procs:
                p.join(timeout=max(
                    1.0, (deadline - datetime.datetime.now()).total_seconds()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5.0)
    if errors:
        r = min(errors)
        raise RuntimeError(f"run_local: rank {r} of {n} failed:\n{errors[r]}")
    missing = [r for r in range(n) if r not in results]
    if missing:
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"run_local: ranks {missing} of {n} gave no "
                           f"result within {timeout} s (exit codes "
                           f"{codes})")
    return [results[r] for r in range(n)]
