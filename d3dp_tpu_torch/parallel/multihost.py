"""Process groups: joining one, starting one process per rank, and a
process's share of a global batch.

Counterpart of d3dp_tpu/parallel/multihost.py on torch.distributed. In the
port one process drives one device, so where a JAX process spans every
device of its host, here the multi-host flags name processes: process i
drives card i modulo the host's card count. `global_batch` has no
counterpart: there is no global array to assemble, a rank holds only its
own rows (`mesh.put_global` places them). Single-device runs never need
this module.
"""

import os
import socket
import tempfile

import torch
import torch.distributed as dist


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None,
                         backend=None):
    """Join the process group; returns (rank, world size).

    With `coordinator_address` ("host:port") the group rendezvouses there
    over TCP, and `num_processes` and `process_id` are required. With no
    arguments it reads torchrun's environment (`env://`: MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK), the counterpart of JAX's
    auto-detection. `backend`: nccl where torch sees a card, else gloo."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator-address needs --num-hosts and --host-id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def host_slice(batch_axis_size):
    """This process's [lo, hi) share of a global batch axis."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = batch_axis_size // n
    return i * per, (i + 1) * per


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, port, backend, threads, result_path, args):
    torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        torch.save(result, result_path)


def spawn(fn, world, *args, backend="gloo"):
    """Run fn(*args) in `world` new processes (start method spawn), rank r
    of a process group on a free localhost port in each; returns rank 0's
    result (a copy, through a file) when all have ended, and raises if one
    failed. `fn` and `args` are pickled, so `fn` is a module-level
    function. The ranks share this process's CPU threads: more threads than
    cores make every rank's CPU ops crawl."""
    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "rank0.pt")
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, _free_port(), backend, threads, result_path, args),
            nprocs=world, start_method="spawn")
        return torch.load(result_path, weights_only=False)

