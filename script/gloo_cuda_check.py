"""Which of the port's collectives the gloo backend takes on CUDA tensors.

Two ranks share card 0 over gloo (NCCL refuses two ranks on one device) and
run one collective that ``stllm_tpu_torch/parallel`` or the ring attention
calls, on CUDA tensors, checked against the value it must have; each
collective gets a fresh pair of processes, since gloo can abort a process
instead of raising. Prints one JSON line: {collective: "ok" | the error}.

    python3 script/gloo_cuda_check.py
"""

from __future__ import annotations

import json
import multiprocessing
import os
import queue
import socket
import sys
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _cases(rank: int):
    from stllm_tpu_torch.ops.ring_attention import _send_recv
    from stllm_tpu_torch.parallel import collectives as coll

    dev = torch.device("cuda", 0)
    world = dist.group.WORLD
    x = torch.arange(8, dtype=torch.float32, device=dev).reshape(4, 2) + 10 * rank
    both = torch.cat([torch.arange(8.0).reshape(4, 2), torch.arange(8.0).reshape(4, 2) + 10])

    def new_group():
        t = torch.ones(2, device=dev)
        dist.all_reduce(t, group=dist.new_group([0, 1]))
        return t

    return {
        "all_gather (gather_many, uint8 bytes)": (
            lambda: coll.gather_many([x], [0], world)[0], both),
        "reduce_scatter (reduce_scatter_many)": (
            lambda: coll.reduce_scatter_many([x], [0], world)[0],
            (both[:4] + both[4:])[2 * rank:2 * rank + 2]),
        "all_reduce (all_reduce_many, psum_scalar)": (
            lambda: coll.all_reduce_many([x], world)[0], both[:4] + both[4:]),
        "batch_isend_irecv (ring rotation)": (
            lambda: _send_recv(x, world, 1), both[4:] if rank == 0 else both[:4]),
        "new_group + all_reduce": (new_group, torch.full((2,), 2.0)),
    }


def _rank(rank: int, port: int, case: str, results) -> None:
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=2, timeout=timedelta(seconds=60))
        fn, want = _cases(rank)[case]
        got = fn()
        results.put((rank, "ok" if got.is_cuda and torch.equal(got.cpu(), want)
                     else f"wrong value {got.cpu().tolist()}"))
    except Exception as e:  # the finding is which ones raise, and how
        results.put((rank, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(case: str) -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, case, results)) for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:      # drain before joining; a rank that aborts reports nothing
        while len(got) < 2:
            rank, msg = results.get(timeout=120)
            got[rank] = msg
    except queue.Empty:
        pass
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.terminate()
            p.join()
    if len(got) < 2:
        return f"aborted: exit codes {[p.exitcode for p in procs]}, ranks reporting {got}"
    return got[0] if got[0] == got[1] else f"ranks disagree: {got}"


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_check: no CUDA device", file=sys.stderr)
        return 1
    names = ["all_gather (gather_many, uint8 bytes)", "reduce_scatter (reduce_scatter_many)",
             "all_reduce (all_reduce_many, psum_scalar)", "batch_isend_irecv (ring rotation)",
             "new_group + all_reduce"]
    print(json.dumps({"torch": torch.__version__, "card": torch.cuda.get_device_name(0),
                      "gloo_on_cuda": {name: _run(name) for name in names}}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
