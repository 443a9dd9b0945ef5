"""Multi-rank dry run: one FSDP x TP optimizer step and a context-parallel
forward on n ranks (the counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m stllm_tpu_torch.dryrun 4          # four cards
    python -m stllm_tpu_torch.dryrun 4 --cpu    # four CPU ranks over gloo

``spawn(fn, n, ...)`` is the launcher it runs on: n processes, each joined
to one process group as rank r (``parallel.mesh.init_distributed`` over a
loopback port), each calling ``fn(rank, device, *args)``; it returns the
ranks' results in rank order and raises if a rank fails or outlives the
time limit (``start`` returns at once and waits later). By default the
ranks run on the cards, one each, and fewer cards than ranks raise: the
reference re-executes itself on a virtual CPU mesh instead, and the port
never carries on on the CPU unasked.
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List

import numpy as np
import torch

TINY = dict(
    vit=dict(image_size=56, patch_size=14, width=64, depth=2, heads=4, mlp_hidden=128,
             use_flash=False),
    qformer=dict(hidden=32, num_layers=2, heads=4, intermediate=64, encoder_width=64,
                 num_query=8, vocab_size=128),
    llama=dict(vocab_size=256, hidden=64, num_layers=2, heads=4, intermediate=128,
               max_positions=512),
    video_input="residual", residual_size=2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, n: int, port: int, device, timeout_s: float, inbox, results):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(n), LOCAL_RANK=str(rank))
    import torch.distributed as dist

    from stllm_tpu_torch.parallel.mesh import init_distributed

    if device == "cpu":
        torch.set_num_threads(1)    # n ranks share the host's cores
    try:
        args = inbox.get(timeout=timeout_s)
        dev = init_distributed(device, timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, None, fn(rank, dev, *args)))
    except BaseException:  # report, then exit non-zero
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start(fn: Callable, n: int, *args, device=None, timeout_s: float = 60.0
          ) -> Callable[[], List[Any]]:
    """Start ``fn(rank, device, *args)`` on n ranks of one process group and
    return a function that waits for them and returns their results in
    rank order, so the caller can work while the ranks run. ``fn`` must be
    importable by name and its results picklable; a collective waits at
    most ``timeout_s`` for a rank, and the whole run at most ten times
    that. A rank that fails, or the time limit, raises; every process is
    gone when the wait returns."""
    ctx = multiprocessing.get_context("spawn")
    inbox, results = ctx.Queue(), ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, port, device, timeout_s, inbox,
                                                  results), daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    # the arguments go through a queue: a start() whose arguments outgrow the
    # pipe's buffer would wait for its child to boot before the next one starts
    for _ in procs:
        inbox.put(args)

    def wait() -> List[Any]:
        got, errors = {}, []
        deadline = time.monotonic() + timeout_s * 10
        try:
            while len(got) < n and not errors:
                try:
                    rank, err, out = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode and r not in got]
                    if dead:
                        errors.append(f"ranks {dead} exited with codes "
                                      f"{[procs[r].exitcode for r in dead]}")
                    elif time.monotonic() > deadline:
                        errors.append(f"no result within {timeout_s * 10:.0f} s from ranks "
                                      f"{sorted(set(range(n)) - set(got))}")
                    continue
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                got[rank] = out
            for p in procs:
                p.join(timeout=timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
            inbox.close()
        if errors or any(p.exitcode for p in procs):
            raise RuntimeError(f"ranks of {getattr(fn, '__name__', fn)} failed: " + (
                "\n".join(errors) or f"exit codes {[p.exitcode for p in procs]}"))
        return [got[r] for r in range(n)]

    return wait


def spawn(fn: Callable, n: int, *args, device=None, timeout_s: float = 60.0) -> List[Any]:
    """``start(...)`` and wait: the ranks' results in rank order."""
    return start(fn, n, *args, device=device, timeout_s=timeout_s)()


def tiny_cfg(dtype=torch.float32):
    """The dry run's tiny ST-LLM config (``__graft_entry__._tiny_cfg``)."""
    from stllm_tpu_torch.models.llama import LlamaConfig
    from stllm_tpu_torch.models.qformer import QFormerConfig
    from stllm_tpu_torch.models.stllm import STLLMConfig
    from stllm_tpu_torch.models.vit import ViTConfig

    return STLLMConfig(vit=ViTConfig(dtype=dtype, **TINY["vit"]),
                       qformer=QFormerConfig(dtype=dtype, **TINY["qformer"]),
                       llama=LlamaConfig(dtype=dtype, **TINY["llama"]),
                       video_input=TINY["video_input"], residual_size=TINY["residual_size"])


def tiny_batch(cfg, b: int, t: int, seq_len: int, seed: int = 0):
    """A packed batch of ``b`` rows (``__graft_entry__._batch``), numpy."""
    from stllm_tpu_torch.data.packing import pack_training_batch, sample_video_mask

    rng = np.random.default_rng(seed)
    v = cfg.num_video_tokens(t)
    keep = sample_video_mask(rng, b, v)
    batch = pack_training_batch(
        [[5, 6, 7]] * b, [[8, 9]] * b,
        [list(rng.integers(10, cfg.llama.vocab_size - 1, 4)) for _ in range(b)],
        num_video=v, seq_len=seq_len, pad_id=0, keep=keep)
    s = cfg.vit.image_size
    batch["frames"] = rng.normal(size=(b, t, s, s, 3)).astype(np.float32)
    batch["qformer_input_ids"] = rng.integers(0, cfg.qformer.vocab_size, (b, 6)).astype(np.int32)
    batch["qformer_attention_mask"] = np.ones((b, 6), np.int32)
    return batch


def dryrun_rank(rank: int, device, n_devices: int) -> dict:
    """One rank's part of ``dryrun_multichip``."""
    from stllm_tpu_torch.models.llama import llama_forward
    from stllm_tpu_torch.models.stllm import init_stllm
    from stllm_tpu_torch.parallel.context import context_parallel_forward
    from stllm_tpu_torch.parallel.mesh import make_mesh
    from stllm_tpu_torch.parallel.sharding import gather_tree
    from stllm_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    data = n_devices // model
    mesh = make_mesh(data=data, model=model)
    cfg = tiny_cfg()
    params = init_stllm(torch.Generator(device=device).manual_seed(0), cfg)
    opt = make_optimizer(1e-3)
    state = create_train_state(params, opt, mesh=mesh, min_size=64)
    # 2 rows per data shard, accumulated over 2 micro-batches
    batch = tiny_batch(cfg, b=2 * data, t=4, seq_len=64)
    step = make_train_step(cfg, opt, accum_steps=2, mesh=mesh)
    state, metrics = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss} in the multi-rank dry run")

    # sequence parallelism: the context-parallel LLaMA forward (ring attention
    # over the data axis) against the dense forward
    llama = gather_tree(mesh, state.tree["llama"], state.specs["llama"])
    embeds = torch.as_tensor(np.random.default_rng(0).normal(
        size=(2, 16 * data, cfg.llama.hidden)) * 0.1, dtype=torch.float32, device=device)
    with torch.no_grad():
        cp = context_parallel_forward(llama, embeds, mesh, cfg.llama, axis_name="data")
        dense, _ = llama_forward(llama, inputs_embeds=embeds, cfg=cfg.llama)
    cp_err = float((cp - dense).abs().max())
    if cp_err >= 1e-3:
        raise AssertionError(f"context-parallel mismatch {cp_err}")
    line = (f"dryrun_multichip({n_devices}): mesh={mesh.shape} loss={loss:.4f} "
            f"mvm={float(metrics['loss_mvm']):.4f} cp_err={cp_err:.2e}")
    return {"line": line, "loss": loss, "loss_mvm": float(metrics["loss_mvm"]),
            "cp_err": cp_err, "mesh": dict(mesh.shape)}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Spawn ``n_devices`` ranks (cards by default, ``device="cpu"`` for
    gloo ranks on the CPU), run ``dryrun_rank`` on each, print rank 0's
    summary line and return its numbers."""
    if device is None and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} cards, "
                           f"{torch.cuda.device_count()} are visible; pass device='cpu' "
                           "to run the ranks on the CPU")
    out = spawn(dryrun_rank, n_devices, n_devices, device=device)[0]
    print(out["line"])
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
