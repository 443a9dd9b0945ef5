"""Same-session A/B of the serving throughput of two trees of the port:
parent, change, change, parent (script/bench_serving_ab.py).

The reference checks out a fixed earlier commit as a git worktree and runs
its bench_serving and the current tree's back to back, A/B/B/A, correcting
the older arm for the round trips of its remote session; that correction
and its keys have no counterpart here. The parent is ``git archive``
of a revision (default HEAD~1) unpacked into a temporary directory, or a
tree given whole (``--parent-tree``); each run is
``python -m stllm_tpu_torch.timing.bench_serving`` in its own process,
started in its tree with only that tree on ``PYTHONPATH``, so each tree
builds its kernels into its own (ignored) ``stllm_tpu_torch/_build/`` and
the parent never loads the change's libraries. The order parent, change,
change, parent cancels a linear drift over the session.

    python -m stllm_tpu_torch.timing.bench_serving_ab [n_requests] [slots]
        [--rev REV | --parent-tree DIR] [--cpu] [--out-dir DIR]

Merges the "ab" section into DIR/BENCH_SERVING.json (default timing_out/):
every run's document (its raw drains included), the best tokens/s of each
arm and both ratios, change over parent, of the greedy drains and of the
sampled mix.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional

from stllm_tpu_torch.timing import _common

HARNESS = "stllm_tpu_torch.timing.bench_serving_ab"
DOC = "BENCH_SERVING.json"
CHANGE = Path(__file__).resolve().parents[2]     # the tree this module runs from
ORDER = ("parent", "change", "change", "parent")
BENCH = "stllm_tpu_torch.timing.bench_serving"
RUN_TIMEOUT = 1800


def unpack_revision(rev: str, repo: Path = CHANGE) -> Path:
    """``git archive rev`` of ``repo`` unpacked into a new temporary
    directory."""
    dest = Path(tempfile.mkdtemp(prefix="stllm_ab_parent_"))
    archive = subprocess.run(["git", "-C", str(repo), "archive", "--format=tar", rev],
                             capture_output=True, check=True)
    subprocess.run(["tar", "-x", "-C", str(dest)], input=archive.stdout, check=True)
    return dest


def bench_command(n: int, slots: int, out_dir: Path, cpu: bool) -> List[str]:
    cmd = [sys.executable, "-m", BENCH, str(n), str(slots), "--out-dir", str(out_dir)]
    return cmd + (["--cpu"] if cpu else [])


def run_bench(tree: Path, cmd: List[str], out_dir: Path) -> Dict:
    """``cmd`` in ``tree`` with only ``tree`` on PYTHONPATH; the document
    it wrote into ``out_dir``."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run(cmd, cwd=str(tree), env=env, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} in {tree} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    with open(out_dir / DOC) as f:
        return json.load(f)


def ab(parent: Path, n: int, slots: int, cpu: bool,
       runner: Optional[Callable[[Path, List[str], Path], Dict]] = None,
       change: Path = CHANGE) -> Dict:
    """The four runs in ``ORDER`` through ``runner`` (default ``run_bench``),
    each writing into a fresh directory, and the section: every run's
    document, each arm's best and the ratios."""
    runner = runner or run_bench
    if not (parent / "stllm_tpu_torch" / "timing" / "bench_serving.py").exists():
        raise FileNotFoundError(f"{parent} holds no stllm_tpu_torch/timing/bench_serving.py")
    trees = {"parent": parent, "change": change}
    runs: Dict[str, List[Dict]] = {"parent": [], "change": []}
    scratch = Path(tempfile.mkdtemp(prefix="stllm_ab_runs_"))
    try:
        for i, arm in enumerate(ORDER):
            out_dir = scratch / f"{i}_{arm}"
            out_dir.mkdir()
            doc = runner(trees[arm], bench_command(n, slots, out_dir, cpu), out_dir)
            runs[arm].append(doc)
            print(json.dumps({arm: {k: doc.get(k) for k in (
                "tokens_per_s", "sampled_mix_tokens_per_s", "drain_s")}}), flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    best = {arm: max(r["tokens_per_s"] for r in rs) for arm, rs in runs.items()}
    mix = {arm: max(r["sampled_mix_tokens_per_s"] for r in rs) for arm, rs in runs.items()}
    return {
        "protocol": f"parent/change/change/parent, one process a run, n={n}, slots={slots}, "
                    "best per arm",
        "order": list(ORDER),
        "parent_tree": str(parent),
        "change_tokens_per_s": best["change"],
        "parent_tokens_per_s": best["parent"],
        "change_sampled_mix_tokens_per_s": mix["change"],
        "parent_sampled_mix_tokens_per_s": mix["parent"],
        "ratio_change_over_parent": best["change"] / best["parent"],
        "sampled_mix_ratio_change_over_parent": mix["change"] / mix["parent"],
        "change_runs": runs["change"],
        "parent_runs": runs["parent"],
    }


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="serving throughput of the parent tree against this one, "
                    "parent/change/change/parent")
    parser.add_argument("n_requests", nargs="?", type=int, default=24,
                        help="requests a drain (default 24)")
    parser.add_argument("slots", nargs="?", type=int, default=8, help="decode slots (default 8)")
    parent = parser.add_mutually_exclusive_group()
    parent.add_argument("--rev", default="HEAD~1",
                        help="the parent revision, unpacked by git archive (default HEAD~1)")
    parent.add_argument("--parent-tree", help="an unpacked parent tree instead of --rev")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    tree = Path(args.parent_tree) if args.parent_tree else unpack_revision(args.rev)
    try:
        section = ab(tree.resolve(), args.n_requests, args.slots, args.cpu)
    finally:
        if not args.parent_tree:
            shutil.rmtree(tree, ignore_errors=True)
    section["parent"] = args.parent_tree or args.rev
    print(json.dumps({k: v for k, v in section.items() if not k.endswith("_runs")}), flush=True)
    _common.merge_doc(args.out_dir, DOC,
                      lambda doc: doc.update(ab=_common.stamp(section, device, HARNESS)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
