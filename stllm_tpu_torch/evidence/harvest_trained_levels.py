"""Merge the per-level results of a (possibly still running)
int8_equivalence_trained log into TOME_EQUIV.json.

The trained harness prints one JSON line for each completed ToMe level but
writes TOME_EQUIV.json only after all levels finish; a run cut short would
lose every completed level. This lifts the per-level lines from the log, so
the document holds the evidence that exists.

    python -m stllm_tpu_torch.evidence.harvest_trained_levels [LOG] [--cpu] [--out-dir DIR]

Idempotent; safe to run while the harness is still writing the log. It only
reads and writes files, but like every harness it expects the card unless
``--cpu`` is passed. The section's "device" is the one the log names (the
trained harness prints it first).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Tuple

from stllm_tpu_torch.evidence import _common
from stllm_tpu_torch.ops.tome import MERGE_LEVELS

HARNESS = "stllm_tpu_torch.evidence.harvest_trained_levels"
MODEL = ("4096-width 8-layer LLaMA + 1408-width 16-block ViT (full matmul "
         "shapes, reduced depth), trained to emit fixed 16-token answers; "
         "half the videos smooth, half iid noise")


def read_log(log: str) -> Tuple[Dict[str, Dict], Optional[str]]:
    """The completed levels of ``log`` and the device line it names."""
    levels, device = {}, None
    with open(log) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(doc.get("device"), str):
                device = doc["device"]
            for k, v in doc.items():
                if k in MERGE_LEVELS and isinstance(v, dict) and "smooth_video" in v:
                    levels[k] = v
    return levels, device


def harvest(log: str, out_dir: str) -> Dict:
    """Lift the completed levels of ``log`` into ``out_dir``/TOME_EQUIV.json.
    Returns {"harvested": [...], "pending": [...]}, or None when the log
    holds no completed level (nothing is written)."""
    levels, device = read_log(log)
    if not levels:
        return None
    path = os.path.join(out_dir, _common.TOME_EQUIV)
    tdoc = _common.read_doc(path)
    # supersedes the older n=8 8-block arms once any deeper arm exists
    tdoc.pop("trained_model_medium", None)
    tdoc.pop("trained_model_t_medium", None)
    sect = tdoc.setdefault("trained_levels", {"model": MODEL, "levels": {}})
    sect["levels"].update(levels)
    # the sample count comes from the harness's own per-arm output: a
    # partial or smoke run with a smaller n is not mislabelled
    sect["n_per_subset"] = min(arm["smooth_video"]["n"] for arm in sect["levels"].values())
    done = sorted(sect["levels"])
    missing = sorted(k for k in MERGE_LEVELS if k != "off" and k not in sect["levels"])
    if missing:
        sect["note"] = (f"harvested incrementally from the running "
                        f"equivalence job; levels still pending: {missing}")
    else:
        sect.pop("note", None)
    sect["device"] = device or sect.get("device", "not named in the log")
    sect["harness"] = HARNESS
    _common.write_doc(path, tdoc)
    return {"harvested": done, "pending": missing}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="lift the per-level lines of an int8_equivalence_trained log into "
                    "TOME_EQUIV.json")
    parser.add_argument("log", nargs="?", default="/tmp/equiv_trained_r5b.log",
                        help="the trained harness's log (default /tmp/equiv_trained_r5b.log)")
    _common.add_device_args(parser)
    args = parser.parse_args(argv)
    if _common.pick_device(args, parser.prog) is None:
        return 1
    out = harvest(args.log, args.out_dir)
    if out is None:
        print("no completed levels in", args.log)
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
