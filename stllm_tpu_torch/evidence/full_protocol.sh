#!/usr/bin/env bash
# The port's evidence harnesses (stllm_tpu_torch/evidence/) at their full
# protocols, in order, on one CUDA card, from the repository root:
#
#   bash stllm_tpu_torch/evidence/full_protocol.sh [OUT_DIR [STEP...]]
#
# STEP is int8, w4a16, tome, probe, trained, depth, mem7b, tp7b or
# tp7b_serve (default: all nine, in that order; trained also harvests its
# log). The documents (EQUIV_INT8.json, TOME_EQUIV.json, MEM7B.json,
# TP7B_CHECK.json, TP7B_SERVE.json) land in OUT_DIR (default
# evidence_out/), each harness's output in OUT_DIR/<step>.log, and a line
# "== <step> rc=<code> <seconds> s" after each. A failed harness does not
# stop the ones after it; the script exits with the last failure's code.
set -u
out=${1:-evidence_out}
shift || true
steps=${*:-int8 w4a16 tome probe trained depth mem7b tp7b tp7b_serve}
mkdir -p "$out"
status=0
ev=stllm_tpu_torch.evidence

run() {
    local step=$1
    shift
    local start
    start=$(date +%s)
    echo "== $step: python3 -m $* ($(nvidia-smi --query-gpu=name,power.limit \
        --format=csv,noheader | head -n 1))"
    python3 -m "$@" 2>&1 | tee "$out/$step.log"
    local rc=${PIPESTATUS[0]}
    echo "== $step rc=$rc $(( $(date +%s) - start )) s"
    if [ "$rc" -ne 0 ]; then status=$rc; fi
}

for step in $steps; do
    case $step in
        int8) run int8 $ev.int8_equivalence 100 int8 --out-dir "$out" ;;
        w4a16) run w4a16 $ev.int8_equivalence 100 w4a16 --out-dir "$out" ;;
        tome) run tome $ev.tome_equivalence 60 --out-dir "$out" ;;
        probe) run probe $ev.probe_spec_divergence ;;
        trained)
            run trained $ev.int8_equivalence_trained 400 32 16 8 --out-dir "$out"
            run harvest $ev.harvest_trained_levels "$out/trained.log" --out-dir "$out" ;;
        depth) run depth $ev.w4a16_depth 400 16 4 8 16 --out-dir "$out" ;;
        mem7b) run mem7b $ev.mem7b --out-dir "$out" ;;
        tp7b) run tp7b $ev.tp7b_check --out-dir "$out" ;;
        tp7b_serve) run tp7b_serve $ev.tp7b_serve_check --out-dir "$out" ;;
        *) echo "unknown step $step"; status=2 ;;
    esac
done
exit $status
