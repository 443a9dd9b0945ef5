#!/usr/bin/env bash
# The port's timing harnesses (stllm_tpu_torch/timing/) at the JAX scripts'
# default protocols, in order, on one CUDA card, from the repository root:
#
#   bash stllm_tpu_torch/timing/full_protocol.sh [OUT_DIR [STEP...]]
#
# STEP is decode, profile, serving, pipeline_serving, encode_static,
# train_step, pipeline, btadapter, tome, beam, prefix, longctx, spec_decode,
# spec_trained, spec_serving, decode_budget, w4_unpack or call_fusion
# (default: all, in that order; bench_serving_ab needs a parent tree and
# runs by hand). The documents
# (BENCH_*.json) land in OUT_DIR (default timing_out/), each harness's
# output in OUT_DIR/<step>.log, and a line "== <step> rc=<code> <seconds> s"
# after each. A failed harness does not stop the ones after it; the script
# exits with the last failure's code. bench_pipeline --from-video writes
# its clips with cv2 (last in its step, it overwrites the "int4" section).
set -u
out=${1:-timing_out}
shift || true
steps=${*:-decode profile serving pipeline_serving encode_static train_step pipeline \
btadapter tome beam prefix longctx spec_decode spec_trained spec_serving decode_budget \
w4_unpack call_fusion}
mkdir -p "$out"
status=0
t=stllm_tpu_torch.timing

run() {
    local step=$1
    shift
    local start
    start=$(date +%s)
    echo "== $step: python3 -m $* ($(nvidia-smi --query-gpu=name,power.limit \
        --format=csv,noheader | head -n 1))"
    python3 -m "$@" 2>&1 | tee -a "$out/$step.log"
    local rc=${PIPESTATUS[0]}
    echo "== $step rc=$rc $(( $(date +%s) - start )) s"
    if [ "$rc" -ne 0 ]; then status=$rc; fi
}

for step in $steps; do
    case $step in
        decode)
            run decode $t.bench_decode bf16 int8 int4 int4pc int4h8 int4kv8 int4f int4g64 \
                int4fg128 --out-dir "$out"
            run decode $t.bench_decode int4f --batch 8 --out-dir "$out" ;;
        profile) run profile $t.profile_decode int4f ;;
        serving) run serving $t.bench_serving 24 8 --out-dir "$out" ;;
        pipeline_serving)
            run pipeline_serving $t.bench_pipeline_serving --out-dir "$out"
            run pipeline_serving $t.bench_pipeline_serving --tome=auto --out-dir "$out" ;;
        encode_static) run encode_static $t.bench_encode_static --fused-ln 0 proj fc2 1 ;;
        train_step)
            run train_step $t.bench_train_step --steps 8
            run train_step $t.bench_train_step --steps 8 --bf16-base ;;
        pipeline)
            run pipeline $t.bench_pipeline --out-dir "$out"
            run pipeline $t.bench_pipeline --int8 --out-dir "$out"
            run pipeline $t.bench_pipeline --int4 --out-dir "$out"
            run pipeline $t.bench_pipeline --int4 --tome=auto --out-dir "$out"
            run pipeline $t.bench_pipeline --int4 --from-video --out-dir "$out" ;;
        btadapter) run btadapter $t.bench_btadapter --out-dir "$out" ;;
        tome) run tome $t.bench_tome 8 --out-dir "$out" ;;
        beam)
            run beam $t.bench_beam both int8 --out-dir "$out"
            run beam $t.bench_beam both int4 --out-dir "$out"
            run beam $t.bench_beam batched int4 --out-dir "$out" ;;
        prefix) run prefix $t.bench_prefix --out-dir "$out" ;;
        longctx) run longctx $t.bench_decode_longctx 512 2048 4096 --out-dir "$out" ;;
        spec_decode) run spec_decode $t.bench_spec_decode 6 --out-dir "$out" ;;
        spec_trained) run spec_trained $t.bench_spec_trained 400 300 --out-dir "$out" ;;
        spec_serving) run spec_serving $t.bench_spec_serving 400 300 --out-dir "$out" ;;
        decode_budget) run decode_budget $t.probe_decode_budget --out-dir "$out" ;;
        w4_unpack) run w4_unpack $t.probe_w4_unpack --out-dir "$out" ;;
        call_fusion) run call_fusion $t.probe_w4_call_fusion --out-dir "$out" ;;
        *) echo "unknown step $step"; status=2 ;;
    esac
done
exit $status
