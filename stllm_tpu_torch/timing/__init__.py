"""Timing harnesses: how fast do the port's paths run on the card?

Each module runs as ``python -m stllm_tpu_torch.timing.<name>``, with the
positional arguments and flags of the JAX script of the same name in
``script/``, on the CUDA card unless ``--cpu`` is passed. The ones with a
document merge it into ``--out-dir`` (default ``timing_out/``), keeping the
sections other runs own; every document and printed summary carries the
card's ``nvidia-smi`` name and power limit, and every repeat's raw seconds
beside the statistic:

- ``bench_decode``: greedy decode latency by weight format
  (``BENCH_DECODE.json``);
- ``profile_decode``: one decode traced by ``torch.profiler`` (printed);
- ``bench_serving``: continuous-batching throughput, greedy and a
  half-sampled mix (``BENCH_SERVING.json``);
- ``bench_pipeline_serving``: video-QA serving against one slot
  (``BENCH_PIPELINE_SERVING.json``);
- ``bench_encode_static``: the static-int8 encode under each fused-LN
  setting (printed);
- ``bench_train_step``: the BTAdapter QA training step (printed);
- ``bench_pipeline``: one QA's end-to-end latency (``BENCH_PIPELINE.json``);
- ``bench_btadapter``: the BTAdapter encoder and its merge levels
  (``BENCH_BTADAPTER.json``);
- ``bench_tome``: encode throughput at every merge level (``BENCH_TOME.json``);
- ``bench_beam``: greedy against beam 5 (``BENCH_BEAM.json`` for the
  batched form, else printed);
- ``bench_prefix``: multi-turn chat, full re-prefill against PrefixSession
  (``BENCH_PREFIX.json``);
- ``bench_decode_longctx``: decode at long contexts, int8 KV and H2O
  (``BENCH_DECODE.json["long_ctx"]``);
- ``bench_spec_decode``, ``bench_spec_trained``: speculative decoding,
  random and trained (``BENCH_SPEC.json``, ``["trained_demo"]``);
- ``bench_spec_serving``: speculative decoding through the batcher
  (``BENCH_SERVING.json["speculative"]``);
- ``bench_serving_ab``: ``bench_serving`` on a parent tree against this
  one, parent, change, change, parent (``BENCH_SERVING.json["ab"]``);
- ``probe_decode_budget``, ``probe_w4_unpack``, ``probe_w4_call_fusion``:
  the weight-streaming kernels #12-#15 in the decode skeleton, the unpack
  variants and the fused calls (``PROBE_*.json``).

Each module splits ``build_*`` (the stack from a config, a device and a
seed), ``run_*`` (built params, a config and the protocol -> the result)
and ``main`` (parse, build, run, write), so the tests run every harness
whole at a tiny size on the CPU and the smoke hands one built 7B stack to
several harnesses.
"""
