"""Evidence harnesses: do the quantized, merged and speculative serving forms
answer as bf16 does?

Each module runs as ``python -m stllm_tpu_torch.evidence.<name>``, on the
CUDA card unless ``--cpu`` is passed, and writes its JSON document into
``--out-dir`` (default ``evidence_out/``):

- ``int8_equivalence``: int8 or W4A16 stack against bf16 on random full-size
  weights (``EQUIV_INT8.json``);
- ``tome_equivalence``: every token-merging level against the unmerged
  static-int8 stack (``TOME_EQUIV.json``);
- ``probe_spec_divergence``: where speculative serving first leaves plain
  greedy, and by what margin (printed);
- ``w4a16_depth``: W4A16 and int8 error against decoder depth on trained
  proxies (``EQUIV_INT8.json["w4a16_depth_scaling"]``);
- ``int8_equivalence_trained``: the quantized stacks and every merge level
  on a trained full-width, reduced-depth proxy (both documents);
- ``harvest_trained_levels``: the per-level lines of a trained run's log
  into ``TOME_EQUIV.json``;
- ``mem7b``, ``tp7b_check``, ``tp7b_serve_check``: the 7B train step's and
  serving's per-rank memory, TP rules and collectives, one rank of a mesh
  on torch's fake process group (``_fake_group``; ``MEM7B.json``,
  ``TP7B_CHECK.json``, ``TP7B_SERVE.json``).

Every harness is a set of plain functions on tensors that take a config, so
the tests run each one whole at a tiny size on the CPU.
"""
