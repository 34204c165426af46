"""User scripts of the port, each run as ``python -m murcl_tpu_torch.scripts.<name>``
(``run_camelyon.sh`` with ``sh``), each on ``cuda:0`` unless ``--device cpu``:

- ``export_torchvision_weights``: the extractor's ``--weights`` pickle;
- ``ppo_sanity``: the PPO learning check;
- the JAX package's probes of its TPU kernels, on the card's: K2/K3's
  ``dbg_bwd_ablate``, ``dbg_vpu_lean`` and ``dbg_mxu_vpu_overlap``; the
  one-hot compaction's ``dbg_compact_ablate``, ``dbg_grouped_ablate`` and
  ``dbg_grouped_gate``; K7's gate masks, ``dropout_smoke``; selection's
  breakdown, ``dbg_select``;
- the step diagnostics: ``profile_step`` (the stage-1 step's top ops by
  device time), ``profile_stages`` (the same for stages 2 and 3),
  ``dbg_step`` (a step against its pieces) and ``scale_smoke`` (streaming
  supervised steps over 1,000-10,000-patch bags and a full-bag pool);
- ``run_camelyon.sh``: the runbook, slide files to heatmaps.

Their shared helpers: ``probes`` (the device rule, the timer, the probes'
inputs) and ``profiling`` (a ``torch.profiler`` run's table of ops).
"""
