"""User scripts of the port, each run as ``python -m murcl_tpu_torch.scripts.<name>``:
``export_torchvision_weights`` (the extractor's ``--weights`` pickle),
``ppo_sanity`` (the PPO learning check), and the JAX package's K2/K3 probes
on the card, ``dbg_bwd_ablate``, ``dbg_vpu_lean`` and ``dbg_mxu_vpu_overlap``
(their shared helpers in ``probes``)."""
