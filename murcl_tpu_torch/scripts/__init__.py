"""User scripts of the port, each run as ``python -m murcl_tpu_torch.scripts.<name>``:
``export_torchvision_weights`` (the extractor's ``--weights`` pickle) and
``ppo_sanity`` (the PPO learning check)."""
