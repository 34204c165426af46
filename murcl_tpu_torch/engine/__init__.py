"""Training engine: config, MuRCL stage-1 contrastive engine, supervised
RLMIL engine, losses, optimizer, checkpoints and JAX weight interchange."""
