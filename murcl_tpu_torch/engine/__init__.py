"""Training engine: config, stage-1 contrastive engine, optimizer,
checkpoints and JAX weight interchange."""
