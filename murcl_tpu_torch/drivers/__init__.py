"""Training drivers (stage-1 MuRCL pretraining)."""
