"""Data layer: on-disk contract, device feature bank, synthetic fixtures."""
