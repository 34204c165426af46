"""Slide preprocessing (tiling, tissue masks, patch features, k-means) and
full-slide attention heatmaps."""
