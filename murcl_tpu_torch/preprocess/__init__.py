"""Slide IO and full-slide attention heatmaps."""
