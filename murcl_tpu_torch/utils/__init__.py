"""Experiment utilities (seeds, run dirs, json, loggers, trackers)."""
