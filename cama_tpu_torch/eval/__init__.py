"""Evaluation of a reprojected map against 2-D ground truth (map_metrics)."""
