"""Evaluation: keypoint metrics and COCO keypoint AP, numpy only."""
