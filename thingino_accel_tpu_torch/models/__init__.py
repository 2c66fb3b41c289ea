"""Model pre/post-processing (YOLO)."""
