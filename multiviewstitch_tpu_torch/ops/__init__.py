"""Per-pixel and per-keypoint operators; K1-K3 sit behind consistency,
point_sampling and rasterizer."""
