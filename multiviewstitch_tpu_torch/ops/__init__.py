"""Per-pixel, per-keypoint and volume operators; K1-K3 sit behind
consistency, point_sampling and rasterizer."""
