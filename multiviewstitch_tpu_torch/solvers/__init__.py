"""SRT estimation (Kabsch + RANSAC) and the largest-component trim."""
