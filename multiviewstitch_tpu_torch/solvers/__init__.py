"""SRT estimation (Kabsch + RANSAC), the largest-component trim, point-set
PCA, rigid template alignment, ARAP deformation, bundle adjustment and the
pose graph."""
