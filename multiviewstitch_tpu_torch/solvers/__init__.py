"""SRT estimation (Kabsch + RANSAC), the largest-component trim, point-set
PCA, rigid template alignment and ARAP deformation."""
