"""File formats of the port: Result/SRT.txt (``srt``), OBJ and NPTS
(``meshio``), raw disparity rasters (``rawdepth``) and the stage manifest
(``manifest``), each its own copy, so nothing here imports the JAX
package."""
