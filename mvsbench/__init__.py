"""mvsbench: the benchmark of multiviewstitch_tpu_torch on one H100.

Run as ``python3 mvsbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout; see ``mvsbench/README.md``.
Nothing here imports jax or the JAX package; the plain reference
(``geometry``, ``raster``, ``reference``) imports nothing of the port.
"""
