"""Result/SRT.txt reading and writing (mesh and point files come from the
jax-free multiviewstitch_tpu.io.meshio)."""
