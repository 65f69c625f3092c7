"""multiviewstitch_tpu_torch — the PyTorch / CUDA port of multiviewstitch_tpu.

Runs the ``align`` path (the reference's -a 1 AlignmentSeq) on one NVIDIA
H100: the reference's on-disk layout (``--config``) or synthetic inputs
rendered with the port's rasterizer, per-sequence prep (foreground mask,
view synthesis, SIFT, unprojection), the batched edge sweep, the SRT solve
and greedy chain, fusion (consistency check, oriented point sampling),
per-frame meshes, TSDF or screened Poisson reconstruction and the
AllSeqProj trim, with optional view-graph refinement (pose graph or
bundle adjustment); and the reference's second mode: ``deform`` (rigid
template alignment, ARAP fit) and ``render`` (the deformed model drawn
into every frame, optional depth refinement). The JAX package beside it is the reference the port is
tested against; this package imports ``torch`` and never ``jax``.

Package layout (mirrors multiviewstitch_tpu, of which it imports nothing):
  config.py  StitchConfig and the legacy config.txt loader (its own copy)
  core/      cameras (and the .act format), similarity transforms
  ops/       rasterizer (K3), consistency (K1), point_sampling (K2: the
             whole oriented point sampler), view_synth, features, match,
             filters, tsdf, poisson, meshing, segmentation, mesh_normals,
             depth_refine
  solvers/   srt (Kabsch + RANSAC), unionfind, pca, alignment (rigid
             template fit), deformation (ARAP), ba (bundle adjustment),
             pose_graph
  models/    template_body (its own copy), parts (16-part labels, 1-NN)
  pipeline/  fixtures (scenes, sensor noise), ingest, executor,
             match_edges, align_seq, ba_refine, deform_render
  io/        srt (SRT.txt), meshio (OBJ, NPTS), manifest, rawdepth (its
             own copies)
  csrc/      CUDA C++ sources of K1-K3 (sm_90a)
  kernels/   nvcc build + ctypes wrappers + launch counts
  utils/     debug_artifacts, debug_mode, metrics (their own copies)
  cli.py     ``align``, ``deform``, ``render`` and ``pipeline`` entry points
  interop.py numpy -> torch converters for cameras, similarities,
             sequences, meshes, BA problems and match candidates
"""

__version__ = "0.1.0"
