"""The PyTorch port imports without jax (the GPU machine has none), without
any module of the JAX package (it keeps its own copies of the jax-free
ones), and without nvcc or a card: its kernels build lazily, on the first
CUDA call."""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import multiviewstitch_tpu_torch as pkg
names = []
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    names.append(m.name)
assert "multiviewstitch_tpu_torch.cli" in names, names
assert "multiviewstitch_tpu_torch.kernels" in names, names
for mod in ("ops.mesh_normals", "ops.depth_refine", "solvers.pca",
            "solvers.alignment", "solvers.deformation", "models.parts",
            "models.template_body", "pipeline.deform_render", "solvers.ba",
            "solvers.pose_graph", "pipeline.ba_refine",
            "utils.debug_artifacts", "utils.debug_mode", "utils.metrics",
            "parallel", "parallel.mesh", "parallel.view_windows",
            "parallel.match_dist", "parallel.ba_dist", "parallel.arap_dist",
            "parallel.arap_blocks", "pipeline.executor", "utils.profiling",
            "io.native_loader", "ops.simplify", "solvers.essential"):
    assert "multiviewstitch_tpu_torch." + mod in names, mod
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax."))
ref = sorted(k for k in sys.modules if k == "multiviewstitch_tpu" or
             k.startswith("multiviewstitch_tpu."))
print(len(names), "modules;", "jax loaded:" if bad else "jax absent", bad)
print("JAX package modules loaded:" if ref else "JAX package absent", ref)
sys.exit(1 if bad or ref else 0)
"""


def test_port_imports_every_module_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "jax absent" in proc.stdout
    assert "JAX package absent" in proc.stdout


def test_kernel_wrappers_refuse_cpu_tensors():
    from multiviewstitch_tpu_torch import kernels
    d = torch.zeros(2, 4, 5)
    K = torch.eye(3).expand(2, 3, 3).contiguous()
    t = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.consistency(d, K, K, t, min_dsp=0.1, max_dsp=1.0,
                            reproj_err=4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.oriented_points(d, K, K, t, t, sample_radius=2, nbr_num=1,
                                nbr_step=1, min_dsp=0.1, max_dsp=1.0,
                                dsp_err=0.05, conf_min=0.5)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.raster(torch.zeros(1, 3, 3), torch.zeros(1, 3,
                                                         dtype=torch.int32),
                       torch.ones(1, 1, dtype=torch.bool), height=4, width=5)
    f = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.stencil_jacobi(f, f.clone(), f.clone(), screen=1e-3,
                               omega=0.8)
    assert kernels.launch_counts() == {
        "consistency": 0, "oriented_points": 0, "raster": 0, "stencil": 0}


def test_kernel_library_is_keyed_on_sources_and_ignored_by_git():
    from multiviewstitch_tpu_torch.kernels import _build
    p = _build.LIB.path()
    assert p == _build.LIB.path()
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    rel = os.path.relpath(p, REPO)
    proc = subprocess.run(["git", "check-ignore", "-q", rel], cwd=REPO)
    assert proc.returncode == 0, f"{rel} is not git-ignored"
    srcs = {os.path.basename(s) for s in _build.LIB.sources()}
    assert {"consistency.cu", "sampling.cu", "raster.cu",
            "stencil.cu"} <= srcs
