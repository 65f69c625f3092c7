"""What the benchmark loads: neither jax nor the JAX package anywhere, and
nothing of the port in the reference. Each check runs in a subprocess,
so this process's imports do not count."""

import json
import os
import subprocess
import sys

from mvsbench.harness import FORBIDDEN

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HARNESS = ["mvsbench", "mvsbench.harness", "mvsbench.spec",
           "mvsbench.calibrate", "mvsbench.run"]
REFERENCE = ["mvsbench.geometry", "mvsbench.raster", "mvsbench.reference",
             "mvsbench.judge", "mvsbench.fixtures", "mvsbench.layout",
             "mvsbench.trace", "mvsbench.scenes",
             "mvsbench.scenes.bumpy_sphere", "mvsbench.scenes.posed_body",
             "mvsbench.roofline", "mvsbench.roofline.k1",
             "mvsbench.roofline.k2", "mvsbench.roofline.k3"]


def _loaded(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(
        os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _tops(mods):
    return ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({k.split('.')[0] "
            "for k in sys.modules})))\n")


def test_reference_loads_nothing_of_the_port_or_jax():
    tops = _loaded(_tops(REFERENCE))
    assert not tops & set(FORBIDDEN)
    assert "multiviewstitch_tpu_torch" not in tops


def test_harness_and_readers_load_no_jax():
    code = _tops(HARNESS) .replace(
        "print(", "import glob, os\n"
        "from mvsbench import spec\n"
        "for p in glob.glob('mvsbench/metrics/*.py'):\n"
        "    spec.reader(os.path.basename(p)[:-3])\n"
        "import multiviewstitch_tpu_torch.cli\nprint(", 1)
    tops = _loaded(code)
    assert not tops & set(FORBIDDEN)


def test_a_cpu_job_loads_no_jax():
    code = (
        "import json, sys, time, torch\n"
        "from mvsbench import spec, harness\n"
        "b = spec.benchmark(); c = spec.cell('scan_vga.seq2x16', b)\n"
        "t = dict(c.traffic, frames=5, width=160, height=120, focal=131.25)\n"
        "cfg = json.loads(json.dumps(c.config))\n"
        "cfg['settings']['PsnDptMax'] = 6; cfg['set']['max_keypoints'] = 256\n"
        "c = c._replace(traffic=t, config=cfg)\n"
        "harness.run_cell(c, 5, 0.0, False, torch.device('cpu'), "
        "time.perf_counter()).close()\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(
        os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
