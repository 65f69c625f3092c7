"""The port's own StitchConfig and legacy config loader against the JAX
package's (the port imports nothing of the JAX package, so it keeps a
copy; these tests keep the copy in step).

Tolerance: none — field names, annotations and defaults are equal, and
both loaders give equal configs for the same files."""

import dataclasses

import pytest

from multiviewstitch_tpu import config as jcfg
from multiviewstitch_tpu_torch import config as tcfg

# every key of the reference's config.txt format, with a value unlike its
# default
_LEGACY_TEXT = """# reference-style config
WriteMesh 1 Segment 1 AllSeqProj 1
ViewCount 3 MinMatchCount 9 IterNum 77 SampleIterval 12 SSDWin 5
Axis 1 RotAngle 7.5 PixelError 33.0 AdtPxlErrRatio 0.5 SSDError 20.0
ReprojError 3 DistMax 0.6 RatioMax 0.75
HLMarginRatio 0.11 VLMarginRatio 0.12 HRMarginRatio 0.13 VRMarginRatio 0.14
MinDsp 0.002 MaxDsp 2.5 ImgPathList dirs.txt
PtSampRds 3 NbrFrmNum 4 NbrFrmStep 2 MaxDspErr 0.02 MinConf 0.7
EdgeSzThres 5.0 PsnDptMax 9 PsnDptMin 6
DistThreshold 0.8 SmoothThreshold 0.2 UnknownKey 5
"""
_DIRS_TEXT = """# sequences
seq_a seq_b   # second
seq_c
"""


def _fields(cls):
    return [(f.name, f.type, f.default, f.default_factory)
            for f in dataclasses.fields(cls)]


def test_stitch_config_fields_types_and_defaults_match_jax():
    assert _fields(tcfg.StitchConfig) == _fields(jcfg.StitchConfig)
    assert dataclasses.asdict(tcfg.StitchConfig()) == \
        dataclasses.asdict(jcfg.StitchConfig())
    assert tcfg._LEGACY_KEYS == jcfg._LEGACY_KEYS


def test_stitch_config_replace_and_frozen():
    c = tcfg.StitchConfig().replace(nbr_frm_num=3, dsp_err=0.05)
    assert (c.nbr_frm_num, c.dsp_err) == (3, 0.05)
    with pytest.raises(dataclasses.FrozenInstanceError):
        c.nbr_frm_num = 4


@pytest.mark.parametrize("with_dirs", [False, True])
def test_load_legacy_config_matches_jax(tmp_path, with_dirs):
    path = tmp_path / "config.txt"
    path.write_text(_LEGACY_TEXT)
    if with_dirs:
        (tmp_path / "dirs.txt").write_text(_DIRS_TEXT)
    got = tcfg.load_legacy_config(str(path))
    want = jcfg.load_legacy_config(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.nbr_frm_step == 2 and got.write_mesh is True
    assert got.image_dirs == (("seq_a", "seq_b", "seq_c") if with_dirs
                              else ())


def test_load_image_dir_list_matches_jax(tmp_path):
    path = tmp_path / "dirs.txt"
    path.write_text(_DIRS_TEXT)
    assert tcfg.load_image_dir_list(str(path)) == \
        jcfg.load_image_dir_list(str(path)) == ["seq_a", "seq_b", "seq_c"]
