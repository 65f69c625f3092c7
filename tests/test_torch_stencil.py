"""K4's wrappers (``kernels.stencil_*``, csrc/stencil.cu) on the CPU: the
argument checks that need no card raise before any launch, the float32
scalars handed to the kernels are PyTorch's, and the Poisson solver's
CPU tensors take the plain code (no K4 launch). The kernels themselves run
on the card: tests/test_torch_gpu.py holds them to the plain code bit for
bit."""

import numpy as np
import pytest
import torch

from multiviewstitch_tpu_torch import kernels
from multiviewstitch_tpu_torch.ops import poisson as P


def _f(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


# each wrapper with its valid CPU arguments, as (call, fields); the cases
# below replace one field and expect the check to name it
WRAPPERS = {
    "jacobi": (lambda x, b, out: kernels.stencil_jacobi(
        x, b, out, screen=1e-3, omega=0.8), ("x", "b", "out")),
    "matvec": (lambda x: kernels.stencil_matvec(x, screen=1e-3), ("x",)),
    "residual_restrict": (lambda x, b: kernels.stencil_residual_restrict(
        x, b, screen=1e-3), ("x", "b")),
    "prolong_add": (lambda x, e: kernels.stencil_prolong_add(x, e),
                    ("x", "e")),
    "coarsest": (lambda x, b: kernels.stencil_coarsest(
        x, b, screen=1e-3, omega=0.8, iters=42), ("x", "b")),
    "box_blur": (lambda a, out: kernels.stencil_box_blur(a, out, axis=1),
                 ("a", "out")),
}
SIDE = 8


def _valid(field):
    return _f(SIDE // 2, SIDE // 2, SIDE // 2) if field == "e" else \
        _f(SIDE, SIDE, SIDE)


def _call(wrapper, **replace):
    fn, fields = WRAPPERS[wrapper]
    return fn(*(replace.get(f, _valid(f)) for f in fields))


@pytest.fixture
def no_launch():
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


BAD = {
    "float64": (TypeError, "dtype", lambda f: _valid(f).double()),
    "not_a_tensor": (TypeError, "expected a tensor",
                     lambda f: _valid(f).numpy()),
    "not_cubic": (ValueError, "shape", lambda f: _f(SIDE, SIDE, SIDE + 2)),
    "flat": (ValueError, "shape", lambda f: _f(SIDE ** 3)),
    "non_contiguous": (ValueError, "contiguous",
                       lambda f: _valid(f).transpose(0, 2)),
}


@pytest.mark.parametrize("bad", sorted(BAD))
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_stencil_wrappers_check_the_first_field(no_launch, wrapper, bad):
    err, match, make = BAD[bad]
    first = WRAPPERS[wrapper][1][0]
    with pytest.raises(err, match=match):
        _call(wrapper, **{first: make(first)})


@pytest.mark.parametrize("wrapper", [w for w in sorted(WRAPPERS)
                                     if len(WRAPPERS[w][1]) > 1])
def test_stencil_wrappers_check_the_other_sides(no_launch, wrapper):
    for field in WRAPPERS[wrapper][1][1:]:
        with pytest.raises(ValueError, match=field):
            _call(wrapper, **{field: _f(SIDE + 2, SIDE + 2, SIDE + 2)})


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_stencil_wrappers_refuse_cpu_tensors(no_launch, wrapper):
    with pytest.raises(ValueError, match="CUDA"):
        _call(wrapper)


@pytest.mark.parametrize("wrapper", ["residual_restrict", "prolong_add"])
def test_stencil_restriction_and_prolongation_need_an_even_side(no_launch,
                                                                wrapper):
    odd = _f(SIDE + 1, SIDE + 1, SIDE + 1)
    with pytest.raises(ValueError, match="odd"):
        _call(wrapper, x=odd, b=odd, e=_f(SIDE // 2, SIDE // 2, SIDE // 2))


def test_stencil_coarsest_holds_at_most_16_cubed(no_launch):
    big = _f(17, 17, 17)
    with pytest.raises(ValueError, match="4096"):
        _call("coarsest", x=big, b=big)
    with pytest.raises(ValueError, match="sweeps"):
        kernels.stencil_coarsest(_f(4, 4, 4), _f(4, 4, 4), screen=1e-3,
                                 omega=0.8, iters=-1)


def test_stencil_box_blur_takes_axes_0_to_2(no_launch):
    with pytest.raises(ValueError, match="axis"):
        kernels.stencil_box_blur(_f(4, 4, 4), _f(4, 4, 4), axis=3)


def test_launch_counts_name_the_stencil_kernel():
    assert kernels.KERNELS[-1] == "stencil"
    assert "stencil" in kernels.launch_counts()


@pytest.mark.parametrize("screen", [1e-3, 1e-3 * 4 ** 6, 0.0, 0.3])
def test_stencil_scalars_are_float32_as_pytorch_casts_them(screen):
    """-screen and omega cast to float32 to nearest; 1 / diag is the
    float32 quotient 1 / float32(-6 - screen), which PyTorch's CUDA div_
    by a Python scalar multiplies by."""
    neg, om, inv = kernels._jacobi_coef(screen, 0.8)
    f32 = np.float32
    assert neg == float(f32(-screen)) and om == float(f32(0.8))
    assert inv == float(f32(1.0) / f32(-6.0 - screen))
    assert kernels._f32(1.0 / 3.0) == float(f32(1.0) / f32(3.0))


def test_cpu_solves_take_the_plain_code(no_launch):
    """_vcycle, _cg, _box_blur_ and _smooth_jacobi on CPU tensors launch no
    K4 kernel, and the V-cycle's plain coarsest level (nu + 40 sweeps in
    one call) equals nu sweeps then 40."""
    g = torch.Generator().manual_seed(0)
    b = torch.randn(32, 32, 32, generator=g)
    assert not P._on_k4(b)
    x = P._vcycle(torch.zeros_like(b), b, 1e-3)
    assert torch.isfinite(x).all() and float(x.abs().max()) > 0
    P._cg(b[:16, :16, :16].contiguous(), 1e-3, 3)
    P._box_blur_(b.clone())
    bc = P._restrict2(P._residual(x, b, 1e-3)).mul_(4.0)[:16, :16, :16]
    one = P._smooth_jacobi(torch.zeros_like(bc), bc, 4e-3, 42)
    two = P._smooth_jacobi(P._smooth_jacobi(torch.zeros_like(bc), bc, 4e-3,
                                            2), bc, 4e-3, 40)
    assert torch.equal(one, two)
