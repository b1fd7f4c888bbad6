"""Port parity: the checked render (tpu_pathtracer_torch/utils/debug.py).

The same scene and params go through JAX's `checked_render_frame`
(checkify) and the port's (`CheckMode`, a TorchDispatchMode).  A clean
render gives no error in both packages, with the port's image equal to
its unchecked frame bit for bit; each injected fault changes values, not
shapes, and gives the same error class in both.  JAX's function builds a
new `jax.jit` at every call, so this file makes three such calls (clean,
NaN, division by zero); an out-of-range index is held op by op, against
checkify on the JAX op that a render would reach."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

import tpu_pathtracer as jpt
from tpu_pathtracer.ops import trace as jtrace
from tpu_pathtracer.scene.envmap import gradient_sky as j_gradient_sky
from tpu_pathtracer.utils import debug as jdebug
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.scene.envmap import gradient_sky
from tpu_pathtracer_torch.utils import debug

CAM = dict(position=(0, 1, 4), look_at=(0, 0.5, 0))
KW = dict(width=8, height=8, aspect=1.0, samples_per_frame=1, max_bounces=2)


@pytest.fixture(scope="module")
def scenes():
    return (jpt.default_scene(j_gradient_sky(8, 16)).compile(),
            tpt.default_scene(gradient_sky(8, 16)).compile(device="cpu"))


def _inject(pkg, fault):
    """(params) of either package with `fault` written into the camera:
    a NaN position, or a zero direction (normalize divides by its norm)."""
    cam = pkg.Camera.create(**CAM)
    xp = jnp if pkg is jpt else torch
    if fault == "nan":
        cam = dataclasses.replace(cam, position=xp.asarray([np.nan, 1.0, 4.0], dtype=xp.float32))
    elif fault == "div":
        cam = dataclasses.replace(cam, direction=xp.zeros(3, dtype=xp.float32))
    return pkg.RenderParams.create(cam, frame=1)


def _class_name(err):
    exc = err.get_exception()
    return None if exc is None else type(exc).__name__


@pytest.fixture(scope="module")
def jax_errors(scenes):
    """JAX's checked render on each case: its three calls in this file."""
    return {fault: _class_name(jdebug.checked_render_frame(scenes[0], _inject(jpt, fault),
                                                           **KW)[0])
            for fault in ("clean", "nan", "div")}


def test_clean_render_has_no_error_in_either_package(scenes, jax_errors):
    assert jax_errors["clean"] is None
    err, img = debug.checked_render_frame(scenes[1], _inject(tpt, "clean"), **KW)
    assert err.get() is None and err.get_exception() is None
    err.throw()  # no error: returns
    assert torch.equal(img, ttrace.render_frame(scenes[1], _inject(tpt, "clean"), **KW))


@pytest.mark.parametrize("fault,cls", [("nan", "NaNError"), ("div", "DivisionByZeroError")])
def test_injected_fault_gives_jax_error_class(scenes, jax_errors, fault, cls):
    assert jax_errors[fault] == cls
    err, img = debug.checked_render_frame(scenes[1], _inject(tpt, fault), **KW)
    assert _class_name(err) == cls
    assert img.shape == (8, 8, 3)  # the run still returns an image, as checkify's does
    with pytest.raises(getattr(debug, cls)):
        err.throw()


def test_nan_message_names_the_op(scenes):
    err, _ = debug.checked_render_frame(scenes[1], _inject(tpt, "nan"), **KW)
    assert err.get() == "nan generated by op: aten.add."  # checkify: "... primitive: add."
    with pytest.raises(debug.NaNError, match="aten.add"):
        debug.assert_finite_render(scenes[1], _inject(tpt, "nan"), **KW)
    debug.assert_finite_render(scenes[1], _inject(tpt, "clean"), **KW)


def test_errors_selects_the_checks(scenes):
    """A zero direction divides 0 by 0: under `nan_checks` alone the same
    op is caught as a NaN, under `index_checks` alone nothing fires."""
    params = _inject(tpt, "div")
    err, _ = debug.checked_render_frame(scenes[1], params, errors=debug.nan_checks, **KW)
    assert _class_name(err) == "NaNError" and "aten.div" in err.get()
    err, _ = debug.checked_render_frame(scenes[1], params, errors=debug.index_checks, **KW)
    assert err.get() is None
    assert debug.float_checks == debug.nan_checks | debug.div_checks


def test_out_of_range_material_index_is_clamped_as_in_jax(scenes):
    """A material index past the table, written into the compiled scene:
    both packages clamp it before their gather (`pack_shade_material_rows`),
    so neither reports it, and the frame is the unchecked one."""
    jsc = scenes[0]
    bits = np.asarray(jsc.packed.tri_shade).view(np.int32).copy()
    bits[0, 9] = 99
    jshade = jnp.asarray(bits.view(np.float32))
    jsc = dataclasses.replace(jsc, packed=dataclasses.replace(jsc.packed, tri_shade=jshade))
    jerr, _ = checkify.checkify(jax.jit(jtrace.pack_shade_material_rows),
                                errors=checkify.index_checks)(jsc)
    assert jerr.get() is None

    tsc = scenes[1]
    shade = torch.from_numpy(bits.view(np.float32))
    tsc = dataclasses.replace(tsc, packed=dataclasses.replace(tsc.packed, tri_shade=shade))
    err, img = debug.checked_render_frame(tsc, _inject(tpt, "clean"), **KW)
    assert err.get() is None
    assert torch.equal(img, ttrace.render_frame(tsc, _inject(tpt, "clean"), **KW))


def test_out_of_range_gather_gives_jax_error_class():
    """The op-level counterpart: an index past the end of a gather."""
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([0, 3, 9], np.int32)
    jerr, _ = checkify.checkify(lambda a, i: a[i], errors=checkify.index_checks)(
        jnp.asarray(x), jnp.asarray(idx))
    with debug.CheckMode() as mode:
        got = torch.from_numpy(x)[torch.from_numpy(idx).long()]
    err = mode.error()
    assert _class_name(jerr) == _class_name(err) == "OOBError"
    assert "(4, 3)" in err.get()
    np.testing.assert_array_equal(got.numpy(), x[[0, 3, 3]])  # clamped into range


def _index_cases():
    x = torch.arange(20, dtype=torch.float32).reshape(5, 4)
    yield "index_select", lambda i: torch.index_select(x, 0, i), 5, False
    yield "gather", lambda i: torch.gather(x, 0, i[:, None].expand(-1, 4)), 5, False
    yield "take", lambda i: torch.take(x, i), 20, True
    yield "index", lambda i: x[i], 5, True
    yield "index_put_", lambda i: x.clone().index_put_((i,), torch.zeros(4)), 5, True
    yield "scatter", lambda i: torch.zeros(5, 4).scatter(0, i[:, None].expand(-1, 4),
                                                         torch.ones(i.numel(), 4)), 5, False
    yield "scatter_add", lambda i: torch.zeros(5).scatter_add(0, i, torch.ones(i.numel())), \
        5, False
    yield "embedding", lambda i: torch.nn.functional.embedding(i, x), 5, False
    yield "index_add", lambda i: torch.zeros(5, 4).index_add(0, i, torch.ones(i.numel(), 4)), \
        5, False


@pytest.mark.parametrize("case", list(_index_cases()), ids=lambda c: c[0])
def test_index_ops_flag_and_clamp_out_of_range_indices(case):
    """Out of range is outside [0, n), or [-n, n) where the op wraps
    negative indices; the op then runs on the indices clamped into range.
    An index in range passes unchanged and fires nothing."""
    _, op, n, wraps = case
    lo = -n if wraps else 0
    inside = torch.tensor([lo, n - 1, 0])
    with debug.CheckMode() as mode:
        got = op(inside)
    assert mode.error().get() is None and torch.equal(got, op(inside))
    for bad in ([n, 0], [lo - 1, 1]):
        with debug.CheckMode() as mode:
            got = op(torch.tensor(bad))
        assert isinstance(mode.error().get_exception(), debug.OOBError)
        assert torch.equal(got, op(torch.tensor(bad).clamp(lo, n - 1)))


@pytest.mark.parametrize("divisor", [torch.tensor([1.0, 0.0]), torch.tensor([2, 0]), 0.0],
                         ids=["float", "int", "scalar"])
def test_any_zero_divisor_is_a_division_by_zero(divisor):
    """checkify's div check: any zero in the divisor, float or int."""
    x = torch.tensor([1.0, 2.0])
    for op in (lambda: x / divisor, lambda: torch.remainder(x, divisor),
               lambda: torch.fmod(x, divisor)):
        with debug.CheckMode(debug.div_checks) as mode:
            op()
        assert isinstance(mode.error().get_exception(), debug.DivisionByZeroError)
    with debug.CheckMode(debug.div_checks) as mode:
        _ = 1.0 / torch.tensor([0.5, 0.0])  # reaches aten as reciprocal
    assert "aten.reciprocal" in mode.error().get()
    with debug.CheckMode() as mode:
        _ = x / torch.tensor([1.0, 2.0])
    assert mode.error().get() is None


def test_first_error_wins_and_empty_is_not_checked():
    with debug.CheckMode() as mode:
        torch.empty(64)
        torch.empty_like(torch.ones(3)).new_empty(8)
        a = torch.tensor([0.0]) / torch.tensor([0.0])  # div by zero, then its NaN
        _ = a + 1.0
    assert mode.error().get() == "division by zero in op: aten.div"
    assert all(cls is not debug.NaNError or "empty" not in msg for _, cls, msg in mode._flags)
    assert len(mode._flags) == 3  # div's zero divisor, div's NaN, add's NaN
