"""Numerical sanitizers: the checked render.

The port of `tpu_pathtracer.utils.debug`.  The JAX package runs its frame
under `jax.experimental.checkify`; here `checked_render_frame` runs
`ops.trace.render_frame` under `CheckMode`, a `TorchDispatchMode` that
only observes, with checkify's semantics:

  * NaN (`nan_checks`): a NaN anywhere in the output of an op of
    checkify's `nan_primitives` (add, sub, mul, div, rem, pow, sqrt,
    rsqrt, exp, log, the trigonometric functions, dot_general, the sum
    and product reductions, cumsum, ...), mapped to the aten ops that
    compute them (`NAN_OPS`).  Ops that do not initialise their output
    (`empty`, `empty_like`, `empty_strided`, `new_empty`) are not among
    them: the kernel wrappers allocate with these.
  * Division by zero (`div_checks`): any zero in the divisor of `div`,
    `remainder`, `fmod`, `floor_divide`, `addcdiv` or `reciprocal`
    (`1.0 / x` reaches aten as `reciprocal`), float as well as int, as
    checkify's `div_error_check` flags any zero divisor of `lax.div`.
  * Index (`index_checks`): an index outside [0, n), or [-n, n) where the
    op wraps negative indices, given to `index_select`, `gather`, `take`,
    `embedding`, `index`, `index_put_`, `index_add`, `index_copy`,
    `index_fill` or `scatter*` (checkify's `gather_error_check`).  The mode
    clamps every index into range before the op runs, so an out-of-range
    index never reaches a CUDA kernel (whose device-side assert would
    poison the context); for an index in range the clamp is a no-op.

As checkify does, the run records the first error and still returns an
image.  Each check leaves its flag on the device, in program order; the
flags are read once, after the frame, so the checks add no host sync of
their own (the BVH walks' compaction reads stay as they are).

What the mode does not see: the CUDA kernels, which are called through
`ctypes` (`_build.load`), not through the dispatcher.  Their outputs are
checked by the first torch op that reads them, as checkify does not see
inside a `pallas_call` either.

Use it in tests and debugging sessions: every checked op launches one or
two more small kernels, so the checked frame is slower than the plain one.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import trace

__all__ = [
    "CheckError", "CheckMode", "DivisionByZeroError", "Error", "NaNError", "OOBError",
    "assert_finite_render", "checked_render_frame", "div_checks", "float_checks",
    "index_checks", "nan_checks",
]


class CheckError(Exception):
    """An error found by a check (checkify's JaxException)."""


class NaNError(CheckError):
    pass


class DivisionByZeroError(CheckError):
    pass


class OOBError(CheckError):
    pass


nan_checks = frozenset({NaNError})
div_checks = frozenset({DivisionByZeroError})
index_checks = frozenset({OOBError})
float_checks = nan_checks | div_checks

# checkify's nan_primitives as aten ops (in-place and out= overloads share
# the name, trailing underscore dropped).
NAN_OPS = frozenset({
    "acos", "acosh", "add", "addcdiv", "addcmul", "addmm", "addmv", "asin", "asinh", "atan",
    "atan2", "atanh", "baddbmm", "bmm", "constant_pad_nd", "convolution", "cos", "cosh",
    "cummax", "cummin", "cumprod", "cumsum", "digamma", "div", "dot", "erf", "erfc",
    "erfinv", "exp", "exp2", "expm1", "floor_divide", "fmod", "lerp", "lgamma",
    "linalg_vector_norm", "log", "log10", "log1p", "log2", "logcumsumexp", "logsumexp", "mean",
    "mm", "mul", "mv", "pow", "prod", "reciprocal", "remainder", "rsqrt", "rsub", "sigmoid",
    "sin", "sinh",
    "special_i0e", "special_i1e", "sqrt", "sub", "sum", "tan", "tanh", "_log_softmax",
    "_softmax",
})
# The division ops and the argument that holds the divisor.
DIV_OPS = {"div": "other", "remainder": "other", "fmod": "other", "floor_divide": "other",
           "reciprocal": "self", "addcdiv": "tensor2"}
# The index ops: (argument holding the index, argument holding the dim or
# None for dim 0 / the flat tensor, whether negative indices wrap).
INDEX_OPS = {
    "index_select": ("index", "dim", False), "gather": ("index", "dim", False),
    "take": ("index", None, True), "embedding": ("indices", None, False),
    "index_add": ("index", "dim", False), "index_copy": ("index", "dim", False),
    "index_fill": ("index", "dim", False), "scatter": ("index", "dim", False),
    "scatter_add": ("index", "dim", False), "scatter_reduce": ("index", "dim", False),
    "index": ("indices", None, True), "index_put": ("indices", None, True),
}


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


class Error:
    """The result of a checked run: `.get()` gives the first error's
    message or None, `.get_exception()` the error itself, `.throw()`
    raises it."""

    def __init__(self, exc: CheckError | None = None):
        self._exc = exc

    def get(self) -> str | None:
        return None if self._exc is None else str(self._exc)

    def get_exception(self) -> CheckError | None:
        return self._exc

    def throw(self) -> None:
        if self._exc is not None:
            raise self._exc

    def __repr__(self):
        return f"Error({self.get()!r})"


class CheckMode(TorchDispatchMode):
    """Observe every aten op run inside `with CheckMode(errors):` and record
    checkify's checks for it; `.error()` reads them once afterwards."""

    def __init__(self, errors=None):
        super().__init__()
        self.errors = frozenset(float_checks | index_checks if errors is None else errors)
        self._flags = []  # (bool tensor or bool, error class, message)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        name = _op_name(func)
        names = [a.name for a in func._schema.arguments]
        args = list(args)

        def get(arg):
            i = names.index(arg)
            return args[i] if i < len(args) else kwargs.get(arg)

        def put(arg, value):
            i = names.index(arg)
            if i < len(args):
                args[i] = value
            else:
                kwargs[arg] = value

        if OOBError in self.errors and name in INDEX_OPS:
            self._check_index(name, get, put)
        if DivisionByZeroError in self.errors and name in DIV_OPS and DIV_OPS[name] in names:
            y = get(DIV_OPS[name])
            fired = bool(y == 0) if not isinstance(y, torch.Tensor) else (y == 0).any()
            self._flags.append((fired, DivisionByZeroError, f"division by zero in op: aten.{name}"))
        out = func(*args, **kwargs)
        if NaNError in self.errors and name in NAN_OPS:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()):
                    self._flags.append((torch.isnan(t).any(), NaNError,
                                        f"nan generated by op: aten.{name}."))
        return out

    def _check_index(self, name, get, put):
        arg, dim_arg, wraps = INDEX_OPS[name]
        src = get("weight" if name == "embedding" else "self")
        index = get(arg)
        if isinstance(index, (list, tuple)):  # index / index_put: one entry per dim
            clamped, dim = [], 0
            for ix in index:
                if ix is None:
                    clamped.append(ix)
                    dim += 1
                elif ix.dtype in (torch.bool, torch.uint8):  # a mask spans ix.dim() dims
                    clamped.append(ix)
                    dim += ix.dim()
                else:
                    clamped.append(self._clamp(name, ix, src.shape[dim], wraps, src.shape))
                    dim += 1
            put(arg, type(index)(clamped))
            return
        if dim_arg is None:
            n = src.numel() if name == "take" else src.shape[0]
        else:
            n = src.shape[get(dim_arg)] if src.dim() else 1
        put(arg, self._clamp(name, index, n, wraps, src.shape))

    def _clamp(self, name, index, n, wraps, shape):
        lo = -n if wraps else 0
        message = (f"out-of-bounds indexing in op: aten.{name} for array of shape "
                   f"{tuple(shape)}: an index is outside [{lo}, {n})")
        if index.numel() == 0:
            return index
        if n == 0:  # nothing to clamp into: stop here rather than run the op
            raise OOBError(message)
        self._flags.append((((index < lo) | (index >= n)).any(), OOBError, message))
        return index.clamp(lo, n - 1)

    def error(self) -> Error:
        """The first check that fired, in program order (one host read a device)."""
        fired = [f if isinstance(f, bool) else None for f, _, _ in self._flags]
        by_device = {}
        for i, (f, _, _) in enumerate(self._flags):
            if fired[i] is None:
                by_device.setdefault(f.device, []).append(i)
        for idx in by_device.values():
            values = torch.stack([self._flags[i][0].reshape(()) for i in idx]).tolist()
            for i, v in zip(idx, values):
                fired[i] = bool(v)
        for f, (_, cls, message) in zip(fired, self._flags):
            if f:
                return Error(cls(message))
        return Error()


def checked_render_frame(scene, params, *, width: int, height: int, aspect: float,
                         samples_per_frame: int = 1, max_bounces: int = 4,
                         env_importance: bool = False, errors=None):
    """`render_frame` under the float and index checks (`errors`, by
    default `float_checks | index_checks`).  Returns (error, image):
    `error.get()` is the first error's message or None, `error.throw()`
    raises it.  `render_frame` moves `params` to the scene's device."""
    mode = CheckMode(errors)
    with mode:
        image = trace.render_frame(scene, params, width=width, height=height, aspect=aspect,
                             samples_per_frame=samples_per_frame, max_bounces=max_bounces,
                             env_importance=env_importance)
    return mode.error(), image


def assert_finite_render(scene, params, **kw) -> None:
    """Raise if the render produces NaN/Inf or out-of-bounds indexing."""
    err, _ = checked_render_frame(scene, params, **kw)
    err.throw()
