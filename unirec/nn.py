"""A small functional module layer: the part of the Flax linen API this
package uses, with the same parameter paths, shapes and initialiser
distributions (the random draws for a given seed differ from Flax's).

Modules are dataclasses.  Submodules constructed inside a ``@compact``
method (or ``setup``) bind to the module that is running, under their
``name`` or an automatic ``ClassName_N``.  ``init`` builds the variable
collections and ``apply`` runs the model on given collections; both are
pure functions of their inputs, so they compose with ``jax.jit``,
``jax.grad`` and sharding like any JAX function.

Supported: ``Module`` with ``param``, ``variable``, ``sow``, ``make_rng``,
``has_variable``, ``get_variable``, ``variables``, ``clone``, ``init`` and
``apply``; ``compact``; ``remat`` (``jax.checkpoint`` with a policy); and
the layers ``Dense``, ``DenseGeneral``, ``LayerNorm``, ``Dropout``,
``Embed`` and ``Conv``, numerically as in Flax.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import zlib
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.nn import (  # noqa: F401  (re-exported for model code)
    gelu,
    initializers,
    log_softmax,
    logsumexp,
    relu,
    sigmoid,
    silu,
    softmax,
)

Array = jax.Array
Dtype = Any

_AUTO = object()


class _Context(threading.local):
    def __init__(self):
        self.stack = []  # modules whose method is running, innermost last


_CTX = _Context()


class _Frame:
    """Variable collections, rng keys and mutability of one init/apply."""

    def __init__(self, variables, rngs, mutable, initializing):
        self.store: Dict[str, dict] = {
            col: _copy_dicts(tree) for col, tree in (variables or {}).items()
        }
        self.rngs = dict(rngs or {})
        self.mutable = mutable  # predicate on collection names
        self.initializing = initializing
        self.counters: Dict[Tuple, int] = {}

    def node(self, col: str, path: Tuple[str, ...]) -> Optional[dict]:
        node = self.store.get(col)
        for p in path:
            if node is None:
                return None
            node = node.get(p)
        return node

    def ensure(self, col: str, path: Tuple[str, ...]) -> dict:
        node = self.store.setdefault(col, {})
        for p in path:
            node = node.setdefault(p, {})
        return node


def _copy_dicts(tree):
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _mutable_predicate(mutable) -> Callable[[str], bool]:
    if mutable is True:
        return lambda col: True
    if mutable is False or mutable is None:
        return lambda col: False
    if isinstance(mutable, str):
        return lambda col: col == mutable
    names = frozenset(mutable)
    return lambda col: col in names


class Variable:
    """Handle on one variable; ``.value`` reads it and, where the
    collection is mutable, writes it."""

    def __init__(self, module: "Module", col: str, name: str):
        self._module, self._col, self._name = module, col, name

    @property
    def value(self):
        return self._module.get_variable(self._col, self._name)

    @value.setter
    def value(self, v):
        m = self._module
        if not m._frame.mutable(self._col):
            raise ValueError(
                f"collection {self._col!r} is immutable here; pass "
                f"mutable=[{self._col!r}] to apply")
        m._frame.ensure(self._col, m._path)[self._name] = v


def _wrap_method(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._frame is None:
            raise RuntimeError(
                f"{type(self).__name__} is not bound: call it through "
                "init/apply, or construct it inside a compact method")
        self._run_setup()
        _CTX.stack.append(self)
        self._autoname = {}
        try:
            return fn(self, *args, **kwargs)
        finally:
            _CTX.stack.pop()

    wrapped._module_wrapped = True
    return wrapped


def compact(fn):
    """Marks the method that may construct submodules inline.  Every
    ``__call__`` of a module may, so this only documents the intent."""
    return fn


class Module:
    """Base class; subclasses are dataclasses of their hyperparameters."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        call = cls.__dict__.get("__call__")
        if call is not None and not getattr(call, "_module_wrapped", False):
            cls.__call__ = _wrap_method(call)
        dataclasses.dataclass(cls, eq=True, unsafe_hash=True, repr=False)
        field_init = cls.__init__

        def __init__(self, *args, name=None, parent=_AUTO, **kw):
            field_init(self, *args, **kw)
            self._attach(name, parent)

        cls.__init__ = __init__

    # -- binding ---------------------------------------------------------

    def _attach(self, name, parent):
        if parent is _AUTO:
            parent = _CTX.stack[-1] if _CTX.stack else None
        self._setup_done = False
        self._autoname: Dict[str, int] = {}
        if parent is None:
            self._frame, self._path = None, ()
        else:
            if name is None:
                prefix = type(self).__name__
                n = parent._autoname.get(prefix, 0)
                parent._autoname[prefix] = n + 1
                name = f"{prefix}_{n}"
            self._frame, self._path = parent._frame, parent._path + (name,)
        self.name = name

    def _fields(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def _bound_copy(self, frame: _Frame, path: Tuple[str, ...], cls=None):
        m = (cls or type(self))(**self._fields(), name=self.name, parent=None)
        m._frame, m._path = frame, path
        return m

    def _run_setup(self):
        if self._setup_done:
            return
        self._setup_done = True
        if type(self).setup is not Module.setup:
            _CTX.stack.append(self)
            try:
                self.setup()
            finally:
                _CTX.stack.pop()

    def setup(self) -> None:
        pass

    def clone(self, **updates) -> "Module":
        """An unbound copy with some fields replaced."""
        fields = self._fields()
        fields.update(updates)
        return type(self)(**fields, parent=None)

    # -- variables -------------------------------------------------------

    def param(self, name: str, init_fn: Callable, *init_args, **init_kwargs):
        frame = self._frame
        node = frame.node("params", self._path)
        if node is not None and name in node:
            return node[name]
        if not frame.mutable("params"):
            raise KeyError(
                f"parameter {'/'.join(self._path + (name,))} is missing")
        value = init_fn(self.make_rng("params"), *init_args, **init_kwargs)
        frame.ensure("params", self._path)[name] = value
        return value

    def variable(self, col: str, name: str, init_fn: Optional[Callable] = None,
                 *init_args) -> Variable:
        if not self.has_variable(col, name):
            if init_fn is None or not self._frame.mutable(col):
                raise KeyError(
                    f"variable {col}:{'/'.join(self._path + (name,))} is "
                    "missing")
            self._frame.ensure(col, self._path)[name] = init_fn(*init_args)
        return Variable(self, col, name)

    def has_variable(self, col: str, name: str) -> bool:
        node = self._frame.node(col, self._path)
        return node is not None and name in node

    def get_variable(self, col: str, name: str, default=None):
        node = self._frame.node(col, self._path)
        return default if node is None else node.get(name, default)

    @property
    def variables(self) -> Dict[str, dict]:
        out = {}
        for col in self._frame.store:
            node = self._frame.node(col, self._path)
            if node is not None:
                out[col] = node
        return out

    def sow(self, col: str, name: str, value) -> bool:
        """Appends ``value`` to a tuple in ``col`` when ``col`` is mutable."""
        if not self._frame.mutable(col):
            return False
        node = self._frame.ensure(col, self._path)
        node[name] = node.get(name, ()) + (value,)
        return True

    def make_rng(self, name: str = "params") -> Array:
        """A key of stream ``name``, distinct for each module path and each
        call, derived by folding the path and a call counter into the key
        given to init/apply."""
        frame = self._frame
        if name not in frame.rngs:
            raise ValueError(f"no rng stream {name!r}: pass rngs={{{name!r}: "
                             "key}} to apply")
        slot = (self._path, name)
        count = frame.counters.get(slot, 0)
        frame.counters[slot] = count + 1
        tag = "/".join(self._path) + f"|{name}|{count}"
        return jax.random.fold_in(frame.rngs[name],
                                  zlib.crc32(tag.encode()) & 0x7FFFFFFF)

    # -- entry points ----------------------------------------------------

    def init(self, rngs, *args, **kwargs) -> Dict[str, dict]:
        """Runs the module with every collection but ``intermediates``
        mutable and returns the collections it created."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        frame = _Frame({}, rngs, lambda col: col != "intermediates", True)
        self._bound_copy(frame, ())(*args, **kwargs)
        return frame.store

    def apply(self, variables, *args, rngs=None, mutable=False, **kwargs):
        """Runs the module on ``variables``.  With ``mutable`` set, returns
        ``(output, {collection: tree})`` for the mutable collections."""
        frame = _Frame(variables, rngs, _mutable_predicate(mutable), False)
        out = self._bound_copy(frame, ())(*args, **kwargs)
        if mutable is False:
            return out
        return out, {c: t for c, t in frame.store.items() if frame.mutable(c)}


def remat(target, static_argnums: Sequence[int] = (), policy=None):
    """``target`` with its ``__call__`` under ``jax.checkpoint``.

    ``static_argnums`` count ``self`` as 0, as Flax's ``nn.remat`` does;
    the other arguments must be pytrees of arrays (``None`` included).  The
    module's variables and the rng keys enter the checkpoint as arguments,
    and keys are derived from the same paths as without remat, so remat
    changes memory and time only.  Collections written inside are
    dropped."""
    static = frozenset(static_argnums)

    class Remat(target):
        def __call__(self, *args):
            frame = self._frame
            if frame.initializing:
                return target.__call__(self, *args)
            dyn_idx = [i for i in range(len(args)) if (i + 1) not in static]
            sub = {}
            for col in frame.store:
                node = frame.node(col, self._path)
                if node is not None:
                    sub[col] = node

            def body(sub_vars, rngs, *dyn):
                full = list(args)
                for i, v in zip(dyn_idx, dyn):
                    full[i] = v
                variables = {}
                for col, node in sub_vars.items():
                    tree = variables.setdefault(col, {})
                    for p in self._path[:-1]:
                        tree = tree.setdefault(p, {})
                    tree[self._path[-1]] = node
                inner = _Frame(variables, rngs, lambda col: False, False)
                m = self._bound_copy(inner, self._path, cls=target)
                return m(*full)

            return jax.checkpoint(body, policy=policy)(
                sub, frame.rngs, *[args[i] for i in dyn_idx])

    Remat.__name__ = Remat.__qualname__ = target.__name__
    return Remat


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _promote(*xs, dtype=None):
    if dtype is None:
        dtype = jnp.result_type(*[x for x in xs if x is not None])
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


default_kernel_init = initializers.lecun_normal()
default_embed_init = initializers.variance_scaling(
    1.0, "fan_in", "normal", out_axis=0)


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis."""

    features: int
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs: Array) -> Array:
        kernel = self.param("kernel", self.kernel_init,
                            (jnp.shape(inputs)[-1], self.features))
        bias = (self.param("bias", self.bias_init, (self.features,))
                if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(inputs, kernel,
                            (((inputs.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y = y + jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


def _as_tuple(x) -> Tuple:
    return tuple(x) if isinstance(x, Iterable) else (x,)


class DenseGeneral(Module):
    """A dense map contracting ``axis`` of the input; output axes are the
    remaining input axes followed by ``features``."""

    features: Union[int, Sequence[int]]
    axis: Union[int, Sequence[int]] = -1
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs: Array) -> Array:
        features = _as_tuple(self.features)
        axis = tuple(a % inputs.ndim for a in _as_tuple(self.axis))
        in_shape = tuple(inputs.shape[a] for a in axis)
        kshape = in_shape + features
        flat = (int(np.prod(in_shape)), int(np.prod(features)))

        def kernel_init(rng, shape, dtype):
            return jnp.reshape(self.kernel_init(rng, flat, dtype), shape)

        kernel = self.param("kernel", kernel_init, kshape, jnp.float32)
        bias = None
        if self.use_bias:
            def bias_init(rng, shape, dtype):
                return jnp.reshape(
                    self.bias_init(rng, (flat[1],), dtype), shape)

            bias = self.param("bias", bias_init, features, jnp.float32)
        inputs, kernel, bias = _promote(inputs, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(
            inputs, kernel,
            ((axis, tuple(range(len(axis)))), ((), ())))
        if bias is not None:
            y = y + jnp.reshape(bias, (1,) * (y.ndim - len(features))
                                + features)
        return y


class LayerNorm(Module):
    """Normalises the last axis; statistics in at least float32, as Flax
    computes them (mean of squares minus squared mean)."""

    epsilon: float = 1e-6
    dtype: Optional[Dtype] = None
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = initializers.zeros
    scale_init: Callable = initializers.ones

    @compact
    def __call__(self, x: Array) -> Array:
        stat_dtype = jnp.promote_types(self.dtype or jnp.result_type(x),
                                       jnp.float32)
        xs = jnp.asarray(x, stat_dtype)
        mean = xs.mean(-1, keepdims=True)
        mean2 = jnp.square(xs).mean(-1, keepdims=True)
        var = jnp.maximum(0.0, mean2 - jnp.square(mean))
        y = x - mean
        mul = lax.rsqrt(var + self.epsilon)
        args = [x]
        feat = (x.shape[-1],)
        if self.use_scale:
            scale = self.param("scale", self.scale_init, feat)
            mul = mul * scale
            args.append(scale)
        y = y * mul
        if self.use_bias:
            bias = self.param("bias", self.bias_init, feat)
            y = y + bias
            args.append(bias)
        return jnp.asarray(y, self.dtype or jnp.result_type(*args))


class Dropout(Module):
    """Inverted dropout drawing from the ``dropout`` rng stream."""

    rate: float

    @compact
    def __call__(self, inputs: Array, deterministic: bool) -> Array:
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), p=keep,
                                    shape=inputs.shape)
        return lax.select(mask, inputs / keep, jnp.zeros_like(inputs))


class Embed(Module):
    """Lookup table ``embedding [num_embeddings, features]``."""

    num_embeddings: int
    features: int
    dtype: Optional[Dtype] = None
    embedding_init: Callable = default_embed_init

    @compact
    def __call__(self, inputs: Array) -> Array:
        if not jnp.issubdtype(inputs.dtype, jnp.integer):
            raise ValueError("Embed takes integer indices")
        table = self.param("embedding", self.embedding_init,
                           (self.num_embeddings, self.features))
        if self.dtype is not None:
            table = jnp.asarray(table, self.dtype)
        return jnp.take(table, inputs, axis=0)


class Conv(Module):
    """Channels-last convolution with "SAME" padding and an
    ``[*kernel_size, in, out]`` kernel."""

    features: int
    kernel_size: Sequence[int]
    strides: Union[int, Sequence[int]] = 1
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs: Array) -> Array:
        ks = tuple(self.kernel_size)
        nsp = len(ks)
        strides = ((self.strides,) * nsp if isinstance(self.strides, int)
                   else tuple(self.strides))
        kernel = self.param("kernel", self.kernel_init,
                            ks + (inputs.shape[-1], self.features))
        bias = (self.param("bias", self.bias_init, (self.features,))
                if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias, dtype=self.dtype)
        dn = lax.conv_dimension_numbers(inputs.shape, kernel.shape,
                                        _channels_last(nsp))
        y = lax.conv_general_dilated(inputs, kernel, strides, "SAME",
                                     dimension_numbers=dn)
        if bias is not None:
            y = y + jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


def _channels_last(nsp: int):
    sp = "".join("HWDXYZ"[i] for i in range(nsp))
    return (f"N{sp}C", f"{sp}IO", f"N{sp}C")


def flatten_dict(tree: dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple, Any]:
    """Nested dict -> {path tuple: leaf}; empty dicts drop out."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(flatten_dict(v, path))
        else:
            out[path] = v
    return out
