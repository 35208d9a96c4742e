"""The package's module layer (unirec/nn.py): parameter paths, layer
numerics against plain formulas, rng streams, remat, collections and the
train state."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from unirec import nn
from unirec.train.common import TrainState


class TwoDense(nn.Module):
    features: int = 3

    @nn.compact
    def __call__(self, x):
        h = nn.Dense(self.features)(x)
        h = nn.Dense(self.features, name="named")(h)
        return nn.Dense(self.features)(h)


class Shared(nn.Module):
    @nn.compact
    def __call__(self, x):
        d = nn.Dense(x.shape[-1], name="shared")
        return d(d(x))


class DropTwice(nn.Module):
    rate: float = 0.5

    @nn.compact
    def __call__(self, x, deterministic=False):
        a = nn.Dropout(self.rate)(x, deterministic=deterministic)
        b = nn.Dropout(self.rate)(x, deterministic=deterministic)
        return a, b


class Block(nn.Module):
    rate: float = 0.3

    @nn.compact
    def __call__(self, x, deterministic=True):
        h = nn.Dense(x.shape[-1], name="fc")(x)
        h = nn.Dropout(self.rate)(jnp.tanh(h), deterministic=deterministic)
        return nn.LayerNorm(name="ln")(h + x)


class Stack(nn.Module):
    remat: bool = False
    policy: object = None

    @nn.compact
    def __call__(self, x, deterministic=True):
        cls = Block
        if self.remat:
            cls = nn.remat(Block, static_argnums=(2,), policy=self.policy)
        for i in range(3):
            x = cls(name=f"layer_{i}")(x, deterministic)
        return x


class Sower(nn.Module):
    @nn.compact
    def __call__(self, x):
        self.sow("intermediates", "h", x * 2)
        return nn.Dense(2)(x)


class Counter(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        count = self.variable("batch_stats", "count",
                              lambda: jnp.zeros((), jnp.int32))
        if train:
            count.value = count.value + 1
        return x + count.value


class WithSetup(nn.Module):
    features: int = 4

    def setup(self):
        self.w = self.param("w", nn.initializers.ones, (self.features,))
        self.proj = nn.Dense(self.features, name="proj")

    def __call__(self, x):
        return self.proj(x) * self.w


def _paths(tree):
    return sorted("/".join(str(getattr(k, "key", k)) for k in p)
                  for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0])


def test_autonames_and_explicit_names():
    params = TwoDense().init(jax.random.PRNGKey(0), jnp.ones((2, 5)))["params"]
    assert _paths(params) == [
        "Dense_0/bias", "Dense_0/kernel", "Dense_1/bias", "Dense_1/kernel",
        "named/bias", "named/kernel",
    ]
    assert params["Dense_0"]["kernel"].shape == (5, 3)


def test_module_called_twice_shares_params():
    x = jnp.asarray(np.random.RandomState(0).randn(2, 4), jnp.float32)
    v = Shared().init(jax.random.PRNGKey(0), x)
    assert _paths(v["params"]) == ["shared/bias", "shared/kernel"]
    w, b = v["params"]["shared"]["kernel"], v["params"]["shared"]["bias"]
    want = (x @ w + b) @ w + b
    np.testing.assert_allclose(Shared().apply(v, x), want, rtol=1e-6)


@pytest.mark.parametrize("dtype,use_bias", [
    (None, True), (None, False), (jnp.bfloat16, True), (jnp.float32, True),
])
def test_dense_matches_formula(dtype, use_bias):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7).astype(np.float32)
    m = nn.Dense(5, use_bias=use_bias, dtype=dtype)
    v = m.init(jax.random.PRNGKey(1), jnp.asarray(x))
    p = v["params"]
    assert p["kernel"].dtype == jnp.float32
    assert ("bias" in p) == use_bias
    y = m.apply(v, jnp.asarray(x))
    want = x @ np.asarray(p["kernel"])
    if use_bias:
        want = want + np.asarray(p["bias"])
    assert y.dtype == (dtype or jnp.float32)
    tol = 3e-2 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(np.asarray(y, np.float32), want, rtol=tol,
                               atol=tol)


def test_dense_general_contracts_axis():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 6).astype(np.float32)
    m = nn.DenseGeneral(features=3, axis=1)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    k, b = np.asarray(v["params"]["kernel"]), np.asarray(v["params"]["bias"])
    assert k.shape == (4, 3) and b.shape == (3,)
    y = m.apply(v, jnp.asarray(x))
    np.testing.assert_allclose(y, np.einsum("bkd,kf->bdf", x, k) + b,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layernorm_matches_formula(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 16) * 3 + 1).astype(np.float32)
    m = nn.LayerNorm(epsilon=1e-5, dtype=dtype)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x, dtype))
    v = {"params": {"scale": jnp.arange(16.0) / 8, "bias": jnp.ones(16)}}
    y = m.apply(v, jnp.asarray(x, dtype))
    xd = np.asarray(jnp.asarray(x, dtype), np.float64)
    mu = xd.mean(-1, keepdims=True)
    want = (xd - mu) / np.sqrt(xd.var(-1, keepdims=True) + 1e-5)
    want = want * np.arange(16.0) / 8 + 1
    assert y.dtype == dtype
    tol = 3e-2 if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(np.asarray(y, np.float64), want, atol=tol)


def test_embed_lookup_and_dtype():
    m = nn.Embed(10, 4, dtype=jnp.bfloat16)
    ids = jnp.asarray([[1, 9], [0, 3]])
    v = m.init(jax.random.PRNGKey(0), ids)
    table = v["params"]["embedding"]
    assert table.shape == (10, 4) and table.dtype == jnp.float32
    y = m.apply(v, ids)
    assert y.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(y), np.asarray(table.astype(jnp.bfloat16))[np.asarray(ids)])
    with pytest.raises(ValueError):
        m.apply(v, jnp.ones((2,), jnp.float32))


def test_conv_patch_embedding_matches_einsum():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    m = nn.Conv(5, kernel_size=(4, 4), strides=(4, 4), use_bias=False)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    k = np.asarray(v["params"]["kernel"])
    assert k.shape == (4, 4, 3, 5)
    y = np.asarray(m.apply(v, jnp.asarray(x)))
    patches = x.reshape(2, 2, 4, 2, 4, 3).transpose(0, 1, 3, 2, 4, 5)
    want = np.einsum("bijhwc,hwco->bijo", patches, k)
    np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0])
def test_dropout_semantics(rate):
    x = jnp.ones((64, 64))
    m = nn.Dropout(rate)
    np.testing.assert_array_equal(m.apply({}, x, deterministic=True), x)
    y = np.asarray(m.apply({}, x, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)}))
    if rate == 0.0:
        np.testing.assert_array_equal(y, x)
    elif rate == 1.0:
        assert (y == 0).all()
    else:
        kept = y != 0
        assert 0.4 < kept.mean() < 0.6
        np.testing.assert_allclose(y[kept], 1.0 / (1.0 - rate))


def test_rng_streams_distinct_and_reproducible():
    x = jnp.ones((32, 32))
    rngs = {"dropout": jax.random.PRNGKey(3)}
    a, b = DropTwice().apply({}, x, rngs=rngs)
    assert not np.array_equal(np.asarray(a), np.asarray(b))
    a2, _ = DropTwice().apply({}, x, rngs=rngs)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(a2))
    with pytest.raises(ValueError, match="dropout"):
        DropTwice().apply({}, x)


def test_init_params_differ_across_layers_and_seeds():
    x = jnp.ones((2, 5))
    p0 = TwoDense().init(jax.random.PRNGKey(0), x)["params"]
    p1 = TwoDense().init(jax.random.PRNGKey(1), x)["params"]
    assert not np.array_equal(p0["Dense_1"]["kernel"], p0["named"]["kernel"])
    assert not np.array_equal(p0["Dense_0"]["kernel"], p1["Dense_0"]["kernel"])


@pytest.mark.parametrize("policy", [
    None, jax.checkpoint_policies.dots_with_no_batch_dims_saveable,
])
def test_remat_matches_plain_values_and_grads(policy):
    x = jnp.asarray(np.random.RandomState(0).randn(4, 8), jnp.float32)
    plain, rem = Stack(), Stack(remat=True, policy=policy)
    v = plain.init(jax.random.PRNGKey(0), x)
    assert _paths(rem.init(jax.random.PRNGKey(0), x)) == _paths(v)
    rngs = {"dropout": jax.random.PRNGKey(5)}
    w = jnp.asarray(np.random.RandomState(1).randn(4, 8), jnp.float32)

    def loss(m):
        return lambda p: jnp.sum(m.apply(p, x, False, rngs=rngs) * w)

    l0, g0 = jax.jit(jax.value_and_grad(loss(plain)))(v)
    l1, g1 = jax.jit(jax.value_and_grad(loss(rem)))(v)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    # same dropout masks, so the grads agree up to float32 rounding of the
    # recomputed forward (relative to each leaf's scale)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        scale = float(np.abs(np.asarray(a)).max())
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * scale)


def test_sow_collects_only_when_mutable():
    x = jnp.ones((1, 3))
    v = Sower().init(jax.random.PRNGKey(0), x)
    assert set(v) == {"params"}  # init leaves intermediates out
    out = Sower().apply(v, x)
    assert out.shape == (1, 2)
    out, state = Sower().apply(v, x, mutable="intermediates")
    np.testing.assert_array_equal(state["intermediates"]["h"][0], x * 2)


def test_variable_updates_only_when_mutable():
    x = jnp.zeros(())
    v = Counter().init(jax.random.PRNGKey(0), x)
    assert int(v["batch_stats"]["count"]) == 0
    _, state = Counter().apply(v, x, train=True, mutable=["batch_stats"])
    assert int(state["batch_stats"]["count"]) == 1
    assert float(Counter().apply(state, x)) == 1.0
    with pytest.raises(ValueError, match="immutable"):
        Counter().apply(v, x, train=True)


def test_setup_style_module():
    x = jnp.ones((2, 4))
    v = WithSetup().init(jax.random.PRNGKey(0), x)
    assert _paths(v["params"]) == ["proj/bias", "proj/kernel", "w"]
    p = v["params"]
    want = (np.ones((2, 4)) @ np.asarray(p["proj"]["kernel"])
            + np.asarray(p["proj"]["bias"]))
    np.testing.assert_allclose(WithSetup().apply(v, x), want, rtol=1e-6)


def test_clone_and_missing_params():
    m = TwoDense(features=3)
    c = m.clone(features=6)
    assert c.features == 6 and m.features == 3 and c._frame is None
    v = m.init(jax.random.PRNGKey(0), jnp.ones((1, 2)))
    with pytest.raises(KeyError, match="Dense_0"):
        c.apply({"params": {}}, jnp.ones((1, 2)))
    with pytest.raises(RuntimeError, match="not bound"):
        m(jnp.ones((1, 2)))
    assert m.apply(v, jnp.ones((1, 2))).shape == (1, 3)


def test_variables_property_and_has_variable():
    class Probe(nn.Module):
        @nn.compact
        def __call__(self, x):
            d = nn.Dense(2, name="d")
            y = d(x)
            assert d.has_variable("params", "kernel")
            assert not d.has_variable("params", "missing")
            assert set(d.variables["params"]) == {"kernel", "bias"}
            return y

    Probe().init(jax.random.PRNGKey(0), jnp.ones((1, 3)))


@pytest.mark.parametrize("layer,shape", [
    ("Dense", (2, 6)), ("DenseGeneral", (2, 4, 6)), ("LayerNorm", (2, 6)),
    ("Embed", (2, 3)), ("Conv", (1, 8, 8, 3)),
])
def test_layers_match_flax_when_installed(layer, shape):
    """Where Flax is installed, each layer computes what flax.linen's does
    on the same parameters, with the same parameter names and shapes."""
    linen = pytest.importorskip("flax.linen")
    kw = {
        "Dense": dict(features=5),
        "DenseGeneral": dict(features=3, axis=1),
        "LayerNorm": dict(epsilon=1e-6),
        "Embed": dict(num_embeddings=11, features=4),
        "Conv": dict(features=5, kernel_size=(4, 4), strides=(4, 4)),
    }[layer]
    rng = np.random.RandomState(0)
    x = (jnp.asarray(rng.randint(0, 11, shape)) if layer == "Embed"
         else jnp.asarray(rng.randn(*shape), jnp.float32))
    ours, theirs = getattr(nn, layer)(**kw), getattr(linen, layer)(**kw)
    v = ours.init(jax.random.PRNGKey(0), x)
    v_flax = theirs.init(jax.random.PRNGKey(0), x)
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(jnp.shape, dict(v))) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(jnp.shape, dict(v_flax)))
    assert jax.tree_util.tree_map(jnp.shape, dict(v)) == \
        jax.tree_util.tree_map(jnp.shape, dict(v_flax))
    np.testing.assert_allclose(ours.apply(v, x), theirs.apply(v, x),
                               rtol=1e-6, atol=1e-6)


def test_train_state_matches_optax():
    params = {"w": jnp.ones((3,)), "b": jnp.zeros(())}
    tx = optax.adamw(1e-2)
    state = TrainState.create(apply_fn=None, params=params, tx=tx)
    assert state.step == 0
    grads = {"w": jnp.asarray([1.0, -2.0, 3.0]), "b": jnp.asarray(0.5)}
    new = jax.jit(lambda s, g: s.apply_gradients(grads=g))(state, grads)
    upd, _ = tx.update(grads, tx.init(params), params)
    want = optax.apply_updates(params, upd)
    assert int(new.step) == 1
    for k in params:
        np.testing.assert_allclose(new.params[k], want[k], rtol=1e-6)
    leaves, treedef = jax.tree_util.tree_flatten(new)
    again = jax.tree_util.tree_unflatten(treedef, leaves)
    assert again.tx is tx and int(again.step) == 1
    assert new.replace(step=5).step == 5


def test_dense_general_multi_axis_multi_feature():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    m = nn.DenseGeneral(features=(6, 2), axis=(1, 2))
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    k, b = np.asarray(v["params"]["kernel"]), np.asarray(v["params"]["bias"])
    assert k.shape == (3, 4, 6, 2) and b.shape == (6, 2)
    y = m.apply(v, jnp.asarray(x))
    want = np.einsum("bijd,ijfg->bdfg", x, k) + b
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_scale,use_bias", [
    (False, True), (True, False), (False, False),
])
def test_layernorm_optional_scale_and_bias(use_scale, use_bias):
    x = jnp.asarray(np.random.RandomState(2).randn(3, 8), jnp.float32)
    m = nn.LayerNorm(use_scale=use_scale, use_bias=use_bias)
    v = m.init(jax.random.PRNGKey(0), x)
    assert set(v.get("params", {})) == (
        ({"scale"} if use_scale else set()) | ({"bias"} if use_bias else set()))
    xd = np.asarray(x, np.float64)
    want = (xd - xd.mean(-1, keepdims=True)) / np.sqrt(
        xd.var(-1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(m.apply(v, x), want, atol=1e-5)


@pytest.mark.parametrize("strides", [1, 2])
def test_conv_same_padding_matches_lax(strides):
    x = jnp.asarray(np.random.RandomState(3).randn(1, 7, 7, 2), jnp.float32)
    m = nn.Conv(4, kernel_size=(3, 3), strides=strides)
    v = m.init(jax.random.PRNGKey(0), x)
    want = jax.lax.conv_general_dilated(
        x, v["params"]["kernel"], (strides, strides), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + v["params"]["bias"]
    np.testing.assert_allclose(m.apply(v, x), want, rtol=1e-5, atol=1e-5)


def test_flatten_dict_paths():
    tree = {"a": {"b": 1, "c": {"d": 2}}, "e": 3, "empty": {}}
    assert nn.flatten_dict(tree) == {("a", "b"): 1, ("a", "c", "d"): 2,
                                     ("e",): 3}


def test_remat_static_args_and_none():
    class Scaled(nn.Module):
        @nn.compact
        def __call__(self, x, factor, tag=None):
            assert isinstance(factor, float) and tag is None
            return nn.Dense(2, name="d")(x) * factor

    class Outer(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.remat(Scaled, static_argnums=(2,))(name="inner")(
                x, 2.0, None)

    x = jnp.ones((1, 3))
    v = Outer().init(jax.random.PRNGKey(0), x)
    got = jax.jit(lambda p: Outer().apply(p, x))(v)
    d = v["params"]["inner"]["d"]
    np.testing.assert_allclose(got, 2.0 * (x @ d["kernel"] + d["bias"]),
                               rtol=1e-6)


def test_modules_compare_and_hash_by_fields():
    a, b, c = nn.Dense(3), nn.Dense(3), nn.Dense(4)
    assert a == b and hash(a) == hash(b) and a != c
    fn = jax.jit(lambda m, x: m.apply(m.init(jax.random.PRNGKey(0), x), x),
                 static_argnums=0)
    assert fn(a, jnp.ones((1, 2))).shape == (1, 3)


def test_module_context_is_per_thread():
    """Tracing in two threads at once must not bind one thread's
    submodules to the other thread's parent."""
    import threading

    x = jnp.ones((2, 5))
    results, errors = [], []

    def run():
        try:
            for _ in range(20):
                results.append(_paths(
                    TwoDense().init(jax.random.PRNGKey(0), x)["params"]))
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert all(r == results[0] for r in results) and len(results) == 80
