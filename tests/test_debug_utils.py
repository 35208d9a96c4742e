"""utils/debug: the NaN/Inf sanitizers (SURVEY.md §5 — the JAX-native
stand-in for the reference's nonexistent race detection / sanitizers) must
actually trip on bad numerics and restore global config afterwards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unirec.utils.debug import eager_mode, nan_checks


def test_nan_checks_trip_on_nan_and_restore_config():
    assert not jax.config.jax_debug_nans  # conftest default

    def bad(x):
        return x / (x - x)  # 0/0 → NaN inside jit

    with nan_checks():
        assert jax.config.jax_debug_nans
        with pytest.raises((FloatingPointError, ZeroDivisionError)):
            jax.jit(bad)(jnp.ones(())).block_until_ready()
    assert not jax.config.jax_debug_nans
    assert not jax.config.jax_debug_infs


def test_nan_checks_pass_clean_model_forward():
    """A real model forward under the sanitizer: the Q-Former's additive
    -1e9 masks must not trip the Inf check (they are large-finite by
    design — models/qformer.py)."""
    from unirec.configs import ItemQFormerConfig
    from unirec.models.item_qformer import ItemQFormer

    cfg = ItemQFormerConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, num_query_tokens=4, field_embedding_dim=32,
        num_fields=3, dropout=0.0,
    )
    model = ItemQFormer(config=cfg)
    rng = np.random.RandomState(0)
    fields = jnp.asarray(rng.randn(2, 3, 32), jnp.float32)
    mask = jnp.asarray([[1, 1, 0], [1, 0, 0]], jnp.float32)
    params = model.init(jax.random.PRNGKey(0), fields, mask,
                        deterministic=True)
    with nan_checks():
        out = jax.jit(
            lambda p, f, m: model.apply(p, f, m, deterministic=True)
        )(params, fields, mask)
        rep = np.asarray(out["item_representation"])
    assert np.isfinite(rep).all()


def test_eager_mode_disables_jit():
    calls = []

    @jax.jit
    def probe(x):
        calls.append(1)  # python side effect: runs once per TRACE
        return x + 1

    with eager_mode():
        probe(jnp.ones(()))
        probe(jnp.ones(()))
    # eagerly the python body runs on EVERY call; under jit the second
    # call would hit the compiled cache and never re-enter python
    assert len(calls) == 2
    probe(jnp.ones(()))
    probe(jnp.ones(()))
    assert len(calls) == 3
