"""Attention-map introspection (utils.debug.capture_attention_maps) vs the
reference's save_attention hooks (reference: models/qformer.py:147-159).

The reference exposes attention maps by mutating module state
(``save_attention=True`` → ``get_attention_map()``); this rebuild's
functional equivalent sows the probs as flax intermediates.  This test runs
BOTH on identical weights/inputs and compares the cross-attention maps
elementwise.
"""

import numpy as np
import pytest

from tests.conftest import add_reference_to_path, reference_available

torch = pytest.importorskip("torch")

if not reference_available():  # pragma: no cover
    pytest.skip("reference tree unavailable", allow_module_level=True)

add_reference_to_path()

import transformers.modeling_utils as _mu  # noqa: E402
import transformers.pytorch_utils as _pu  # noqa: E402

for _name in (
    "apply_chunking_to_forward",
    "find_pruneable_heads_and_indices",
    "prune_linear_layer",
):
    if not hasattr(_mu, _name):
        setattr(_mu, _name, getattr(_pu, _name))

from models.qformer import BertConfig, BertModel  # noqa: E402 (oracle)

import jax.numpy as jnp  # noqa: E402

from unirec.configs import ItemQFormerConfig, QFormerConfig  # noqa: E402
from unirec.models.item_qformer import ItemQFormer  # noqa: E402
from unirec.models.qformer import QFormerModel  # noqa: E402
from unirec.utils.debug import capture_attention_maps  # noqa: E402
from unirec.utils.torch_convert import convert_qformer_model  # noqa: E402

HIDDEN, LAYERS, HEADS, FFN, WIDTH, K = 64, 4, 4, 128, 48, 8


def _models():
    cfg = BertConfig(
        hidden_size=HIDDEN,
        num_hidden_layers=LAYERS,
        num_attention_heads=HEADS,
        intermediate_size=FFN,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
        add_cross_attention=True,
        cross_attention_freq=2,
        encoder_width=WIDTH,
        query_length=K,
        vocab_size=100,
        max_position_embeddings=32,
    )
    torch.manual_seed(0)
    tmodel = BertModel(cfg, add_pooling_layer=False)
    tmodel.eval()
    fcfg = QFormerConfig(
        hidden_size=HIDDEN,
        num_hidden_layers=LAYERS,
        num_attention_heads=HEADS,
        intermediate_size=FFN,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
        add_cross_attention=True,
        cross_attention_freq=2,
        encoder_width=WIDTH,
        query_length=K,
        vocab_size=100,
        max_position_embeddings=32,
    )
    return tmodel, fcfg


def test_cross_attention_maps_match_reference_hooks():
    tmodel, fcfg = _models()
    rng = np.random.RandomState(0)
    q = rng.randn(3, K, HIDDEN).astype(np.float32)
    mem = rng.randn(3, 6, WIDTH).astype(np.float32)
    mask = np.array(
        [[1, 1, 1, 1, 1, 1], [1, 1, 0, 1, 0, 1], [1, 0, 0, 0, 0, 0]],
        dtype=np.float32,
    )

    # reference hooks: flip save_attention on every cross-attention module
    cross_layers = [
        (i, layer.crossattention.self)
        for i, layer in enumerate(tmodel.encoder.layer)
        if layer.has_cross_attention
    ]
    for _, mod in cross_layers:
        mod.save_attention = True
    # NOT under no_grad: the reference hook path register_hook()s the probs
    # tensor (models/qformer.py:254), which requires grad to be enabled —
    # exactly the kind of side-effect the functional sow avoids.
    q_t = torch.tensor(q, requires_grad=True)
    t_out = tmodel(
        query_embeds=q_t,
        encoder_hidden_states=torch.tensor(mem),
        encoder_attention_mask=torch.tensor(mask),
        attention_mask=torch.ones(3, K),
        return_dict=True,
    ).last_hidden_state.detach().numpy()
    t_maps = {
        i: mod.get_attention_map().detach().numpy() for i, mod in cross_layers
    }
    assert len(t_maps) == 2  # layers 0 and 2 at cross_attention_freq=2

    fmodel = QFormerModel(fcfg)
    variables = {"params": convert_qformer_model(tmodel.state_dict(), fcfg)}
    f_out, maps = capture_attention_maps(
        fmodel,
        variables,
        query_embeds=jnp.asarray(q),
        attention_mask=jnp.ones((3, K)),
        encoder_hidden_states=jnp.asarray(mem),
        encoder_attention_mask=jnp.asarray(mask),
    )
    # the capture pass does not perturb the forward
    np.testing.assert_allclose(np.asarray(f_out), t_out, atol=2e-5, rtol=1e-4)

    # one sown map per attention module: 4 self + 2 cross
    self_keys = [k for k in maps if k.endswith("/attention")]
    cross_keys = [k for k in maps if k.endswith("/crossattention")]
    assert len(self_keys) == LAYERS and len(cross_keys) == 2

    for (i, _), key in zip(cross_layers, cross_keys):
        assert f"layer_{i}/" in key
        f_map = np.asarray(maps[key])
        assert f_map.shape == t_maps[i].shape  # [B, H, K, F]
        np.testing.assert_allclose(f_map, t_maps[i], atol=2e-5, rtol=1e-4)
        # masked fields get exactly zero attention
        np.testing.assert_allclose(f_map[1, :, :, 2], 0.0, atol=1e-9)


def test_capture_on_item_qformer_wrapper():
    """The helper works on the wrapper model users actually hold (C1's
    introspection surface via ItemQFormer), incl. kernel-path configs."""
    cfg = ItemQFormerConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=4, field_embedding_dim=16,
        num_fields=3, dropout=0.0, fast_attention=True,
    )
    model = ItemQFormer(cfg)
    rng = np.random.RandomState(1)
    fields = jnp.asarray(rng.randn(2, 3, 16).astype(np.float32))
    mask = jnp.asarray(np.array([[1, 1, 1], [1, 0, 1]], np.float32))
    import jax

    params = model.init(jax.random.PRNGKey(0), fields, mask)
    out, maps = capture_attention_maps(model, params, fields, mask)
    assert out["query_outputs"].shape == (2, 4, 32)
    cross = [k for k in maps if "crossattention" in k]
    assert len(cross) == 1  # cross at layer 0 only (freq 2, 2 layers)
    probs = np.asarray(maps[cross[0]])
    assert probs.shape == (2, 2, 4, 3)
    # rows sum to 1; masked field 1 of item 1 gets zero attention
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs[1, :, :, 1], 0.0, atol=1e-9)
