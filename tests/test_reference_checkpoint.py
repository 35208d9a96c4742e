"""Reference checkpoint compatibility: a torch ``best_qformer_model.pth``
saved in the reference's schema (training/item_qformer_training.py:178-182)
loads through QFormerInference and reproduces the torch model's outputs."""

import numpy as np
import pytest

from tests.conftest import add_reference_to_path, reference_available

torch = pytest.importorskip("torch")

if not reference_available():  # pragma: no cover
    pytest.skip("reference tree unavailable", allow_module_level=True)

add_reference_to_path()

import transformers.modeling_utils as _mu  # noqa: E402
import transformers.pytorch_utils as _pu  # noqa: E402

for _n in ("apply_chunking_to_forward", "find_pruneable_heads_and_indices",
           "prune_linear_layer"):
    if not hasattr(_mu, _n):
        setattr(_mu, _n, getattr(_pu, _n))


def test_pth_checkpoint_roundtrip(tmp_path):
    from models.qformer_utils import QFormerForItemRepresentation  # oracle

    torch.manual_seed(0)
    num_fields = 5
    tmodel = QFormerForItemRepresentation(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, num_query_tokens=4, field_embedding_dim=48,
        num_fields=num_fields, dropout=0.0,
    )
    tmodel.eval()

    # save in the reference trainer's schema
    ckpt_path = str(tmp_path / "best_qformer_model.pth")
    torch.save(
        {
            "model_state_dict": tmodel.state_dict(),
            "config": tmodel.config,
            "field_names": ["a", "b", "c", "d", "e"],
        },
        ckpt_path,
    )

    from unirec.inference.qformer_inference import QFormerInference

    inf = QFormerInference(ckpt_path, batch_size=8)
    assert inf.field_names == ["a", "b", "c", "d", "e"]
    assert inf.config.num_query_tokens == 4
    assert inf.config.num_fields == num_fields

    rng = np.random.RandomState(0)
    fields = rng.randn(3, num_fields, 48).astype(np.float32)
    mask = np.ones((3, num_fields), np.float32)
    tokens = inf.query_tokens_from_embeddings(fields, mask)

    with torch.no_grad():
        t_out = tmodel(torch.tensor(fields), torch.tensor(mask))[
            "query_outputs"
        ].numpy()
    # bf16 inference vs fp32 torch: loose tolerance
    np.testing.assert_allclose(tokens, t_out, atol=0.08, rtol=0.1)
    # correlation must be essentially 1
    c = np.corrcoef(tokens.ravel(), t_out.ravel())[0, 1]
    assert c > 0.999


def test_export_roundtrip_into_reference(tmp_path):
    """The OTHER direction: a JAX-trained ItemQFormer exports to a
    reference-schema ``best_qformer_model.pth`` that (a) loads STRICT into
    the reference ``QFormerForItemRepresentation`` rebuilt from the pickled
    config exactly as data_processing/qformer_inference.py:29-48 does, with
    matching forward outputs, and (b) round-trips back through the import
    converter to the identical Flax tree."""
    import jax
    import jax.numpy as jnp

    from models.qformer_utils import QFormerForItemRepresentation  # oracle
    from unirec.configs import ItemQFormerConfig
    from unirec.models.item_qformer import ItemQFormer
    from unirec.utils.torch_convert import (
        load_reference_item_qformer_checkpoint,
        save_reference_item_qformer_checkpoint,
    )

    cfg = ItemQFormerConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, num_query_tokens=4, field_embedding_dim=48,
        num_fields=5, dropout=0.0,
    )
    model = ItemQFormer(config=cfg)
    rng = np.random.RandomState(1)
    fields = rng.randn(3, 5, 48).astype(np.float32)
    mask = np.asarray(
        [[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], np.float32
    )
    variables = model.init(
        jax.random.PRNGKey(0), jnp.asarray(fields), jnp.asarray(mask),
        deterministic=True,
    )

    path = str(tmp_path / "best_qformer_model.pth")
    save_reference_item_qformer_checkpoint(
        path, variables["params"], cfg, ["a", "b", "c", "d", "e"]
    )

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    config = ckpt["config"]
    tmodel = QFormerForItemRepresentation(
        hidden_size=config.hidden_size,
        num_hidden_layers=config.num_hidden_layers,
        num_attention_heads=config.num_attention_heads,
        intermediate_size=config.intermediate_size,
        num_query_tokens=config.query_length,
        field_embedding_dim=config.encoder_width,
        num_fields=len(ckpt["field_names"]),
        dropout=config.hidden_dropout_prob,
    )
    tmodel.load_state_dict(ckpt["model_state_dict"], strict=True)
    tmodel.eval()

    out = model.apply(
        variables, jnp.asarray(fields), jnp.asarray(mask), deterministic=True
    )
    with torch.no_grad():
        t_out = tmodel(torch.tensor(fields), torch.tensor(mask))
    for key in ("query_outputs", "item_representation", "reconstructed_fields"):
        np.testing.assert_allclose(
            np.asarray(out[key], np.float32), t_out[key].numpy(),
            atol=2e-5, err_msg=key,
        )

    cfg2, vars2, names2 = load_reference_item_qformer_checkpoint(path)
    assert names2 == ["a", "b", "c", "d", "e"]
    assert cfg2 == cfg
    # the re-imported tree gains the synthesized torch-only leaves (zero
    # word/position tables, zero text FFNs), so compare via a second export:
    # it must reproduce the first state_dict bit-for-bit
    from unirec.utils.torch_convert import export_item_qformer

    sd1 = export_item_qformer(variables["params"], cfg)
    sd2 = export_item_qformer(vars2["params"], cfg2)
    assert sorted(sd1) == sorted(sd2)
    for k in sd1:
        np.testing.assert_array_equal(sd1[k], sd2[k], err_msg=k)


def test_user_export_loads_strict_into_reference(tmp_path):
    """A saved reference-schema ``best_user_qformer_model.pth``
    (training/user_qformer_training.py:218-228) rebuilds the reference
    UserQFormer from the pickled config and loads strict, with matching
    forward predictions."""
    import jax
    import jax.numpy as jnp

    from training.user_qformer_training import UserQFormer as RefUserQFormer
    from unirec.configs import UserQFormerConfig
    from unirec.models.user_qformer import UserQFormer
    from unirec.utils.torch_convert import (
        save_reference_user_qformer_checkpoint,
    )

    kw = dict(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, num_query_tokens=8, input_embedding_dim=48,
        num_item_tokens_to_predict=4, dropout=0.0,
    )
    cfg = UserQFormerConfig(**kw)
    model = UserQFormer(config=cfg)
    rng = np.random.RandomState(2)
    seq = rng.randn(3, 10, 48).astype(np.float32)
    mask = np.ones((3, 10), np.float32)
    mask[0, 6:] = 0.0
    variables = model.init(
        jax.random.PRNGKey(0), jnp.asarray(seq), jnp.asarray(mask),
        deterministic=True,
    )

    path = str(tmp_path / "best_user_qformer_model.pth")
    save_reference_user_qformer_checkpoint(
        path, variables["params"], cfg, epoch=3, loss=1.25
    )
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert set(ckpt) == {"model_state_dict", "config", "epoch", "loss"}
    assert ckpt["epoch"] == 3 and ckpt["loss"] == 1.25
    config = ckpt["config"]
    sd = ckpt["model_state_dict"]
    # num_item_tokens_to_predict is recovered from the head's output width,
    # like any reference-side consumer would
    k_pred = sd["prediction_head.3.weight"].shape[0] // config.encoder_width
    tmodel = RefUserQFormer(
        hidden_size=config.hidden_size,
        num_hidden_layers=config.num_hidden_layers,
        num_attention_heads=config.num_attention_heads,
        intermediate_size=config.intermediate_size,
        num_query_tokens=config.query_length,
        input_embedding_dim=config.encoder_width,
        num_item_tokens_to_predict=k_pred,
        dropout=config.hidden_dropout_prob,
    )
    tmodel.load_state_dict(sd, strict=True)
    tmodel.eval()

    pred = model.apply(
        variables, jnp.asarray(seq), jnp.asarray(mask), deterministic=True
    )
    with torch.no_grad():
        t_pred = tmodel(torch.tensor(seq), torch.tensor(mask))
    np.testing.assert_allclose(
        np.asarray(pred, np.float32), t_pred.numpy(), atol=2e-5
    )


def test_export_roundtrips_relative_position_and_pooler():
    """Export must also invert the C1 long-tail variants: relative-position
    self-attention (distance_embedding) and the tanh pooler — a torch
    BertModel state_dict with both survives convert -> export bit-for-bit."""
    from models.qformer import BertConfig, BertModel  # reference oracle
    from unirec.configs import QFormerConfig
    from unirec.utils.torch_convert import (
        convert_qformer_model,
        export_qformer_model,
    )

    cfg = BertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, add_cross_attention=True,
        cross_attention_freq=1, encoder_width=24, query_length=4,
        vocab_size=50, max_position_embeddings=16,
        position_embedding_type="relative_key_query",
    )
    torch.manual_seed(5)
    tmodel = BertModel(cfg, add_pooling_layer=True)
    sd_ref = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}

    qc = QFormerConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, add_cross_attention=True,
        cross_attention_freq=1, encoder_width=24, query_length=4,
        vocab_size=50, max_position_embeddings=16,
        position_embedding_type="relative_key_query",
    )
    params = convert_qformer_model(sd_ref, qc)
    sd_out = export_qformer_model(params, qc)
    assert sorted(sd_out) == sorted(sd_ref)
    for k in sd_ref:
        np.testing.assert_array_equal(sd_out[k], sd_ref[k], err_msg=k)
    tmodel.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd_out.items()},
        strict=True,
    )


def test_mwne_checkpoint_import_matches_reference(tmp_path):
    """A reference ``mathematical_encoder_*_normalized.pth`` (the trained
    number encoder the ItemEncoder requires — reference:
    models/item_encoder_pure_value.py:68-70, schema models/mwne.py:784-806)
    converts to Flax variables whose eval forward matches the reference's
    ``load_trained_encoder`` output exactly."""
    from models.mwne import (  # reference oracle
        ImprovedMathematicalEncoder,
        load_trained_encoder,
    )

    from unirec.encoders.backends import MWNENumberBackend

    torch.manual_seed(3)
    base = ImprovedMathematicalEncoder(
        embedding_dim=64, num_frequencies=8, max_frequency=50.0,
        include_raw=True, device="cpu",
    )
    with torch.no_grad():  # move off the all-ones init so the test bites
        base.fourier_weight.add_(0.3 * torch.randn_like(base.fourier_weight))
        base.raw_scale.add_(0.3 * torch.randn_like(base.raw_scale))
        base.extra_proj.weight.add_(
            0.3 * torch.randn_like(base.extra_proj.weight))

    path = str(tmp_path / "mathematical_encoder_64d_normalized.pth")
    torch.save(
        {
            "encoder_state_dict": base.state_dict(),
            "encoder_config": {
                "embedding_dim": 64, "num_frequencies": 8,
                "max_frequency": 50.0, "include_raw": True,
            },
            "normalization_config": {
                "use_normalization": True, "target_std": 1.0,
                "momentum": 0.99, "min_std": 0.1,
            },
        },
        path,
    )

    backend = MWNENumberBackend.from_reference_checkpoint(path)
    assert backend.config.embedding_dim == 64
    assert backend.config.num_frequencies == 8

    nums = np.array([0.0, 1.0, -2.5, 3.14159, 1000.0, -0.001], np.float32)
    ours = np.asarray(
        backend.model.apply(backend.variables, nums, train=False))

    oracle = load_trained_encoder(path, device="cpu")
    with torch.no_grad():
        theirs = oracle(torch.tensor(nums)).numpy()
    # moderate magnitudes match tightly; the 1000.0 row reaches phase
    # ~5e4 rad where fp32 sin/cos argument reduction differs between
    # torch and XLA by ~ulp(phase) ≈ 4e-3 rad — backend precision, not a
    # conversion artifact
    np.testing.assert_allclose(
        ours[np.abs(nums) < 100], theirs[np.abs(nums) < 100],
        atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, theirs, atol=2e-2, rtol=1e-3)


def test_mwne_export_loads_into_reference(tmp_path):
    """The OTHER direction: a JAX-trained MWNE exports to a checkpoint the
    reference's ``load_trained_encoder`` consumes directly, with matching
    outputs — and the frequency-grid validation rejects a checkpoint whose
    buffer disagrees with its own config."""
    import jax
    import jax.numpy as jnp

    from models.mwne import load_trained_encoder  # reference oracle
    from unirec.configs import MWNEConfig
    from unirec.models.mwne import NormalizedMathematicalEncoder
    from unirec.utils.torch_convert import (
        convert_mwne,
        save_reference_mwne_checkpoint,
    )

    cfg = MWNEConfig(embedding_dim=48, num_frequencies=6, max_frequency=80.0)
    model = NormalizedMathematicalEncoder(cfg)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((4,)))
    # perturb the learnables the way training would
    key = jax.random.PRNGKey(2)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.3 * jax.random.normal(key, p.shape, p.dtype),
        variables["params"],
    )
    variables = {"params": params, "batch_stats": variables["batch_stats"]}

    out = str(tmp_path / "exported_mwne.pth")
    save_reference_mwne_checkpoint(
        out, cfg, variables,
        final_metrics={"additivity_mse": 0.0, "invertibility_mean": 0.0,
                       "distance_rank_correlation": 1.0},
    )

    oracle = load_trained_encoder(out, device="cpu")
    nums = np.linspace(-5.0, 5.0, 11).astype(np.float32)
    with torch.no_grad():
        theirs = oracle(torch.tensor(nums)).numpy()
    ours = np.asarray(model.apply(variables, nums, train=False))
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=1e-5)

    # round-trips back to the identical Flax tree
    cfg2, variables2 = convert_mwne(
        torch.load(out, map_location="cpu", weights_only=False))
    assert cfg2 == cfg
    flat1 = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat2 = dict(jax.tree_util.tree_leaves_with_path(variables2["params"]))
    assert set(flat2) == {k for k, _ in flat1}
    for k, v in flat1:
        np.testing.assert_array_equal(v, flat2[k], err_msg=str(k))

    # validation: a frequencies buffer inconsistent with its config is refused
    bad = torch.load(out, map_location="cpu", weights_only=False)
    bad["encoder_state_dict"]["frequencies"] = (
        bad["encoder_state_dict"]["frequencies"] * 2.0)
    with pytest.raises(ValueError, match="frequencies"):
        convert_mwne(bad)
