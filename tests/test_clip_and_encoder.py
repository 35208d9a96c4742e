"""CLIP towers (parity vs HF) + ItemEncoder orchestration semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unirec.configs import FieldSchema, MWNEConfig
from unirec.encoders.backends import (
    HashImageBackend,
    HashTextBackend,
    MWNENumberBackend,
    Qwen3TextBackend,
)
from unirec.encoders.item_encoder import ItemEncoder
from unirec.models.clip import (
    CLIPTextConfig,
    CLIPTextTower,
    CLIPVisionConfig,
    CLIPVisionTower,
    convert_clip_text,
    convert_clip_vision,
    preprocess_image,
)

VC = CLIPVisionConfig(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2,
    num_attention_heads=4, image_size=32, patch_size=8, projection_dim=48,
)
TC = CLIPTextConfig(
    vocab_size=200, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=16,
    projection_dim=48, eos_token_id=199,
)


def test_clip_vision_parity_vs_hf():
    torch = pytest.importorskip("torch")
    from transformers import CLIPConfig, CLIPModel
    from transformers.models.clip.configuration_clip import (
        CLIPTextConfig as HFText,
        CLIPVisionConfig as HFVision,
    )

    hf_cfg = CLIPConfig(
        text_config=dict(
            vocab_size=TC.vocab_size, hidden_size=TC.hidden_size,
            intermediate_size=TC.intermediate_size,
            num_hidden_layers=TC.num_hidden_layers,
            num_attention_heads=TC.num_attention_heads,
            max_position_embeddings=TC.max_position_embeddings,
            eos_token_id=199, bos_token_id=198,
        ),
        vision_config=dict(
            hidden_size=VC.hidden_size, intermediate_size=VC.intermediate_size,
            num_hidden_layers=VC.num_hidden_layers,
            num_attention_heads=VC.num_attention_heads,
            image_size=VC.image_size, patch_size=VC.patch_size,
        ),
        projection_dim=48,
    )
    torch.manual_seed(0)
    hf = CLIPModel(hf_cfg).eval()

    rng = np.random.RandomState(0)
    pix_nchw = rng.randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        t_img = hf.get_image_features(
            pixel_values=torch.tensor(pix_nchw)
        ).numpy()

    model = CLIPVisionTower(VC)
    params = {"params": convert_clip_vision(hf.state_dict(), VC)}
    f_img = np.asarray(
        model.apply(params, jnp.asarray(pix_nchw.transpose(0, 2, 3, 1)))
    )
    np.testing.assert_allclose(f_img, t_img, atol=3e-5, rtol=1e-4)

    # text tower parity
    ids = rng.randint(1, 199, (2, 12)).astype(np.int64)
    ids[:, -1] = 199  # EOT = max id
    with torch.no_grad():
        t_txt = hf.get_text_features(input_ids=torch.tensor(ids)).numpy()
    tmodel = CLIPTextTower(TC)
    tparams = {"params": convert_clip_text(hf.state_dict(), TC)}
    f_txt = np.asarray(tmodel.apply(tparams, jnp.asarray(ids.astype(np.int32))))
    np.testing.assert_allclose(f_txt, t_txt, atol=3e-5, rtol=1e-4)


def test_preprocess_image_shape_and_range():
    PIL = pytest.importorskip("PIL")
    from PIL import Image

    img = Image.fromarray(
        (np.random.RandomState(0).rand(50, 70, 3) * 255).astype(np.uint8)
    )
    arr = preprocess_image(img, 32)
    assert arr.shape == (32, 32, 3)
    assert np.abs(arr).max() < 4.0  # normalized range


def test_item_encoder_modality_routing():
    enc = ItemEncoder(
        text_backend=HashTextBackend(1024),
        image_backend=HashImageBackend(768),
        number_backend=MWNENumberBackend(MWNEConfig(embedding_dim=1024)),
    )
    samples = [
        {"title": "Lip Balm", "price": 9.99, "main_image": "img_a",
         "brand": "Acme"},
        {"title": "", "price": "bad", "main_image": None},
    ]
    fields = ["title", "price", "main_image", "brand", "unknown_field"]
    out = enc.encode_batch_by_field(samples, fields)
    for f in fields:
        assert out[f].shape == (2, 1024)
    # empty text -> zeros
    assert np.abs(out["title"][1]).sum() == 0
    assert np.abs(out["title"][0]).sum() > 0
    # image zero-padded from 768: last 256 dims zero
    assert np.abs(out["main_image"][0][768:]).sum() == 0
    assert np.abs(out["main_image"][0][:768]).sum() > 0
    # missing image -> zeros
    assert np.abs(out["main_image"][1]).sum() == 0
    # numbers L2-normalized; invalid -> encode 0.0 (nonzero embedding)
    np.testing.assert_allclose(np.linalg.norm(out["price"][0]), 1.0, rtol=1e-4)
    assert np.abs(out["price"][1]).sum() > 0
    # unknown field -> zeros
    assert np.abs(out["unknown_field"]).sum() == 0


def test_item_encoder_single_sample_and_dims():
    enc = ItemEncoder(
        text_backend=HashTextBackend(1024),
        image_backend=HashImageBackend(768),
        number_backend=MWNENumberBackend(MWNEConfig(embedding_dim=1024)),
    )
    emb = enc.encode_sample({"title": "x", "price": 3})
    assert set(emb) == set(FieldSchema().fields)
    assert all(v.shape == (1024,) for v in emb.values())
    dims = enc.get_embedding_dimensions()
    assert all(d == 1024 for d in dims.values())


def test_item_encoder_determinism():
    enc = ItemEncoder(
        text_backend=HashTextBackend(64),
        image_backend=HashImageBackend(48),
        number_backend=MWNENumberBackend(MWNEConfig(embedding_dim=64,
                                                    num_frequencies=8)),
        embedding_dim=64,
    )
    s = [{"title": "same", "price": 5.0}]
    a = enc.encode_batch_by_field(s, ["title", "price"])
    b = enc.encode_batch_by_field(s, ["title", "price"])
    np.testing.assert_array_equal(a["title"], b["title"])
    np.testing.assert_array_equal(a["price"], b["price"])


def test_qwen3_text_backend_smoke():
    from unirec.configs import tiny_qwen3_config

    backend = Qwen3TextBackend(
        tiny_qwen3_config(max_position_embeddings=64),
        max_length=16, batch_size=4, dtype=jnp.float32,
    )
    embs = backend.encode(["hello world", "lip balm", "hello world"])
    assert embs.shape == (3, 64)
    np.testing.assert_allclose(np.linalg.norm(embs, axis=1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(embs[0], embs[2], atol=1e-6)  # deterministic
    assert np.abs(embs[0] - embs[1]).max() > 1e-3


def test_clip_image_backend_with_pil_images():
    from PIL import Image

    from unirec.encoders.backends import CLIPImageBackend

    backend = CLIPImageBackend(VC, batch_size=2, dtype=jnp.float32)
    imgs = [
        Image.fromarray((np.full((40, 40, 3), c)).astype(np.uint8))
        for c in (10, 200)
    ]
    out = backend.encode([imgs[0], None, imgs[1], ""])
    assert out.shape == (4, 48)
    assert np.abs(out[0]).sum() > 0 and np.abs(out[2]).sum() > 0
    assert np.abs(out[1]).sum() == 0 and np.abs(out[3]).sum() == 0
    assert np.abs(out[0] - out[2]).max() > 1e-4
