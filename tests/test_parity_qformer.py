"""Numerical parity: Flax Q-Former vs the PyTorch reference implementation.

Copies random-initialized torch weights into the Flax models via
unirec.utils.torch_convert and compares forward activations to tight
tolerance (BASELINE.json north-star: "output embeddings match the PyTorch/HF
reference to numerical tolerance").  Uses the reference strictly as a test
oracle; skipped when the reference tree or torch is unavailable.
"""

import numpy as np
import pytest

from tests.conftest import add_reference_to_path, reference_available

torch = pytest.importorskip("torch")

if not reference_available():  # pragma: no cover
    pytest.skip("reference tree unavailable", allow_module_level=True)

add_reference_to_path()

# The reference was written against an older transformers; re-export the
# helpers it imports from modeling_utils (they moved to pytorch_utils).
import transformers.modeling_utils as _mu  # noqa: E402
import transformers.pytorch_utils as _pu  # noqa: E402

for _name in (
    "apply_chunking_to_forward",
    "find_pruneable_heads_and_indices",
    "prune_linear_layer",
):
    if not hasattr(_mu, _name):
        setattr(_mu, _name, getattr(_pu, _name))

from models.qformer import BertConfig, BertModel  # noqa: E402  (reference oracle)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from unirec.configs import ItemQFormerConfig, QFormerConfig  # noqa: E402
from unirec.models.item_qformer import ItemQFormer  # noqa: E402
from unirec.models.qformer import QFormerModel  # noqa: E402
from unirec.utils.torch_convert import (  # noqa: E402
    convert_item_qformer,
    convert_qformer_model,
)

HIDDEN, LAYERS, HEADS, FFN, WIDTH, K = 64, 4, 4, 128, 48, 8


def make_torch_bert(add_cross=True, cross_freq=2, dropout=0.0):
    cfg = BertConfig(
        hidden_size=HIDDEN,
        num_hidden_layers=LAYERS,
        num_attention_heads=HEADS,
        intermediate_size=FFN,
        hidden_dropout_prob=dropout,
        attention_probs_dropout_prob=dropout,
        add_cross_attention=add_cross,
        cross_attention_freq=cross_freq,
        encoder_width=WIDTH,
        query_length=K,
        vocab_size=100,
        max_position_embeddings=32,
    )
    torch.manual_seed(0)
    model = BertModel(cfg, add_pooling_layer=False)
    model.eval()
    return cfg, model


def flax_cfg(dropout=0.0, add_cross=True):
    return QFormerConfig(
        hidden_size=HIDDEN,
        num_hidden_layers=LAYERS,
        num_attention_heads=HEADS,
        intermediate_size=FFN,
        hidden_dropout_prob=dropout,
        attention_probs_dropout_prob=dropout,
        add_cross_attention=add_cross,
        cross_attention_freq=2,
        encoder_width=WIDTH,
        query_length=K,
        vocab_size=100,
        max_position_embeddings=32,
    )


def test_query_only_cross_attention_parity():
    """The canonical item Q-Former path: query tokens + field memory + mask."""
    _, tmodel = make_torch_bert()
    rng = np.random.RandomState(0)
    q = rng.randn(3, K, HIDDEN).astype(np.float32)
    mem = rng.randn(3, 6, WIDTH).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 0, 1, 0, 1], [1, 0, 0, 0, 0, 0]],
                    dtype=np.float32)

    with torch.no_grad():
        t_out = tmodel(
            query_embeds=torch.tensor(q),
            encoder_hidden_states=torch.tensor(mem),
            encoder_attention_mask=torch.tensor(mask),
            attention_mask=torch.ones(3, K),
            return_dict=True,
        ).last_hidden_state.numpy()

    fmodel = QFormerModel(flax_cfg())
    params = {"params": convert_qformer_model(tmodel.state_dict(), flax_cfg())}
    f_out = np.asarray(
        fmodel.apply(
            params,
            query_embeds=jnp.asarray(q),
            attention_mask=jnp.ones((3, K)),
            encoder_hidden_states=jnp.asarray(mem),
            encoder_attention_mask=jnp.asarray(mask),
        )
    )
    np.testing.assert_allclose(f_out, t_out, atol=2e-5, rtol=1e-4)


def test_query_plus_text_parity():
    """Queries + text tokens, split FFN paths, padding mask."""
    _, tmodel = make_torch_bert()
    rng = np.random.RandomState(1)
    q = rng.randn(2, K, HIDDEN).astype(np.float32)
    mem = rng.randn(2, 5, WIDTH).astype(np.float32)
    ids = np.array([[5, 6, 7, 8], [9, 10, 0, 0]], dtype=np.int64)
    text_mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], dtype=np.float32)
    full_mask = np.concatenate([np.ones((2, K), np.float32), text_mask], axis=1)

    with torch.no_grad():
        t_out = tmodel(
            input_ids=torch.tensor(ids),
            attention_mask=torch.tensor(full_mask),
            query_embeds=torch.tensor(q),
            encoder_hidden_states=torch.tensor(mem),
            return_dict=True,
        ).last_hidden_state.numpy()

    fmodel = QFormerModel(flax_cfg())
    params = {"params": convert_qformer_model(tmodel.state_dict(), flax_cfg())}
    f_out = np.asarray(
        fmodel.apply(
            params,
            input_ids=jnp.asarray(ids),
            attention_mask=jnp.asarray(full_mask),
            query_embeds=jnp.asarray(q),
            encoder_hidden_states=jnp.asarray(mem),
        )
    )
    np.testing.assert_allclose(f_out, t_out, atol=2e-5, rtol=1e-4)


def test_decoder_unilm_mask_parity():
    """is_decoder=True: causal text + bidirectional query prefix (UniLM)."""
    _, tmodel = make_torch_bert()
    rng = np.random.RandomState(2)
    q = rng.randn(2, K, HIDDEN).astype(np.float32)
    mem = rng.randn(2, 5, WIDTH).astype(np.float32)
    ids = np.array([[5, 6, 7, 8], [9, 10, 11, 0]], dtype=np.int64)
    text_mask = np.array([[1, 1, 1, 1], [1, 1, 1, 0]], dtype=np.float32)
    full_mask = np.concatenate([np.ones((2, K), np.float32), text_mask], axis=1)

    with torch.no_grad():
        t_out = tmodel(
            input_ids=torch.tensor(ids),
            attention_mask=torch.tensor(full_mask),
            query_embeds=torch.tensor(q),
            encoder_hidden_states=torch.tensor(mem),
            is_decoder=True,
            return_dict=True,
        ).last_hidden_state.numpy()

    fmodel = QFormerModel(flax_cfg())
    params = {"params": convert_qformer_model(tmodel.state_dict(), flax_cfg())}
    f_out = np.asarray(
        fmodel.apply(
            params,
            input_ids=jnp.asarray(ids),
            attention_mask=jnp.asarray(full_mask),
            query_embeds=jnp.asarray(q),
            encoder_hidden_states=jnp.asarray(mem),
            is_decoder=True,
        )
    )
    np.testing.assert_allclose(f_out, t_out, atol=2e-5, rtol=1e-4)


def test_item_qformer_wrapper_parity():
    """Full QFormerForItemRepresentation vs ItemQFormer: all three outputs."""
    try:
        from models.qformer_utils import QFormerForItemRepresentation
    except Exception as e:  # pragma: no cover
        pytest.skip(f"reference wrapper unimportable: {e}")

    torch.manual_seed(3)
    num_fields = 6
    tmodel = QFormerForItemRepresentation(
        hidden_size=HIDDEN,
        num_hidden_layers=LAYERS,
        num_attention_heads=HEADS,
        intermediate_size=FFN,
        num_query_tokens=K,
        field_embedding_dim=WIDTH,
        num_fields=num_fields,
        dropout=0.0,
    )
    tmodel.eval()

    rng = np.random.RandomState(3)
    fields = rng.randn(4, num_fields, WIDTH).astype(np.float32)
    mask = (rng.rand(4, num_fields) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0

    with torch.no_grad():
        t_out = tmodel(torch.tensor(fields), torch.tensor(mask))

    cfg = ItemQFormerConfig(
        hidden_size=HIDDEN,
        num_hidden_layers=LAYERS,
        num_attention_heads=HEADS,
        intermediate_size=FFN,
        num_query_tokens=K,
        field_embedding_dim=WIDTH,
        num_fields=num_fields,
        dropout=0.0,
    )
    fmodel = ItemQFormer(cfg)
    params = {"params": convert_item_qformer(tmodel.state_dict(), cfg)}
    f_out = fmodel.apply(params, jnp.asarray(fields), jnp.asarray(mask))

    for key in ["query_outputs", "item_representation", "reconstructed_fields"]:
        np.testing.assert_allclose(
            np.asarray(f_out[key]),
            t_out[key].numpy(),
            atol=3e-5,
            rtol=1e-4,
            err_msg=key,
        )


def test_lm_head_model_parity():
    """BertLMHeadModel logits + label-smoothed loss vs QFormerLMHeadModel."""
    from models.qformer import BertLMHeadModel

    from unirec.models.qformer import QFormerLMHeadModel
    from unirec.utils.torch_convert import convert_qformer_lm_model

    cfg, _ = make_torch_bert()
    torch.manual_seed(4)
    tmodel = BertLMHeadModel(cfg)
    tmodel.eval()

    rng = np.random.RandomState(4)
    q = rng.randn(2, K, HIDDEN).astype(np.float32)
    mem = rng.randn(2, 5, WIDTH).astype(np.float32)
    ids = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], dtype=np.int64)
    full_mask = np.ones((2, K + 4), np.float32)
    labels = ids.copy()

    with torch.no_grad():
        t_out = tmodel(
            input_ids=torch.tensor(ids),
            attention_mask=torch.tensor(full_mask),
            query_embeds=torch.tensor(q),
            encoder_hidden_states=torch.tensor(mem),
            labels=torch.tensor(labels),
            return_dict=True,
        )
    t_logits = t_out.logits.numpy()
    t_loss = float(t_out.loss)

    fmodel = QFormerLMHeadModel(flax_cfg())
    params = {
        "params": convert_qformer_lm_model(tmodel.state_dict(), flax_cfg())
    }
    f_logits, f_loss = fmodel.apply(
        params,
        input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(full_mask),
        query_embeds=jnp.asarray(q),
        encoder_hidden_states=jnp.asarray(mem),
        labels=jnp.asarray(labels),
    )
    np.testing.assert_allclose(
        np.asarray(f_logits), t_logits, atol=5e-5, rtol=1e-3
    )
    np.testing.assert_allclose(float(f_loss), t_loss, rtol=1e-4)


@pytest.mark.parametrize("variant", ["relative_key", "relative_key_query"])
def test_relative_position_parity(variant):
    """BERT relative-position self-attention variants
    (reference: models/qformer.py:207-242).  Self-attention-only encoder:
    the reference einsum assumes Lq == Lkv, so cross-attention layers are
    incompatible with relative mode in the reference too."""
    cfg = BertConfig(
        hidden_size=HIDDEN,
        num_hidden_layers=LAYERS,
        num_attention_heads=HEADS,
        intermediate_size=FFN,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
        add_cross_attention=False,
        cross_attention_freq=2,
        encoder_width=WIDTH,
        query_length=K,
        vocab_size=100,
        max_position_embeddings=32,
        position_embedding_type=variant,
    )
    torch.manual_seed(7)
    tmodel = BertModel(cfg, add_pooling_layer=False)
    tmodel.eval()

    rng = np.random.RandomState(7)
    q = rng.randn(2, K, HIDDEN).astype(np.float32)
    ids = np.array([[5, 6, 7, 8], [9, 10, 0, 0]], dtype=np.int64)
    text_mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], dtype=np.float32)
    full_mask = np.concatenate([np.ones((2, K), np.float32), text_mask], axis=1)

    with torch.no_grad():
        t_out = tmodel(
            input_ids=torch.tensor(ids),
            attention_mask=torch.tensor(full_mask),
            query_embeds=torch.tensor(q),
            return_dict=True,
        ).last_hidden_state.numpy()

    fcfg = QFormerConfig(
        hidden_size=HIDDEN,
        num_hidden_layers=LAYERS,
        num_attention_heads=HEADS,
        intermediate_size=FFN,
        hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0,
        add_cross_attention=False,
        encoder_width=WIDTH,
        query_length=K,
        vocab_size=100,
        max_position_embeddings=32,
        position_embedding_type=variant,
    )
    fmodel = QFormerModel(fcfg)
    params = {"params": convert_qformer_model(tmodel.state_dict(), fcfg)}
    f_out = np.asarray(
        fmodel.apply(
            params,
            input_ids=jnp.asarray(ids),
            attention_mask=jnp.asarray(full_mask),
            query_embeds=jnp.asarray(q),
        )
    )
    np.testing.assert_allclose(f_out, t_out, atol=3e-5, rtol=1e-4)


def test_pooler_parity():
    """BertPooler (dense+tanh over the first token,
    reference: models/qformer.py:592-604)."""
    cfg, tmodel = make_torch_bert()
    torch.manual_seed(8)
    tmodel = BertModel(cfg, add_pooling_layer=True)
    tmodel.eval()

    rng = np.random.RandomState(8)
    q = rng.randn(3, K, HIDDEN).astype(np.float32)
    mem = rng.randn(3, 6, WIDTH).astype(np.float32)

    with torch.no_grad():
        t_out = tmodel(
            query_embeds=torch.tensor(q),
            encoder_hidden_states=torch.tensor(mem),
            attention_mask=torch.ones(3, K),
            return_dict=True,
        )
    t_seq = t_out.last_hidden_state.numpy()
    t_pooled = t_out.pooler_output.numpy()

    fmodel = QFormerModel(flax_cfg(), add_pooling_layer=True)
    params = {"params": convert_qformer_model(tmodel.state_dict(), flax_cfg())}
    f_seq, f_pooled = fmodel.apply(
        params,
        query_embeds=jnp.asarray(q),
        attention_mask=jnp.ones((3, K)),
        encoder_hidden_states=jnp.asarray(mem),
    )
    np.testing.assert_allclose(np.asarray(f_seq), t_seq, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(f_pooled), t_pooled, atol=2e-5, rtol=1e-4
    )


def test_generate_parity_vs_hf():
    """Generation parity: the KV-cached greedy/beam decoders vs the reference
    riding HF ``generate`` (reference models/qformer.py:1104-1135,
    ``prepare_inputs_for_generation``/``_reorder_cache``).

    transformers >= 4.50 dropped ``GenerationMixin`` from PreTrainedModel, so
    the oracle grafts it back onto the reference class; identical converted
    weights must then produce identical token sequences for greedy decoding,
    greedy with an EOS early stop, and a 3-wide no-EOS beam (equal-length
    hypotheses, so HF's length penalty cancels and sequence order is exact).
    Beam-with-EOS is out of scope by design: HF retires finished hypotheses
    out of the beam while this implementation freezes them in place, which
    legitimately explores different continuations.
    """
    from transformers.generation import GenerationMixin

    from models.qformer import BertLMHeadModel

    from unirec.models.qformer_decode import (
        kv_cached_beam_generate,
        kv_cached_greedy_generate,
    )
    from unirec.utils.torch_convert import convert_qformer_lm_model

    class GenBert(BertLMHeadModel, GenerationMixin):
        pass

    cfg, _ = make_torch_bert()
    torch.manual_seed(11)
    tmodel = GenBert(cfg)
    tmodel.eval()

    rng = np.random.RandomState(11)
    B, M_MEM, T_NEW = 2, 5, 7
    q = rng.randn(B, K, HIDDEN).astype(np.float32)
    mem = rng.randn(B, M_MEM, WIDTH).astype(np.float32)
    bos, pad = 5, 0
    t_ids = torch.full((B, 1), bos, dtype=torch.long)

    def hf_generate(num_beams, eos):
        with torch.no_grad():
            out = tmodel.generate(
                input_ids=t_ids,
                query_embeds=torch.tensor(q),
                encoder_hidden_states=torch.tensor(mem),
                encoder_attention_mask=torch.ones(B, M_MEM),
                num_beams=num_beams,
                max_new_tokens=T_NEW,
                do_sample=False,
                bos_token_id=bos,
                eos_token_id=eos,
                pad_token_id=pad,
            ).numpy()
        # all rows finishing early shortens the output: re-pad to fixed shape
        full = np.full((B, 1 + T_NEW), pad, np.int64)
        full[:, : out.shape[1]] = out
        return full

    fcfg = flax_cfg()
    fparams = {
        "params": convert_qformer_lm_model(tmodel.state_dict(), fcfg)
    }
    fq, fmem = jnp.asarray(q), jnp.asarray(mem)
    fem = jnp.ones((B, M_MEM))
    no_eos = 10**6  # outside the vocab: never emitted, never matched

    def f_greedy(eos):
        return np.asarray(
            jax.jit(
                lambda p: kv_cached_greedy_generate(
                    p, fcfg, fq, fmem, fem, bos_token_id=bos,
                    eos_token_id=eos, pad_token_id=pad,
                    max_new_tokens=1 + T_NEW,  # counts BOS; HF counts new only
                )
            )(fparams)
        )

    t_greedy = hf_generate(1, None)
    np.testing.assert_array_equal(f_greedy(no_eos), t_greedy)

    # EOS early stop: reuse a token greedy actually emits mid-sequence
    eos = int(next(x for x in t_greedy[0, 1:] if x != pad))
    np.testing.assert_array_equal(f_greedy(eos), hf_generate(1, eos))

    t_beam = hf_generate(3, None)
    f_beam, _ = jax.jit(
        lambda p: kv_cached_beam_generate(
            p, fcfg, fq, fmem, fem, bos_token_id=bos, eos_token_id=no_eos,
            pad_token_id=pad, max_new_tokens=1 + T_NEW, num_beams=3,
        )
    )(fparams)
    np.testing.assert_array_equal(np.asarray(f_beam), t_beam)
