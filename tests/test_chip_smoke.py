"""chip_smoke.py's phases at tiny widths on the CPU (the script itself
refuses to run without a GPU), the runtime helper, and the phases at full
width where a GPU is present."""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
from unirec.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    tiny_qwen3_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN = tiny_qwen3_config(max_position_embeddings=64)
QF = ItemQFormerConfig(
    hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=128, num_query_tokens=2, field_embedding_dim=16,
    num_fields=3,
)
JC = JointModelConfig(num_history_items=3, num_query_tokens_per_item=2,
                      max_length=32)


def test_tokens_phase_tiny():
    cfg = ItemQFormerConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, num_query_tokens=4, field_embedding_dim=16,
        num_fields=3)
    out = cs.phase_tokens(cfg, batch=8, n_batches=2, n_ref=8)
    assert out["items"] == 16 and out["cos_min"] >= cs.TOKEN_COS_MIN
    assert out["masked_field_excess"] <= 0.0


def test_joint_phase_tiny():
    out = cs.phase_joint(QWEN, QF, JC, batch=4, steps=3)
    assert len(out["losses"]) == 3 and out["frozen_leaves_moved"] == 0
    assert out["trainable_leaves_moved"] > 0 and out["remat"]
    assert out["loss_rel_err"] <= cs.JOINT_LOSS_RTOL


def test_serve_phase_tiny():
    out = cs.phase_serve(QWEN, QF, JC, n_items=40, n_requests=8,
                         batch_size=4)
    assert out["requests"] == 8
    assert out["max_kth_shortfall"] <= cs.SERVE_SCORE_TOL
    assert out["int8_user_cos_min"] > cs.INT8_USER_COS_MIN


def test_four_phase_on_virtual_devices(eight_devices):
    out = cs.phase_four(QWEN, QF, JC, batch=8)
    assert set(out) == {"1x1", "dp4xtp1", "dp2xtp2"}
    assert out["dp2xtp2"]["loss_rel_err"] <= cs.FOUR_RTOL


def test_script_refuses_to_run_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py", "--phase", "tokens"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "platform 'cpu'" in p.stderr


def test_runtime_compile_cache_dir(monkeypatch):
    from unirec import runtime

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert runtime.setup_runtime() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    try:
        assert runtime.setup_runtime() == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.gpu
def test_tokens_phase_full_width_on_gpu(gpu):
    out = cs.phase_tokens(n_batches=1)
    assert out["cos_min"] >= cs.TOKEN_COS_MIN
