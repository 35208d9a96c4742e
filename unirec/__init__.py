"""UniRec in JAX: a framework for LLM-based multimodal sequential
recommendation, rebuilt from scratch with the capabilities of
ulab-uiuc/UniRec.

Pipeline stages (SURVEY.md §1):
  1. Item encoding   — multimodal field encoders + Item Q-Former compression
  2. User encoding   — user-history sequence modeling with a User Q-Former
  3. Joint ranking   — Qwen3-0.6B + LoRA with injected item query tokens,
                       InfoNCE training and candidate-pool ranking eval
"""

__version__ = "0.1.0"

from unirec import configs  # noqa: F401
