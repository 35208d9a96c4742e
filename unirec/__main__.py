"""``python -m unirec <command>`` dispatcher.

Commands:
  data        data-pipeline builders (dicts, filtering, rec samples)
  train       training stages (precompute/mwne/item-qformer/user-qformer/joint)
              + evaluate
  tokens      batch item-query-token generation (flagship data tool)
  embed       candidate-pool item embeddings (clip / qwen3)
  review-embed  review + item concatenated embeddings
  users       offline bulk user-embedding sweep (joint-space vectors)
  serve       HTTP recommendation server (full-catalog retrieval)
"""

import sys


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        return 0
    from unirec.runtime import setup_runtime

    setup_runtime()
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd == "data":
        from unirec.cli.data_pipeline import main as m
    elif cmd == "train":
        from unirec.cli.train_cli import main as m
    elif cmd == "tokens":
        from unirec.cli.generate_all_item_embeddings import main as m
    elif cmd == "embed":
        from unirec.cli.candidate_embeddings import main as m
    elif cmd == "review-embed":
        from unirec.cli.review_embeddings import main as m
    elif cmd == "users":
        from unirec.cli.user_embeddings import main as m
    elif cmd == "serve":
        from unirec.cli.serve_cli import main as m
    else:
        print(f"unknown command {cmd!r}\n{__doc__}", file=sys.stderr)
        return 2
    return m(argv)


if __name__ == "__main__":
    raise SystemExit(main())
