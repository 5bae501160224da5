"""Guided examples of the port, one per JAX package example.

Each runs as ``python -m repro_torch.examples.<name>`` on the card (the
default) or with ``--device cpu``, builds what the JAX package's
``examples/<name>.py`` builds, and prints the same lines (rates aside), so
the two can be compared line for line:

  quickstart         the paper pipeline, kMatrix against TCM/gMatrix
  sketch_queries     the Type II query surface on kMatrix
  query_serving      snapshot-isolated queries over live ingest
  background_ingest  the runtime: workers, metrics, crash and resume
  train_lm           a gemma-2-style LM trained a few hundred steps

(``examples/distributed_sketch.py`` has ``repro_torch.distributed.demo``.)
"""
