"""The port's static analysis: the JAX package's ``repro.analysis`` over
``src/repro_torch``.

An AST-based, dependency-free invariant checker: ``python -m
repro_torch.analysis --gate`` walks ``src/repro_torch`` and enforces the
invariants the port's accuracy claims (and the transport tier's safety)
rest on:

  trace-purity         functions torch runs again or later (bodies passed
                       to ``torch.utils.checkpoint.checkpoint``, the
                       ``forward``/``backward`` of ``torch.autograd.Function``
                       subclasses) stay side-effect free (no clocks, RNG,
                       locks, global mutation, or MetricsHub instruments)
  wire-schema          the frame registry in net/wire.py is unique, every
                       registered kind is dispatched exactly once per
                       dispatcher, and the committed
                       ``net/wire_schema.lock`` fingerprint matches
  unpickler-allowlist  the restricted unpickler's allowlist, its map to
                       the port's modules and the ``# wire-type`` marked
                       classes agree, and every entry is live
  no-pickle-hot-path   modules on the ingest hot path never touch pickle
  lock-discipline      ``# guarded-by:`` field annotations hold statically
                       and the nested-``with`` lock-order graph is acyclic
  write-after-publish  no in-place write targets a published front (the
                       port's isolation rule, in place of the JAX
                       package's use-after-donate)

The dynamic half lives in :mod:`repro_torch.analysis.witness`: ``python
-m repro_torch.analysis.witness <module> [args...]`` runs a module under
a lock-order witness that also guards every publish and compares the
bytes of every live published front with a copy taken at its publish.
"""
from repro_torch.analysis.engine import (  # noqa: F401
    Finding,
    Project,
    SourceFile,
    all_rules,
    load_baseline,
    run_rules,
)
