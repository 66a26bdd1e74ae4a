"""Elastic Node verification half of the port (DESIGN.md §10):

* :mod:`repro_torch.verify.vectors`     — deterministic golden
  stimulus/response sets per design, written and read as portable
  ``.npz`` + JSON manifest, byte for byte the reference's;
* :mod:`repro_torch.verify.conformance` — differential execution (all
  emulator modes mutually bit-exact; int vs float oracle within the
  wordlength-derived error budget; golden replay) →
  :class:`ConformanceReport`, template fuzzing and the in-service
  :func:`canary_check`;
* :mod:`repro_torch.verify.protocol`    — the measurement procedure
  (warmup, ``n_runs``, latency/energy tolerance bands against the XC7S15
  model and the paper's Table I numbers).

:func:`verify_deployment` is the deployment-level entry that
``Deployment.verify`` calls; :func:`run_conformance_batch` is the batched
sweep over K isomorphic candidates (:mod:`repro_torch.rtl.multi`).
"""
from repro_torch.verify.conformance import (CanaryResult,  # noqa: F401
                                            ConformanceReport, canary_check,
                                            fuzz_template,
                                            graph_error_budget_lsb,
                                            run_conformance,
                                            run_conformance_batch,
                                            verify_deployment)
from repro_torch.verify.protocol import (TABLE1_GOP_PER_J,  # noqa: F401
                                         TABLE1_LATENCY_US, TABLE1_POWER_MW,
                                         MeasurementProtocol, ProtocolCheck,
                                         ProtocolReport, run_protocol)
from repro_torch.verify.vectors import (GOLDEN_SEED, VectorSet,  # noqa: F401
                                        canonical_graph, canonical_params,
                                        emit_golden, generate_vectors,
                                        golden_dir, load_vectors,
                                        save_vectors)
