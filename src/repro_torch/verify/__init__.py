"""Elastic Node verification half of the port: golden vector sets
(``vectors``). Conformance reports and the measurement protocol come with
the verification slice.
"""
from repro_torch.verify.vectors import (GOLDEN_SEED, VectorSet,  # noqa: F401
                                        canonical_graph, canonical_params,
                                        generate_vectors, golden_dir,
                                        load_vectors)
