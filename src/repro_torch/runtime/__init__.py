"""Runtimes of the port: the batched LM server (``server.py``), the
fault-tolerant trainer (``trainer.py``) and the failure injector that tests
fault tolerance without a cluster (``failures.py``)."""
from repro_torch.runtime.failures import (  # noqa: F401
    FailureInjector, PreemptionError, StragglerWarning)
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401
