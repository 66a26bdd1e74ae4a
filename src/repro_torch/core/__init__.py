"""Configuration types (``types``), the stage reports the workflow's
feedback loop reads (``report``), the component registry (``registry``),
the loop itself (``creator.Creator``, ``workflow.Workflow``) and the
deployment-target API (DESIGN.md §8), re-exported here as the public
surface: register a Target, translate through the registry, get back the
uniform Deployment artifact.
"""
from repro_torch.core.target import (DEFAULT_N_RUNS,  # noqa: F401
                                     Deployment, Target, TargetOptions,
                                     TorchDeployment, TorchOptions,
                                     get_target, list_targets,
                                     register_lazy_target, register_target)
