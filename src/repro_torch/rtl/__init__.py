"""RTL backend of the port (DESIGN.md §3, §9).

Pipeline:  quantized model ──lower──▶ fixed-point dataflow IR (``ir``)
           ──analyze──▶ static interval/format/resource checks
           (``analyze``, ``diagnostics``; CLI ``python -m
           repro_torch.rtl.lint``) ──instantiate──▶ VHDL-like template
           artifacts (``templates``, ``emit``) ──verify──▶ bit-exact int32
           emulator (``emulator``; its programs, CUDA Graphs on the card,
           in ``program_cache``/``cuda_graph``; K isomorphic designs at
           once in ``multi``) ──cost──▶ XC7S15 resource/cycle model
           (``resources``).

Every stage is a registry-dispatched walk over the hardware-template (op)
library (``oplib``): one :class:`~repro_torch.rtl.oplib.HWTemplate` per
layer kind owns lowering, analysis, emission, emulation and cost.

Entry point for users: ``Creator.translate(st, target="rtl",
options=RTLOptions(...))`` — "rtl" resolves to :data:`RTL_TARGET` through
the deployment-target registry (``repro_torch.core.target``); the pieces
are importable here for direct use and tests.
"""
from repro_torch.rtl.analyze import (AnalysisContext,  # noqa: F401
                                     AnalysisError, Interval, analyze_graph)
from repro_torch.rtl.backend import (RTL_TARGET,  # noqa: F401
                                     RTLExecutable, RTLOptions, RTLTarget,
                                     measure_rtl, translate_rtl)
from repro_torch.rtl.diagnostics import (RULES, AnalysisReport,  # noqa: F401
                                         Diagnostic, make_diagnostic)
from repro_torch.rtl.emit import emit_graph, write_artifacts  # noqa: F401
from repro_torch.rtl.emulator import (EmulationResult,  # noqa: F401
                                      RTLEmulator, assert_bit_exact,
                                      outputs_by_mode, reference_apply)
from repro_torch.rtl.ir import (ActApplyNode, ActLUTNode,  # noqa: F401
                                Conv1dNode, Edge, ElementwiseNode, Graph,
                                LinearNode, LSTMCellNode, iso_key,
                                lower_conv_model, lower_conv_stack,
                                lower_linear_stack, lower_lstm_model,
                                lower_model, validate_formats)
from repro_torch.rtl.multi import (MultiDesignEmulator,  # noqa: F401
                                   assert_isomorphic, stack_params)
from repro_torch.rtl.program_cache import ProgramLRU  # noqa: F401
from repro_torch.rtl.oplib import (HWTemplate, get_template,  # noqa: F401
                                   list_templates, lowerable_families,
                                   register_template, unregister_template)
from repro_torch.rtl.resources import (NodeCost,  # noqa: F401
                                       ResourceReport, estimate, node_cost,
                                       synthesize)
