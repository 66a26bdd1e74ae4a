"""RTL backend of the port: the fixed-point dataflow IR (``ir``), the
hardware-template library (``oplib``) and the bit-exact integer emulator
(``emulator``). Emission, cost and static analysis come with the toolchain
slice.
"""
from repro_torch.rtl.emulator import (EmulationResult,  # noqa: F401
                                      RTLEmulator, assert_bit_exact,
                                      outputs_by_mode, reference_apply)
from repro_torch.rtl.ir import (ActApplyNode, ActLUTNode,  # noqa: F401
                                Conv1dNode, Edge, ElementwiseNode, Graph,
                                LinearNode, LSTMCellNode, iso_key,
                                lower_conv_model, lower_conv_stack,
                                lower_linear_stack, lower_lstm_model,
                                lower_model, validate_formats)
from repro_torch.rtl.oplib import (HWTemplate, get_template,  # noqa: F401
                                   list_templates, lowerable_families,
                                   register_template)
