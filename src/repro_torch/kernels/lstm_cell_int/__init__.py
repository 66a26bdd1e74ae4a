"""Fused integer LSTM-window template (the RTL emulator's hot path)."""
from repro_torch.kernels.lstm_cell_int.kernel import (  # noqa: F401
    CellSpec, lstm_window_int_cuda, mma_takes)
from repro_torch.kernels.lstm_cell_int.ops import (  # noqa: F401
    lstm_window_int, variant)
from repro_torch.kernels.lstm_cell_int.ref import (  # noqa: F401
    lstm_window_int_ref, lstm_window_steps)
