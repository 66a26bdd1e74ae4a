"""Float LSTM-window template (B3): a gate-fused f32 LSTM cell over S steps."""
from repro_torch.kernels.lstm_cell.kernel import lstm_window_cuda  # noqa: F401
from repro_torch.kernels.lstm_cell.ops import lstm_window  # noqa: F401
from repro_torch.kernels.lstm_cell.ref import lstm_window_ref  # noqa: F401
