"""Hardware specs (``hw``: the paper's XC7S15 and, in place of the
reference's TPU entry, the H100 the port runs on), the three-term roofline
(``roofline``), the 8-channel energy meter (``meter``) and the step counter
that feeds both from a torch program (``cost``).
"""
from repro_torch.energy.hw import H100_SXM, XC7S15, HWSpec  # noqa: F401
from repro_torch.energy.meter import (ChannelReport,  # noqa: F401
                                      channel_report, meter_channels)
from repro_torch.energy.roofline import (CollectiveStats,  # noqa: F401
                                         RooflineReport, parse_collectives,
                                         roofline)
