from repro_torch.quant.fixedpoint import (FxpFormat,  # noqa: F401
                                          fxp_quantize, fxp_requant_int,
                                          fxp_to_int)
