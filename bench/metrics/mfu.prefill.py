"""The window's prefills' share of the bf16 peak: the model's work of
each prefill (``prefill_flops`` of its prompt) over the seconds from its
``server.prefill`` span's start to its first token on the host (the span
ends before the device does), summed."""
from bench.harness.counts import BF16_FLOP_PER_S


def read(r):
    first = {s.rid: s.stamps[0] for s in r.run.served if s.stamps}
    flops = secs = 0.0
    for sp in r.spans("server.prefill"):
        rid = sp.attrs["rid"]
        if rid not in first:
            continue
        flops += r.model.prefill_flops(r.config, sp.attrs["prompt_len"])
        secs += first[rid] - sp.start
    return 100.0 * flops / (secs * BF16_FLOP_PER_S) if secs > 0 else None
