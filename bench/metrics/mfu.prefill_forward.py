"""The window's prefill forwards' share of the bf16 peak: the model's work
of each (``prefill_flops`` of each row's tokens) over the device time of
its ``model.forward`` span (``mode`` "prefill", ``runtime/server.py``),
summed: the model step alone, without the cache's pad and install, the
logits' copy to the host, sampling or launch lag (``mfu.prefill``'s
interval holds them all)."""
from bench.harness.counts import BF16_FLOP_PER_S


def read(r):
    flops = secs = 0.0
    for sp in r.spans("model.forward"):
        if sp.attrs["mode"] != "prefill":
            continue
        rows = sp.attrs["rows"]
        flops += rows * r.model.prefill_flops(r.config,
                                              sp.attrs["tokens"] // rows)
        secs += sp.dev_end - sp.dev_start
    return 100.0 * flops / (secs * BF16_FLOP_PER_S) if secs > 0 else None
