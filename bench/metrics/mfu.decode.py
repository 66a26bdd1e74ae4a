"""The decode ticks' share of the bf16 peak: the model's work of the busy
rows (``decode_flops`` at each token's context) over the ``server.decode``
spans' seconds (the span ends after the logits' copy to the host)."""
from bench.harness.counts import BF16_FLOP_PER_S


def read(r):
    run = r.run
    flops = 0
    for s in run.served:
        n = len(s.req.prompt)
        # token k > 0 came from a tick that read n + k positions
        flops += sum(r.model.decode_flops(r.config, n + k)
                     for k, t in enumerate(s.stamps)
                     if k > 0 and run.t0 <= t <= run.t1)
    secs = sum(sp.end - sp.start for sp in r.spans("server.decode"))
    return 100.0 * flops / (secs * BF16_FLOP_PER_S) if secs > 0 else None
