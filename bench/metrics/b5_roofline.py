"""B5's share of its roofline in the profiled slice: the least time its
calls need (per call the larger of FLOPs at the bf16 peak and bytes at
HBM's, causal pairs, q/k/v read once, o written once) over its kernels'
device time (``flash_fwd*`` in the trace). The calls are the prefills
whose ``server.prefill`` spans began in the slice, one a layer; their
count is held against the kernel's launch counter and the trace."""
from bench.harness import counts


def read(r):
    run = r.run
    if run.trace is None:
        return None
    lo, hi = run.profiled
    lens = [sp.attrs["prompt_len"] for sp in r.run.spans
            if sp.name == "server.prefill" and lo <= sp.start <= hi]
    secs, kernels = run.trace.seconds_of("flash_fwd")
    if not lens:
        return None
    s = r.model.sizes(r.config)
    calls = s["L"] * len(lens)
    if not calls == kernels == run.b5_launches_profiled:
        raise ValueError(f"B5: {calls} calls for {len(lens)} prefills, "
                         f"{kernels} kernels in the trace, "
                         f"{run.b5_launches_profiled} launches counted")
    bound = s["L"] * sum(counts.bound_s(
        counts.b5_flops(n, s["H"], s["hd"]),
        counts.b5_bytes(n, s["H"], s["KV"], s["hd"])) for n in lens)
    return 100.0 * bound / secs
