"""Mean, over the window's decode forwards (``model.forward`` spans with
``mode`` "decode", ``runtime/server.py``), of the device time of their
attention halves (the ``model.attn`` spans under each, one a layer:
norm, attention, residual; ``model/transformer.py``), milliseconds."""


def read(r):
    ticks = {sp.span_id: 0.0 for sp in r.spans("model.forward")
             if sp.attrs["mode"] == "decode"}
    for sp in r.run.spans:
        if sp.name == "model.attn" and sp.parent_id in ticks:
            ticks[sp.parent_id] += sp.dev_end - sp.dev_start
    return 1e3 * sum(ticks.values()) / len(ticks) if ticks else None
