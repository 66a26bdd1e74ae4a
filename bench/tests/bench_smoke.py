"""The benchmark's cells at the port's smoke size, for the CPU tests: the
Yi-9B file with its sizes cut to the port's ``yi-9b`` smoke config, and
each mix cut to a few short requests on a few slots; and a virtual clock,
so that a test serves the same work however loaded the host is.
Importing it puts the repository and the port's ``src/`` on the path."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):            # the benchmark and the port
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

SMALL = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=128,
             vocab_size=512)
PORT_SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=512,
                  vocab_pad_multiple=16)
OVERLAY = {
    "long_prompt": {"prompt": {"dist": "lognormal", "median": 32,
                               "sigma": 0.5, "min": 8, "max": 60},
                    "max_len": 96, "slots": 4, "rate_per_s": 20,
                    "check_tokens": 40},
    "long_decode": {"prompt": {"dist": "uniform", "min": 8, "max": 24},
                    "output": {"dist": "uniform", "min": 20, "max": 40},
                    "max_len": 96, "slots": 4,
                    "clients": 4, "check_tokens": 40},
}


def config() -> dict:
    conf = json.loads((ROOT / "bench/configs/yi-9b.json").read_text())
    conf.update(SMALL)
    conf["port"]["fields"].update(PORT_SMALL)
    return conf


def setup(tmp: Path):
    """(root, bench) whose ``yi-9b`` is the smoke-size file."""
    (tmp / "c.json").write_text(json.dumps(config()))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        if c["name"] == "yi-9b":
            c["file"] = "c.json"
    return tmp, bench


def overlay(cell: str) -> dict:
    return dict(OVERLAY[cell.split(".", 1)[1]])


class VirtualClock:
    """Seconds that pass only when the harness sleeps or the server ticks
    (``tick`` seconds a tick)."""

    def __init__(self, tick: float):
        self.now, self.tick = 0.0, tick

    def __call__(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.now += max(0.0, seconds)


def virtual_time(monkeypatch, server_cls=None, tick: float = 0.1):
    """``server_cls`` (the port's ``Server`` by default) on a
    :class:`VirtualClock`, which the harness's window reads too."""
    from types import SimpleNamespace

    from bench.harness import serve
    from repro_torch.runtime.server import Server

    clock = VirtualClock(tick)
    monkeypatch.setattr(serve, "time", SimpleNamespace(
        perf_counter=clock, sleep=clock.sleep))

    class OnClock(server_cls or Server):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, clock=clock, **kwargs)

        def step(self):
            super().step()
            clock.now += clock.tick

    return OnClock
