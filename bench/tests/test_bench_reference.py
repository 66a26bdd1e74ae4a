"""The benchmark's frozen reference against the port's plain path at the
smoke size, in float32 on the CPU: a prefill's last logits, then decode
steps through a cache padded as the server pads it, match the reference's
logits at the same positions; the weights' layout is the port's parameter
tree; the float8 control departs from both."""
from __future__ import annotations

import pytest
import torch

import bench_smoke
from bench.harness import program
from bench.harness import weights as wts
from bench.reference import dense
from bench.run import _same_shapes


@pytest.fixture(scope="module")
def smoke():
    conf = bench_smoke.config()
    cfg = program.model_config(conf)
    w = wts.draw(dense.layout(conf), 2 ** 31 + 5, torch.float32, "cpu")
    return conf, cfg, w


def test_layout_is_the_ports_parameter_tree(smoke):
    conf, cfg, _ = smoke
    _same_shapes(dense.layout(conf), program.schema_shapes(cfg))
    full = program.model_config(
        __import__("json").loads((bench_smoke.ROOT / "bench/configs/yi-9b.json")
                                 .read_text()))
    assert (full.n_layers, full.d_model, full.n_kv_heads, full.d_ff,
            full.vocab_size) == (48, 4096, 4, 11008, 64000)


@pytest.mark.parametrize("prompt_len", [5, 17])
def test_prefill_and_decode_match_the_reference(smoke, prompt_len):
    from repro_torch.core.types import SMOKE_MESH, ParallelismConfig
    from repro_torch.model.lm import make_decode_step, make_prefill_step
    from repro_torch.model.transformer import pad_cache

    conf, cfg, w = smoke
    par = ParallelismConfig(compute_dtype="float32", attn_impl="ref")
    gen = torch.Generator().manual_seed(prompt_len)
    seq = torch.randint(2, conf["vocab_size"], (prompt_len + 4,),
                        generator=gen)
    prefill = make_prefill_step(cfg, SMOKE_MESH, par)
    decode = make_decode_step(cfg, SMOKE_MESH, par)
    with torch.no_grad():
        logits, cache = prefill(w, {"tokens": seq[None, :prompt_len]})
        got = [logits[0]]
        cache = pad_cache(cache, 32)
        for i in range(prompt_len, prompt_len + 4):
            logits, cache = decode(w, seq[None, i:i + 1], cache)
            got.append(logits[0])
        want = dense.logits(w, conf, seq, prompt_len - 1)
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)


def test_the_float8_control_departs_from_the_reference(smoke):
    conf, _, w = smoke
    seq = torch.arange(2, 40)
    with torch.no_grad():
        ref = dense.logits(w, conf, seq, 0)
        low = dense.logits(w, conf, seq, 0, mm=dense.mm_fp8)
    rel = ((low - ref).norm() / ref.norm()).item()
    assert 1e-3 < rel < 0.5
