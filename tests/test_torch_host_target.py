"""PyTorch port, the host target against the JAX package on the CPU: the
roofline and the 8-channel meter (equal to the reference on the same HLO
text), the step counter that feeds them from a torch program (exact matmul
FLOPs, the reference meter's dot FLOPs on ``elastic-lstm``, equal counts on
the CPU and on ``meta``, each kernel wrapper counted once with its
formula), ``TorchOptions``/``TorchDeployment``/``TorchTarget`` (the
reference's ``"xla"`` contract), ``Workflow`` over both targets,
``Deployment.verify`` of a host deployment and the launcher's default run.

The reference's XLA target and meter run here imported with the
deprecation warning silenced, as the other port tests import the JAX
package.
"""
import contextlib
import dataclasses
import importlib
import io
import json
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                       # image lacks hypothesis: use shim
    from _hypothesis_compat import given, settings, st

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.configs import get_config as j_get_config
    from repro.core import creator as jcreator
    from repro.core import target as jtarget
    from repro.core import types as jtypes
    from repro.energy import hw as jhw
    from repro.energy import meter as jmeter
    from repro.model import layers as jlayers
    from repro.model import lm as jlm
    from repro.model import lstm as jlstm

from repro_torch import kernels as tkernels
from repro_torch import obs as tobs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import creator as tcreator
from repro_torch.core import report as treport
from repro_torch.core import target as ttarget
from repro_torch.core import types as ttypes
from repro_torch.core import workflow as tworkflow
from repro_torch.energy import cost as tcost
from repro_torch.energy import hw as thw
from repro_torch.energy import meter as tmeter
from repro_torch.launch import elastic_workflow as tew
from repro_torch.model.layers import param_count, tree_map
from repro_torch.model.lm import Stepper
from repro_torch.model.lstm import lstm_apply, lstm_flops

# the packages export ``roofline`` the function under the module's name
jroof = importlib.import_module("repro.energy.roofline")
troof = importlib.import_module("repro_torch.energy.roofline")

ARCHS = ("elastic-lstm", "elastic-conv1d")
#: the port's H100 spec in the reference's HWSpec type, for equal inputs
J_H100 = jhw.HWSpec(**dataclasses.asdict(thw.H100_SXM))
HW_CHANNELS = ("mxu", "hbm", "ici", "gather", "layout", "other")

HLO = """
HloModule test
ENTRY main {
  %p = bf16[256,1024]{1,0} parameter(0)
  %ar = bf16[256,1024]{1,0} all-reduce(%p), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[64,512]{1,0} all-gather(%x), replica_groups=[16,8]<=[128], dimensions={0}
  %rs = f32[8,128]{1,0} reduce-scatter(%y), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add
  %cp = bf16[32,32]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  %a2a = f32[16,64]{1,0} all-to-all(%w), replica_groups={{0,1}}
  %d = f32[256,64]{1,0} dot(%a, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %e = f32[256,64]{1,0} exponential(%d)
  %r = f32[256]{0} reduce(%e, %c), dimensions={1}, to_apply=%add
  %g = f32[16,64]{1,0} gather(%e, %i), offset_dims={1}
  %t = f32[64,256]{0,1} transpose(%e), dimensions={1,0}
  %o = f32[4]{0} custom-call(%r), custom_call_target="x"
}
"""
ASYNC = """
  %ars = (bf16[128,8]{1,0}, bf16[128,8]{1,0}) all-reduce-start(%p), replica_groups={{0,1}}
  %ard = bf16[128,8]{1,0} all-reduce-done(%ars)
"""


@pytest.fixture(scope="module")
def lstm_hlo():
    """The reference's compiled ``lstm_apply`` at ``infer_1``: its host
    target's deployment text."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cr = jcreator.Creator()
        jst = cr.build(j_get_config("elastic-lstm"),
                       jtypes.SHAPES_LSTM["infer_1"])
        _, dep = cr.translate(jst, target="xla")
    return dep.hlo_text


# --------------------------------------------------------------------------- #
# Roofline and meter: equal to the reference on the same text
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("text", ["bf16[256,1024]", "f32[8]",
                                  "(f32[4], bf16[2,2])", "s8[3,0,2]",
                                  "pred[7]", "token[]", "f8e4m3fn[16]",
                                  "(s32[], u64[2,3])"])
def test_shape_bytes_equals_reference(text):
    assert troof._shape_bytes(text) == jroof._shape_bytes(text)


@pytest.mark.parametrize("text", [HLO, ASYNC, HLO + ASYNC, ""])
@pytest.mark.parametrize("n_devices", [1, 2, 128])
def test_parse_collectives_equals_reference(text, n_devices):
    got = troof.parse_collectives(text, n_devices)
    want = jroof.parse_collectives(text, n_devices)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_wire_bytes == want.total_wire_bytes
    assert got.total_local_bytes == want.total_local_bytes


_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")
_DTYPES = ("bf16", "f32", "s8", "f64", "pred")


@settings(max_examples=60, deadline=None)
@given(kind=st.integers(0, 4), dtype=st.integers(0, 4),
       rows=st.integers(1, 512), cols=st.integers(0, 64),
       group=st.integers(1, 16), fmt=st.integers(0, 2),
       phase=st.integers(0, 2), in_while=st.integers(0, 1))
def test_parse_collectives_on_drawn_lines(kind, dtype, rows, cols, group,
                                          fmt, phase, in_while):
    shape = f"{_DTYPES[dtype]}[{rows},{cols}]{{1,0}}"
    groups = ("replica_groups={{" + ",".join(map(str, range(group))) + "}}",
              f"replica_groups=[{128 // group},{group}]<=[128]",
              "channel_id=1")[fmt]
    op = _KINDS[kind] + ("", "-start", "-done")[phase]
    out = f"({shape}, {shape})" if phase == 1 else shape
    line = f"  %c = {out} {op}(%p), {groups}, to_apply=%add"
    text = (f"%while_body.1 (p: f32[]) -> f32[] {{\n{line}\n}}\n"
            if in_while else line + "\n")
    got = troof.parse_collectives(text, 8)
    want = jroof.parse_collectives(text, 8)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.in_while == (in_while if phase != 2 else 0)


@pytest.mark.parametrize("cost", [{"flops": 3.0}, [{"flops": 3.0}],
                                  ({"bytes accessed": 1.0},), [], None, {}])
def test_normalize_cost_equals_reference(cost):
    assert troof.normalize_cost(cost) == jroof.normalize_cost(cost)


@pytest.mark.parametrize("cost,n_devices,model_flops", [
    ({"flops": 197e12, "bytes accessed": 1e9}, 4, 4 * 197e12),
    ({"flops": 1e9, "bytes accessed": 5e12}, 1, 2e9),
    ([{"flops": 0.0, "bytes accessed": 0.0}], 1, 1.0),
    ({"flops": 2e12, "bytes accessed": 1e8}, 128, 1e14)])
def test_roofline_equals_reference(cost, n_devices, model_flops):
    kw = dict(arch="a", shape="s", mesh="m", n_devices=n_devices, cost=cost,
              hlo_text=HLO, model_flops=model_flops, memory_analysis="x")
    got = troof.roofline(**kw, hw=thw.H100_SXM)
    want = jroof.roofline(**kw, hw=J_H100)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()
    assert troof.HEADER == jroof.HEADER
    # the port's default spec is the card it runs on
    assert dataclasses.asdict(troof.roofline(**kw)) == \
        dataclasses.asdict(got)


def _hlo_texts(lstm_hlo):
    return {"handcrafted": HLO + ASYNC, "lstm_infer_1": lstm_hlo}


@pytest.mark.parametrize("which", ["handcrafted", "lstm_infer_1"])
@pytest.mark.parametrize("n_devices", [1, 4])
def test_meter_channels_equals_reference(lstm_hlo, which, n_devices):
    text = _hlo_texts(lstm_hlo)[which]
    got = tmeter.meter_channels(text, n_devices, thw.H100_SXM)
    want = jmeter.meter_channels(text, n_devices, J_H100)
    assert got.work == want.work and got.op_counts == want.op_counts
    for ch in HW_CHANNELS:                   # these read only the HWSpec
        assert got.seconds[ch] == want.seconds[ch], ch
    for ch in ("vpu", "reduce"):             # the stated VPU_FLOPS change
        assert got.seconds[ch] * tmeter.VPU_FLOPS == pytest.approx(
            want.seconds[ch] * jmeter.VPU_FLOPS, rel=1e-12, abs=0)
    for ch, watts in tmeter.CHANNEL_WATTS.items():
        assert got.joules[ch] == watts * got.seconds[ch]
    if which == "lstm_infer_1":
        assert got.work["mxu"] == 20200.0 and got.op_counts["mxu"] == 7


def test_meter_constants_are_the_cards():
    assert tmeter.VPU_FLOPS == 67e12
    assert sum(tmeter.CHANNEL_WATTS.values()) == thw.H100_SXM.active_w
    assert list(tmeter.CHANNEL_WATTS) == list(jmeter.CHANNEL_WATTS)
    assert tmeter.GATHER_BW_FRACTION == jmeter.GATHER_BW_FRACTION


# --------------------------------------------------------------------------- #
# The step counter
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dims", [(8, 16, 4, 32), (1, 7, 3, 5),
                                  (128, 64, 256, 2)])
def test_matmul_chain_counts_two_mnk_a_product(dims):
    m, k, n, p = dims
    gen = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(s, generator=gen) for s in
               ((m, k), (k, n), (n, p)))
    cost = tcost.count_step(lambda a, b, c: (a @ b) @ c, (a, b, c))
    assert cost.flops == 2 * m * k * n + 2 * m * n * p
    assert cost.work["mxu"] == cost.flops and cost.op_counts["mxu"] == 2
    assert cost.bytes_accessed == 4 * (m * k + k * n + m * n
                                       + m * n + n * p + m * p)
    assert cost.work["hbm"] == cost.bytes_accessed
    assert (cost.argument_bytes, cost.output_bytes, cost.temp_bytes) == \
        (4 * (m * k + k * n + n * p), 4 * m * p, 4 * m * n)
    assert len(cost.as_text().splitlines()) == 2
    assert cost.cost_analysis() == {"flops": cost.flops,
                                    "bytes accessed": cost.bytes_accessed}


def test_counter_rules_for_views_reductions_and_live_bytes():
    x = torch.ones(64, 32)

    def step(x):
        a = x * 2.0                      # 2048 flops, vpu
        b = a.t()                        # a view: nothing counted
        s = b.sum(0)                     # reads 2048 elements
        c = b.contiguous()               # a copy (layout), no flops
        del a, b                         # a's storage is freed here
        return c + s[None, :]

    cost = tcost.count_step(step, (x,))
    names = [op.name for op in cost.ops]
    assert names == ["aten.mul.Tensor", "aten.sum.dim_IntList",
                     "aten.clone.default", "aten.add.Tensor"]
    flops = [op.flops for op in cost.ops]
    assert flops == [2048, 2048, 0, 2048]
    assert [op.channel for op in cost.ops] == ["vpu", "reduce", "layout",
                                               "vpu"]
    # a (held by its view b), s and c live together once c is made; the
    # result is the step's output, not an intermediate
    assert cost.temp_bytes == 4 * (2048 + 64 + 2048)
    assert cost.output_bytes == 4 * 2048 and cost.alias_bytes == 0


def test_counter_in_place_writes_and_gathers():
    table = torch.zeros(100, 8)
    idx = torch.tensor([3, 5, 7])
    cache = torch.zeros(4, 16, 8)
    rows = torch.arange(4)
    at = torch.tensor([1, 2, 3, 4])
    vals = torch.ones(4, 8)

    def step(table, idx, cache, vals):
        g = table[idx]                                  # gathers 3 rows
        cache.index_put_((rows, at), vals)              # writes 4 rows
        return g, cache

    cost = tcost.count_step(step, (table, idx, cache, vals))
    gather, put = cost.ops
    assert gather.bytes == idx.numel() * 8 + 2 * 3 * 8 * 4
    assert put.bytes == 8 * (4 + 4) + 2 * 4 * 8 * 4  # indices, values in/out
    assert (gather.channel, put.channel) == ("gather", "gather")
    assert cost.alias_bytes == cache.numel() * 4


def test_elastic_lstm_mxu_work_equals_the_reference_dot_flops():
    """The port's counted products of the 6-step window equal the
    reference meter's exact dot FLOPs on its compiled HLO at batch 256,
    where the compiled module keeps its seven dots (six steps, the
    head)."""
    B = 256
    jcfg, cfg = j_get_config("elastic-lstm"), get_config("elastic-lstm")
    jp = jlayers.init_params(jlm.param_schema(jcfg), jax.random.PRNGKey(0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        hlo = jax.jit(lambda p, x: jlstm.lstm_apply(p, x, jcfg)[0]).lower(
            jp, jnp.zeros((B, 6, 1))).compile().as_text()
    assert hlo.count(" dot(") == 7
    want = jmeter.meter_channels(hlo, 1).work["mxu"]
    tp = to_torch(params_from_jax(jp, cfg), "cpu")
    x = torch.zeros(B, 6, 1)
    with torch.inference_mode():
        cost = tcost.count_step(lambda p, x: lstm_apply(p, x, cfg)[0],
                                (tp, x))
    assert cost.work["mxu"] == want == B * 20200
    assert cost.op_counts["mxu"] == 7


def _yi_smoke(kind, impl="flash", dtype="float32"):
    yi = get_config("yi-9b", smoke=True)
    shape = ttypes.ShapeConfig("s", kind, 48, 2)
    stp = Stepper(yi, shape, ttypes.SMOKE_MESH, ttypes.ParallelismConfig(
        compute_dtype=dtype, attn_impl=impl))
    params = stp.init(device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, yi.vocab_size, (2, 1 if kind == "decode"
                                              else 48), generator=gen,
                           dtype=torch.int32)
    if kind == "prefill":
        return stp, stp.prefill_fn(), (params, {"tokens": tokens})
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                     stp.cache_schema(),
                     is_leaf=lambda s: hasattr(s, "init"))
    return stp, stp.decode_fn(), (params, tokens, cache)


@pytest.mark.parametrize("kind,impl", [("prefill", "flash"),
                                       ("prefill", "ref"),
                                       ("decode", "flash")])
def test_counts_equal_on_cpu_and_meta(kind, impl):
    _, fn, args = _yi_smoke(kind, impl)
    with torch.inference_mode():
        cpu = tcost.count_step(fn, args)
    meta_args = tree_map(lambda t: t.to("meta"), args)
    with torch.inference_mode():
        meta = tcost.count_step(fn, meta_args)
    assert cpu == meta
    assert cpu.flops > 0 and cpu.temp_bytes > 0


def test_flash_attention_counted_once_a_layer_with_its_formula():
    stp, fn, args = _yi_smoke("prefill", "flash")
    cfg = stp.cfg
    with torch.inference_mode():
        cost = tcost.count_step(fn, args)
    flash = [op for op in cost.ops if op.name == "flash_attention"]
    assert len(flash) == cfg.n_layers
    B, S, H, hd = 2, 48, cfg.n_heads, cfg.hd
    for op in flash:
        assert op.flops == 4 * B * H * hd * S * (S + 1) // 2
        assert op.bytes == 4 * B * S * H * hd * 4        # q, k, v, out
        assert op.channel == "mxu"
    # the plain version's (S, S) scores, run inside the wrapper, go
    # uncounted
    assert f",{S},{S}]" not in cost.as_text()
    assert tkernels.recorder is None


def _wrapper_cases():
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.lstm_cell import ops as lc
    from repro_torch.kernels.lstm_cell_int import ops as lci
    from repro_torch.kernels.lstm_cell_int.kernel import CellSpec
    from repro_torch.kernels.mac_int import ops as mi
    from repro_torch.kernels.mamba2 import ops as m2
    from repro_torch.kernels.quant_matmul import ops as qm
    from repro_torch.kernels.rwkv6 import ops as rw
    from repro_torch.quant.fixedpoint import FxpFormat

    gen = torch.Generator().manual_seed(0)

    def rn(*s):
        return torch.randn(s, generator=gen)

    def ri(lo, hi, *s):
        return torch.randint(lo, hi, s, generator=gen, dtype=torch.int32)

    A, W, C = FxpFormat(8, 4), FxpFormat(8, 6), FxpFormat(16, 8)
    spec = CellSpec(hidden=4, d_in=1, seq_len=6, act_fmt=A, w_fmt=W,
                    state_fmt=C, sig_lo=A.lo, tanh_lo=A.lo)
    table = ri(-8, 8, A.hi - A.lo + 1)
    B, S, H, P, N = 2, 32, 2, 4, 3
    return {
        "flash_attention": (fa.flash_attention,
                            (rn(2, 9, 3, 8), rn(2, 9, 3, 8), rn(2, 9, 3, 8)),
                            {}, 4 * 2 * 3 * 8 * 45),
        "decode_attention": (da.decode_attention,
                             (rn(2, 1, 6, 8), rn(2, 9, 3, 8), rn(2, 9, 3, 8),
                              torch.tensor([4, 9], dtype=torch.int32)),
                             {}, 4 * 2 * 6 * 8 * 9),
        "mac_int": (mi.mac_int_op, (ri(-9, 9, 5, 7), ri(-9, 9, 7, 3),
                                    ri(-9, 9, 3)),
                    dict(shift=2, lo=-128, hi=127), 2 * 5 * 7 * 3),
        "lstm_window_int": (lci.lstm_window_int,
                            (ri(A.lo, A.hi + 1, 3, 6, 1),
                             ri(W.lo, W.hi + 1, 5, 16), ri(-9, 9, 16),
                             table, table.clone()), dict(spec=spec),
                            2 * 3 * 6 * 5 * 16),
        "lstm_window": (lc.lstm_window, (rn(3, 6, 2), rn(6, 16), rn(16)),
                        {}, 2 * 3 * 6 * 6 * 16),
        "quant_matmul": (qm.quant_matmul,
                         (rn(5, 32), torch.randint(-127, 128, (32, 6),
                                                   generator=gen,
                                                   dtype=torch.int8),
                          rn(6).abs()), {}, 2 * 5 * 32 * 6),
        "ssd": (m2.ssd, (rn(B, S, H, P), rn(B, S, H).abs(), -rn(H).abs(),
                         rn(B, S, 1, N), rn(B, S, 1, N)), dict(chunk=16),
                4 * B * S * H * P * N),
        "wkv6": (rw.wkv6, (rn(B, S, H, N), rn(B, S, H, N), rn(B, S, H, N),
                           -rn(B, S, H, N).abs(), rn(H, N)), dict(chunk=16),
                 4 * B * S * H * N * N),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "mac_int", "lstm_window_int",
                                  "lstm_window", "quant_matmul", "ssd",
                                  "wkv6"])
def test_every_wrapper_reports_one_op_on_cpu_and_meta(name):
    fn, args, kwargs, flops = _wrapper_cases()[name]
    want = fn(*args, **kwargs)                   # no counter installed
    counts = {}
    for dev in ("cpu", "meta"):
        dargs = tree_map(lambda t: t.to(dev), args)
        cost = tcost.count_step(lambda *a: fn(*a, **kwargs), dargs)
        counts[dev] = cost
        assert [op.name for op in cost.ops] == [name]
        assert cost.ops[0].flops == flops
        ins = sum(t.numel() * t.element_size() for t in args)
        outs = sum(t.numel() * t.element_size()
                   for t in tcost._tensors(want))
        assert cost.bytes_accessed == ins + outs
    assert counts["cpu"] == counts["meta"]
    got = fn(*tree_map(lambda t: t.to("meta"), args), **kwargs)
    for g, w in zip(tcost._tensors(got), tcost._tensors(want)):
        assert (g.device.type, g.shape, g.dtype) == ("meta", w.shape,
                                                     w.dtype)


def test_full_width_yi9b_prefill_counts_on_meta():
    """Yi-9B's 2,048-token prefill at full width, counted on ``meta`` in
    bf16 without drawing a weight: 48 B5 ops, counted FLOPs within 2% of
    2·N·tokens, compute-bound on the H100."""
    yi = get_config("yi-9b")
    stp = Stepper(yi, ttypes.ShapeConfig("prefill_2k", "prefill", 2048, 1),
                  ttypes.SMOKE_MESH, ttypes.ParallelismConfig(
                      compute_dtype="bfloat16", attn_impl="flash"))
    params = tree_map(lambda s: torch.empty(s.shape, dtype=torch.bfloat16,
                                            device="meta"), stp.schema,
                      is_leaf=lambda s: hasattr(s, "init"))
    syn, dep = tcreator.Creator(device="cpu").translate(stp, params=params)
    assert dep.ops_text.count("flash_attention") == yi.n_layers
    mf = ttarget.model_flops_estimate(yi, stp.shape)
    assert 0.98 < mf / syn.flops < 1.0
    assert syn.bottleneck == "compute" and syn.fits
    assert syn.argument_bytes == 2 * param_count(stp.schema) + 4 * 2048


# --------------------------------------------------------------------------- #
# The target contract, mirroring the reference's tests/test_target.py
# --------------------------------------------------------------------------- #


def _lstm_stepper(creator):
    return creator.build(get_config("elastic-lstm"),
                         ttypes.SHAPES_LSTM["infer_1"])


def test_registry_lists_the_references_targets():
    assert ttarget.list_targets() == jtarget.list_targets() == ["rtl", "xla"]
    tgt = ttarget.get_target("xla")
    assert tgt is ttarget.TORCH_TARGET and isinstance(tgt, ttarget.Target)
    assert (tgt.name, tgt.default_hw, tgt.options_cls,
            tgt.requires_stepper) == ("xla", thw.H100_SXM,
                                      ttarget.TorchOptions, False)
    assert isinstance(tgt.options_from_knobs({"bits": 8}),
                      ttarget.TorchOptions)
    with pytest.raises(ValueError, match=r"unknown target 'hls'; "
                       r"registered targets: \['rtl', 'xla'\]"):
        ttarget.get_target("hls")


@pytest.mark.parametrize("kind", ["synthesize", "", "Prefill"])
def test_torch_options_validate_kind_as_the_reference(kind):
    with pytest.raises(ValueError) as jexc:
        jtarget.XLAOptions(kind=kind)
    with pytest.raises(ValueError) as texc:
        ttarget.TorchOptions(kind=kind)
    assert str(texc.value) == str(jexc.value).replace("XLAOptions",
                                                      "TorchOptions")
    for ok in (None, "train", "prefill", "decode"):
        assert ttarget.TorchOptions(kind=ok).kind == ok


def test_measure_defaults_unified_across_targets():
    cr = tcreator.Creator(device="cpu")
    rtl = tcreator.Creator(hw=thw.XC7S15, device="cpu")
    _, dep = rtl.translate(_lstm_stepper(rtl), target="rtl")
    x = torch.randn(1, 6, 1)
    m_rtl = dep.measure((x,), model="m", model_flops=1e4)
    xd = ttarget.TorchDeployment(fn=lambda a: a * 2, hw=thw.XC7S15,
                                 device="cpu")
    m_xla = xd.measure((x,), model="m", model_flops=1e4)
    assert m_rtl.n_runs == m_xla.n_runs == ttarget.DEFAULT_N_RUNS
    assert (m_rtl.target, m_xla.target) == ("rtl", "xla")
    assert m_xla.platform == "cpu" and m_xla.power_w == thw.XC7S15.active_w
    assert 0 < m_xla.latency_p50_s <= m_xla.latency_p99_s
    raw = cr.measure(lambda a: a + 1, (x,), model="m", model_flops=1.0,
                     n_runs=3)
    assert (raw.target, raw.n_runs, raw.platform) == ("xla", 3, "cpu")


def test_bind_step_keeps_metadata_and_save_round_trips(tmp_path):
    cr = tcreator.Creator(device="cpu")
    syn, dep = cr.translate(_lstm_stepper(cr))
    assert dep.target == "xla" and dep.cycles is None and dep.kind == \
        "prefill"
    assert dep.cost == {"flops": syn.flops,
                        "bytes_accessed": syn.bytes_accessed,
                        "wire_bytes": syn.wire_bytes,
                        "est_latency_s": syn.est_latency_s}
    bound = dep.bind_step(lambda a: a + 1)
    assert bound.ops_text == dep.ops_text and bound.cost == dep.cost
    assert float(bound(torch.zeros(()))) == 1.0
    dep.save(str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "deployment.json", "module.ops.txt"]
    assert (tmp_path / "module.ops.txt").read_text() == dep.ops_text
    assert json.loads((tmp_path / "deployment.json").read_text()) == {
        "target": "xla", "hw": "h100-sxm", "cost": dep.cost}


def test_translate_reports_what_it_counted():
    cr = tcreator.Creator(device="cpu")
    stp = _lstm_stepper(cr)
    tracer = tobs.Tracer()
    prev = tobs.set_tracer(tracer)
    try:
        syn, dep = cr.translate(stp, target="xla")
    finally:
        tobs.set_tracer(prev)
    p = stp.init(device="cpu")
    with torch.inference_mode():
        cost = tcost.count_step(dep.fn, (p, {
            "x": torch.zeros(1, 6, 1), "y": torch.zeros(1, 1)}))
    assert cost.as_text() == dep.ops_text
    assert (syn.flops, syn.bytes_accessed) == (cost.flops,
                                               cost.bytes_accessed)
    assert (syn.argument_bytes, syn.output_bytes, syn.temp_bytes) == (
        cost.argument_bytes, cost.output_bytes, cost.temp_bytes)
    assert syn.backend == "xla" and syn.target == "h100-sxm" and syn.fits
    assert syn.bottleneck == "memory"
    assert syn.est_latency_s == cost.bytes_accessed / thw.H100_SXM.hbm_bw
    assert set(syn.channels) == set(tmeter.CHANNEL_WATTS)
    assert syn.compile_seconds > 0
    names = [s.name for s in tracer.spans]
    assert names.count("xla.lower") == 1 and names.count("xla.compile") == 1


def test_translate_kinds_and_devices():
    cr = tcreator.Creator(device="cpu")
    stp = _lstm_stepper(cr)
    syn, dep = cr.translate(stp, kind="train")
    assert dep.kind == "train" and syn.flops > 0
    yi = get_config("yi-9b", smoke=True)
    lm = cr.build(yi, ttypes.ShapeConfig("d", "decode", 64, 2))
    syn, dep = cr.translate(lm)
    assert dep.kind == "decode" and syn.flops > 0
    # the new K/V land in the cache in place: one index_put_ each a layer
    assert dep.ops_text.count("index_put_") == 2 * yi.n_layers
    # the LM train step, since the LM training slice (ROADMAP A11)
    syn, dep = cr.translate(lm, kind="train")
    assert dep.kind == "train" and syn.flops > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcreator.Creator().translate(stp)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttarget.TorchDeployment(fn=lambda: None)


# --------------------------------------------------------------------------- #
# Workflow over both targets, mirroring tests/test_workflow.py
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("target", ["xla", "rtl"])
def test_workflow_single_path_over_targets(target):
    cfg = get_config("elastic-lstm")

    def train(knobs):
        params = Stepper(cfg, ttypes.SHAPES_LSTM["infer_1"],
                         ttypes.SMOKE_MESH, ttypes.ParallelismConfig()
                         ).init(device="cpu")
        rep = treport.DesignReport(model="elastic-lstm", train_loss=0.0,
                                   eval_loss=0.0)
        return params, rep, None

    def steps(knobs, params):
        x = torch.randn(1, 6, 1, generator=torch.Generator().manual_seed(0))
        return (lambda p, xx: lstm_apply(p, xx, cfg)[0]), (params, x), \
            float(lstm_flops(cfg))

    creator = tcreator.Creator(hw=thw.XC7S15, device="cpu") \
        if target == "rtl" else tcreator.Creator(device="cpu")
    wf = tworkflow.Workflow(
        creator=creator, train_fn=train, step_builder=steps,
        stepper_builder=(lambda k: creator.build(
            cfg, ttypes.SHAPES_LSTM["infer_1"])) if target == "rtl"
        else None, target=target)
    assert tworkflow.Workflow(creator=creator, train_fn=train,
                              step_builder=steps).target == "xla"
    tracer = tobs.Tracer()
    prev = tobs.set_tracer(tracer)
    try:
        rec = wf.run_once({"bits": 8, "frac": 6})
    finally:
        tobs.set_tracer(prev)
    assert rec.measurement.target == target
    assert rec.measurement.n_runs == ttarget.DEFAULT_N_RUNS
    assert rec.measurement.latency_s > 0
    assert rec.synthesis.model == "elastic-lstm"
    assert "latency_rel_err" in rec.est_vs_meas
    names = {s.name for s in tracer.spans}
    if target == "xla":
        assert {"workflow.stage2", "xla.lower", "xla.compile",
                "xla.measure"} <= names
        syn = rec.synthesis
        assert syn.backend == "xla" and syn.target == "h100-sxm"
        assert syn.flops > lstm_flops(cfg) * 0.9 and syn.fits
        assert syn.utilization == syn.temp_bytes / thw.H100_SXM.hbm_bytes
    else:
        assert "rtl.measure" in names and "xla.lower" not in names


# --------------------------------------------------------------------------- #
# Deployment.verify on a host deployment, mirroring tests/test_conformance.py
# --------------------------------------------------------------------------- #


def _window_batch(cfg, stp):
    from repro_torch.model.lm import input_specs

    gen = torch.Generator().manual_seed(0)
    return {k: (torch.randn(s, generator=gen) if k == "x"
                else torch.zeros(s, dtype=d))
            for k, (s, d) in input_specs(cfg, stp.shape).items()}


def _apply(cfg):
    if cfg.family == "lstm":
        return lstm_apply
    from repro_torch.model.conv1d import conv1d_apply

    return conv1d_apply


def _flops(cfg):
    from repro_torch.model.conv1d import conv1d_flops

    return float(lstm_flops(cfg) if cfg.family == "lstm"
                 else conv1d_flops(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_deployment_verify_xla(arch):
    cfg = get_config(arch)
    cr = tcreator.Creator(device="cpu")
    stp = cr.build(cfg, ttypes.shape_table_for(cfg)["infer_1"])
    _, dep = cr.translate(stp, target="xla")
    params = stp.init(device="cpu")
    batch = _window_batch(cfg, stp)
    apply = _apply(cfg)
    rep = dep.verify((params, batch), model=cfg.name,
                     model_flops=_flops(cfg),
                     oracle=lambda p, b: apply(p, b["x"], cfg))
    assert rep.passed, rep.to_json()
    assert rep.target == "xla" and rep.modes == ()
    assert rep.protocol is not None and rep.protocol["passed"]
    assert any("oracle agreement" in n for n in rep.notes)
    bad = dep.verify((params, batch), model=cfg.name,
                     model_flops=_flops(cfg),
                     oracle=lambda p, b: (apply(p, b["x"], cfg)[0] + 1.0,
                                          apply(p, b["x"], cfg)[1]))
    assert not bad.passed and "deviates from oracle" in bad.notes[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_protocol_estimate_band_on_a_real_host_deployment(arch):
    """A translated host deployment carries the roofline's estimate, so the
    protocol records the advisory latency band without the caller adding
    it (the reference's host deployment carries none, and its test sets
    ``dep.cost["est_latency_s"]`` by hand); only the sanity checks gate."""
    from repro_torch.verify import MeasurementProtocol, run_protocol

    cfg = get_config(arch)
    cr = tcreator.Creator(device="cpu")
    stp = cr.build(cfg, ttypes.shape_table_for(cfg)["infer_1"])
    syn, dep = cr.translate(stp, target="xla")
    rep = run_protocol(dep, (stp.init(device="cpu"), _window_batch(cfg, stp)),
                       model=cfg.name, model_flops=_flops(cfg),
                       protocol=MeasurementProtocol(warmup=1, n_runs=2))
    by_name = {c.name: c for c in rep.checks}
    assert {n for n, c in by_name.items() if c.enforced} == {
        "latency_positive_finite", "energy_positive_finite"}
    band = by_name["latency_vs_estimate"]
    assert not band.enforced and band.reference == syn.est_latency_s
    assert rep.passed and rep.target == "xla" and rep.platform == "cpu"


def test_verify_of_a_bf16_lm_deployment():
    """A bf16 LM deployment's outputs (logits in f32, the K/V cache in
    bf16) are compared with its oracle: numpy has no bf16, so the verify
    path widens them first."""
    yi = get_config("yi-9b", smoke=True)
    cr = tcreator.Creator(device="cpu")
    stp = cr.build(yi, ttypes.ShapeConfig("p", "prefill", 32, 2),
                   par=ttypes.ParallelismConfig(compute_dtype="bfloat16",
                                                attn_impl="flash"))
    params = stp.init(device="cpu", dtype_override=torch.bfloat16)
    syn, dep = cr.translate(stp, params=params)
    assert syn.argument_bytes == 2 * sum(
        t.numel() for t in tcost._tensors(params)) + 4 * 2 * 32
    tokens = torch.randint(0, yi.vocab_size, (2, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    plain = stp.prefill_fn()
    rep = dep.verify((params, {"tokens": tokens}), model=yi.name,
                     model_flops=1.0, oracle=plain)
    assert rep.passed, rep.to_json()
    assert rep.notes[0].startswith("oracle agreement")


# --------------------------------------------------------------------------- #
# The launcher's default run
# --------------------------------------------------------------------------- #


def test_launcher_defaults_follow_the_reference():
    wf = tew.build_workflow("elastic-lstm", device="cpu")
    assert wf.target == "xla" and wf.stepper_builder is None
    assert wf.analyze is None and wf.creator.hw is thw.H100_SXM
    rtl = tew.build_workflow("elastic-lstm", device="cpu", target="rtl")
    assert rtl.analyze == "error" and rtl.creator.hw is thw.XC7S15
    assert rtl.stepper_builder({}).shape.name == "infer_1"


@pytest.mark.parametrize("argv", [
    ["--target", "xla", "--device", "cpu", "--train-steps", "2",
     "--max-iters", "1"],
    ["--device", "cpu", "--train-steps", "2", "--max-iters", "1",
     "--arch", "conv1d", "--verify"]])
def test_launcher_host_target_smoke(argv, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tew.main(argv + ["--build-dir", str(tmp_path)]) == 0
    text = out.getvalue()
    arch = "elastic-conv1d" if "conv1d" in argv else "elastic-lstm"
    # the final translation is RTL whatever the loop's target
    assert f"RTL translate [{arch}]" in text
    assert (tmp_path / arch / "manifest.json").is_file()
    if "--verify" in argv:
        assert "conformance: elastic-conv1d[rtl]  PASS" in text
        assert "FAIL" not in text
