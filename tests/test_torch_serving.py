"""PyTorch port, fleet-scale serving: queue, micro-batcher, router, farm,
pool, shard and loadgen, against the JAX package.

The cases of the reference's ``tests/test_serving.py`` are mirrored one for
one on the port (members run on the CPU here; the card's replays are held
in ``test_torch_gpu.py``), and the parity tests drive both packages
through one script: under one injected clock (the reference's
``VirtualClock``, a counter on the port side) the farm and the
``DeploymentPool`` reach equal terminal states and equal stats, the RTL
farm's answers equal the reference farm's integer for integer, and the
loadgen's report equals the reference's on the same params.
"""
import dataclasses
import json
import threading
import warnings

import numpy as np
import pytest
import torch

# the reference's serving package imports repro.shardmap, whose
# jax.lax.pvary jax 0.9 deprecates (an error under pytest.ini): import it
# with that warning silenced
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    import repro.serving as jserving
    from repro.configs import get_config as j_get_config
    from repro.model.layers import init_params as j_init_params
    from repro.obs import MetricsRegistry as JMetricsRegistry
    from repro.resilience.faults import VirtualClock
    from repro.rtl.backend import translate_rtl as j_translate_rtl
    from repro.serving import loadgen as jloadgen
    from repro.verify import vectors as jvec

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.obs import MetricsRegistry
from repro_torch.rtl.backend import translate_rtl
from repro_torch.serving import (DONE, EXPIRED, FAILED, SHED,
                                 AcceleratorFarm,
                                 AdmissionQueue, AffinityRouter,
                                 DeploymentPool, DesignPool, FarmConfig,
                                 MicroBatcher, NoServeableMember,
                                 ServeRequest, bucket_for, pack, pad_window,
                                 padded_batch_size)
from repro_torch.serving import loadgen
from repro_torch.verify import vectors as tvec

CPU = "cpu"


class Clock:
    """The port side's injected clock: a counter that moves only when told
    (``VirtualClock``'s calling convention)."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += max(0.0, float(dt))


# --------------------------------------------------------------------------- #
# shared fixtures / fakes
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def lstm_exe():
    """The paper's LSTM design, translated once per module, on the CPU."""
    from repro_torch.model.layers import init_params
    from repro_torch.model.lstm import lstm_schema

    cfg = get_config("elastic-lstm")
    params = init_params(lstm_schema(cfg), torch.Generator().manual_seed(0))
    _, exe = translate_rtl(cfg, params, device=CPU)
    return exe


class _Member:
    """Duck-typed farm member: callable on (B, L, F), optional health gate
    and program-cache set for affinity, optional failure injection."""

    def __init__(self, healthy=True, fail=False):
        self.healthy = healthy
        self.fail = fail
        self.calls = 0
        self._held = set()

    def can_serve(self):
        return self.healthy

    def holds_program(self, shape, dtype):
        return (tuple(shape), np.dtype(dtype).name) in self._held

    def __call__(self, arr):
        if self.fail:
            raise RuntimeError("member down")
        self.calls += 1
        arr = np.asarray(arr)
        self._held.add((arr.shape, np.dtype(arr.dtype).name))
        return arr.sum(axis=(1, 2))[:, None]


def _fake_farm(members, *, lengths=(8,), clock=None, **cfg_kw):
    clock = clock if clock is not None else Clock()
    pool = DesignPool(family="fake", members={ln: list(members)
                                              for ln in lengths})
    farm = AcceleratorFarm([pool], FarmConfig(**cfg_kw), clock=clock,
                           metrics=MetricsRegistry())
    return farm, clock


def _win(t, f=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (t, f)).astype(np.float32)


# --------------------------------------------------------------------------- #
# batcher: bucketing, packing, flush policy
# --------------------------------------------------------------------------- #


def test_bucket_and_pad_helpers():
    assert bucket_for((6, 12), 4) == 6
    assert bucket_for((6, 12), 6) == 6
    assert bucket_for((6, 12), 7) == 12
    with pytest.raises(ValueError, match=r"registered lengths: \[6, 12\]"):
        bucket_for((6, 12), 13)
    w = pad_window(_win(3), 8)
    assert w.shape == (8, 2)
    assert np.all(w[3:] == 0) and np.array_equal(w[:3], _win(3))
    with pytest.raises(ValueError, match="exceeds bucket"):
        pad_window(_win(9), 8)
    assert [padded_batch_size(n, 64) for n in (1, 2, 3, 5, 33)] == \
        [1, 2, 4, 8, 64]
    with pytest.raises(ValueError, match="exceeds max_batch"):
        padded_batch_size(100, 64)              # pack splits groups first


def test_padded_batch_size_respects_the_cap_edge():
    assert padded_batch_size(63, 64) == 64
    assert padded_batch_size(64, 64) == 64
    with pytest.raises(ValueError, match="exceeds max_batch"):
        padded_batch_size(65, 64)


def test_pack_pads_batch_and_unpack_slices_back():
    reqs = [ServeRequest(rid=i, design="d", window=_win(3 + i, seed=i))
            for i in range(3)]
    [batch] = pack("d", 8, reqs, pad_batch=True, max_batch=64)
    assert batch.array.shape == (4, 8, 2)       # 3 real rows -> pow2 = 4
    assert batch.fill == 3 / 4
    assert np.all(batch.array[3] == 0)          # filler row
    out = np.arange(8, dtype=np.float32).reshape(4, 2)
    from repro_torch.serving import unpack

    unpack(batch, out)
    for i, r in enumerate(reqs):
        assert np.array_equal(r.result, out[i])


@pytest.mark.parametrize("n", [63, 64, 65])
def test_pack_splits_at_the_max_batch_cap(n):
    reqs = [ServeRequest(rid=i, design="d", window=_win(4, seed=i))
            for i in range(n)]
    batches = pack("d", 8, reqs, pad_batch=True, max_batch=64)
    assert [len(b.requests) for b in batches] == \
        ([63] if n == 63 else [64] if n == 64 else [64, 1])
    assert all(b.array.shape[0] <= 64 for b in batches)
    if n == 63:
        assert batches[0].array.shape[0] == 64      # pow2 pad up to cap
    if n == 64:
        assert batches[0].array.shape[0] == 64      # cap stays the cap
    if n == 65:
        assert batches[1].array.shape[0] == 1       # tail re-quantized
    got = [r.rid for b in batches for r in b.requests]
    assert got == list(range(n))


def test_batcher_form_splits_oversized_groups():
    mb = MicroBatcher(buckets={"d": (8,)}, max_batch=4, max_wait_s=0.0)
    reqs = [ServeRequest(rid=i, design="d", window=_win(4), t_submit=0.0)
            for i in range(9)]
    batches, linger = mb.form(reqs, now=0.0, flush=True)
    assert linger == []
    assert [len(b.requests) for b in batches] == [4, 4, 1]
    assert all(b.array.shape[0] <= 4 for b in batches)


def test_batcher_flush_policy():
    mb = MicroBatcher(buckets={"d": (8,)}, max_batch=4, max_wait_s=1.0)
    reqs = [ServeRequest(rid=i, design="d", window=_win(4), t_submit=0.0)
            for i in range(3)]
    batches, linger = mb.form(reqs, now=0.5)     # young partial: lingers
    assert batches == [] and [r.rid for r in linger] == [0, 1, 2]
    batches, linger = mb.form(reqs, now=1.5)     # oldest aged past linger
    assert len(batches) == 1 and linger == []
    reqs6 = [ServeRequest(rid=i, design="d", window=_win(4), t_submit=0.0)
             for i in range(6)]
    batches, linger = mb.form(reqs6, now=0.0)    # full batch always flushes
    assert len(batches) == 1 and len(batches[0].requests) == 4
    assert [r.rid for r in linger] == [4, 5]
    batches, _ = mb.form(reqs6, now=0.0, flush=True)
    assert sum(len(b.requests) for b in batches) == 6


# --------------------------------------------------------------------------- #
# queue: overflow shedding + deadline expiry
# --------------------------------------------------------------------------- #


def test_queue_sheds_at_capacity():
    q = AdmissionQueue(2, clock=Clock(), metrics=MetricsRegistry())
    reqs = [ServeRequest(rid=i, design="d", window=None) for i in range(4)]
    admitted = [q.offer(r) for r in reqs]
    assert admitted == [True, True, False, False]
    assert [r.status for r in reqs] == ["queued", "queued", SHED, SHED]
    assert all(r.error == "queue_full" for r in reqs[2:])
    assert q.metrics.counter("serving.queue.shed_full").value == 2


def test_queue_expires_on_deadline():
    clock = Clock()
    q = AdmissionQueue(8, clock=clock, metrics=MetricsRegistry())
    hurried = ServeRequest(rid=0, design="d", window=None, deadline_s=1.0)
    patient = ServeRequest(rid=1, design="d", window=None)
    q.offer(hurried)
    q.offer(patient)
    clock.advance(2.0)
    expired = q.expire()
    assert expired == [hurried] and hurried.status == EXPIRED
    assert hurried.error == "deadline"
    assert q.peek() == [patient]                 # FIFO survivor intact


def test_queue_expires_at_exactly_the_deadline():
    clock = Clock()
    q = AdmissionQueue(8, clock=clock, metrics=MetricsRegistry())
    req = ServeRequest(rid=0, design="d", window=None, deadline_s=1.0)
    q.offer(req)
    clock.advance(1.0)                           # now == deadline exactly
    assert q.expire() == [req]
    assert req.status == EXPIRED and req.error == "deadline"
    assert q.metrics.counter("serving.queue.expired").value == 1


class _SteppingClock:
    """A clock that advances ``step`` on every read — deterministically
    opens the take()→dispatch window the farm must re-check."""

    def __init__(self, step=0.1, start=1.0):
        self.t = start
        self.step = step

    def __call__(self):
        t = self.t
        self.t += self.step
        return t


def test_farm_recheck_deadline_at_dispatch_time():
    member = _Member()
    farm, clock = _fake_farm([member], clock=_SteppingClock(step=0.1))
    ra = farm.submit("fake", _win(4), deadline_s=1.35)
    rb = farm.submit("fake", _win(4))
    farm.tick(flush=True)
    a, b = farm.result(ra), farm.result(rb)
    assert a.status == EXPIRED and a.error == "deadline"
    assert a.result is None                      # missed SLO grows no result
    assert b.status == DONE and b.result is not None
    s = farm.stats()
    assert s.expired == 1 and s.done == 1 and s.failed == 0
    assert s.admitted == s.done + s.expired      # reconciliation holds
    assert member.calls == 1                     # batchmate still dispatched

    member2 = _Member()
    farm2, _ = _fake_farm([member2], clock=_SteppingClock(step=0.1))
    rid = farm2.submit("fake", _win(4), deadline_s=1.25)
    farm2.tick(flush=True)                       # expire 1.1 < 1.25, disp 1.3
    assert farm2.result(rid).status == EXPIRED
    assert member2.calls == 0
    s2 = farm2.stats()
    assert s2.dispatches == 0 and s2.expired == 1
    assert s2.admitted == s2.done + s2.expired


def test_farm_overflow_and_deadline_end_to_end():
    farm, clock = _fake_farm([_Member()], max_queue=2, max_batch=4)
    rids = [farm.submit("fake", _win(4)) for _ in range(4)]
    shed = [r for r in rids if farm.result(r).status == SHED]
    assert len(shed) == 2                        # bounded backpressure
    late = farm.submit("fake", _win(4))          # wait: queue is full too
    assert farm.result(late).status == SHED
    farm.run_until_drained()
    assert [farm.result(r).status for r in rids[:2]] == [DONE, DONE]

    farm, clock = _fake_farm([_Member()], max_queue=8)
    rid = farm.submit("fake", _win(4), timeout_s=1.0)
    clock.advance(5.0)
    farm.tick()
    assert farm.result(rid).status == EXPIRED
    s = farm.stats()
    assert s.expired == 1 and s.dispatches == 0  # never wasted a dispatch
    assert s.admitted == s.done + s.expired      # zero dropped invariant


def test_farm_unknown_design_and_oversized_window_shed_at_submit():
    farm, _ = _fake_farm([_Member()], lengths=(8,))
    r1 = farm.submit("nope", _win(4))
    assert farm.result(r1).status == SHED
    assert "unknown design" in farm.result(r1).error
    r2 = farm.submit("fake", _win(99))           # no bucket fits length 99
    assert farm.result(r2).status == SHED
    assert "no window bucket" in farm.result(r2).error


# --------------------------------------------------------------------------- #
# router: affinity + health + redispatch
# --------------------------------------------------------------------------- #


def test_router_prefers_member_holding_the_program():
    a, b = _Member(), _Member()
    b((np.zeros((4, 8, 2), np.float32)))         # b builds (4, 8, 2)
    router = AffinityRouter([a, b], metrics=MetricsRegistry())
    i, m, hit = router.route((4, 8, 2), np.float32)
    assert (i, m, hit) == (1, b, True)
    i, _, hit = router.route((2, 8, 2), np.float32)   # nobody holds: miss
    assert hit is False
    assert router.metrics.counter("serving.router.affinity_hit").value == 1
    assert router.metrics.counter("serving.router.affinity_miss").value == 1


def test_router_health_gate_and_exhaustion():
    sick, well = _Member(healthy=False), _Member()
    router = AffinityRouter([sick, well], metrics=MetricsRegistry())
    for _ in range(4):
        i, _, _ = router.route((1, 8, 2), np.float32)
        assert i == 1                            # quarantined takes nothing
    with pytest.raises(NoServeableMember, match="no serveable member"):
        AffinityRouter([sick], metrics=MetricsRegistry()).route()
    with pytest.raises(NoServeableMember):
        router.route(exclude=(1,))               # well excluded, sick gated


def test_farm_redispatches_once_around_a_failing_member():
    bad, good = _Member(fail=True), _Member()
    farm, _ = _fake_farm([bad, good], max_batch=4)
    rids = [farm.submit("fake", _win(4)) for _ in range(2)]
    farm.run_until_drained()
    assert all(farm.result(r).status == DONE for r in rids)
    s = farm.stats()
    assert s.failed == 0 and s.redispatches >= 1
    assert good.calls >= 1

    farm, _ = _fake_farm([_Member(fail=True), _Member(fail=True)],
                         max_batch=4)
    rid = farm.submit("fake", _win(4))
    farm.run_until_drained()
    assert farm.result(rid).status == "failed"
    assert farm.result(rid).error == "RuntimeError"
    assert farm.stats().failed == 1


# --------------------------------------------------------------------------- #
# RTL bit-exactness + affinity build convergence
# --------------------------------------------------------------------------- #


def test_microbatched_results_bit_exact_vs_per_request(lstm_exe):
    """Ragged windows, packed+padded into shared dispatches, must come back
    integer-identical to calling the deployment per padded window alone."""
    rng = np.random.default_rng(7)
    windows = [rng.standard_normal((t, 1)).astype(np.float32) * 0.5
               for t in (3, 4, 5, 6, 6, 4, 3, 5, 6, 2)]
    pool = DesignPool(family="lstm", members={6: [lstm_exe]})
    farm = AcceleratorFarm([pool], FarmConfig(max_batch=8),
                           metrics=MetricsRegistry())
    rids = [farm.submit("lstm", w) for w in windows]
    farm.run_until_drained()
    for rid, w in zip(rids, windows):
        req = farm.result(rid)
        assert req.status == DONE and req.bucket_len == 6
        assert isinstance(req.result, np.ndarray)
        solo = lstm_exe(pad_window(w, 6)[None]).numpy()[0]
        assert np.array_equal(req.result, solo), rid


def test_affinity_keeps_retraces_bounded(lstm_exe):
    """Steady mixed traffic converges to a stable shape->member assignment:
    after a warm epoch, more identical traffic builds NOTHING new."""
    replica = dataclasses.replace(lstm_exe)      # fresh emulator
    pool = DesignPool(family="lstm", members={6: [lstm_exe, replica]})
    farm = AcceleratorFarm([pool], FarmConfig(max_batch=8),
                           metrics=MetricsRegistry())

    def epoch(seed):
        rng = np.random.default_rng(seed)
        for t in rng.integers(2, 7, size=24):
            farm.submit("lstm", rng.standard_normal(
                (int(t), 1)).astype(np.float32))
        farm.run_until_drained()

    epoch(0)
    warm = lstm_exe.emulator.trace_count + replica.emulator.trace_count
    assert warm > 0
    epoch(1)                                     # same shape universe
    cold = lstm_exe.emulator.trace_count + replica.emulator.trace_count
    assert cold == warm                          # zero new builds
    s = farm.stats()
    assert s.affinity_hits > 0
    assert s.failed == 0 and s.admitted == s.done


def test_executable_holds_program_probe(lstm_exe):
    replica = dataclasses.replace(lstm_exe)
    assert replica.emulator is not lstm_exe.emulator
    x = np.zeros((4, 6, 1), np.float32)
    assert not replica.holds_program(x.shape, x.dtype)
    replica(x)
    assert replica.holds_program(x.shape, x.dtype)
    assert replica.emulator.has_program(x.shape, np.int32)
    assert not replica.holds_program((2, 6, 1), x.dtype)


# --------------------------------------------------------------------------- #
# loadgen: determinism + zero-loss accounting
# --------------------------------------------------------------------------- #


def _loadgen_once():
    clock = Clock()
    farm, pools = loadgen.build_farm(
        ("lstm",), replicas=1, buckets={"lstm": (6,)},
        cfg=FarmConfig(max_batch=8), seed=0, clock=clock,
        metrics=MetricsRegistry(), device=CPU)
    spec = loadgen.TrafficSpec(archs=("lstm",), n_requests=24, wave=8,
                               seed=3)
    return loadgen.run_loadgen(farm, pools, spec, clock=clock)


def test_loadgen_seeded_runs_are_identical():
    a = json.dumps(_loadgen_once(), indent=2, sort_keys=True)
    b = json.dumps(_loadgen_once(), indent=2, sort_keys=True)
    assert a == b
    rep = json.loads(a)
    assert rep["submitted"] == 24
    assert rep["by_status"] == {"done": 24}
    assert rep["dropped_after_admission"] == 0
    assert rep["per_design"]["lstm"]["gop_per_j"] > 0   # cycle-model energy


def test_loadgen_open_loop_sheds_under_overload():
    clock = Clock()
    farm, pools = loadgen.build_farm(
        ("lstm",), replicas=1, buckets={"lstm": (6,)},
        cfg=FarmConfig(max_batch=8, max_queue=8), seed=0, clock=clock,
        metrics=MetricsRegistry(), device=CPU)
    spec = loadgen.TrafficSpec(archs=("lstm",), n_requests=64, wave=32,
                               mode="open", seed=1)
    rep = loadgen.run_loadgen(farm, pools, spec, clock=clock)
    assert rep["by_status"].get("shed", 0) > 0   # the queue was the brake
    assert rep["dropped_after_admission"] == 0   # but nothing vanished
    total = sum(rep["by_status"].values())
    assert total == rep["submitted"] == 64


def test_loadgen_cli_smoke(tmp_path):
    out = tmp_path / "bench.json"
    rc = loadgen.main(["--arch", "lstm", "--requests", "16", "--wave", "8",
                       "--replicas", "1", "--max-batch", "8",
                       "--device", "cpu", "--out", str(out),
                       "--p99-bound", "60"])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["by_status"] == {"done": 16}
    assert rep["dropped_after_admission"] == 0


def test_loadgen_cli_fails_on_a_blown_p99_bound(tmp_path, capsys):
    out = tmp_path / "bench.json"
    rc = loadgen.main(["--arch", "lstm", "--requests", "8", "--wave", "8",
                       "--replicas", "1", "--max-batch", "8",
                       "--device", "cpu", "--out", str(out),
                       "--p99-bound", "0"])
    assert rc == 1
    assert "exceeds bound" in capsys.readouterr().err
    assert json.loads(out.read_text())["by_status"] == {"done": 8}


def test_loadgen_without_a_device_means_cuda_or_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loadgen.main(["--arch", "lstm", "--requests", "1", "--wave", "1",
                      "--replicas", "1"])


# --------------------------------------------------------------------------- #
# measure(): warmup runs must not skew the latency percentiles
# --------------------------------------------------------------------------- #


def _slow_start_fn(slow_calls, slow_s=0.02):
    import time as _time

    state = {"n": 0}

    def fn(x):
        state["n"] += 1
        if state["n"] <= slow_calls:
            _time.sleep(slow_s)
        return x

    fn.state = state
    return fn


def test_measure_percentiles_exclude_warmup():
    from repro_torch.core.target import TorchDeployment

    x = torch.zeros(4)
    dep = TorchDeployment(fn=_slow_start_fn(3), device=CPU)
    rep = dep.measure((x,), model="m", model_flops=1e6, n_runs=10,
                      warmup=3)
    assert dep.fn.state["n"] == 13               # warmup runs DID execute
    assert rep.latency_p99_s < 0.02              # ...but never entered p99

    dep0 = TorchDeployment(fn=_slow_start_fn(3), device=CPU)
    rep0 = dep0.measure((x,), model="m", model_flops=1e6, n_runs=10,
                        warmup=0)
    assert rep0.latency_p99_s >= 0.015


def test_protocol_routes_warmup_into_measure():
    from repro_torch.core.report import MeasurementReport
    from repro_torch.core.target import Deployment
    from repro_torch.verify.protocol import MeasurementProtocol, run_protocol

    seen = {}

    class _Dep(Deployment):
        target = "fake"

        def __call__(self, *a):
            return a

        def measure(self, args, *, model, model_flops, n_runs=1,
                    warmup=1, hw=None):
            seen.update(n_runs=n_runs, warmup=warmup)
            return MeasurementReport(
                model=model, platform="fake", latency_s=1e-3,
                power_w=0.1, energy_j=1e-4, gop_per_j=1.0,
                n_runs=n_runs, target=self.target)

    rep = run_protocol(_Dep(), (np.zeros(2),), model="m", model_flops=1e6,
                       protocol=MeasurementProtocol(warmup=5, n_runs=2))
    assert seen == {"n_runs": 2, "warmup": 5}
    assert rep.warmup == 5 and rep.passed


# --------------------------------------------------------------------------- #
# the program LRU + sharding
# --------------------------------------------------------------------------- #


def test_program_lru_shared_and_thread_safe(lstm_exe):
    from repro_torch.rtl.program_cache import ProgramLRU
    from repro_torch.serving import ShardedExecutable

    sharded = ShardedExecutable(dataclasses.replace(lstm_exe), [CPU])
    assert isinstance(sharded._programs, ProgramLRU)
    assert isinstance(lstm_exe.emulator._programs, ProgramLRU)

    lru = ProgramLRU(max_programs=2)
    built, errors = [], []

    def hammer(tid):
        try:
            for i in range(200):
                key = ("k", i % 3)

                def factory(key=key):
                    built.append(key)
                    return key

                prog, _hit, _ev = lru.get_or_build(key, factory)
                assert prog == key          # never another key's program
        except Exception as e:              # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    st = lru.stats()
    assert st["hits"] + st["misses"] == 4 * 200
    assert st["misses"] == len(built)       # every miss built exactly once
    assert st["size"] <= 2                  # eviction bound respected


def test_sharded_executable_bit_exact_single_device(lstm_exe):
    from repro_torch.serving import ShardedExecutable

    sharded = ShardedExecutable(dataclasses.replace(lstm_exe), [CPU])
    x = np.random.default_rng(5).standard_normal(
        (4, 6, 1)).astype(np.float32) * 0.5
    assert torch.equal(sharded(x), lstm_exe(x))
    assert sharded.holds_program(x.shape, x.dtype)
    x3 = x[:3]
    assert torch.equal(sharded(x3), lstm_exe(x3))


@pytest.mark.parametrize("n_devices", (2, 4))
def test_sharded_executable_multidevice_bit_exact(lstm_exe, n_devices):
    """A list of several devices (the CPU, named n times): the split
    dispatch is integer-identical to the unsplit emulator, odd batches pad
    to a shard multiple, and each device's copy builds its own program."""
    from repro_torch.serving import ShardedExecutable

    sharded = ShardedExecutable(dataclasses.replace(lstm_exe),
                                [CPU] * n_devices)
    assert sharded.n_shards == n_devices
    x = np.random.default_rng(5).standard_normal(
        (8, 6, 1)).astype(np.float32) * 0.5
    assert torch.equal(sharded(x), lstm_exe(x))
    assert torch.equal(sharded(x[:5]), lstm_exe(x[:5]))   # pads to 6 or 8
    assert sharded.holds_program((5, 6, 1), np.float32)
    assert sharded.trace_count == 2 - (n_devices == 4)   # 8 and 8 for 4
    assert all(em.trace_count >= 1 for em in sharded.emulators)
    many = sharded.run_many([x[:3], x[3:]])
    assert torch.equal(torch.cat(many), lstm_exe(x))


# --------------------------------------------------------------------------- #
# parity with the reference under one injected clock
# --------------------------------------------------------------------------- #


def _farm_script(serving, clock, metrics):
    """One scripted farm run over fake members (a sick one, a failing one,
    two healthy ones) in two buckets: shedding at the door and at a full
    queue, deadlines, lingering partial batches, a redispatch, affinity."""
    members = [_Member(), _Member(fail=True), _Member(), _Member()]
    members[0].healthy = False
    pools = [serving.DesignPool(family="fake",
                                members={4: members[:2], 8: members[2:]})]
    farm = serving.AcceleratorFarm(
        pools, serving.FarmConfig(max_queue=12, max_batch=4, max_wait_s=0.5),
        clock=clock, metrics=metrics)
    rng = np.random.default_rng(11)
    for step in range(6):
        for _ in range(5):
            t = int(rng.integers(1, 11))
            farm.submit("fake", _win(t, seed=t),
                        timeout_s=float(rng.choice([0.2, 1.0, 5.0])))
        farm.submit("other", _win(3))
        clock.advance(0.3)
        farm.tick(flush=step % 3 == 2)
    farm.run_until_drained()
    states = [(r.rid, r.status, r.error, r.member, r.bucket_len,
               r.batch_size, None if r.result is None
               else np.asarray(r.result).tolist(), r.t_submit, r.t_done)
              for _, r in sorted(farm.requests.items())]
    return states, farm.stats().to_dict(), [m.calls for m in members]


def test_farm_states_and_stats_equal_the_reference():
    got = _farm_script(__import__("repro_torch.serving",
                                  fromlist=["*"]), Clock(), MetricsRegistry())
    want = _farm_script(jserving, VirtualClock(), JMetricsRegistry())
    assert got == want
    states, stats, _ = got
    # bucket 4's members are one sick and one failing: its batches fail
    # after one redispatch; bucket 8 serves
    assert {s[1] for s in states} == {DONE, SHED, EXPIRED, FAILED}
    assert stats["redispatches"] > 0 and stats["failed"] > 0
    assert stats["admitted"] == \
        stats["done"] + stats["expired"] + stats["failed"]


def _pool_script(pool_cls, metrics):
    members = [_PoolMember(), _PoolMember(fail=True), _PoolMember()]
    pool = pool_cls(members, max_queue=5, max_wait_ticks=3, metrics=metrics)
    rids = []
    for step in range(5):
        rids += [pool.submit(np.float32(step), np.float32(i))
                 for i in range(4)]
        if step == 2:
            for m in members:
                m.healthy = False
        if step == 3:
            members[2].healthy = True
        pool.tick()
    stats = pool.drain()
    return ([pool.result(r) for r in rids], dataclasses.asdict(stats))


class _PoolMember:
    """A pool member: adds its args; can be gated or fail."""

    def __init__(self, fail=False):
        self.fail = fail
        self.healthy = True

    def can_serve(self):
        return self.healthy

    def __call__(self, a, b):
        if self.fail:
            raise ValueError("member down")
        return float(a + b)


def test_deployment_pool_equals_the_reference():
    from repro_torch.serving.pool import DeploymentPool as TPool

    got = _pool_script(TPool, MetricsRegistry())
    want = _pool_script(jserving.DeploymentPool, JMetricsRegistry())
    assert got == want
    statuses = {r["status"] for r in got[0]}
    assert {"ok", "lost", "shed"} <= statuses


def test_deprecated_pool_shim_warns_as_the_reference_does():
    from repro_torch.runtime import server

    with pytest.warns(DeprecationWarning, match="moved to"):
        pool = server.DeploymentPool([_PoolMember()], max_queue=4,
                                     metrics=MetricsRegistry())
    assert isinstance(pool, DeploymentPool)
    rid = pool.submit(1.0, 2.0)
    with pytest.warns(DeprecationWarning, match="drain"):
        stats = pool.run_until_drained()
    assert pool.result(rid)["value"] == 3.0 and stats.served_ok == 1
    assert server.PoolStats is type(stats)


@pytest.fixture(scope="module")
def twin_exes():
    """The canonical elastic-lstm through both packages' translate_rtl,
    the same numpy-seeded params."""
    _, cfg, tp = tvec.canonical_graph("elastic-lstm")
    _, jcfg, jp = jvec.canonical_graph("elastic-lstm")
    _, exe = translate_rtl(cfg, tp, device=CPU)
    _, jexe = j_translate_rtl(jcfg, jp)
    return exe, jexe


def test_rtl_farm_answers_equal_the_reference(twin_exes):
    exe, jexe = twin_exes
    answers = []
    for serving, e, clock, mx in (
            (__import__("repro_torch.serving", fromlist=["*"]),
             dataclasses.replace(exe), Clock(), MetricsRegistry()),
            (jserving, dataclasses.replace(jexe), VirtualClock(),
             JMetricsRegistry())):
        pool = serving.DesignPool(family="lstm",
                                  members={6: [e, dataclasses.replace(e)]})
        farm = serving.AcceleratorFarm([pool], serving.FarmConfig(
            max_batch=8), clock=clock, metrics=mx)
        rng = np.random.default_rng(4)
        rids = [farm.submit("lstm", rng.standard_normal(
            (int(t), 1)).astype(np.float32) * 0.5)
            for t in rng.integers(1, 7, size=21)]
        stats = farm.run_until_drained().to_dict()
        answers.append(([np.asarray(farm.result(r).result) for r in rids],
                        [farm.result(r).member for r in rids], stats))
    (got, members, stats), (want, jmembers, jstats) = answers
    assert len(got) == len(want) == 21
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert members == jmembers and stats == jstats


def test_loadgen_report_equals_the_reference():
    """The same tape through both farms, on the reference's params (carried
    across by ``convert.params_from_jax``), under a clock nobody moves: the
    reports are equal key for key."""
    import jax

    def ref_params(cfg):
        jcfg = j_get_config(cfg.name).with_(**{
            cfg.family: dataclasses.replace(
                getattr(j_get_config(cfg.name), cfg.family),
                seq_len=getattr(cfg, cfg.family).seq_len)})
        if cfg.family == "lstm":
            from repro.model.lstm import lstm_schema as schema
        else:
            from repro.model.conv1d import conv1d_schema as schema
        return params_from_jax(j_init_params(schema(jcfg),
                                             jax.random.PRNGKey(0)), cfg)

    buckets = {"lstm": (6,), "conv1d": (16,)}
    spec = loadgen.TrafficSpec(archs=("lstm", "conv1d"), n_requests=20,
                               wave=8, seed=5)
    jspec = jloadgen.TrafficSpec(archs=("lstm", "conv1d"), n_requests=20,
                                 wave=8, seed=5)
    clock, jclock = Clock(), VirtualClock()
    farm, pools = loadgen.build_farm(
        ("lstm", "conv1d"), replicas=2, buckets=buckets,
        cfg=FarmConfig(max_batch=4), clock=clock, metrics=MetricsRegistry(),
        params=ref_params, device=CPU)
    jfarm, jpools = jloadgen.build_farm(
        ("lstm", "conv1d"), replicas=2, buckets=buckets,
        cfg=jserving.FarmConfig(max_batch=4), clock=jclock,
        metrics=JMetricsRegistry())
    rep = loadgen.run_loadgen(farm, pools, spec, clock=clock)
    jrep = jloadgen.run_loadgen(jfarm, jpools, jspec, clock=jclock)
    assert rep == jrep
    for rid, req in farm.requests.items():
        np.testing.assert_array_equal(req.result,
                                      np.asarray(jfarm.requests[rid].result))
