"""PyTorch port, the chunked scans ``model/ssm.py::ssd_chunked`` and
``model/rwkv.py::wkv6_chunked`` (the plain mirrors of B6's and B7's three
passes) against the JAX package's on the same numpy-seeded inputs: within
1e-5 of the reference's chunked forms (the same algorithm in f32, summed in
another order), and within the reference's 1e-4 of the per-step oracles
(tests/test_chunked_scans.py's bar), at ragged lengths, several chunks,
two groups for the SSD, with and without h0; and invariant to the chunk."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from repro.model.rwkv import wkv6_chunked as j_wkv6_chunked
    from repro.model.ssm import ssd_chunked as j_ssd_chunked

from repro_torch.model.rwkv import wkv6_chunked, wkv6_reference
from repro_torch.model.ssm import ssd_chunked, ssd_reference

SAME_ALGORITHM_TOL = 1e-5
ORACLE_TOL = 1e-4


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.numpy() - np.asarray(want, np.float32)).max())


def _ssd_case(B, S, H, P, G, N, seed):
    """tests/test_chunked_scans.py's distributions."""
    rng = np.random.default_rng(seed)
    x = _f32(rng, (B, S, H, P), 0.5)
    dt = np.log1p(np.exp(_f32(rng, (B, S, H)))).astype(np.float32)
    A = (-np.exp(_f32(rng, (H,), 0.3))).astype(np.float32)
    Bm, Cm = _f32(rng, (B, S, G, N), 0.5), _f32(rng, (B, S, G, N), 0.5)
    h0 = _f32(rng, (B, H, P, N), 0.1)
    return x, dt, A, Bm, Cm, h0


def _wkv_case(B, S, H, N, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (_f32(rng, (B, S, H, N), 0.5) for _ in range(3))
    w_log = (-np.exp(_f32(rng, (B, S, H, N), 0.5))).astype(np.float32)
    u = _f32(rng, (H, N), 0.5)
    h0 = _f32(rng, (B, H, N, N), 0.1)
    return r, k, v, w_log, u, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S,chunk", [(17, 8), (33, 16), (100, 32), (64, 16)])
def test_ssd_chunked_matches_reference_and_oracle(S, chunk, G, with_h0):
    x, dt, A, Bm, Cm, h0 = _ssd_case(2, S, 4, 8, G, 6, S + chunk + G)
    h0 = h0 if with_h0 else None
    y, hf = ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk=chunk,
                        h0=_t(h0))
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    assert tuple(hf.shape) == (2, 4, 8, 6)
    want_y, want_h = j_ssd_chunked(*map(_j, (x, dt, A, Bm, Cm)), chunk=chunk,
                                   h0=_j(h0))
    assert _err(y, want_y) < SAME_ALGORITHM_TOL
    assert _err(hf, want_h) < SAME_ALGORITHM_TOL
    y_r, hf_r = ssd_reference(*map(_t, (x, dt, A, Bm, Cm)), h0=_t(h0))
    assert (y - y_r).abs().max().item() < ORACLE_TOL
    assert (hf - hf_r).abs().max().item() < ORACLE_TOL


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S,chunk", [(17, 8), (33, 16), (100, 32), (64, 32),
                                     (48, 16)])
def test_wkv6_chunked_matches_reference_and_oracle(S, chunk, with_h0):
    r, k, v, w_log, u, h0 = _wkv_case(2, S, 3, 8, S + chunk)
    h0 = h0 if with_h0 else None
    y, hf = wkv6_chunked(*map(_t, (r, k, v, w_log, u)), h0=_t(h0),
                         chunk=chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == r.shape
    assert tuple(hf.shape) == (2, 3, 8, 8)
    want_y, want_h = j_wkv6_chunked(*map(_j, (r, k, v, w_log, u)),
                                    h0=_j(h0), chunk=chunk)
    assert _err(y, want_y) < SAME_ALGORITHM_TOL
    assert _err(hf, want_h) < SAME_ALGORITHM_TOL
    y_r, hf_r = wkv6_reference(*map(_t, (r, k, v, w_log, u)), h0=_t(h0))
    assert (y - y_r).abs().max().item() < ORACLE_TOL
    assert (hf - hf_r).abs().max().item() < ORACLE_TOL


def test_ssd_chunked_is_chunk_invariant():
    """The associativity the SSD's chunked form rests on: the same result
    for any chunking (tests/test_chunked_scans.py::test_chunk_size_
    invariance, here with h0 and a ragged chunk too)."""
    x, dt, A, Bm, Cm, h0 = map(_t, _ssd_case(1, 48, 2, 8, 1, 8, 2))
    outs = [ssd_chunked(x, dt, A, Bm, Cm, chunk=c, h0=h0)
            for c in (8, 16, 48, 32, 5)]
    for y, hf in outs[1:]:
        assert (y - outs[0][0]).abs().max().item() < ORACLE_TOL
        assert (hf - outs[0][1]).abs().max().item() < ORACLE_TOL


def test_wkv6_chunked_is_chunk_invariant():
    r, k, v, w_log, u, h0 = map(_t, _wkv_case(1, 96, 2, 8, 3))
    outs = [wkv6_chunked(r, k, v, w_log, u, h0=h0, chunk=c)
            for c in (16, 32, 48, 96, 8)]
    for y, hf in outs[1:]:
        assert (y - outs[0][0]).abs().max().item() < ORACLE_TOL
        assert (hf - outs[0][1]).abs().max().item() < ORACLE_TOL


@pytest.mark.parametrize("with_h0", [False, True])
def test_wkv6_chunked_gradient_is_finite_where_the_references_is_nan(
        with_h0):
    """ROADMAP §C15: decays near -1.5 a step over 4 chunks of 16 steps put
    the carry's ``seg`` above the diagonal near 96, whose exp overflows
    f32; the reference's ``where(zmask, exp(seg), 0)`` then gives NaN
    gradients (0 · inf). The port masks ``seg`` before the exp: its
    forward equals the reference's within 1e-5, and the gradient of every
    input is finite and within 1e-4 (of the largest magnitude) of the
    per-step oracle's in f64."""
    import jax

    r, k, v, _, u, h0 = _wkv_case(1, 64, 2, 4, 11)
    w_log = np.full(r.shape, -1.5, np.float32)
    h0 = h0 if with_h0 else None
    rng = np.random.default_rng(12)
    gy = _f32(rng, r.shape)
    gh = _f32(rng, (1, 2, 4, 4))
    ins = [r, k, v, w_log, u] + ([h0] if with_h0 else [])

    def port(fn, dtype, **kw):
        ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in ins]
        y, hf = fn(*ts[:5], h0=ts[5] if with_h0 else None, **kw)
        ((y * torch.tensor(gy, dtype=dtype)).sum()
         + (hf * torch.tensor(gh, dtype=dtype)).sum()).backward()
        return y.detach(), [t.grad for t in ts]

    y, grads = port(wkv6_chunked, torch.float32, chunk=16)
    _, oracle = port(wkv6_reference, torch.float64)

    def ref_loss(*a):
        yj, hj = j_wkv6_chunked(*a[:5], h0=a[5] if with_h0 else None,
                                chunk=16)
        return (yj * gy).sum() + (hj * gh).sum()

    ref_grads = jax.grad(ref_loss, argnums=tuple(range(len(ins))))(
        *map(jnp.asarray, ins))
    assert not all(bool(jnp.isfinite(g).all()) for g in ref_grads)
    want_y, _ = j_wkv6_chunked(*map(_j, ins[:5]), h0=_j(h0), chunk=16)
    assert _err(y, want_y) < SAME_ALGORITHM_TOL
    for g, o in zip(grads, oracle):
        assert torch.isfinite(g).all()
        scale = o.abs().max().item()
        assert (g.double() - o).abs().max().item() <= ORACLE_TOL * scale
