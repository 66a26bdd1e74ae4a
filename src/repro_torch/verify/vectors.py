"""Golden stimulus/response vectors — the portable half of the Elastic Node
(port of ``repro/verify/vectors.py``).

A vector set is ``vectors.npz`` (``stimulus``/``response`` int32 code
arrays at the design's input/output Q-formats) plus ``manifest.json``
(design, formats, shapes, seed, per-array SHA-256). Stimulus comes from a
seeded numpy PCG64 stream and always leads with the corner rows (all-zero,
all-min, all-max codes); canonical per-arch designs use numpy-seeded
weights; the ``.npz`` is written through a fixed-timestamp zip writer. So
the port regenerates the checked-in sets byte for byte
(:func:`emit_golden`).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.quant.fixedpoint import FxpFormat

#: the vector format this reader understands (recorded per manifest)
VECTOR_FORMAT_VERSION = 1
#: the one seed golden (checked-in) vector sets are generated with
GOLDEN_SEED = 2024
#: random rows per golden set, on top of the 3 corner rows
GOLDEN_N_RANDOM = 13

VECTORS_NPZ = "vectors.npz"
VECTORS_MANIFEST = "manifest.json"


def parse_fmt(s: str) -> FxpFormat:
    """Inverse of ``str(FxpFormat)`` — "Q8.4" -> FxpFormat(8, 4)."""
    if not s.startswith("Q") or "." not in s:
        raise ValueError(f"not a Q-format string: {s!r}")
    total, frac = s[1:].split(".", 1)
    return FxpFormat(int(total), int(frac))


@dataclass(frozen=True)
class VectorSet:
    """One design's golden vectors: int codes in, expected int codes out."""

    design: str
    stimulus: np.ndarray             # (B, *in_shape) int32, codes of in_fmt
    response: np.ndarray             # (B, *out_shape) int32, codes of out_fmt
    in_fmt: FxpFormat
    out_fmt: FxpFormat
    seed: int = GOLDEN_SEED
    meta: Dict = field(default_factory=dict)

    @property
    def n_vectors(self) -> int:
        return int(self.stimulus.shape[0])

    def stimulus_f(self) -> np.ndarray:
        """The float values the int stimulus codes represent (exact)."""
        return self.stimulus.astype(np.float32) / self.in_fmt.scale

    def head(self, n: int) -> "VectorSet":
        """The first ``n`` rows as a standalone set — the canary slice.
        The leading rows are the corner patterns (zero, rail-low,
        rail-high), which exercise every memory's contribution before any
        random row would."""
        if n < 1:
            raise ValueError(f"head(n) needs n >= 1, got {n}")
        n = min(n, self.n_vectors)
        return VectorSet(design=self.design,
                         stimulus=self.stimulus[:n],
                         response=self.response[:n],
                         in_fmt=self.in_fmt, out_fmt=self.out_fmt,
                         seed=self.seed,
                         meta={**self.meta, "slice": f"head({n})"})


def _sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def corner_codes(shape: Tuple[int, ...], fmt: FxpFormat) -> np.ndarray:
    """The 3 rows every stimulus set leads with: silence, rail-low,
    rail-high."""
    return np.stack([np.zeros(shape, np.int32),
                     np.full(shape, fmt.lo, np.int32),
                     np.full(shape, fmt.hi, np.int32)])


def stimulus_codes(shape: Tuple[int, ...], fmt: FxpFormat, *,
                   n_random: int = GOLDEN_N_RANDOM,
                   seed: int = GOLDEN_SEED) -> np.ndarray:
    """Corner rows + ``n_random`` seeded uniform rows over the full code
    range — numpy PCG64, the same bytes on every platform."""
    rng = np.random.Generator(np.random.PCG64(seed))
    rows = [corner_codes(shape, fmt)]
    if n_random > 0:
        rows.append(rng.integers(fmt.lo, fmt.hi + 1,
                                 size=(n_random, *shape),
                                 dtype=np.int64).astype(np.int32))
    return np.concatenate(rows, axis=0)


def generate_vectors(graph, *, n_random: int = GOLDEN_N_RANDOM,
                     seed: int = GOLDEN_SEED, mode: str = "jnp",
                     device: Optional[Union[str, torch.device]] = None
                     ) -> VectorSet:
    """The golden set of a lowered design: deterministic stimulus at the
    input edge's format, responses from the bit-exact emulator (``jnp``
    mode by default, like the reference)."""
    from repro_torch.rtl.emulator import RTLEmulator
    from repro_torch.rtl.oplib import get_template

    in_edge = graph.edges[graph.inputs[0]]
    out_edge = graph.edges[graph.outputs[0]]
    stim = stimulus_codes(in_edge.shape, in_edge.fmt,
                          n_random=n_random, seed=seed)
    resp = RTLEmulator(graph, mode=mode, device=device).run_int(stim) \
        .outputs.cpu().numpy().astype(np.int32)
    kinds = sorted({n.op for n in graph.nodes})
    meta = {
        "format_version": VECTOR_FORMAT_VERSION,
        "template_kinds": kinds,
        "sequential_kinds": sorted(
            k for k in kinds if get_template(k).sequential),
        "edges": {e.name: {"shape": list(e.shape), "fmt": str(e.fmt)}
                  for e in graph.edges.values()},
        "emulator_mode": mode,
        "n_corner": 3,
        "n_random": n_random,
    }
    return VectorSet(design=graph.name, stimulus=stim, response=resp,
                     in_fmt=in_edge.fmt, out_fmt=out_edge.fmt, seed=seed,
                     meta=meta)


# --------------------------------------------------------------------------- #
# Serialization: deterministic .npz + JSON manifest
# --------------------------------------------------------------------------- #


def _write_npz_deterministic(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` minus the nondeterminism: fixed zip timestamps, sorted
    member order, no compression — same arrays, same bytes, every time."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for name in sorted(arrays):
            buf = io.BytesIO()
            np.save(buf, np.ascontiguousarray(arrays[name]))
            info = zipfile.ZipInfo(f"{name}.npy",
                                   date_time=(1980, 1, 1, 0, 0, 0))
            zf.writestr(info, buf.getvalue())


def save_vectors(vs: VectorSet, out_dir: str) -> Dict[str, str]:
    """Write ``vectors.npz`` + ``manifest.json``; returns {filename: path}.

    The manifest carries SHA-256 digests of both arrays so a bring-up
    harness can validate a transfer without trusting the transport.
    """
    os.makedirs(out_dir, exist_ok=True)
    npz_path = os.path.join(out_dir, VECTORS_NPZ)
    man_path = os.path.join(out_dir, VECTORS_MANIFEST)
    _write_npz_deterministic(npz_path, {"stimulus": vs.stimulus,
                                        "response": vs.response})
    manifest = {
        "design": vs.design,
        "format_version": VECTOR_FORMAT_VERSION,
        "seed": vs.seed,
        "n_vectors": vs.n_vectors,
        "stimulus": {"shape": list(vs.stimulus.shape), "dtype": "int32",
                     "fmt": str(vs.in_fmt), "sha256": _sha256(vs.stimulus)},
        "response": {"shape": list(vs.response.shape), "dtype": "int32",
                     "fmt": str(vs.out_fmt), "sha256": _sha256(vs.response)},
        "meta": vs.meta,
    }
    with open(man_path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    return {VECTORS_NPZ: npz_path, VECTORS_MANIFEST: man_path}


def load_vectors(in_dir: str) -> VectorSet:
    """Read a saved set back, verifying shapes and SHA-256 digests (a golden
    set that fails its own checksums must never silently 'pass')."""
    with open(os.path.join(in_dir, VECTORS_MANIFEST)) as f:
        man = json.load(f)
    if man["format_version"] != VECTOR_FORMAT_VERSION:
        raise ValueError(
            f"vector set {in_dir!r} has format_version "
            f"{man['format_version']}, this reader understands "
            f"{VECTOR_FORMAT_VERSION}")
    with np.load(os.path.join(in_dir, VECTORS_NPZ)) as z:
        stim, resp = np.asarray(z["stimulus"]), np.asarray(z["response"])
    for name, arr in (("stimulus", stim), ("response", resp)):
        want = man[name]
        if list(arr.shape) != want["shape"]:
            raise ValueError(f"{name} shape {list(arr.shape)} != manifest "
                             f"{want['shape']}")
        got = _sha256(arr)
        if got != want["sha256"]:
            raise ValueError(f"{name} sha256 mismatch in {in_dir!r}: "
                             f"{got} != {want['sha256']}")
    return VectorSet(design=man["design"], stimulus=stim, response=resp,
                     in_fmt=parse_fmt(man["stimulus"]["fmt"]),
                     out_fmt=parse_fmt(man["response"]["fmt"]),
                     seed=man["seed"], meta=man.get("meta", {}))


# --------------------------------------------------------------------------- #
# Canonical per-arch designs (what the checked-in golden sets pin)
# --------------------------------------------------------------------------- #


def _materialize(schema, draw):
    """Rebuild ``schema`` with ``draw(spec)`` at every PSpec leaf, visiting
    dict keys in SORTED order and lists in order — the leaf order of
    ``jax.tree.flatten``, which the reference draws its weights in."""
    from repro_torch.model.layers import is_pspec

    if is_pspec(schema):
        return draw(schema)
    if isinstance(schema, dict):
        drawn = {k: _materialize(schema[k], draw) for k in sorted(schema)}
        return {k: drawn[k] for k in schema}
    if isinstance(schema, (list, tuple)):
        return type(schema)(_materialize(v, draw) for v in schema)
    raise TypeError(f"unexpected schema node {type(schema).__name__}")


def canonical_params(schema, *, seed: int = 0):
    """Materialize a schema with numpy-seeded weights (PCG64), drawn in the
    reference's leaf order so both packages get the same arrays."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def draw(spec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        scale = spec.scale if spec.scale is not None else \
            1.0 / np.sqrt(max(1, spec.shape[0]))
        return (rng.standard_normal(spec.shape) * scale).astype(np.float32)

    return _materialize(schema, draw)


def canonical_graph(arch: str, *, seed: int = 0,
                    **fmt_kwargs) -> Tuple[object, object, object]:
    """The reference design golden vectors are generated against: registered
    arch config + numpy-seeded canonical weights + default Q-formats,
    lowered through the hardware-template registry.

    Returns ``(graph, cfg, params)``.
    """
    from repro_torch.configs import get_config
    from repro_torch.rtl.ir import lower_model

    cfg = get_config(arch)
    params = canonical_params(schema_for(cfg), seed=seed)
    return lower_model(cfg, params, **fmt_kwargs), cfg, params


def schema_for(cfg):
    """Family -> parameter schema, for the families the RTL registry lowers."""
    if cfg.family == "lstm":
        from repro_torch.model.lstm import lstm_schema

        return lstm_schema(cfg)
    if cfg.family == "conv1d":
        from repro_torch.model.conv1d import conv1d_schema

        return conv1d_schema(cfg)
    from repro_torch.rtl.oplib import lowerable_families

    raise NotImplementedError(
        f"no canonical schema for family {cfg.family!r}; "
        f"lowerable families: {lowerable_families()}")


def golden_dir(root: str, arch: str) -> str:
    """Layout convention for checked-in sets: ``<root>/<arch>/``."""
    return os.path.join(root, arch)


def emit_golden(arch: str, root: str, *, seed: int = GOLDEN_SEED,
                device: Optional[Union[str, torch.device]] = None
                ) -> VectorSet:
    """Generate + save the canonical golden set for ``arch`` under
    ``root/<arch>/``; the one entry point both the snapshot tests and a
    regeneration run use (so they cannot drift apart). The responses come
    from the emulator on ``device`` (``None`` means CUDA)."""
    graph, _, _ = canonical_graph(arch)
    vs = generate_vectors(graph, seed=seed, device=device)
    save_vectors(vs, golden_dir(root, arch))
    return vs
