"""PyTorch port, package rules: the port and chip_smoke.py import nothing
of JAX or of the JAX package, and every kernel keeps the reference layout
with its CUDA source in ``repro_torch/csrc/``."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(p.relative_to(ROOT).as_posix()
                    for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)(\s|\.|,|$)|from\s+(jax|repro)(\s|\.))",
    re.MULTILINE)


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_no_jax_and_no_reference(rel):
    text = (ROOT / rel).read_text()
    bad = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not bad, f"{rel} imports {bad}"


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.rtl import ir", "import repro", "  import repro.x"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.rtl import ir",
                 "import jaxtyping", "# import jax"):
        assert not FORBIDDEN.search(line), line


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.rtl, repro_torch.verify, "
            "repro_torch.convert, repro_torch.configs, "
            "repro_torch.runtime.server, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.kernels.lstm_cell, repro_torch.kernels.quant_matmul, "
            "repro_torch.kernels.mamba2, repro_torch.kernels.rwkv6, "
            "repro_torch.quant.ptq, repro_torch.model.ssm, "
            "repro_torch.model.rwkv, repro_torch.energy, "
            "repro_torch.core.report, repro_torch.rtl.lint, "
            "repro_torch.verify.conformance, repro_torch.verify.protocol, "
            "repro_torch.data, repro_torch.optim, repro_torch.quant.qat, "
            "repro_torch.core.target, repro_torch.core.registry, "
            "repro_torch.core.creator, repro_torch.core.workflow, "
            "repro_torch.rtl.backend, repro_torch.launch.elastic_workflow, "
            "repro_torch.rtl.program_cache, repro_torch.rtl.cuda_graph, "
            "repro_torch.rtl.multi, repro_torch.serving, "
            "repro_torch.serving.queue, repro_torch.serving.batcher, "
            "repro_torch.serving.router, repro_torch.serving.farm, "
            "repro_torch.serving.pool, repro_torch.serving.shard, "
            "repro_torch.serving.loadgen, repro_torch.resilience, "
            "repro_torch.resilience.faults, repro_torch.resilience.guard, "
            "repro_torch.resilience.chaos, repro_torch.obs.export, "
            "repro_torch.runtime.failures, repro_torch.model.moe, "
            "repro_torch.model.frontend, repro_torch.model.transformer, "
            "repro_torch.launch.dryrun; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro'); "
            "assert not bad, bad")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _loaded_source(package: str) -> str:
    """The ``csrc/<name>.cu`` a kernel package's launcher loads."""
    text = (PORT / "kernels" / package / "kernel.py").read_text()
    found = re.findall(r'build\.load\("(\w+)"\)', text)
    assert len(found) == 1, (package, found)
    return found[0]


def test_every_kernel_has_source_launcher_wrapper_and_plain_version():
    from repro_torch.kernels import PORT_KERNELS, TEMPLATES, build

    names = build.kernel_names()
    assert names == ["decode_attention", "flash_attention", "lstm_cell",
                     "lstm_cell_int", "mac_int", "quant_matmul", "ssd",
                     "wkv6"]
    for package in TEMPLATES + PORT_KERNELS:
        for part in ("kernel.py", "ops.py", "ref.py"):
            assert (PORT / "kernels" / package / part).is_file(), (package,
                                                                    part)
    assert sorted(_loaded_source(p)
                  for p in TEMPLATES + PORT_KERNELS) == names
    assert build.BUILD_DIR == ROOT / "build" / "repro_torch"


def test_every_reference_template_is_ported():
    """Each entry of the reference's ``repro.kernels.TEMPLATES`` (read from
    its source, so nothing of JAX is imported) has a port package with its
    launcher, wrapper, plain version and a CUDA source the launcher loads;
    the port's TEMPLATES lists them and ``mac_int`` (the reference keeps
    that kernel in ``rtl/oplib.py``), and nothing else; every other kernel
    package on disk is one of ``PORT_KERNELS``, which replace none."""
    import ast

    from repro_torch.kernels import PORT_KERNELS, TEMPLATES

    tree = ast.parse((ROOT / "src" / "repro" / "kernels" / "__init__.py")
                     .read_text())
    ref = next(ast.literal_eval(node.value) for node in tree.body
               if isinstance(node, ast.Assign)
               and getattr(node.targets[0], "id", "") == "TEMPLATES")
    assert len(ref) == 6
    assert sorted(TEMPLATES) == sorted((*ref, "mac_int"))
    on_disk = sorted(p.parent.name for p in
                     (PORT / "kernels").glob("*/kernel.py"))
    assert on_disk == sorted(TEMPLATES + PORT_KERNELS)
    assert not set(TEMPLATES) & set(PORT_KERNELS)
    for package in ref:
        for part in ("kernel.py", "ops.py", "ref.py"):
            assert (PORT / "kernels" / package / part).is_file(), (package,
                                                                    part)
        assert (PORT / "csrc" / f"{_loaded_source(package)}.cu").is_file()


def test_library_key_follows_source_flags_and_compiler(monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "nvcc_version", lambda: "release 12.4")
    path = build.library_path("mac_int")
    assert path.parent == build.BUILD_DIR and path.name.startswith("mac_int-")
    assert build.library_path("lstm_cell_int") != path
    monkeypatch.setattr(build, "nvcc_version", lambda: "release 12.8")
    assert build.library_path("mac_int") != path
    monkeypatch.setattr(build, "nvcc_version", lambda: "release 12.4")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("mac_int") != path
