"""Structural rules of the PyTorch port.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  anything of the reference package ``repro`` (only tests import both);
* entry points default to the card: without ``device=`` they raise when
  no GPU is visible instead of running on the CPU;
* the engine serves the dense per-slot layout by default and refuses it
  only with an int8 KV store;
* every kernel wrapper has a plain version beside it and a launch
  counter, every CUDA source says which TPU kernel it replaces, and no
  module builds anything at import time.
"""
import ast
import importlib
import os
import pkgutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = _port_files()
    assert len(files) > 20 and os.path.exists(files[0])
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                bad.append(f"{os.path.relpath(path, ROOT)}: {mod}")
    assert not bad, "\n".join(bad)


def _all_port_modules():
    import repro_torch

    return [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]


def test_importing_every_module_builds_nothing():
    from repro_torch.kernels import _build

    for name in _all_port_modules():
        importlib.import_module(name)
    assert _build._loaded == {} and _build.build_seconds == {}


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine

    cfg = get_arch("stablelm-1.6b").reduced()
    cpu_model = Model(cfg, device="cpu")
    params = cpu_model.init(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cpu_model, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg, device="cuda")
    ServeEngine(cpu_model, params, device="cpu")  # asked for the CPU: fine


def test_engine_serves_the_dense_layout_by_default():
    """The dense per-slot layout is the default and serves (dense caches,
    no pool statistics); it is refused only with an int8 KV store, whose
    pooled blocks need the paged layout."""
    from repro_torch.configs import get_arch
    from repro_torch.models.attention import KVCache
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.serve import ServeConfig, ServeEngine

    assert ServeConfig().kv_block_size == 0
    model = Model(get_arch("stablelm-1.6b").reduced(), device="cpu")
    eng = ServeEngine(model, model.init(0), ServeConfig(kv_block_size=0), device="cpu")
    assert isinstance(eng._states["layers"][0], KVCache) and eng.kv_stats == {}
    assert eng.generate_batch([np.arange(5, dtype=np.int32)], 3)[0].gen_len == 3
    quant = Model(model.cfg, ModelOptions(kv_quant="int8"), device="cpu")
    with pytest.raises(ValueError, match="dense per-slot caches"):
        ServeEngine(quant, model.init(0), ServeConfig(kv_block_size=0), device="cpu")


def _kernel_packages():
    kdir = os.path.join(PORT, "kernels")
    return sorted(d for d in os.listdir(kdir) if os.path.isdir(os.path.join(kdir, d, "csrc")))


def test_every_kernel_has_plain_version_counter_and_note():
    from repro_torch.kernels import _build

    pkgs = _kernel_packages()
    assert pkgs == ["bts_encode", "flash_attention", "int8_matmul", "paged_attention",
                    "rglru_scan", "stoch_matmul"]
    for pkg in pkgs:
        ops = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
        importlib.import_module(f"repro_torch.kernels.{pkg}.ref")
        counted = [n for n, f in vars(ops).items()
                   if callable(f) and isinstance(getattr(f, "launches", None), int)]
        assert counted, f"{pkg}: no wrapper carries a launch counter"
        plain = [n for n, f in vars(ops).items()
                 if getattr(f, "__module__", "") == f"repro_torch.kernels.{pkg}.ref"]
        assert plain, f"{pkg}: ops.py does not use a plain version from ref.py"
        srcs = [s for lib in _build.LIBRARIES.values() for s in lib
                if s.startswith(f"{pkg}/csrc/")]
        assert srcs and all(os.path.exists(os.path.join(PORT, "kernels", s)) for s in srcs)
    # every library's sources (a package may build more than one library)
    for name, srcs in _build.LIBRARIES.items():
        assert srcs and all(s.startswith(tuple(f"{p}/csrc/" for p in pkgs)) for s in srcs), name
        for s in srcs:
            with open(os.path.join(PORT, "kernels", s), encoding="utf-8") as f:
                text = f.read()
            assert "Replaces: src/repro/kernels/" in text, s
            assert "bound" in text and "Design:" in text, s
            assert "torch/extension.h" not in text  # plain C ABI, built by nvcc


def test_launch_registry_covers_every_counted_wrapper():
    from repro_torch.kernels import kernel_wrappers, launch_counts, reset_launches

    counted = {n for pkg in _kernel_packages()
               for n, f in vars(importlib.import_module(f"repro_torch.kernels.{pkg}.ops")).items()
               if callable(f) and isinstance(getattr(f, "launches", None), int)}
    wrappers = kernel_wrappers()
    assert set(wrappers) == counted
    assert {"flash_attention", "dense_attention_decode", "rglru_scan"} <= counted
    wrappers["int8_gemm"].launches = 3
    assert launch_counts()["int8_gemm"] == 3
    reset_launches()
    assert set(launch_counts().values()) == {0}


def test_wrappers_run_plain_on_cpu_and_refuse_other_devices():
    from repro_torch.core.quant import QTensor
    from repro_torch.kernels.int8_matmul.ops import int8_gemm, int8_matmul_t
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import (
        dense_attention_decode, paged_attention_decode,
    )

    x = torch.ones(3, 8, dtype=torch.int8)
    w_t = torch.ones(5, 8, dtype=torch.int8)
    before = int8_gemm.launches
    out = int8_matmul_t(QTensor(x, torch.tensor(1.0)), QTensor(w_t, torch.ones(1, 5)))
    assert torch.equal(out, torch.full((3, 5), 8.0)) and int8_gemm.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        int8_gemm(x.to("meta"), w_t.to("meta"))
    q = torch.zeros(1, 2, 16, device="meta")
    pool = torch.zeros(3, 2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        paged_attention_decode(q, pool, pool, torch.zeros(1, 2, dtype=torch.int32),
                               torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        dense_attention_decode(q, pool[:1], pool[:1], torch.ones(1, dtype=torch.int32))
    qs = torch.zeros(1, 2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_attention(qs, qs, qs)
    before = flash_attention.launches
    out = flash_attention(*(torch.ones(1, 2, 4, 16) for _ in range(3)))
    assert torch.allclose(out, torch.ones(1, 2, 4, 16)) and flash_attention.launches == before


def test_rglru_scan_wrapper_follows_the_port_rules():
    """The linear-recurrence wrapper: its plain loop on a CPU tensor (no
    launch counted), a refusal on any other non-CUDA device, a counter in
    the registry, and a CUDA source that names the TPU kernel it replaces."""
    from repro_torch.kernels import _build, launch_counts
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    a = torch.full((2, 3, 4), 0.5)
    b = torch.ones(2, 3, 4)
    before = ops.rglru_scan.launches
    out = ops.rglru_scan(a, b)
    assert ops.rglru_scan.launches == before and "rglru_scan" in launch_counts()
    assert torch.equal(out, rglru_scan_ref(a, b))
    assert torch.allclose(out[0, :, 0], torch.tensor([1.0, 1.5, 1.75]))
    with pytest.raises(ValueError, match="device"):
        ops.rglru_scan(a.to("meta"), b.to("meta"))
    (src,) = _build.LIBRARIES["rglru_scan"]
    with open(os.path.join(PORT, "kernels", src), encoding="utf-8") as f:
        text = f.read()
    assert "Replaces: src/repro/kernels/rglru_scan/kernel.py :: rglru_scan_kernel" in text
    assert "sm_90a" in text and "__global__" in text


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """A library's build key hashes the headers its sources include, so
    editing the shared Hopper header rebuilds the libraries that include
    it (flash attention, decode, paged prefill, the sm_90 int8 GEMM, the
    binary tensor-core stochastic GEMM and the scan) and no other."""
    import shutil

    from repro_torch.kernels import _build

    users = {n for n in _build.LIBRARIES
             if any(p.name == "hopper.cuh" for p in _build.headers(n))}
    assert users == {"flash_attention", "decode", "paged_prefill", "int8_gemm_sm90",
                     "stoch_gemm_sm90", "rglru_scan"}
    copy = tmp_path / "kernels"
    shutil.copytree(os.path.join(PORT, "kernels"), copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(_build, "_PKG", copy)
    before = {n: _build._target(n)[0] for n in _build.LIBRARIES}
    with open(copy / "common" / "hopper.cuh", "a", encoding="utf-8") as f:
        f.write("\n// edited\n")
    after = {n: _build._target(n)[0] for n in _build.LIBRARIES}
    assert {n for n in before if before[n] != after[n]} == users
