"""The port stands alone: no module of ``triton_distributed_tpu_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package, importing the port
loads neither, and its entry points refuse to fall back to the CPU when no
card is visible."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "triton_distributed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "triton_distributed_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_scan_sees_the_whole_port():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert "chip_smoke.py" in names
    assert "triton_distributed_tpu_torch/models/engine.py" in names
    assert "triton_distributed_tpu_torch/kernels/sp_attention.py" in names
    assert "triton_distributed_tpu_torch/kernels/paged_attention.py" in names
    for mod in ("__init__", "batch_engine", "kv_pool", "prefix_cache",
                "scheduler"):
        assert f"triton_distributed_tpu_torch/serving/{mod}.py" in names
    for mod in ("kernels/moe_utils", "layers/moe_mlp", "kernels/_signal",
                "kernels/gemm_reduce_scatter", "runtime/perf_model",
                "kernels/allreduce", "kernels/ep_all_to_all",
                "kernels/notify_wait", "runtime/mesh",
                "layers/ep_a2a_layer", "kernels/moe_overlap",
                "kernels/reduce_scatter"):
        assert f"triton_distributed_tpu_torch/{mod}.py" in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_matcher_does_not_catch_the_port_itself():
    assert _forbidden("triton_distributed_tpu.models")
    assert _forbidden("jax.numpy")
    assert not _forbidden("triton_distributed_tpu_torch.models")


def test_import_leaves_jax_unloaded():
    code = ("import sys, triton_distributed_tpu_torch as p; "
            "import triton_distributed_tpu_torch.kernels; "
            "import triton_distributed_tpu_torch.serving; "
            "import triton_distributed_tpu_torch.runtime.perf_model; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'triton_distributed_tpu' or "
            "m.startswith('triton_distributed_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_engine_without_device_needs_a_card():
    from triton_distributed_tpu_torch import (
        BatchEngine,
        Engine,
        KVPool,
        ModelConfig,
        params_from_jax,
    )
    from triton_distributed_tpu_torch.runtime.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(ModelConfig.from_name("tiny"))
    # The serving path takes its Engine's device; a pool made on its own
    # defaults to the card as well.
    cpu = Engine(ModelConfig.from_name("tiny"), device="cpu")
    assert BatchEngine(cpu, n_slots=2).pool.state.k.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        KVPool(ModelConfig.from_name("tiny"), n_blocks=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    # The weight carrier places on the card by default as well.
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(None, ModelConfig.from_name("tiny"))
