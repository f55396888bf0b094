"""The port stands alone: importing it (every submodule) loads neither jax
nor any module of the JAX package, no port file or chip_smoke.py imports
them, and entry points refuse the default device when there is no card."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "mpi_knn_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]

_PROBE = """
import importlib, json, pkgutil, sys
import mpi_knn_tpu_torch
for mod in pkgutil.walk_packages(mpi_knn_tpu_torch.__path__, "mpi_knn_tpu_torch."):
    if mod.name != "mpi_knn_tpu_torch.__main__":
        importlib.import_module(mod.name)
import chip_smoke
print(json.dumps(sorted(sys.modules)))
"""


def test_importing_the_port_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("ops.fused_knn", "ops.fused_ring", "ops.fused_rotation",
                "ops.rerank", "ops.quant", "backends.ring",
                "backends.ring_resumable", "backends.resumable",
                "utils.checkpoint", "parallel.mesh", "serve.index",
                "serve.engine", "serve.cli", "utils.report", "utils.logs",
                "utils.timing", "ops.approx_topk", "data._native",
                "data.matfile", "data.vecs", "data.svd", "data.digits",
                "data.mnist", "data.synthetic"):
        assert f"mpi_knn_tpu_torch.{mod}" in loaded
    assert "chip_smoke" in loaded
    bad = [m for m in loaded
           if m == "jax" or m.startswith(("jax.", "jaxlib"))
           or m == "mpi_knn_tpu" or m.startswith("mpi_knn_tpu.")]
    assert bad == []


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_of_the_port_imports_jax(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "mpi_knn_tpu"), (path, name)


def _entry_points():
    from mpi_knn_tpu_torch import (
        KNNClassifier,
        ServeSession,
        all_knn,
        build_index,
        query_knn,
    )
    from mpi_knn_tpu_torch.cli import main
    from mpi_knn_tpu_torch.data import svd_reduce

    X = np.zeros((16, 4), np.float32)
    index = build_index(X, k=2, device="cpu")  # built before the card vanishes
    return {
        "all_knn": lambda: all_knn(X, k=2),
        "KNNClassifier": lambda: KNNClassifier(k=2),
        "cli": lambda: main(["--data", "synthetic:64x4c2", "--k", "2"]),
        "build_index": lambda: build_index(X, k=2),
        "query_knn": lambda: query_knn(X, index),
        "ServeSession": lambda: ServeSession(index),
        "query_cli": lambda: main(["query", "--data", "synthetic:64x4c2",
                                   "--synthetic", "8", "--k", "2"]),
        "svd_reduce": lambda: svd_reduce(X, 2),
    }


@pytest.mark.parametrize("entry", ["all_knn", "KNNClassifier", "cli",
                                   "build_index", "query_knn", "ServeSession",
                                   "query_cli", "svd_reduce"])
def test_default_device_without_a_card_raises(entry, monkeypatch):
    entries = _entry_points()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entries[entry]()
