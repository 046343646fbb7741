"""The port stands alone: ``repro_torch`` imports neither JAX nor ``repro``,
its entry points run on CUDA unless the caller asks for the CPU, and
``repro_torch.core`` exports the names ``repro.core`` does."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.core.arima import ARIMA
from repro_torch.core.delivery import make_prefetcher
from repro_torch.core.kmeans import kmeans
from repro_torch.core.placement import PlacementEngine
from repro_torch.core.simulator import SimConfig, run_strategy
from repro_torch.configs import get_reduced_config
from repro_torch.convert import gru_params_from_numpy, params_from_numpy
from repro_torch.core.rnn_predictor import GRUPredictor
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import TrainConfig, train_loop

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _module_names() -> list[str]:
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_importing_every_module_loads_no_jax_or_repro():
    names = _module_names()
    assert {"repro_torch.core.engine", "repro_torch.core.interval_store",
            "repro_torch.kernels.arima_bank",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.ssd_scan", "repro_torch.serve.engine",
            "repro_torch.launch.serve", "repro_torch.core.rnn_predictor",
            "repro_torch.kernels.gru_fit", "repro_torch.data",
            "repro_torch.data.staging", "repro_torch.data.pipeline",
            "repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.loop", "repro_torch.distributed",
            "repro_torch.distributed.checkpoint",
            "repro_torch.launch.train"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imported_roots(tree: ast.AST) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_has_no_jax_or_repro_import(path):
    roots = _imported_roots(ast.parse(path.read_text()))
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, roots


_GRID = T.OOI_PROFILE.grid
_ENTRY_POINTS = {
    "ARIMA": lambda **kw: ARIMA(**kw),
    "ARIMA_scalar": lambda **kw: ARIMA(bank=False, **kw),
    "kmeans": lambda **kw: kmeans(np.zeros((4, 3), np.float32), 2, **kw),
    "PlacementEngine": lambda **kw: PlacementEngine(_GRID, **kw),
    "make_prefetcher_hpm": lambda **kw: make_prefetcher("hpm", _GRID, **kw),
    "make_prefetcher_md2": lambda **kw: make_prefetcher("md2", _GRID, **kw),
    "run_strategy": lambda **kw: run_strategy(
        "cache_only", T.make_trace("ooi", seed=0, scale=0.01)[:50], _GRID,
        SimConfig(), **kw),
    "run_strategy_interval": lambda **kw: run_strategy(
        "cache_only", T.make_trace("ooi", seed=0, scale=0.01)[:50], _GRID,
        SimConfig(), engine="interval", **kw),
    "init_params": lambda **kw: init_params(
        torch.Generator().manual_seed(0), get_reduced_config("yi-6b"), **kw),
    "params_from_numpy": lambda **kw: params_from_numpy(
        {"embed": np.zeros((4, 2)), "final_norm": np.ones(2), "units": []},
        dataclasses.replace(get_reduced_config("yi-6b"), n_layers=0), **kw),
    "ServeEngine": lambda **kw: ServeEngine(get_reduced_config("yi-6b"), {},
                                            **kw),
    "GRUPredictor": lambda **kw: GRUPredictor(**kw),
    "train_loop": lambda **kw: train_loop(
        get_reduced_config("yi-6b"), TrainConfig(),
        iter([{"tokens": np.zeros((1, 8), np.int32),
               "labels": np.zeros((1, 8), np.int32)}]), 1, **kw),
    "launch_train": lambda **kw: launch_train.main(
        ["--arch", "yi-6b", "--reduced", "--steps", "1", "--batch", "1",
         "--seq", "8"] + [f"--{k}={v}" for k, v in kw.items()]),
    "gru_params_from_numpy": lambda **kw: gru_params_from_numpy(
        {"wz": np.zeros((12, 12)), "wr": np.zeros((12, 12)),
         "wc": np.zeros((12, 12)), "uz": np.zeros(12), "ur": np.zeros(12),
         "uc": np.zeros(12), "bz": np.zeros(12), "br": np.zeros(12),
         "bc": np.zeros(12), "wo": np.zeros(12), "bo": np.zeros(())}, **kw),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[name]()
    with pytest.raises(RuntimeError, match="CUDA"):
        _ENTRY_POINTS[name](device="cuda")
    _ENTRY_POINTS[name](device="cpu")         # the CPU is asked for: runs


def test_core_exports_the_same_names_as_repro():
    assert set(T.__all__) == set(J.__all__)
