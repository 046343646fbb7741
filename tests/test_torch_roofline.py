"""The port's roofline layer against ``repro``'s: the analytical FLOP and
byte model for every cell, the roofline terms under each package's
constants, the model against ``FlopCounterMode`` on reduced configs, and
the collective counter on a known all-gather."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as J
import repro.roofline.analysis as JA
import repro.roofline.flops_model as JF
import repro_torch.configs as T
import repro_torch.roofline.analysis as TA
import repro_torch.roofline.flops_model as TF
from repro_torch.models.transformer import init_params, loss_fn

CELLS = J.cells()
ARCHS = J.list_archs()
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_flops_and_bytes_match_repro(arch, shape_name):
    """Same formulas on the same configs: exact."""
    jc, tc = J.get_config(arch), T.get_config(arch)
    js, ts = J.SHAPES[shape_name], T.SHAPES[shape_name]
    decode = js.kind == "decode"
    assert TF.forward_flops_per_token(tc, ts.seq_len, decode) == \
        JF.forward_flops_per_token(jc, js.seq_len, decode)
    for n_dev in (256, 512):
        for remat in (True, False):
            assert TF.cell_flops(tc, ts, n_dev, remat) == \
                JF.cell_flops(jc, js, n_dev, remat)
        assert TF.cell_hbm_bytes(tc, ts, n_dev) == \
            JF.cell_hbm_bytes(jc, js, n_dev)
        assert TF.cell_hbm_bytes(tc, ts, n_dev, window_caches=True) == \
            JF.cell_hbm_bytes(jc, js, n_dev, window_caches=True)
    assert TF.kv_cache_bytes(tc, js.global_batch, js.seq_len) == \
        JF.kv_cache_bytes(jc, js.global_batch, js.seq_len)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_and_active_params_match_repro(arch):
    jc, tc = J.get_config(arch), T.get_config(arch)
    assert TF.param_bytes(tc) == JF.param_bytes(jc)
    assert TA.active_params(tc) == JA.active_params(jc)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        assert TA.model_flops(tc, T.SHAPES[shape_name]) == \
            JA.model_flops(jc, J.SHAPES[shape_name])


def _entry(kind_bytes: float, arch: str, shape_name: str) -> dict:
    return {"arch": arch, "shape": shape_name, "n_devices": 256,
            "flops": 2.1e14, "hbm_model_bytes": 3.0e11 * kind_bytes,
            "min_hbm_bytes": 1.2e10, "param_bytes_per_dev": 1.0e10,
            "collective_bytes": {"all-gather": 4e10 * kind_bytes,
                                 "all-reduce": 1e9, "reduce-scatter": 0,
                                 "all-to-all": 0, "collective-permute": 0}}


@pytest.mark.parametrize("scale", [0.01, 1.0, 100.0])
@pytest.mark.parametrize("arch,shape_name",
                         [("yi-6b", "train_4k"),
                          ("deepseek-v3-671b", "decode_32k"),
                          ("mamba2-1.3b", "prefill_32k")])
def test_roofline_terms_match_repro_formulas(monkeypatch, arch, shape_name,
                                             scale):
    """``repro``'s ``roofline_terms`` with the port's H100 constants put
    in gives the port's terms exactly; the constants themselves are the
    H100 SXM datasheet's."""
    assert (TA.PEAK_FLOPS, TA.HBM_BW, TA.LINK_BW) == (989e12, 3.35e12,
                                                       450e9)
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(JA, name, getattr(TA, name))
    entry = _entry(scale, arch, shape_name)
    want = JA.roofline_terms(dict(entry), J.get_config(arch))
    got = TA.roofline_terms(dict(entry), T.get_config(arch))
    assert got == want
    assert TA.measured_roofline_fraction(got, 2.0) == \
        max(got["ideal_compute_s"], got["ideal_memory_s"]) / 2.0


@pytest.mark.parametrize("arch", ARCHS)
def test_flop_model_against_flop_counter(arch):
    """``FlopCounterMode`` (every matmul the port runs) on a reduced
    loss (forward, and MTP where the config has it) within 15% of
    ``forward_flops_per_token`` × tokens, the tolerance ``repro`` states
    for its model against a compile."""
    cfg = T.get_reduced_config(arch)
    b, s = 2, 64
    cb = (cfg.codebooks,) if cfg.codebooks > 1 else ()
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab, (b, s, *cb), generator=gen)
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.n_prefix:
        batch["prefix_embeddings"] = torch.zeros(
            b, cfg.n_prefix, cfg.d_model, dtype=cfg.dtype)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        loss_fn(params, cfg, batch)
    tokens_seen = s + cfg.n_prefix
    want = TF.forward_flops_per_token(cfg, tokens_seen) * b * tokens_seen
    assert counter.get_total_flops() == pytest.approx(want, rel=0.15)


_ALL_GATHER = r"""
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.dryrun import init_fake_mesh
from repro_torch.roofline.analysis import collective_bytes
mesh = init_fake_mesh((4, 2), ("data", "model"))
t = torch.empty(64, 48, dtype=torch.bfloat16, device="meta")
d = distribute_tensor(t, mesh, [Shard(0), Shard(1)], src_data_rank=None)
with collective_bytes() as coll:
    d.redistribute(mesh, [Replicate(), Shard(1)])
print(coll.bytes["all-gather"], coll.calls["all-gather"],
      sum(coll.bytes.values()))
"""


def test_collective_counter_sizes_an_all_gather():
    """Gathering a [64, 48] bf16 tensor's rows over 4 data ranks (columns
    split over 2 model ranks): one all-gather whose result is [64, 24]."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _ALL_GATHER],
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got, calls, total = map(int, out.stdout.split()[-3:])
    assert (got, calls, total) == (64 * 24 * 2, 1, 64 * 24 * 2)
