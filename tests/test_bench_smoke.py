"""``bench.py`` and ``chip_smoke.py`` wiring, exercised on the CPU at cut
block sizes: every benchmark configuration builds, runs its K-block
dispatch, and passes the smoke run's float64-reference check.  (The
numbers a CPU run prints are not hardware statements; the full-width run
is ``python chip_smoke.py`` on the card.)"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench = _load("bench")


def _small(kw):
    """The config at a cut block size: the same nbins/ntaps/nchan/ingest,
    just enough frames for the taps, K=2."""
    kw = dict(kw)
    frames = max(kw.get("ntaps", 4), 8)
    kw["block_pow"] = int(np.log2(kw["nbins"] * frames))
    kw["blocks_per_call"] = 2
    return kw


@pytest.mark.parametrize("name", sorted(bench.CONFIGS))
def test_bench_config_runs(name):
    res = bench.bench(iters=1, warmup=0, **_small(bench.CONFIGS[name]))
    assert res["samples_per_s"] > 0
    assert res["nbins"] == bench.CONFIGS[name]["nbins"]


@pytest.mark.parametrize("name", sorted(bench.CONFIGS))
def test_chip_smoke_config_check(name):
    cs = _load("chip_smoke")
    cs.check_config(name, _small(bench.CONFIGS[name]),
                    np.random.default_rng(0), iters=1)


def test_require_gpu_refuses_cpu():
    import fxtpu.runtime.device as device
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()
