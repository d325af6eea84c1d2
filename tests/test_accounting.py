"""The analytic collective-volume model == what XLA actually emits.

These tests compile the sharded step on an 8-device virtual mesh, parse
every collective in the executable, and assert the per-block payload bytes
equal `parallel/accounting.py`'s model — including the corner turn, which
moves O(num_samp) bytes per block when bins are sharded."""

import jax.numpy as jnp
import numpy as np
import pytest

from fxtpu.config import CorrelatorConfig
from fxtpu.fx import FxEngine
from fxtpu.parallel import make_correlator_mesh
from fxtpu.parallel.accounting import measured_volume, predicted_volume

NUM_SAMP, NBINS, NTAPS = 2**14, 256, 4


def _measure(t, f, *, int8=False, ntaps=NTAPS, mode="SPECTRUM"):
    kw = dict(ingest_dtype="int8") if int8 else {}
    cfg = CorrelatorConfig(num_samp=NUM_SAMP, nbins=NBINS, ntaps=ntaps,
                           clamp_num_samp=False, mode=mode, **kw)
    mesh = make_correlator_mesh(t, f)
    eng = FxEngine(cfg, mesh=mesh)
    iq, _, hist = eng.example_inputs(0)
    delays = jnp.asarray([0.0, 3.3e-7], jnp.float32)
    return measured_volume(eng.step, iq, delays, eng.fresh_history())


def _predict(t, f, *, ntaps=NTAPS, continuum=False):
    return predicted_volume(nch=2, nbl=1, nbins=NBINS, num_samp=NUM_SAMP,
                            ntaps=ntaps, mesh_time=t, mesh_freq=f,
                            continuum=continuum)


@pytest.mark.parametrize("t,f", [(4, 2), (8, 1), (2, 4), (2, 2)])
def test_xla_path_volume_matches_model(t, f):
    assert _measure(t, f) == _predict(t, f)


@pytest.mark.parametrize("t,f", [(4, 2), (8, 1)])
def test_deep_tap_volume_matches_model(t, f):
    """An 8-tap halo (7 of each shard's 8 rows) is what the model says."""
    assert _measure(t, f, ntaps=8) == _predict(t, f, ntaps=8)


def test_continuum_volume_matches_model():
    """CONTINUUM products add the bin mean across the freq shards."""
    assert _measure(4, 2, mode="CONTINUUM") == _predict(4, 2, continuum=True)


def test_int8_ingest_moves_the_same_collectives():
    """int8 planes are dequantized before the F-stage, so the collectives
    carry f32 payloads exactly as for complex64 ingest."""
    assert _measure(4, 2, int8=True) == _predict(4, 2)


def test_corner_turn_is_the_dominant_term():
    """With bins sharded, the all_to_all moves each device's full local
    spectra — the O(num_samp) term."""
    xla = _measure(4, 2)
    assert xla["all-to-all"] == 2 * 2 * (NUM_SAMP // NBINS // 8) * NBINS * 4
    assert xla["all-to-all"] == max(xla.values())
    assert _measure(8, 1)["all-to-all"] == 0


def test_model_scales_with_problem():
    """O() behavior of the model itself: corner-turn bytes scale with
    num_samp; the psum of the integrated product does not."""
    small = predicted_volume(nch=2, nbl=1, nbins=NBINS, num_samp=NUM_SAMP,
                             ntaps=NTAPS, mesh_time=4, mesh_freq=2)
    big = predicted_volume(nch=2, nbl=1, nbins=NBINS, num_samp=4 * NUM_SAMP,
                           ntaps=NTAPS, mesh_time=4, mesh_freq=2)
    assert big["all-to-all"] == 4 * small["all-to-all"]
    assert big["all-reduce"] == small["all-reduce"]


def test_hlo_volume_async_forms():
    """Async collectives as the GPU compiler emits them: an all-reduce-start
    result is its output (a tuple when XLA combined several all-reduces),
    permute/all-to-all -start tuples carry the operand alias and are
    halved, and -done lines never count."""
    from fxtpu.parallel.accounting import hlo_volume
    hlo = "\n".join([
        "  %ars = (f32[2,4]{1,0}, f32[8]{0}) all-reduce-start(%a, %b), "
        "replica_groups={{0,1,2,3}}, to_apply=%add",
        "  %ard = (f32[2,4]{1,0}, f32[8]{0}) all-reduce-done(%ars)",
        "  %cps = (f32[2,3,256]{2,1,0}, f32[2,3,256]{2,1,0}, u32[], u32[]) "
        "collective-permute-start(%t), source_target_pairs={{0,1}}",
        "  %cpd = f32[2,3,256]{2,1,0} collective-permute-done(%cps)",
        "  %a2a = f32[2,2,64,128]{3,2,1,0} all-to-all(%s), dimensions={3}",
    ])
    v = hlo_volume(hlo)
    assert v["all-reduce"] == (8 + 8) * 4
    assert v["collective-permute"] == 2 * 3 * 256 * 4
    assert v["all-to-all"] == 2 * 2 * 64 * 128 * 4
    with pytest.raises(NotImplementedError):
        hlo_volume("  %ags = (f32[4]{0}, f32[16]{0}) all-gather-start(%x)")


def test_collective_time_model_arithmetic():
    """The switched-NVLink time model is pinned to the volumes: all-reduce
    moves 2(n-1)/n of its bytes, a permute sends once, all-to-all
    (n-1)/n."""
    from fxtpu.parallel.accounting import predicted_collective_time
    vols = {"collective-permute": 100, "all-reduce": 800,
            "all-to-all": 400, "all-gather": 0, "reduce-scatter": 0}
    bw = 100.0
    t = predicted_collective_time(vols, 8, bw)
    want = 100 / bw + 2 * (7 / 8) * 800 / bw + (7 / 8) * 400 / bw
    assert abs(t - want) < 1e-12
    assert predicted_collective_time(vols, 1, bw) == 0.0


def test_link_bandwidth_table():
    """The H100's nominal NVLink rate is looked up by device kind; an
    unknown card is an error, never a default."""
    from fxtpu.parallel.accounting import link_bandwidth
    assert link_bandwidth("NVIDIA H100 80GB HBM3") == 450e9
    with pytest.raises(KeyError):
        link_bandwidth("cpu")


def test_scaling_efficiency_prediction_shape():
    """The prediction is consistent with its own inputs: the corner-turn
    configuration moves more bytes and so predicts a lower efficiency than
    the time-only split, and rate = n * single * efficiency."""
    from fxtpu.parallel.accounting import predicted_scaling_efficiency
    kw = dict(samples_per_s_single=20e9, nch=2, nbl=1, nbins=4096,
              num_samp=2**21, ntaps=4, n_shards=4,
              device_kind="NVIDIA H100 80GB HBM3")
    time_only = predicted_scaling_efficiency(**kw)
    corner = predicted_scaling_efficiency(mesh_freq=2, **kw)
    assert corner["volumes"]["all-to-all"] > 0
    assert time_only["volumes"]["all-to-all"] == 0
    assert 0 < corner["efficiency"] < time_only["efficiency"] <= 1
    assert np.isclose(corner["aggregate_samples_per_s"],
                      4 * 20e9 * corner["efficiency"], rtol=1e-6)
    with pytest.raises(KeyError):
        predicted_scaling_efficiency(**{**kw, "device_kind": "unknown card"})
