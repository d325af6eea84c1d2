"""Mesh-sharded execution on an 8-device virtual CPU mesh: the sharded step
(halo exchange + corner turn + psum) must match the single-device step and
the float64 reference, and streaming history must flow across both block
and shard boundaries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fxtpu.config import CorrelatorConfig
from fxtpu.fx import FxEngine
from fxtpu.ops.cplx import Cplx, to_complex
from fxtpu.parallel import make_correlator_mesh, validate_shapes


def as_c(x):
    return to_complex(x) if isinstance(x, Cplx) else np.asarray(x)


def _cfg(**kw):
    kw.setdefault("num_samp", 2**14)
    kw.setdefault("nbins", 256)
    kw.setdefault("clamp_num_samp", False)
    return CorrelatorConfig(**kw)


def _inputs(cfg, seed=0, d=3.3e-7):
    eng = FxEngine(cfg)
    iq, _, hist = eng.example_inputs(seed)
    delays = jnp.asarray([0.0] + [d] * (cfg.nchan - 1), dtype=jnp.float32)
    return eng, iq, delays, hist


@pytest.mark.parametrize("t,f", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)])
@pytest.mark.parametrize("mode", ["SPECTRUM", "CONTINUUM"])
def test_sharded_matches_single_device(t, f, mode):
    cfg = _cfg(mode=mode)
    eng1, iq, delays, hist = _inputs(cfg)
    v1, h1 = eng1.step(iq, delays, hist)
    mesh = make_correlator_mesh(t, f)
    engN = FxEngine(cfg, mesh=mesh)
    vN, hN = engN.step(iq, delays, engN.fresh_history())
    np.testing.assert_allclose(as_c(vN), as_c(v1),
                               rtol=5e-4, atol=5e-7)
    np.testing.assert_allclose(as_c(hN), as_c(h1),
                               rtol=1e-5, atol=1e-7)


def test_sharded_nchan8_baselines():
    cfg = _cfg(nchan=8, mode="SPECTRUM", include_autos=True)
    eng1, iq, delays, hist = _inputs(cfg, seed=7)
    v1, _ = eng1.step(iq, delays, hist)
    assert v1.shape == (36, cfg.nbins)  # 8 inputs -> 36 baselines w/ autos
    mesh = make_correlator_mesh(4, 2)
    engN = FxEngine(cfg, mesh=mesh)
    vN, _ = engN.step(iq, delays, engN.fresh_history())
    np.testing.assert_allclose(as_c(vN), as_c(v1),
                               rtol=5e-4, atol=5e-7)


def test_sharded_streaming_history():
    """History produced by the sharded step feeds the next sharded block
    identically to the single-device chain."""
    cfg = _cfg()
    mesh = make_correlator_mesh(4, 2)
    eng1 = FxEngine(cfg)
    engN = FxEngine(cfg, mesh=mesh)
    rng = np.random.default_rng(11)
    blocks = [eng1.prepare_block(
        (rng.normal(size=(2, cfg.num_samp))
         + 1j * rng.normal(size=(2, cfg.num_samp))).astype(np.complex64))
        for _ in range(3)]
    delays = jnp.asarray([0.0, 1e-7], dtype=jnp.float32)
    h1, hN = eng1.fresh_history(), engN.fresh_history()
    for blk in blocks:
        v1, h1 = eng1.step(blk, delays, h1)
        vN, hN = engN.step(blk, delays, hN)
        np.testing.assert_allclose(as_c(vN), as_c(v1),
                                   rtol=5e-4, atol=5e-7)


def test_validate_shapes():
    mesh = make_correlator_mesh(4, 2)
    rows, bins = validate_shapes(2**14, 256, mesh)
    assert rows == 8 and bins == 128
    with pytest.raises(ValueError):
        validate_shapes(2**14, 100, mesh)      # bins not divisible by freq
    with pytest.raises(ValueError):
        validate_shapes(256 * 12, 256, mesh)   # rows not divisible by 8


def test_mesh_construction():
    mesh = make_correlator_mesh(0, 2)  # all devices
    assert mesh.shape["time"] * mesh.shape["freq"] == len(jax.devices())
    with pytest.raises(ValueError):
        make_correlator_mesh(16, 2)


def test_single_tap_pfb_sharded():
    """ntaps=1 (plain windowed FFT) has no halo; must still work sharded."""
    cfg = _cfg(ntaps=1)
    eng1, iq, delays, hist = _inputs(cfg)
    v1, _ = eng1.step(iq, delays, hist)
    engN = FxEngine(cfg, mesh=make_correlator_mesh(4, 2))
    vN, _ = engN.step(iq, delays, engN.fresh_history())
    np.testing.assert_allclose(as_c(vN), as_c(v1),
                               rtol=5e-4, atol=5e-7)


def test_int8_sharded_matches_f32_mesh_within_quant():
    """int8 mesh ingest (int8 planes sample-sharded, dequantized in-graph)
    == f32 mesh fed the SAME quantized values (dequantized host-side):
    identical math at quantized precision, so agreement is float
    tolerance, not quantization tolerance."""
    cfg8 = _cfg(mode="SPECTRUM", ingest_dtype="int8")
    cfg = _cfg(mode="SPECTRUM")
    rng = np.random.default_rng(5)
    raw = rng.integers(-127, 128, size=(2, cfg.num_samp, 2)).astype(np.int8)
    cplx = ((raw[..., 0].astype(np.float32)
             + 1j * raw[..., 1].astype(np.float32))
            * cfg8.quant_step).astype(np.complex64)
    delays = jnp.asarray([0.0, 1e-7], dtype=jnp.float32)
    mesh = make_correlator_mesh(4, 2)
    eng8 = FxEngine(cfg8, mesh=mesh)
    engf = FxEngine(cfg, mesh=mesh)
    v8, _ = eng8.step(eng8.prepare_block(raw), delays, eng8.fresh_history())
    vf, _ = engf.step(engf.prepare_block(cplx), delays, engf.fresh_history())
    scale = np.abs(as_c(vf)).max()
    np.testing.assert_allclose(as_c(v8), as_c(vf), atol=3e-5 * scale)


def _k_blocks(cfg, k, seed=13, int8=False):
    rng = np.random.default_rng(seed)
    if int8:
        return [rng.integers(-127, 128, size=(cfg.nchan, cfg.num_samp, 2)
                             ).astype(np.int8) for _ in range(k)]
    return [(rng.normal(size=(cfg.nchan, cfg.num_samp))
             + 1j * rng.normal(size=(cfg.nchan, cfg.num_samp))
             ).astype(np.complex64) for _ in range(k)]


def test_sharded_multi_step_xla_scan():
    """The mesh path batches via lax.scan of the per-block sharded step —
    any K, stacked layout."""
    cfg = _cfg(mode="SPECTRUM")
    mesh = make_correlator_mesh(4, 2)
    eng = FxEngine(cfg, mesh=mesh)
    k = eng.dispatch_batch_for(5)
    assert k == 5  # scan path takes any K
    blocks = _k_blocks(cfg, k, seed=21)
    delays = jnp.zeros((k, cfg.nchan), jnp.float32).at[:, 1].set(3e-7)
    vis_m, hist_m = eng.multi_step(eng.prepare_batch(blocks), delays,
                                   eng.fresh_history())
    hist = eng.fresh_history()
    for i, b in enumerate(blocks):
        v, hist = eng.step(eng.prepare_block(b), delays[i], hist)
        np.testing.assert_allclose(as_c(vis_m)[i], as_c(v),
                                   rtol=5e-5, atol=1e-7)
    np.testing.assert_allclose(as_c(hist_m), as_c(hist),
                               rtol=1e-5, atol=1e-7)


def test_dispatch_batch_for_rounds_to_shard_multiple():
    """Single-process engines, mesh or not, batch any K (the sharded multi
    step is a scan of whole blocks, so no shard-count multiple is
    needed); K <= 1 means per-block dispatch."""
    cfg = _cfg()
    mesh = make_correlator_mesh(4, 2)
    eng = FxEngine(cfg, mesh=mesh)
    assert eng.dispatch_batch_for(21) == 21
    assert eng.dispatch_batch_for(7) == 7
    assert eng.dispatch_batch_for(1) == 1
    eng1 = FxEngine(cfg)
    assert eng1.dispatch_batch_for(21) == 21  # single device: any K
    assert FxEngine(cfg, impl="complex").dispatch_batch_for(21) == 1


def test_sharded_multi_step_int8():
    """int8 ingest through the sharded K-block dispatch == K sequential
    sharded steps."""
    cfg = _cfg(mode="SPECTRUM", ingest_dtype="int8")
    mesh = make_correlator_mesh(2, 4)
    eng = FxEngine(cfg, mesh=mesh)
    k = 3
    blocks = _k_blocks(cfg, k, int8=True)
    delays = jnp.zeros((k, cfg.nchan), jnp.float32).at[:, 1].set(1e-7)
    vis_m, hist_m = eng.multi_step(eng.prepare_batch(blocks), delays,
                                   eng.fresh_history())
    hist = eng.fresh_history()
    for i, b in enumerate(blocks):
        v, hist = eng.step(eng.prepare_block(b), delays[i], hist)
        np.testing.assert_allclose(as_c(vis_m)[i], as_c(v),
                                   rtol=5e-5, atol=1e-7)
    np.testing.assert_allclose(as_c(hist_m), as_c(hist),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("ntaps", [4, 32])
@pytest.mark.parametrize("t,f", [(8, 1), (4, 2), (2, 2)])
def test_deep_tap_sharded_matches_single_device(t, f, ntaps):
    """Deep-tap PFBs across the mesh: the (ntaps-1)-row halo spans most of
    each shard's rows at 32 taps.  Two streamed blocks, sharded == single
    device == the float64 reference."""
    from fxtpu import reference
    from fxtpu.ops.planes import pack_delays

    nbins = 128
    cfg = _cfg(num_samp=nbins * 256, nbins=nbins, ntaps=ntaps)
    rng = np.random.default_rng(ntaps + 10 * t)
    common = rng.normal(size=(2, cfg.num_samp)) \
        + 1j * rng.normal(size=(2, cfg.num_samp))
    blocks = [(common[i] + rng.normal(size=(2, cfg.num_samp))
               + 1j * rng.normal(size=(2, cfg.num_samp))
               ).astype(np.complex64) for i in range(2)]
    d_sec = np.array([0.0, 4.1e-7])
    delays = jnp.asarray(pack_delays(d_sec, cfg.frequency))
    eng1 = FxEngine(cfg)
    engN = FxEngine(cfg, mesh=make_correlator_mesh(t, f))
    h1, hN = eng1.fresh_history(), engN.fresh_history()
    got = []
    for b in blocks:
        v1, h1 = eng1.step(eng1.prepare_block(b), delays, h1)
        vN, hN = engN.step(engN.prepare_block(b), delays, hN)
        scale = np.abs(as_c(v1)).max()
        np.testing.assert_allclose(as_c(vN), as_c(v1), atol=2e-5 * scale)
        np.testing.assert_allclose(as_c(hN), as_c(h1), atol=1e-6)
        got.append(as_c(vN))
    want = reference.fx_blocks(blocks, eng1.window2d, eng1.pairs,
                               bandwidth=cfg.bandwidth,
                               frequency=cfg.frequency, delays=d_sec)
    assert reference.max_rel_error(np.stack(got), want) < 1e-5
