"""Dual-plane path: the planes FFT against numpy, and the planes
implementation against the complex implementation for every stage and for
the full step.  This is the representation the production step runs in, so
parity here is what makes the CPU oracle suite meaningful for the GPU."""

import jax.numpy as jnp
import numpy as np
import pytest

from fxtpu.config import CorrelatorConfig
from fxtpu.fx import FxEngine
from fxtpu.ops import cfft
from fxtpu.ops.cplx import from_complex, to_complex
from fxtpu.ops import planes as pl_ops
from fxtpu.ops.pfb import spectrometer_poly
from fxtpu.ops.window import pfb_window
from fxtpu.ops.delay import estimate_delay_gaussian
from fxtpu.sources.synthetic import complex_noise, fractional_delay


# ---------------------------------------------------------------------------
# planes FFT vs numpy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [8, 128, 256, 4096, 2**16,
                               4099,            # prime -> Bluestein
                               3 + 2**12,       # reference's odd block size
                               2 * (3 + 2**12)  # delay-estimator pad of it
                               ])
def test_cfft_matches_numpy(rng, n):
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
    got = to_complex(cfft.fft(from_complex(x)))
    want = np.fft.fft(x)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=3e-6 * scale)
    got_i = to_complex(cfft.ifft(from_complex(x)))
    want_i = np.fft.ifft(x)
    np.testing.assert_allclose(got_i, want_i,
                               atol=3e-6 * np.abs(want_i).max())


def test_cfft_batched(rng):
    x = (rng.normal(size=(3, 5, 64)) + 1j * rng.normal(size=(3, 5, 64))
         ).astype(np.complex64)
    got = to_complex(cfft.fft(from_complex(x)))
    np.testing.assert_allclose(got, np.fft.fft(x, axis=-1), atol=1e-4)


def test_cfft_roundtrip(rng):
    x = (rng.normal(size=4096) + 1j * rng.normal(size=4096)
         ).astype(np.complex64)
    back = to_complex(cfft.ifft(cfft.fft(from_complex(x))))
    np.testing.assert_allclose(back, x, atol=1e-5)


# ---------------------------------------------------------------------------
# plane ops vs complex reference ops
# ---------------------------------------------------------------------------
def test_spectrometer_planes_matches_complex(rng):
    nbins, ntaps = 256, 4
    x = (rng.normal(size=(2, 2**13)) + 1j * rng.normal(size=(2, 2**13))
         ).astype(np.complex64)
    w2d = jnp.asarray(pfb_window(ntaps, nbins).reshape(ntaps, nbins),
                      jnp.float32)
    want = np.asarray(spectrometer_poly(jnp.asarray(x), w2d.reshape(-1),
                                        nbins))
    got, hist = pl_ops.spectrometer_planes(from_complex(x), w2d, nbins)
    scale = np.abs(want).max()
    np.testing.assert_allclose(to_complex(got), want, atol=2e-5 * scale)
    # carried history equals the raw input tail
    np.testing.assert_allclose(
        to_complex(hist).reshape(2, -1),
        x[:, 2**13 - (ntaps - 1) * nbins:], atol=1e-6)


@pytest.mark.parametrize("offset", [-2000, -1, 0, 1, 999])
def test_delay_planes_matches_complex(rng, offset):
    rate = 2.4e6
    x = complex_noise(rng, 2**14)
    y = np.roll(x, offset)
    want = float(estimate_delay_gaussian(jnp.asarray(x), jnp.asarray(y),
                                         rate))
    got = float(pl_ops.estimate_delay_planes(from_complex(x),
                                             from_complex(y), rate))
    assert abs(got - want) * rate < 0.01      # near-identical estimates
    assert abs(offset - got * rate) < 0.5     # and the oracle itself


def test_delay_planes_odd_length_bluestein(rng):
    """The reference's 3+2^12 block pads to 2*4099 (prime factor) — the
    Bluestein path must keep the oracle."""
    rate = 2.4e6
    x = complex_noise(rng, 3 + 2**12)
    y = np.roll(x, -701)
    got = float(pl_ops.estimate_delay_planes(from_complex(x),
                                             from_complex(y), rate))
    assert abs(-701 - got * rate) < 0.5


# ---------------------------------------------------------------------------
# step parity: planes vs complex, all modes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["SPECTRUM", "CONTINUUM"])
@pytest.mark.parametrize("nchan", [2, 4])
def test_fx_step_planes_matches_complex(mode, nchan):
    cfg = CorrelatorConfig(mode=mode, nchan=nchan, num_samp=2**13,
                           nbins=256, clamp_num_samp=False)
    rng = np.random.default_rng(5)
    block = (rng.normal(size=(nchan, cfg.num_samp))
             + 1j * rng.normal(size=(nchan, cfg.num_samp))
             ).astype(np.complex64)
    delays = jnp.asarray([0.0] + [2.5e-7] * (nchan - 1), jnp.float32)

    eng_c = FxEngine(cfg, impl="complex")
    vis_c, hist_c = eng_c.step(jnp.asarray(block), delays,
                               eng_c.fresh_history())
    eng_p = FxEngine(cfg, impl="planes")
    vis_p, hist_p = eng_p.step(eng_p.prepare_block(block), delays,
                               eng_p.fresh_history())
    scale = np.abs(np.asarray(vis_c)).max()
    np.testing.assert_allclose(to_complex(vis_p), np.asarray(vis_c),
                               atol=2e-4 * scale)
    np.testing.assert_allclose(to_complex(hist_p), np.asarray(hist_c),
                               atol=1e-5)


def test_packed_delays_carrier_phase_precision(rng):
    """pack_delays reduces the carrier cycles in float64 host-side: at a
    microsecond delay (thousands of carrier cycles at 1.42 GHz) the
    visibility phase from packed delays must track an f64 oracle ~2 orders
    of magnitude tighter than the plain-f32-delay form."""
    from fxtpu.ops.planes import pack_delays
    cfg = CorrelatorConfig(mode="SPECTRUM", num_samp=2**13, nbins=256,
                           clamp_num_samp=False)
    d1 = 1.234567e-6  # ~1753 carrier cycles at 1.4204 GHz
    block = (rng.normal(size=(2, cfg.num_samp))
             + 1j * rng.normal(size=(2, cfg.num_samp))).astype(np.complex64)
    eng = FxEngine(cfg)
    iq = eng.prepare_block(block)

    vis_plain, _ = eng.step(iq, jnp.asarray([0.0, d1], jnp.float32),
                            eng.fresh_history())
    vis_packed, _ = eng.step(
        iq, jnp.asarray(pack_delays([0.0, d1], cfg.frequency)),
        eng.fresh_history())

    # f64 oracle: rotate the PLAIN-path's zero-delay visibility by the
    # exact phase and compare phases
    vis0, _ = eng.step(iq, jnp.zeros((2,), jnp.float32),
                       eng.fresh_history())
    f = np.fft.fftshift(np.fft.fftfreq(256, 1 / cfg.bandwidth)
                        ) + cfg.frequency
    want = to_complex(vis0)[0] * np.exp(-2j * np.pi * f * d1)

    def phase_err(v):
        e = np.angle(to_complex(v)[0] / want)
        return np.abs(e).max()

    err_plain = phase_err(vis_plain)
    err_packed = phase_err(vis_packed)
    assert err_packed < 1e-5
    assert err_packed < err_plain / 20


def test_calibrator_planes_matches_complex(rng):
    cfg = CorrelatorConfig(num_samp=2**14, nbins=256, clamp_num_samp=False)
    x = complex_noise(rng, cfg.num_samp, scale=1.0)
    block = np.stack([x, fractional_delay(x, 4.8)]).astype(np.complex64)
    eng_c = FxEngine(cfg, impl="complex")
    eng_p = FxEngine(cfg, impl="planes")
    d_c = np.asarray(eng_c.calibrate(jnp.asarray(block)))
    d_p = np.asarray(eng_p.calibrate(eng_p.prepare_block(block)))
    assert abs(d_c[1] - d_p[1]) * cfg.bandwidth < 0.01
    assert abs(d_p[1] * cfg.bandwidth - 4.8) < 0.3


def test_multi_step_matches_sequential():
    """K blocks scanned in one dispatch == K sequential single steps,
    including the carried history and per-block delays."""
    import jax
    from jax import tree
    cfg = CorrelatorConfig(mode="SPECTRUM", num_samp=2**13, nbins=256,
                           clamp_num_samp=False)
    eng = FxEngine(cfg)
    rng = np.random.default_rng(9)
    k = 4
    blocks = [eng.prepare_block(
        (rng.normal(size=(2, cfg.num_samp))
         + 1j * rng.normal(size=(2, cfg.num_samp))).astype(np.complex64))
        for _ in range(k)]
    delays = np.linspace(0, 1e-6, k)[:, None] * np.array([0.0, 1.0])

    hist = eng.fresh_history()
    seq_vis = []
    for i in range(k):
        v, hist = eng.step(blocks[i],
                           jnp.asarray(delays[i], jnp.float32), hist)
        seq_vis.append(to_complex(v))

    iq = tree.map(lambda *xs: jnp.stack(xs), *blocks)
    mv, mhist = eng.multi_step(iq, jnp.asarray(delays, jnp.float32),
                               eng.fresh_history())
    got = to_complex(mv)
    for i in range(k):
        np.testing.assert_allclose(got[i], seq_vis[i], atol=1e-6)
    np.testing.assert_allclose(to_complex(mhist), to_complex(hist),
                               atol=1e-7)


def test_calibrator_nchan4_distinct_delays(rng):
    """Per-channel delays against channel 0 are recovered independently."""
    cfg = CorrelatorConfig(num_samp=2**14, nbins=256, nchan=4,
                           clamp_num_samp=False)
    x = complex_noise(rng, cfg.num_samp, scale=1.0)
    true_samps = [0.0, 3.0, -7.0, 12.5]
    block = np.stack([fractional_delay(x, d) for d in true_samps]
                     ).astype(np.complex64)
    eng = FxEngine(cfg)
    d = np.asarray(eng.calibrate(eng.prepare_block(block)))
    got_samps = d * cfg.bandwidth
    # sign convention: channel c delayed by +d relative to ch0 estimates -d?
    # estimate_delay(ref=ch0, x=chc) returns how much chc lags ch0: +d.
    for c in range(4):
        assert abs(got_samps[c] - true_samps[c]) < 0.5, (c, got_samps)
