"""K-blocks-per-dispatch ``multi_step`` against the float64 NumPy reference
over channel counts, product modes and ingest widths, plus checks of the
reference itself that do not go through the device step."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from fxtpu import reference
from fxtpu.config import CorrelatorConfig
from fxtpu.fx import FxEngine
from fxtpu.ops.cplx import to_complex
from fxtpu.ops.planes import pack_delays
from fxtpu.ops.window import pfb_window

from test_reference_step import TOL, correlated

REF_PATH = Path(reference.__file__)


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("mode", ["SPECTRUM", "CONTINUUM", "TEST"])
@pytest.mark.parametrize("nchan,autos", [(2, False), (3, False), (8, True)])
def test_multi_step_matches_reference(nchan, autos, mode, ingest):
    """Three chained blocks in one dispatch, per-block delays (as the TEST
    sweep sends them), all baselines, autos included at 8 inputs."""
    cfg = CorrelatorConfig(mode=mode, nchan=nchan, include_autos=autos,
                           nbins=256, ntaps=4, num_samp=256 * 16,
                           clamp_num_samp=False, ingest_dtype=ingest)
    k = 3
    rng = np.random.default_rng(nchan * 10 + k)
    blocks = correlated(rng, nchan, cfg.num_samp, k, ingest == "int8",
                        cfg.quant_step)
    d_sec = np.array([[0.0] + [1e-7 * (c + i) for c in range(1, nchan)]
                      for i in range(k)])
    eng = FxEngine(cfg)
    vis, hist = eng.multi_step(
        eng.prepare_batch(blocks),
        jnp.asarray(pack_delays(d_sec, cfg.frequency)), eng.fresh_history())
    want = reference.fx_blocks(blocks, eng.window2d, eng.pairs,
                               bandwidth=cfg.bandwidth,
                               frequency=cfg.frequency, delays=d_sec,
                               mode=mode, quant_step=cfg.quant_step)
    got = to_complex(vis)
    nbl = nchan * (nchan - 1) // 2 + (nchan if autos else 0)
    assert got.shape == want.shape
    assert got.shape[:2] == (k, nbl)
    assert reference.max_rel_error(got, want) < TOL
    # the carried history is the last block's DC-removed tail rows
    last = reference._as_samples(blocks[-1], cfg.quant_step)
    last = last - last.mean(axis=-1, keepdims=True)
    np.testing.assert_allclose(
        to_complex(hist),
        last[:, -(cfg.ntaps - 1) * cfg.nbins:].reshape(nchan, -1, cfg.nbins),
        atol=1e-5 * np.abs(last).max())


def test_reference_module_imports_without_jax():
    """The reference is independent of the code under test: it loads and
    runs with NumPy alone."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('ref', {str(REF_PATH)!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "import numpy as np\n"
        "v, h = m.fx_block(np.ones((2, 64), complex), np.ones((2, 16)),\n"
        "                  m.baseline_pairs(2), bandwidth=1.0, frequency=0.0,\n"
        "                  delays=[0.0, 0.0])\n"
        "assert 'jax' not in sys.modules\n"
        "print(v.shape, h.shape)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "(1, 16) (2, 1, 16)"


def test_reference_history_is_stream_continuous():
    """With zero-mean blocks (DC removal a no-op), two chained blocks equal
    one block twice as long: the carried rows are exactly the frames the
    FIR needs across the boundary."""
    rng = np.random.default_rng(1)
    nbins, ntaps = 64, 4
    w = pfb_window(ntaps, nbins).reshape(ntaps, nbins)
    pairs = reference.baseline_pairs(2, include_autos=True)
    x = rng.normal(size=(2, 2 * 32 * nbins)) \
        + 1j * rng.normal(size=(2, 2 * 32 * nbins))
    a, b = x[:, : 32 * nbins], x[:, 32 * nbins:]
    a -= a.mean(axis=-1, keepdims=True)
    b -= b.mean(axis=-1, keepdims=True)
    kw = dict(bandwidth=2.4e6, frequency=1.4e9, delays=[0.0, 2e-7])
    va, h = reference.fx_block(a, w, pairs, **kw)
    vb, _ = reference.fx_block(b, w, pairs, history=h, **kw)
    whole, _ = reference.fx_block(np.concatenate([a, b], axis=1), w, pairs,
                                  **kw)
    np.testing.assert_allclose((va + vb) / 2, whole, rtol=1e-12, atol=1e-12)


def test_reference_fir_matches_convolution():
    """The FIR is, per bin, a convolution along frames with the reversed
    tap column of the window (independent statement via np.convolve)."""
    rng = np.random.default_rng(2)
    nbins, ntaps, s = 16, 4, 10
    w = rng.normal(size=(ntaps, nbins))
    x = rng.normal(size=(1, s * nbins)) + 1j * rng.normal(size=(1, s * nbins))
    x -= x.mean()
    vis, _ = reference.fx_block(x, w, np.array([[0, 0]]), bandwidth=1.0,
                                frequency=0.0, delays=[0.0])
    rows = x.reshape(s, nbins)
    fir = np.stack([np.convolve(np.r_[np.zeros(ntaps - 1), rows[:, b]],
                                w[::-1, b], mode="valid")
                    for b in range(nbins)], axis=1)
    spec = np.fft.fft(fir, axis=-1)
    want = np.fft.fftshift((np.abs(spec) ** 2).mean(axis=0))
    np.testing.assert_allclose(vis[0], want, rtol=1e-10)


def test_reference_tone_and_delay():
    """A complex tone lands in its fftshifted bin, and a pure delay shows as
    the FSTC phase 2*pi*f*d on the cross product."""
    nbins, ntaps, s = 128, 4, 64
    n = nbins * s
    k0 = 10
    t = np.arange(n)
    tone = np.exp(2j * np.pi * k0 * t / nbins)
    x = np.stack([tone, tone])
    w = pfb_window(ntaps, nbins).reshape(ntaps, nbins)
    d = 1.5e-7
    bw, fc = 2.4e6, 1.4204e9
    vis, _ = reference.fx_block(x + 0.0, w, np.array([[0, 1]]),
                                bandwidth=bw, frequency=fc,
                                delays=[0.0, d])
    # DC removal takes the tone's mean (zero over whole cycles) only
    peak = int(np.argmax(np.abs(vis[0])))
    assert peak == nbins // 2 + k0
    f = np.fft.fftshift(np.fft.fftfreq(nbins, 1 / bw)) + fc
    assert abs(np.angle(vis[0, peak] * np.exp(2j * np.pi * f[peak] * d))) \
        < 1e-9
    cont, _ = reference.fx_block(x, w, np.array([[0, 1]]), bandwidth=bw,
                                 frequency=fc, delays=[0.0, d],
                                 mode="CONTINUUM")
    np.testing.assert_allclose(cont, vis.mean(axis=-1) / bw, rtol=1e-12)


def test_reference_dequantize():
    q = np.array([[[1, -2], [127, -127]]], np.int8)
    np.testing.assert_array_equal(reference.dequantize(q, 0.5),
                                  [[0.5 - 1j, 63.5 - 63.5j]])
