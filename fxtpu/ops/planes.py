"""Plane-based DSP: PFB, FSTC/X-engine, delay estimator.

These mirror the complex-dtype implementations in
``fxtpu.ops.{pfb,xengine,delay}`` exactly (tests assert parity), but operate
on :class:`~fxtpu.ops.cplx.Cplx` dual-plane reals — the representation the
production step runs in.  The FFT is ``fxtpu.ops.cfft`` (``jnp.fft``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fxtpu.ops import cfft
from fxtpu.ops.cplx import (Cplx, abs2, cconcat, cexp, cfftshift, cmean,
                            cmul, cmulconj, cpad_last, creshape, ctake,
                            czeros)

__all__ = [
    "zero_history_planes", "pfb_fir_planes", "spectrometer_planes",
    "fstc_rotate_planes", "xcorr_baselines_planes", "dc_remove_planes",
    "estimate_delay_planes",
]


def zero_history_planes(batch_shape, nbins: int, ntaps: int,
                        dtype=jnp.float32) -> Cplx:
    return czeros((*batch_shape, max(ntaps - 1, 0), nbins), dtype)


def dc_remove_planes(iq: Cplx) -> Cplx:
    """Subtract per-channel means of both components (effex.py:393-395)."""
    return Cplx(iq.re - jnp.mean(iq.re, axis=-1, keepdims=True),
                iq.im - jnp.mean(iq.im, axis=-1, keepdims=True))


def pfb_fir_planes(xp: Cplx, window2d) -> Cplx:
    """Windowed FIR across taps on planes (same math as ops.pfb.pfb_fir:
    real window times both planes).

    Both planes go through the tap loop as ONE stacked ``[2, ...]`` array
    held behind an optimization barrier.  Measured on an H100 at 32 taps
    and 8192 bins, the per-plane form compiled to one loop fusion that took
    2.1 ms per 2^21-sample block; this form takes 0.23 ms (PERF.md)."""
    ntaps, nbins = window2d.shape
    s = xp.shape[-2] - ntaps + 1
    st = jax.lax.optimization_barrier(jnp.stack([xp.re, xp.im]))
    w = window2d.astype(st.dtype)
    acc = w[0] * jax.lax.slice_in_dim(st, 0, s, axis=-2)
    for t in range(1, ntaps):
        acc = acc + w[t] * jax.lax.slice_in_dim(st, t, t + s, axis=-2)
    return Cplx(acc[0], acc[1])


def spectrometer_planes(x: Cplx, window2d, nbins: int,
                        history: Optional[Cplx] = None
                        ) -> Tuple[Cplx, Cplx]:
    """Streaming PFB spectrometer on planes: returns (spectra, new_history).
    Framing contract identical to ops.pfb.spectrometer_poly_stream."""
    ntaps = window2d.shape[0]
    nsamp = x.shape[-1]
    s = nsamp // nbins
    batch = x.shape[:-1]
    rows = creshape(x[..., : s * nbins], (*batch, s, nbins))
    if ntaps > 1:
        if history is None:
            history = zero_history_planes(batch, nbins, ntaps, x.dtype)
        xp = cconcat([history, rows], axis=-2)
        new_history = xp[..., -(ntaps - 1):, :]
    else:
        xp, new_history = rows, zero_history_planes(batch, nbins, ntaps,
                                                    x.dtype)
    fir = pfb_fir_planes(xp, window2d)
    return cfft.fft(fir), new_history


def pack_delays(delays, frequency) -> np.ndarray:
    """Host-side float64 packing of per-channel delays for full-precision
    FSTC: ``[..., nch]`` seconds -> ``[..., nch, 2]`` of
    ``(delay, frac(frequency * delay))``.

    The ramp's phase ``2 pi f_RF d`` reaches thousands of cycles
    (1.42 GHz x microsecond delays); evaluated from a plain f32 delay the
    trig argument carries ~2.4e-4 rad of rounding.  With the carrier
    cycles reduced modulo 1 in float64 on the host (delays change only at
    (re)calibration — per block only in TEST mode — so this is off the
    hot path), the in-graph argument is ``frac + f_base*d`` = O(1) cycles
    and f32 trig is accurate to ~1e-6.  Every rotation consumer accepts
    both forms."""
    d = np.asarray(delays, np.float64)
    frac = np.mod(frequency * d, 1.0)
    return np.stack([d.astype(np.float32), frac.astype(np.float32)],
                    axis=-1)


def _unpack_delays(delays, nch_ndim: int):
    """(d, frac_or_None): accepts plain [..., nch] or packed [..., nch, 2]
    (``nch_ndim`` = the plain form's ndim)."""
    d = jnp.asarray(delays, jnp.float32)
    if d.ndim == nch_ndim + 1 and d.shape[-1] == 2:
        return d[..., 0], d[..., 1]
    return d, None


def fstc_rotate_planes(spectra: Cplx, delays, bandwidth, frequency) -> Cplx:
    """Per-channel FSTC phase ramp exp(+2 pi j f_RF d_c) (see
    ops.xengine.fstc_rotate; effex.py:516-520 contract).

    ``delays``: plain ``[nch]`` seconds, or the ``[nch, 2]`` packed form
    from :func:`pack_delays` (full-precision carrier phase)."""
    nbins = spectra.shape[-1]
    d, frac = _unpack_delays(delays, 1)
    fbase = np.fft.fftfreq(nbins, d=1.0 / bandwidth)
    fr = (fbase if frac is not None else fbase + frequency).astype(np.float32)
    freqs = jnp.asarray(fr)
    if frac is not None:
        phase = (2.0 * np.pi) * (freqs[None, :] * d[:, None]
                                 + frac[:, None])
    else:
        # plain form: keep the reference expression's evaluation order
        # ((2*pi*f) * d) bit-for-bit with the complex-impl oracle
        phase = (2.0 * np.pi) * freqs[None, :] * d[:, None]
    rot = cexp(phase)  # [nch, nbins]
    rot = Cplx(rot.re[:, None, :], rot.im[:, None, :])
    return cmul(spectra, rot)


#: Baseline count at/above which the X-stage switches from per-pair
#: gathers to the Gram-matrix matmul.  Per-pair materializes two
#: [nbl, frames, nbins] arrays (HBM traffic grows with nbl); the Gram form
#: reads the spectrum exactly twice and contracts frames in one batched
#: dot (traffic constant in nbl).  The 2-channel single-baseline case
#: keeps the cheap elementwise form.
_GRAM_MIN_BASELINES = 4

#: Precision of the Gram X-stage's f32 dots.  Named explicitly: on the GPU
#: the default f32 dot runs in TF32 (~3 decimal digits), which the float64
#: reference comparison does not accept (PERF.md).
GRAM_PRECISION = jax.lax.Precision.HIGHEST


def _xcorr_gram(spectra: Cplx, pairs) -> Cplx:
    """All-pair visibilities via a per-bin Gram matmul.

    G[b, p, q] = sum_s spec[p, s, b] * conj(spec[q, s, b]) — one
    dot_general with the frame axis contracted and the bin axis batched
    (complex product expanded over the two real planes: 4 real matmuls,
    at :data:`GRAM_PRECISION`), then the requested [nbl] (p, q) entries are
    gathered from the tiny [nbins, nch, nch] result."""
    n_frames = spectra.shape[-2]
    kw = dict(dimension_numbers=(((1,), (1,)), ((2,), (2,))),
              precision=GRAM_PRECISION,
              preferred_element_type=jnp.float32)
    # [p, s, b] x [q, s, b] -> [b, p, q]
    rr = jax.lax.dot_general(spectra.re, spectra.re, **kw)
    ii = jax.lax.dot_general(spectra.im, spectra.im, **kw)
    ir = jax.lax.dot_general(spectra.im, spectra.re, **kw)
    ri = jax.lax.dot_general(spectra.re, spectra.im, **kw)
    g = Cplx((rr + ii) / n_frames, (ir - ri) / n_frames)
    pairs = jnp.asarray(pairs)
    sel = ctake(creshape(g, (g.shape[0], -1)),
                pairs[:, 0] * spectra.shape[0] + pairs[:, 1], axis=-1)
    return Cplx(sel.re.T, sel.im.T)  # [nbl, nbins]


def xcorr_baselines_planes(spectra: Cplx, pairs, shift: bool = True) -> Cplx:
    """All-baseline frame-averaged cross power, fftshifted
    (ops.xengine.xcorr_baselines parity).  ``shift=False`` skips the
    fftshift (the sharded step shifts the global bin-sharded result)."""
    pairs = jnp.asarray(pairs)
    if len(pairs) >= _GRAM_MIN_BASELINES:
        xps = _xcorr_gram(spectra, pairs)
    else:
        gp = ctake(spectra, pairs[:, 0], axis=0)
        gq = ctake(spectra, pairs[:, 1], axis=0)
        xps = cmean(cmulconj(gp, gq), axis=-2)
    return cfftshift(xps, axes=-1) if shift else xps


def estimate_delay_planes(iq0: Cplx, iq1: Cplx, rate):
    """Sub-sample delay estimate on planes (ops.delay.estimate_delay_gaussian
    parity: pad-2n FFT xcorr, fftshift, argmax, 3-pt Gaussian interp with
    edge clamping)."""
    n = iq0.shape[-1]
    f0 = cfft.fft(cpad_last(iq0, n))
    f1 = cfft.fft(cpad_last(iq1, n))
    xc = cfft.ifft(cmulconj(f0, f1))
    mag2 = jnp.fft.fftshift(abs2(xc), axes=-1)
    imax = jnp.argmax(mag2, axis=-1)
    ic = jnp.clip(imax, 1, 2 * n - 2)
    m_prev = jnp.take_along_axis(mag2, (ic - 1)[..., None], axis=-1)[..., 0]
    m_best = jnp.take_along_axis(mag2, ic[..., None], axis=-1)[..., 0]
    m_next = jnp.take_along_axis(mag2, (ic + 1)[..., None], axis=-1)[..., 0]
    tiny = jnp.finfo(mag2.dtype).tiny
    # log|x| = 0.5*log|x|^2 — constant 0.5 cancels in the ratio
    lp = jnp.log(jnp.maximum(m_prev, tiny))
    lb = jnp.log(jnp.maximum(m_best, tiny))
    ln = jnp.log(jnp.maximum(m_next, tiny))
    denom = lp - 2.0 * lb + ln
    delta = jnp.where(jnp.abs(denom) > 0.0,
                      0.5 * (lp - ln) / jnp.where(denom == 0.0, 1.0, denom),
                      0.0)
    lag = n - (ic.astype(jnp.float32) + delta)
    return lag / rate
