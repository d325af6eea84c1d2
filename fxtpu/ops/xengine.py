"""X-stage: fractional-sample delay correction, conjugate multiply, integrate.

JAX reimplementation of the reference's cross-power computation
(``/root/reference/effex/effex.py:497-527``), generalized from the fixed
(0, 1) channel pair to N channels with an arbitrary baseline pair map.

Math contract (reference parity for nchan=2, delays=[0, d]):

  freqs = fftfreq(nbins, 1/bandwidth) + frequency          (effex.py:516)
  rot   = exp(-2j*pi*freqs*(-d))                           (effex.py:519)
  xps   = F0 * conj(F1 * rot)                              (effex.py:520)
  vis   = fftshift(mean over frames of xps)                (effex.py:521)
  continuum: vis = mean over bins / bandwidth              (effex.py:523-524)

We factor the phase ramp per channel: G_c = F_c * exp(+2j*pi*freqs*d_c), then
V_pq = mean_k G_p conj(G_q), which reduces to the reference expression when
d_0 = 0, d_1 = d.  The fractional-sample timing correction is the standard
frequency-domain phase gradient (Thompson/Moran/Swenson 3rd ed. p.364).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "rf_freqs",
    "fstc_rotate",
    "xcorr_pair",
    "xcorr_baselines",
    "continuum_reduce",
    "baseline_pairs",
]


def rf_freqs(nbins: int, bandwidth, frequency, dtype=jnp.float32):
    """RF frequency per (unshifted) FFT bin (``effex.py:516``)."""
    return jnp.fft.fftfreq(nbins, d=1.0 / bandwidth).astype(dtype) + jnp.asarray(
        frequency, dtype)


def fstc_rotate(spectra, delays, bandwidth, frequency):
    """Apply the fractional-sample timing-correction phase ramp per channel.

    ``spectra``: ``[nch, S, nbins]`` complex; ``delays``: ``[nch]`` seconds,
    or the packed ``[nch, 2]`` (delay, frac(fc*d)) form from
    :func:`fxtpu.ops.planes.pack_delays` (traced values — updating the
    calibration does NOT recompile, see SURVEY.md "hard parts":
    data-dependent calibration in-graph).
    """
    nbins = spectra.shape[-1]
    rdtype = jnp.float64 if spectra.dtype == jnp.complex128 else jnp.float32
    delays = jnp.asarray(delays, rdtype)
    if delays.ndim == 2 and delays.shape[-1] == 2:
        # packed form: phase = 2pi*(f_base*d + frac), carrier cycles
        # pre-reduced host-side (ops.planes.pack_delays contract)
        d, frac = delays[:, 0], delays[:, 1]
        fbase = jnp.fft.fftfreq(nbins, d=1.0 / bandwidth).astype(rdtype)
        phase = 2.0 * np.pi * (fbase[None, :] * d[:, None] + frac[:, None])
    else:
        freqs = rf_freqs(nbins, bandwidth, frequency, rdtype)
        # exp(+2j*pi*f*d_c) per channel; equals the reference's conj(rot)
        # applied to channel 1 when d_0=0 (effex.py:519-520).
        phase = 2.0 * np.pi * freqs[None, :] * delays[:, None]
    rot = jax.lax.complex(jnp.cos(phase), jnp.sin(phase)).astype(spectra.dtype)
    return spectra * rot[:, None, :]


def xcorr_pair(f0, f1):
    """Cross-power for one pair: frame-averaged ``f0 * conj(f1)``, fftshifted
    to ascending-frequency bin order (``effex.py:520-521``).

    ``f0, f1``: ``[..., S, nbins]``; returns ``[..., nbins]``.
    """
    xps = jnp.mean(f0 * jnp.conj(f1), axis=-2)
    return jnp.fft.fftshift(xps, axes=-1)


def baseline_pairs(nchan: int, include_autos: bool = False) -> np.ndarray:
    """Upper-triangular baseline map: ``[n_baselines, 2]`` int array.

    For nchan=2 without autos this is the reference's single (0, 1) pair;
    for 8 inputs it is the 36-with-autos / 28-cross map (an 8-input array).
    Cross pairs are ordered (p < q) row-major; autos, if included, come first.
    """
    pairs = []
    if include_autos:
        pairs += [(c, c) for c in range(nchan)]
    pairs += [(p, q) for p in range(nchan) for q in range(p + 1, nchan)]
    return np.asarray(pairs, dtype=np.int32)


def xcorr_baselines(spectra, pairs):
    """All-baseline cross power: ``V[l] = mean_k G[p_l] conj(G[q_l])``.

    ``spectra``: ``[nch, S, nbins]`` (already FSTC-rotated);
    ``pairs``: ``[nbl, 2]`` static int array.
    Returns ``[nbl, nbins]`` fftshifted visibilities.

    For small nch the gather+elementwise form below is optimal; at large nch
    the same quantity is the per-bin rank-S update ``F_b F_b^H`` (a batched
    matmul per bin, ``fxtpu.ops.planes._xcorr_gram``).
    """
    pairs = jnp.asarray(pairs)
    gp = spectra[pairs[:, 0]]          # [nbl, S, nbins]
    gq = spectra[pairs[:, 1]]
    xps = jnp.mean(gp * jnp.conj(gq), axis=-2)
    return jnp.fft.fftshift(xps, axes=-1)


def continuum_reduce(vis, bandwidth):
    """CONTINUUM/TEST reduction: average over frequency, normalize by
    bandwidth (``effex.py:523-524``).  ``vis [..., nbins] -> [...]``."""
    return jnp.mean(vis, axis=-1) / bandwidth
