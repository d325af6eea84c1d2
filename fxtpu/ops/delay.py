"""Inter-channel delay estimation: FFT cross-correlation + sub-sample peak.

Fully jittable JAX reimplementation of the reference estimator
(``/root/reference/effex/effex.py:558-627``):

  * zero-pad both series to 2n,
  * circular cross-correlation via ``ifft(fft(a) * conj(fft(b)))`` + fftshift,
  * integer peak by argmax of the magnitude,
  * sub-sample refinement via the 3-point Gaussian (log-parabolic)
    interpolator (DOI 10.1007/978-3-642-58288-2_15),
  * ``delay = (n - (imax + delta)) / rate``.

Differences from the reference (deliberate, see SURVEY.md §2.4):
  * the peak index is clamped to the interior so an argmax at index 0 or
    2n-1 cannot read out of bounds (reference TODO at ``effex.py:619``);
  * log arguments are floored at a tiny epsilon and a vanishing denominator
    yields delta=0 instead of NaN;
  * everything is traced (no host sync at the argmax), so calibration can
    run in-graph and feed the X-engine phase ramp without a recompile.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["estimate_delay_gaussian", "estimate_delay", "xcorr_mag"]


def xcorr_mag(iq_0, iq_1):
    """fftshifted magnitude of the zero-padded circular cross-correlation
    of two equal-length complex series (``effex.py:604-614``)."""
    if iq_0.shape != iq_1.shape:
        raise ValueError("Algorithm assumes input complex timeseries "
                         "are of equal length.")
    n = iq_0.shape[-1]
    pad = [(0, 0)] * (iq_0.ndim - 1) + [(0, n)]
    f0 = jnp.fft.fft(jnp.pad(iq_0, pad))
    f1 = jnp.fft.fft(jnp.pad(iq_1, pad))
    xcorr = jnp.fft.ifft(f0 * jnp.conj(f1))
    return jnp.abs(jnp.fft.fftshift(xcorr, axes=-1))


@jax.jit
def estimate_delay_gaussian(iq_0, iq_1, rate):
    """Sub-sample delay estimate between two channels, in seconds.

    Positive result means ``iq_1`` lags ``iq_0`` (same sign convention as
    the reference: ``iq_1 = roll(iq_0, +k)`` estimates ``+k/rate``,
    ``tests/test_effex.py:100-106``).
    """
    n = iq_0.shape[-1]
    mag = xcorr_mag(iq_0, iq_1)
    imax = jnp.argmax(mag, axis=-1)
    # Clamp to the interior so the 3-point stencil stays in bounds
    # (fixes the reference OOB at effex.py:619-622).
    ic = jnp.clip(imax, 1, 2 * n - 2)
    xprev = jnp.take_along_axis(mag, (ic - 1)[..., None], axis=-1)[..., 0]
    xbest = jnp.take_along_axis(mag, ic[..., None], axis=-1)[..., 0]
    xnext = jnp.take_along_axis(mag, (ic + 1)[..., None], axis=-1)[..., 0]
    tiny = jnp.finfo(mag.dtype).tiny
    lp = jnp.log(jnp.maximum(xprev, tiny))
    lb = jnp.log(jnp.maximum(xbest, tiny))
    ln = jnp.log(jnp.maximum(xnext, tiny))
    denom = lp - 2.0 * lb + ln
    delta = jnp.where(jnp.abs(denom) > 0.0,
                      0.5 * (lp - ln) / jnp.where(denom == 0.0, 1.0, denom),
                      0.0)
    lag = n - (ic.astype(mag.dtype) + delta)
    return lag / rate


def estimate_delay(iq_0, iq_1, rate, test_offset=0.0):
    """Wrapper matching ``Correlator._estimate_delay`` (``effex.py:558-580``):
    in TEST mode the artificial sweep offset is subtracted so the sweep
    starts from a known negative delay."""
    return estimate_delay_gaussian(iq_0, iq_1, rate) - test_offset
