"""F-stage: polyphase filterbank spectrometer (windowed FIR branches + FFT).

JAX replacement for the reference's cuSignal CUDA channelizer
(``cusignal.filtering.channelize_poly`` at ``/root/reference/effex/effex.py:553``).
Rather than translating that kernel, the PFB is expressed as the classic
weighted overlap-add decomposition, which maps directly onto XLA:

  1. reshape the 1-D stream into rows of ``nbins`` samples,
  2. windowed FIR across ``ntaps`` consecutive rows per output frame
     (a ``ntaps``-point stencil along the row axis, fused by XLA),
  3. one batched ``nbins``-point FFT per frame (``jnp.fft``, cuFFT on the
     GPU).

Framing contract (the reference leaves this implicit inside cuSignal, and its
own pad expression is a no-op — ``effex.py:551``): each input block of
``num_samp`` samples yields ``floor(num_samp / nbins)`` output frames; frame
``k`` consumes input rows ``k-ntaps+1 .. k`` with zeros (or carried history,
for streaming) standing in for rows before the block start.  Tail samples
beyond the last full row are dropped.  This reproduces the reference's
windows-per-chunk count and zero-history chunk starts while making streaming
continuity possible (SURVEY.md "hard parts": PFB block boundaries).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "frame_blocks",
    "pfb_fir",
    "spectrometer_poly",
    "spectrometer_poly_stream",
    "zero_history",
]


def zero_history(batch_shape, nbins: int, ntaps: int, dtype=jnp.complex64):
    """Fresh (all-zero) tap history: the state carried between streaming
    blocks, shape ``[..., ntaps-1, nbins]``."""
    return jnp.zeros((*batch_shape, max(ntaps - 1, 0), nbins), dtype=dtype)


def frame_blocks(x, nbins: int, ntaps: int, history=None):
    """Reshape ``x [..., nsamp]`` into PFB rows with tap history prepended.

    Returns ``(xp, new_history)`` where ``xp`` has shape
    ``[..., S + ntaps - 1, nbins]`` with ``S = nsamp // nbins`` data rows,
    and ``new_history`` is the trailing ``ntaps-1`` rows to feed into the
    next block for seamless streaming.
    """
    nsamp = x.shape[-1]
    s = nsamp // nbins
    if s < 1:
        raise ValueError(
            f"block of {nsamp} samples is shorter than one row of {nbins}")
    batch = x.shape[:-1]
    xr = x[..., : s * nbins].reshape(*batch, s, nbins)
    if ntaps == 1:
        return xr, zero_history(batch, nbins, ntaps, x.dtype)
    if history is None:
        history = zero_history(batch, nbins, ntaps, x.dtype)
    xp = jnp.concatenate([history.astype(x.dtype), xr], axis=-2)
    new_history = xp[..., -(ntaps - 1):, :]
    return xp, new_history


def pfb_fir(xp, window2d):
    """Windowed FIR across taps: ``y[..., k, b] = sum_t w[t, b] * xp[..., k+t, b]``.

    ``xp``: ``[..., S + ntaps - 1, nbins]`` (complex), ``window2d``:
    ``[ntaps, nbins]`` (real).  Returns ``[..., S, nbins]``.
    """
    ntaps, nbins = window2d.shape
    s = xp.shape[-2] - ntaps + 1
    w = window2d.astype(_real_dtype(xp.dtype))
    acc = w[0] * jax.lax.slice_in_dim(xp, 0, s, axis=-2)
    for t in range(1, ntaps):
        acc = acc + w[t] * jax.lax.slice_in_dim(xp, t, t + s, axis=-2)
    return acc


def _real_dtype(cdtype):
    return jnp.float64 if jnp.dtype(cdtype) == jnp.complex128 else jnp.float32


def _as_window2d(window, nbins: int):
    window = jnp.asarray(window)
    if window.ndim == 1:
        if window.shape[0] % nbins:
            raise ValueError(
                f"window length {window.shape[0]} not a multiple of nbins {nbins}")
        window = window.reshape(-1, nbins)
    return window


@functools.partial(jax.jit, static_argnames=("nbins",))
def spectrometer_poly(x, window, nbins: int):
    """Stateless (per-block) PFB spectrometer, reference-parity behavior.

    Parameters mirror ``Correlator._spectrometer_poly`` (``effex.py:530-555``):
    ``x [..., nsamp]`` complex samples, ``window`` the length ``ntaps*nbins``
    prototype filter (see ``fxtpu.ops.window.pfb_window``).  Returns complex
    spectra ``[..., S, nbins]`` in ``fftfreq`` bin order (positive tone at
    positive ``fftfreq`` bin, matching the reference test oracle at
    ``tests/test_effex.py:80-84``).
    """
    spectra, _ = spectrometer_poly_stream(x, window, nbins, history=None)
    return spectra


def spectrometer_poly_stream(x, window, nbins: int, history=None):
    """Streaming PFB step: like :func:`spectrometer_poly` but carries tap
    history across blocks so frame continuity is preserved at block
    boundaries (the reference drops this history every chunk)."""
    window2d = _as_window2d(window, nbins)
    ntaps = window2d.shape[0]
    xp, new_history = frame_blocks(x, nbins, ntaps, history)
    fir = pfb_fir(xp, window2d)
    spectra = jnp.fft.fft(fir, axis=-1)
    return spectra, new_history
