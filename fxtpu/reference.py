"""Float64 NumPy reference of the FX correlator step.

A plain, independent statement of what :class:`fxtpu.fx.FxEngine` computes,
written from the reference's math (``effex.py:391-410,497-527``) with no
JAX in it, so that device results can be compared against it at any
shape.  Per block and channel:

  1. DC removal: subtract the block's complex mean.
  2. PFB FIR: frame the first ``S*nbins`` samples as ``S = num_samp//nbins``
     rows, prepend the ``ntaps-1`` DC-removed rows carried from the previous
     block (zeros at stream start), and sum ``window2d[t] * rows[k + t]``.
  3. FFT over the bin axis.
  4. FSTC rotation ``exp(+2 pi j f d_c)``, ``f = fftfreq(nbins, 1/bw) + fc``.
  5. X stage: ``V[p, q] = mean_k G_p conj(G_q)`` per baseline, fftshifted.
  6. CONTINUUM / TEST: the mean over bins divided by the bandwidth.

int8 ingest is ``[..., num_samp, 2]`` quantized (re, im) codes at
``quant_step`` per LSB; :func:`dequantize` turns it into samples first.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["dequantize", "baseline_pairs", "fx_block", "fx_blocks",
           "max_rel_error"]


def dequantize(codes: np.ndarray, quant_step: float) -> np.ndarray:
    """int8 ``[..., n, 2]`` (re, im) codes -> complex128 samples."""
    c = np.asarray(codes, np.float64)
    return (c[..., 0] + 1j * c[..., 1]) * float(quant_step)


def baseline_pairs(nchan: int, include_autos: bool = False) -> np.ndarray:
    """Baseline order of the correlator: autos first (if any), then the
    cross pairs ``p < q`` row-major."""
    pairs = [(c, c) for c in range(nchan)] if include_autos else []
    pairs += [(p, q) for p in range(nchan) for q in range(p + 1, nchan)]
    return np.asarray(pairs, dtype=np.int64)


def _as_samples(block: np.ndarray, quant_step: float) -> np.ndarray:
    block = np.asarray(block)
    if block.dtype == np.int8:
        return dequantize(block, quant_step)
    return block.astype(np.complex128)


def fx_block(block: np.ndarray, window2d: np.ndarray, pairs: np.ndarray,
             *, bandwidth: float, frequency: float, delays: Sequence[float],
             history: Optional[np.ndarray] = None, mode: str = "SPECTRUM",
             quant_step: float = 1.0 / 32) -> Tuple[np.ndarray, np.ndarray]:
    """One block: ``block [nch, num_samp]`` complex (or int8 codes
    ``[nch, num_samp, 2]``), ``delays [nch]`` seconds, ``history
    [nch, ntaps-1, nbins]`` complex128 or None for stream start.

    Returns ``(vis, new_history)``: ``vis`` is ``[nbl, nbins]`` (SPECTRUM)
    or ``[nbl]`` (CONTINUUM/TEST), complex128."""
    x = _as_samples(block, quant_step)
    w = np.asarray(window2d, np.float64)
    ntaps, nbins = w.shape
    nch, num_samp = x.shape
    s = num_samp // nbins
    x = x - x.mean(axis=-1, keepdims=True)
    rows = x[:, : s * nbins].reshape(nch, s, nbins)
    if history is None:
        history = np.zeros((nch, ntaps - 1, nbins), np.complex128)
    xp = np.concatenate([history, rows], axis=1)
    fir = np.zeros((nch, s, nbins), np.complex128)
    for t in range(ntaps):
        fir += w[t] * xp[:, t:t + s]
    spec = np.fft.fft(fir, axis=-1)
    f = np.fft.fftfreq(nbins, 1.0 / bandwidth) + frequency
    d = np.asarray(delays, np.float64)
    spec *= np.exp(2j * np.pi * d[:, None] * f[None, :])[:, None, :]
    p, q = pairs[:, 0], pairs[:, 1]
    vis = np.fft.fftshift((spec[p] * np.conj(spec[q])).mean(axis=1), axes=-1)
    if mode.upper() in ("CONTINUUM", "TEST"):
        vis = vis.mean(axis=-1) / bandwidth
    return vis, xp[:, xp.shape[1] - (ntaps - 1):]


def fx_blocks(blocks: Sequence[np.ndarray], window2d: np.ndarray,
              pairs: np.ndarray, *, bandwidth: float, frequency: float,
              delays: np.ndarray, mode: str = "SPECTRUM",
              quant_step: float = 1.0 / 32) -> np.ndarray:
    """A stream of blocks with the tap history carried from block to block
    (``delays``: ``[nch]`` for all blocks or ``[K, nch]`` per block).
    Returns the stacked ``[K, ...]`` visibilities."""
    delays = np.asarray(delays, np.float64)
    hist, out = None, []
    for i, b in enumerate(blocks):
        d = delays[i] if delays.ndim == 2 else delays
        vis, hist = fx_block(b, window2d, pairs, bandwidth=bandwidth,
                             frequency=frequency, delays=d, history=hist,
                             mode=mode, quant_step=quant_step)
        out.append(vis)
    return np.stack(out)


def max_rel_error(got: np.ndarray, want: np.ndarray) -> float:
    """Largest absolute deviation over the largest reference magnitude:
    the error measure every device-vs-reference check in this repository
    uses (per-bin relative error is meaningless where a spectrum nulls)."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())
