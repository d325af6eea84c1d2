"""Complex FFT on dual-plane reals, through ``jnp.fft``.

The planes representation (:class:`~fxtpu.ops.cplx.Cplx`) is kept for the
whole step; the transform itself joins the two planes into complex64 and
calls ``jnp.fft``, which XLA lowers to cuFFT on the GPU (single precision
throughout, no tensor cores) and to its own FFT on the CPU.  Any length
works, smooth or not (the calibrator pads to ``2n``, e.g. the reference's
odd ``2*(3+2^12)``).

Accuracy against numpy's complex128 FFT is ~2-3e-7 of the peak at 4096 and
8192 bins on an H100 (``PERF.md``), the f32 rounding floor.  This replaced a
Cooley-Tukey of dense DFT-matrix matmuls: on the H100 its f32 dots need the
HIGHEST precision to stay near that floor (at TF32 the error is ~3.6e-4)
and then take 2-2.5x cuFFT's time.

Reference replaced: cupy.fft.{fft,ifft} usage at
``/root/reference/effex/effex.py:516-614`` (via CUDA cuFFT).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fxtpu.ops.cplx import Cplx


def fft(x: Cplx, inverse: bool = False) -> Cplx:
    """Complex FFT over the LAST axis of a dual-plane array.  Forward is
    unnormalized; inverse divides by N (numpy convention)."""
    z = jax.lax.complex(x.re.astype(jnp.float32), x.im.astype(jnp.float32))
    z = jnp.fft.ifft(z, axis=-1) if inverse else jnp.fft.fft(z, axis=-1)
    return Cplx(jnp.real(z), jnp.imag(z))


def ifft(x: Cplx) -> Cplx:
    return fft(x, inverse=True)
