"""Dual-plane complex arithmetic: complex values as (re, im) float pairs.

The production step keeps complex values as an explicit :class:`Cplx`
NamedTuple of two real arrays (the repository began on hardware with no
complex dtypes; whether to move the step to complex64 is an open design
question, ROADMAP.md).  Being a NamedTuple it is automatically a JAX
pytree — it flows through jit, shard_map, scan, and collectives.

Everything here is elementwise work that XLA fuses; the FFT built on top
of it is ``fxtpu.ops.cfft``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Cplx(NamedTuple):
    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def dtype(self):
        return self.re.dtype

    def __getitem__(self, idx):  # type: ignore[override]
        return Cplx(self.re[idx], self.im[idx])

    def astype(self, dtype):
        return Cplx(self.re.astype(dtype), self.im.astype(dtype))


# ---------------------------------------------------------------------------
# construction / conversion
# ---------------------------------------------------------------------------
def from_complex(x) -> Cplx:
    """Host-side split of a complex array into planes (numpy or jax)."""
    if isinstance(x, np.ndarray):
        if x.dtype == np.complex64 and x.flags.c_contiguous:
            # native single-pass deinterleave (2x numpy's strided extract)
            from fxtpu.runtime.native import split_planes_c64
            re, im = split_planes_c64(x)
            return Cplx(jnp.asarray(re), jnp.asarray(im))
        return Cplx(jnp.asarray(np.ascontiguousarray(x.real)),
                    jnp.asarray(np.ascontiguousarray(x.imag)))
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return Cplx(jnp.real(x), jnp.imag(x))
    return Cplx(x, jnp.zeros_like(x))


def to_complex(c: Cplx) -> np.ndarray:
    """Host-side merge back to numpy complex (forces transfer)."""
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def czeros(shape, dtype=jnp.float32) -> Cplx:
    return Cplx(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def stack(c: Cplx):
    """Pack planes into one array with a leading size-2 axis (single-tensor
    form for collectives/DMA)."""
    return jnp.stack([c.re, c.im])


def unstack(arr) -> Cplx:
    return Cplx(arr[0], arr[1])


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------
def cmul(a: Cplx, b: Cplx) -> Cplx:
    return Cplx(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cmulconj(a: Cplx, b: Cplx) -> Cplx:
    """a * conj(b) — the X-engine primitive."""
    return Cplx(a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im)


def conj(a: Cplx) -> Cplx:
    return Cplx(a.re, -a.im)


def cadd(a: Cplx, b: Cplx) -> Cplx:
    return Cplx(a.re + b.re, a.im + b.im)


def csub(a: Cplx, b: Cplx) -> Cplx:
    return Cplx(a.re - b.re, a.im - b.im)


def cscale(a: Cplx, s) -> Cplx:
    return Cplx(a.re * s, a.im * s)


def cexp(phase) -> Cplx:
    """exp(j*phase) for real ``phase``."""
    return Cplx(jnp.cos(phase), jnp.sin(phase))


def abs2(a: Cplx):
    """|a|^2 (avoids the sqrt the magnitude would need)."""
    return a.re * a.re + a.im * a.im


def cmean(a: Cplx, axis=None, keepdims=False) -> Cplx:
    return Cplx(jnp.mean(a.re, axis=axis, keepdims=keepdims),
                jnp.mean(a.im, axis=axis, keepdims=keepdims))


def csum(a: Cplx, axis=None, keepdims=False) -> Cplx:
    return Cplx(jnp.sum(a.re, axis=axis, keepdims=keepdims),
                jnp.sum(a.im, axis=axis, keepdims=keepdims))


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------
def creshape(a: Cplx, shape) -> Cplx:
    return Cplx(a.re.reshape(shape), a.im.reshape(shape))


def cconcat(parts, axis=0) -> Cplx:
    return Cplx(jnp.concatenate([p.re for p in parts], axis=axis),
                jnp.concatenate([p.im for p in parts], axis=axis))


def cpad_last(a: Cplx, pad: int) -> Cplx:
    cfg = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return Cplx(jnp.pad(a.re, cfg), jnp.pad(a.im, cfg))


def ctake(a: Cplx, idx, axis=0) -> Cplx:
    return Cplx(jnp.take(a.re, idx, axis=axis), jnp.take(a.im, idx, axis=axis))


def cfftshift(a: Cplx, axes=-1) -> Cplx:
    return Cplx(jnp.fft.fftshift(a.re, axes=axes),
                jnp.fft.fftshift(a.im, axes=axes))
