"""Every f32 dot on the main path names its precision, read from the traced
program (jaxpr), so none can fall to the backend default (TF32 on the GPU)
without a test failing; the FFT runs on complex64."""

import jax
import jax.extend  # noqa: F401  (jax.extend.core.Jaxpr types)
import jax.numpy as jnp
import numpy as np
import pytest

from fxtpu.config import CorrelatorConfig
from fxtpu.fx import FxEngine
from fxtpu.ops import planes
from fxtpu.parallel import make_correlator_mesh

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _walk(jaxpr):
    """Every equation of a jaxpr and of the jaxprs nested in it (scan,
    jit, shard_map bodies)."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    yield from _walk(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    yield from _walk(sub)


def _prims(fn, *args):
    return list(_walk(jax.make_jaxpr(fn)(*args).jaxpr))


def _engine(nchan=2, autos=False, ingest="complex64", ntaps=4, mesh=None,
            mode="SPECTRUM", frames=16):
    cfg = CorrelatorConfig(mode=mode, nchan=nchan, include_autos=autos,
                           nbins=256, ntaps=ntaps, num_samp=256 * frames,
                           clamp_num_samp=False, ingest_dtype=ingest)
    return FxEngine(cfg, mesh=mesh)


def _check(eqns, want_dots):
    dots = [e for e in eqns if e.primitive.name == "dot_general"]
    assert len(dots) == want_dots
    for e in dots:
        assert e.params["precision"] == HIGHEST, e.params["precision"]
    ffts = [e for e in eqns if e.primitive.name == "fft"]
    assert ffts
    for e in ffts:
        assert e.invars[0].aval.dtype == jnp.complex64


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("nchan,autos,dots", [(2, False, 0), (3, False, 0),
                                              (4, False, 4), (8, True, 4)])
def test_step_dot_precision(nchan, autos, dots, ingest):
    """Below 4 baselines the X stage is elementwise (no dots); from 4 on
    it is the Gram matmul: 4 real dots, each at HIGHEST."""
    eng = _engine(nchan, autos, ingest)
    iq, delays, hist = eng.example_inputs(0)
    _check(_prims(eng.step, iq, delays, hist), dots)


@pytest.mark.parametrize("nchan,autos,dots", [(2, False, 0), (8, True, 4)])
def test_multi_step_dot_precision(nchan, autos, dots):
    eng = _engine(nchan, autos)
    iq, _, hist = eng.example_inputs(0)
    batch = jax.tree.map(lambda a: jnp.stack([a, a]), iq)
    delays = jnp.zeros((2, nchan), jnp.float32)
    _check(_prims(eng.multi_step, batch, delays, hist), dots)


def test_sharded_step_dot_precision():
    eng = _engine(8, True, mesh=make_correlator_mesh(4, 2), frames=64)
    iq, delays, hist = eng.example_inputs(0)
    _check(_prims(eng.step, iq, delays, hist), 4)


def test_calibrator_runs_complex64_fft():
    eng = _engine(2)
    iq, _, _ = eng.example_inputs(0)
    eqns = _prims(eng.calibrate, iq)
    assert not [e for e in eqns if e.primitive.name == "dot_general"]
    ffts = [e for e in eqns if e.primitive.name == "fft"]
    assert len(ffts) == 3  # two forward transforms, one inverse
    assert all(e.invars[0].aval.dtype == jnp.complex64 for e in ffts)


def test_gram_precision_is_named():
    assert planes.GRAM_PRECISION == jax.lax.Precision.HIGHEST


def test_gram_matches_float64():
    """The Gram X stage at its named precision against a float64 einsum."""
    rng = np.random.default_rng(3)
    re = rng.normal(size=(5, 32, 64)).astype(np.float32)
    im = rng.normal(size=(5, 32, 64)).astype(np.float32)
    from fxtpu.ops.cplx import Cplx, to_complex
    from fxtpu.ops.xengine import baseline_pairs
    pairs = baseline_pairs(5, include_autos=True)
    got = to_complex(planes.xcorr_baselines_planes(
        Cplx(jnp.asarray(re), jnp.asarray(im)), pairs, shift=False))
    z = re.astype(np.float64) + 1j * im
    want = (z[pairs[:, 0]] * np.conj(z[pairs[:, 1]])).mean(axis=1)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
