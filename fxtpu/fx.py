"""The per-block FX step and in-graph calibrator.

This is the device-side hot path: everything the reference does per chunk on
the GPU (``/root/reference/effex/effex.py:391-410,497-527``) in ONE jitted
XLA program — DC-spike removal, PFB F-stage, FSTC phase rotation, X-stage
conjugate multiply, and visibility integration.  The calibrated delays enter
as a *traced* vector argument, so recalibration (and the TEST-mode delay
sweep) never triggers a recompile (SURVEY.md "hard parts").

Two implementations, same contract, asserted equal in tests:

  * ``impl='planes'`` (production, the default): complex values as
    dual-plane f32 pairs (fxtpu.ops.{cplx,cfft,planes}); the FFT is
    ``jnp.fft`` (cuFFT on the GPU) and every f32 dot names its precision.
  * ``impl='complex'``: complex64 + jnp.fft — the concise second
    implementation the oracle tests cross-check against.

:mod:`fxtpu.reference` holds the float64 NumPy statement of the same math.

``make_fx_step`` returns the single-device step; pass a mesh to get the
shard_map'ed multi-device step from :mod:`fxtpu.parallel.sharded` with the
same call signature.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from fxtpu.config import CorrelatorConfig
from fxtpu.ops.cplx import Cplx, from_complex
from fxtpu.ops.pfb import pfb_fir, zero_history
from fxtpu.ops import planes as pl_ops
from fxtpu.ops.window import pfb_window
from fxtpu.ops.xengine import (baseline_pairs, continuum_reduce, fstc_rotate)
from fxtpu.ops.delay import estimate_delay_gaussian

__all__ = ["make_fx_step", "make_calibrator", "dc_remove", "FxEngine"]


def dc_remove(iq):
    """DC-spike removal: subtract the per-channel complex mean
    (``effex.py:393-395``)."""
    return iq - jnp.mean(iq, axis=-1, keepdims=True)


def _continuum_planes(vis: Cplx, bandwidth) -> Cplx:
    return Cplx(jnp.mean(vis.re, axis=-1) / bandwidth,
                jnp.mean(vis.im, axis=-1) / bandwidth)


def _dequant(iq: Cplx, quant_step: float) -> Cplx:
    """int8-ingested planes -> f32 at trace time (no-op for f32 input).
    One on-device multiply: the 4x byte saving already happened in the
    rings and the host->device transfer (see sources.base.QuantizedSource)."""
    if iq.re.dtype == jnp.float32:
        return iq
    s = jnp.float32(quant_step)
    return Cplx(iq.re.astype(jnp.float32) * s,
                iq.im.astype(jnp.float32) * s)


def _make_planes_core(*, mode: str, nbins: int, w2d, pairs_a,
                      bandwidth: float, frequency: float,
                      quant_step: float = 1.0 / 32):
    """The shared planes-impl block body (single-step and scan variants)."""
    continuum = mode in ("CONTINUUM", "TEST")

    def core(iq: Cplx, delays, history: Cplx):
        iq = pl_ops.dc_remove_planes(_dequant(iq, quant_step))
        spec, new_hist = pl_ops.spectrometer_planes(iq, w2d, nbins,
                                                    history=history)
        spec = pl_ops.fstc_rotate_planes(spec, delays, bandwidth, frequency)
        vis = pl_ops.xcorr_baselines_planes(spec, pairs_a)
        if continuum:
            vis = _continuum_planes(vis, bandwidth)
        return vis, new_hist

    return core


def make_fx_step(*, mode: str, nbins: int, window2d: np.ndarray,
                 pairs: np.ndarray, bandwidth: float, frequency: float,
                 num_samp: int, impl: str = "planes",
                 mesh: Optional[jax.sharding.Mesh] = None,
                 quant_step: float = 1.0 / 32):
    """Build the jitted per-block step:

        step(iq [nch, num_samp], delays [nch], history [nch, ntaps-1, nbins])
            -> (vis, new_history)

    ``iq``/``history``/``vis`` are :class:`Cplx` pairs for impl='planes',
    complex arrays for impl='complex'.  ``vis``: ``[nbl, nbins]`` fftshifted
    cross-power spectra (SPECTRUM) or ``[nbl]`` scalars (CONTINUUM/TEST),
    matching ``Correlator._pfb_xcorr`` (``effex.py:497-527``) for nchan=2.
    """
    if mesh is not None and int(np.prod(list(mesh.shape.values()))) > 1:
        from fxtpu.parallel.sharded import make_sharded_fx_step
        return make_sharded_fx_step(
            mode=mode, nbins=nbins, window2d=window2d, pairs=pairs,
            bandwidth=bandwidth, frequency=frequency, mesh=mesh,
            num_samp=num_samp, impl=impl, quant_step=quant_step)

    ntaps = int(window2d.shape[0])
    s_rows = num_samp // nbins
    pairs_a = jnp.asarray(pairs)
    continuum = mode in ("CONTINUUM", "TEST")
    w2d = jnp.asarray(window2d, dtype=jnp.float32)

    if impl == "planes":
        return jax.jit(_make_planes_core(
            mode=mode, nbins=nbins, w2d=w2d, pairs_a=pairs_a,
            bandwidth=bandwidth, frequency=frequency,
            quant_step=quant_step))

    if impl != "complex":
        raise ValueError(f"unknown impl {impl}")

    @jax.jit
    def step_c(iq, delays, history):
        iq = dc_remove(iq.astype(jnp.complex64))
        rows = iq[:, : s_rows * nbins].reshape(iq.shape[0], s_rows, nbins)
        if ntaps > 1:
            xp = jnp.concatenate([history.astype(iq.dtype), rows], axis=1)
            new_hist = xp[:, -(ntaps - 1):, :]
        else:
            xp, new_hist = rows, history
        fir = pfb_fir(xp, w2d)
        spec = jnp.fft.fft(fir, axis=-1)
        spec = fstc_rotate(spec, delays, bandwidth, frequency)
        gp = jnp.take(spec, pairs_a[:, 0], axis=0)
        gq = jnp.take(spec, pairs_a[:, 1], axis=0)
        vis = jnp.fft.fftshift(jnp.mean(gp * jnp.conj(gq), axis=1), axes=-1)
        if continuum:
            vis = continuum_reduce(vis, bandwidth)
        return vis, new_hist

    return step_c


def make_fx_multi_step(*, mode: str, nbins: int, window2d: np.ndarray,
                       pairs: np.ndarray, bandwidth: float, frequency: float,
                       quant_step: float = 1.0 / 32):
    """K-blocks-per-dispatch variant (planes impl):

        multi(iq [K, nch, num_samp], delays [K, nch], history)
            -> (vis [K, ...], new_history)

    One ``lax.scan`` carries the PFB tap history block-to-block inside a
    single XLA executable, so K blocks cost one dispatch.  Per-block delay
    vectors keep the TEST-mode sweep expressible inside one dispatch.
    Results are identical to K sequential single-block steps (asserted in
    tests/test_planes.py).
    """
    core = _make_planes_core(
        mode=mode, nbins=nbins, w2d=jnp.asarray(window2d, jnp.float32),
        pairs_a=jnp.asarray(pairs), bandwidth=bandwidth,
        frequency=frequency, quant_step=quant_step)

    @jax.jit
    def multi(iq: Cplx, delays, history: Cplx):
        def body(hist, xs):
            blk, d = xs
            vis, hist = core(blk, d, hist)
            return hist, vis

        new_hist, vis = jax.lax.scan(body, history, (iq, delays))
        return vis, new_hist

    return multi


def make_calibrator(*, bandwidth: float, impl: str = "planes"):
    """Jitted all-channel delay calibration against channel 0.

    Returns ``cal(iq) -> delays [nch]`` seconds, ``delays[0] == 0``.
    Blocks are DC-removed first, as the reference calibrates on the
    DC-removed pinned buffers (``effex.py:391-395`` then ``:484``).

    Memoized process-wide via ``_cached_step`` on (bandwidth, impl): every
    FxEngine with the same bandwidth shares ONE jitted function, so
    re-instantiating engines (warmup runs, repeated Correlators in one
    process) never re-traces or recompiles.
    """
    return _cached_step("cal", (bandwidth, impl),
                        lambda: _build_calibrator(bandwidth, impl))


def _build_calibrator(bandwidth: float, impl: str):
    if impl == "planes":

        @jax.jit
        def cal(iq: Cplx):
            if iq.re.dtype != jnp.float32:
                # int8 ingest: the delay estimator is scale-invariant
                # (argmax of |xcorr|), so a plain convert suffices
                iq = Cplx(iq.re.astype(jnp.float32),
                          iq.im.astype(jnp.float32))
            iq = pl_ops.dc_remove_planes(iq)
            ref = iq[0]
            est = jax.vmap(
                lambda x: pl_ops.estimate_delay_planes(ref, x, bandwidth)
            )(iq[1:])
            return jnp.concatenate([jnp.zeros((1,), est.dtype), est])

        return cal

    @jax.jit
    def cal_c(iq):
        iq = dc_remove(iq.astype(jnp.complex64))
        ref = iq[0]
        est = jax.vmap(lambda x: estimate_delay_gaussian(ref, x, bandwidth))(
            iq[1:])
        return jnp.concatenate([jnp.zeros((1,), est.dtype), est])

    return cal_c


#: Process-wide cache of built (jitted) steps.  jax's in-process executable
#: cache is keyed on the jitted function OBJECT, so two FxEngines with the
#: same config would otherwise each pay the full XLA compile.  Keys are the
#: exact scalars the builders close over.
_STEP_CACHE: dict = {}


def _cached_step(kind: str, key: tuple, build):
    full = (kind, *key)
    if full not in _STEP_CACHE:
        _STEP_CACHE[full] = build()
    return _STEP_CACHE[full]


class FxEngine:
    """Convenience bundle: window + pairs + step + calibrator for a config.

    The object benchmarks, ``chip_smoke.py`` and __graft_entry__ use; the
    Correlator state machine drives one of these.  Step/calibrator
    construction is memoized process-wide (see ``_STEP_CACHE``), so
    re-instantiating engines with equal configs reuses the compiled
    executables.
    """

    def __init__(self, cfg: CorrelatorConfig,
                 mesh: Optional[jax.sharding.Mesh] = None,
                 impl: str = "planes"):
        self.cfg = cfg
        self.mesh = mesh
        self.impl = impl
        self.window = pfb_window(cfg.ntaps, cfg.nbins, cfg.window)
        self.window2d = self.window.reshape(cfg.ntaps, cfg.nbins)
        self.pairs = baseline_pairs(cfg.nchan, cfg.include_autos)
        self._key = (cfg.mode, cfg.nbins, cfg.ntaps, cfg.window, cfg.nchan,
                     cfg.include_autos, cfg.bandwidth, cfg.frequency,
                     cfg.num_samp, impl, mesh, cfg.quant_step)
        self.step = _cached_step("step", self._key, lambda: make_fx_step(
            mode=cfg.mode, nbins=cfg.nbins, window2d=self.window2d,
            pairs=self.pairs, bandwidth=cfg.bandwidth, frequency=cfg.frequency,
            num_samp=cfg.num_samp, impl=impl, mesh=mesh,
            quant_step=cfg.quant_step))
        self.calibrate = make_calibrator(bandwidth=cfg.bandwidth, impl=impl)
        self._multi_step = None

    @property
    def multi_step(self):
        """Lazily-built K-blocks-per-dispatch step (planes impl).  Mesh
        engines get the sharded variant (a scanned sharded per-block step,
        parallel.sharded.make_sharded_fx_multi_step)."""
        if self._multi_step is None:
            if self.impl != "planes":
                raise ValueError("multi_step: planes impl only")
            cfg = self.cfg
            if self.mesh is not None:
                from fxtpu.parallel.sharded import make_sharded_fx_multi_step
                build = lambda: make_sharded_fx_multi_step(  # noqa: E731
                    mode=cfg.mode, nbins=cfg.nbins, window2d=self.window2d,
                    pairs=self.pairs, bandwidth=cfg.bandwidth,
                    frequency=cfg.frequency, mesh=self.mesh,
                    num_samp=cfg.num_samp, impl=self.impl,
                    quant_step=cfg.quant_step)
            else:
                build = lambda: make_fx_multi_step(  # noqa: E731
                    mode=cfg.mode, nbins=cfg.nbins, window2d=self.window2d,
                    pairs=self.pairs, bandwidth=cfg.bandwidth,
                    frequency=cfg.frequency, quant_step=cfg.quant_step)
            self._multi_step = _cached_step("multi", self._key, build)
        return self._multi_step

    def dispatch_batch_for(self, requested: int) -> int:
        """The largest dispatch batch K <= ``requested`` this engine
        supports: planes engines take any K, except multi-process runs,
        which stay per-block (their feeders read per-block sample spans)."""
        if requested <= 1 or self.impl != "planes":
            return 1
        if self.mesh is not None and jax.process_count() > 1:
            return 1
        return requested

    def fresh_history(self):
        shape = (self.cfg.nchan,)
        if self.impl == "planes":
            return pl_ops.zero_history_planes(shape, self.cfg.nbins,
                                              self.cfg.ntaps)
        return zero_history(shape, self.cfg.nbins, self.cfg.ntaps,
                            jnp.complex64)

    def prepare_block(self, block: np.ndarray):
        """Host block [nch, num_samp] complex64 (or int8 ``[nch, num_samp,
        2]``; or a ``[K, ...]`` stack of either) -> device input form.

        With a mesh, placement goes through the sharded ingest path
        (fxtpu.parallel.ingest.put_block): device_put with the block's
        NamedSharding single-host, make_array_from_process_local_data
        under a multi-process runtime (each host reads only its span)."""
        if self.impl != "planes":
            return jnp.asarray(block)
        if (self.cfg.ingest_dtype == "int8"
                and isinstance(block, np.ndarray)
                and np.issubdtype(block.dtype, np.complexfloating)):
            # int8 engine handed COMPLEX samples (no QuantizedSource
            # upstream): quantize here at cfg.quant_step, so the step sees
            # the same int8 codes a quantizing source would have sent
            from fxtpu.runtime.native import quantize_c64
            block = quantize_c64(np.ascontiguousarray(block, np.complex64),
                                 self.cfg.quant_step)
        if self.mesh is not None and isinstance(block, np.ndarray):
            # 3-D complex = a STACKED [K, nch, num_samp] batch for the
            # scanned sharded multi (put_block keeps the sample axis
            # sharded under the leading K); int8 planes are sent as int8
            # (4x fewer H2D bytes) and dequantized in-graph
            from fxtpu.parallel.ingest import put_block
            return put_block(block, self.mesh,
                             global_num_samp=self.cfg.num_samp)
        if (isinstance(block, np.ndarray) and block.dtype == np.int8
                and block.shape[-1] == 2):
            # 8-bit quantized ingest [..., nch, num_samp, 2]: ship the int8
            # planes (4x fewer H2D bytes); the step dequantizes on-device
            # (see _dequant / sources.base.QuantizedSource)
            from fxtpu.runtime.native import split_planes_i8
            re, im = split_planes_i8(block)
            return Cplx(jnp.asarray(re), jnp.asarray(im))
        return from_complex(block)

    def prepare_batch(self, blocks):
        """K host blocks -> the ``[K, nch, ...]`` input for ONE
        :meth:`multi_step` dispatch.  ``blocks``: a sequence of per-block
        host arrays ``[nch, num_samp]`` complex64 (or int8 ``[nch,
        num_samp, 2]``), or an already-stacked ``[K, nch, ...]`` array."""
        return self.prepare_block(np.stack(list(blocks)))

    def calibrate_block(self, iq, ncal: Optional[int] = None):
        """Delay calibration from a prepared SINGLE-BLOCK input, in
        whatever form :meth:`prepare_block` returned it: the leading
        ``ncal`` samples feed the jitted calibrator.  This is the one
        transform the Correlator's local calibration path uses — warm-up
        code must call it too, or it compiles a different executable than
        production runs.

        Mesh inputs are replicated first: the estimator's FFT runs over
        the whole sample axis, which the mesh shards."""
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            rep = NamedSharding(self.mesh, PartitionSpec())
            iq = jax.tree.map(lambda a: jax.device_put(a, rep), iq)
        iq = jax.tree.map(lambda a: a.reshape(a.shape[0], -1), iq)
        if ncal:
            iq = jax.tree.map(lambda a: a[..., : min(ncal, a.shape[-1])],
                              iq)
        return self.calibrate(iq)

    def example_inputs(self, seed: int = 0):
        """Representative (iq, delays, history) inputs for compile checks.
        int8 engines get int8 quantized blocks — the step's input form."""
        rng = np.random.default_rng(seed)
        if self.cfg.ingest_dtype == "int8":
            iq = rng.integers(
                -127, 128, size=(self.cfg.nchan, self.cfg.num_samp, 2)
            ).astype(np.int8)
        else:
            iq = (rng.normal(size=(self.cfg.nchan, self.cfg.num_samp))
                  + 1j * rng.normal(size=(self.cfg.nchan, self.cfg.num_samp))
                  ).astype(np.complex64)
        delays = jnp.zeros(self.cfg.nchan, dtype=jnp.float32)
        return self.prepare_block(iq), delays, self.fresh_history()
