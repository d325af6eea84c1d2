"""Mesh-sharded FX correlator step (shard_map + XLA collectives).

The distributed decomposition (nothing like it exists in the reference — its
only transport is pickled arrays over multiprocessing queues on one host,
``/root/reference/effex/effex.py:105-106``; this is the SURVEY.md §5.8
mesh equivalent):

  1. **F-stage, frame-sharded.**  The input block ``[nch, num_samp]`` is
     viewed as ``S = num_samp/nbins`` PFB rows and split across the
     linearized (time, freq) mesh.  Each device runs the windowed-FIR + FFT
     on its local rows.
  2. **Halo exchange.**  Frame ``k`` needs rows ``k-ntaps+1..k``, so each
     device sends its trailing ``ntaps-1`` rows to its right neighbor
     (``lax.ppermute`` over the linearized shard index — (ntaps-1)*nbins
     samples per channel, tiny vs. the data).  Shard 0 consumes the tap
     history carried from the previous block, preserving streaming
     continuity across both block and shard boundaries.
  3. **Corner turn.**  ``lax.all_to_all`` over the 'freq' axis converts the
     spectra from frame-sharded to bin-sharded layout — the canonical FX
     corner turn, over the device interconnect (NVLink between the cards
     of one host).
  4. **X-stage, bin-sharded.**  Each device multiply-accumulates its bins
     for every baseline over its local frames; ``lax.pmean`` over 'time'
     completes the visibility integration.

Output: visibilities ``[nbl, nbins]`` bin-sharded over 'freq' (fftshift and
the continuum reduction happen outside the shard_map on the global array),
plus the new tap history for the next block.

Default impl is 'planes' (dual-plane reals, the representation of the
single-device step); collectives move a single stacked ``[2, ...]`` array
so each exchange is one transfer.  The 'complex' impl is kept for
cross-checks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from fxtpu.ops import cfft
from fxtpu.ops import planes as pl_ops
from fxtpu.ops.cplx import Cplx, cfftshift, stack, unstack
from fxtpu.ops.pfb import pfb_fir
from fxtpu.ops.xengine import fstc_rotate, continuum_reduce
from fxtpu.parallel.mesh import FREQ_AXIS, TIME_AXIS, validate_shapes

AXES = (TIME_AXIS, FREQ_AXIS)


def _replicate_out(mesh, tree_):
    """Multi-process: force outputs fully replicated (an in-graph
    all_gather) so every host can read them (np.asarray on a
    non-addressable sharded Array raises in multi-controller runs)."""
    rep = NamedSharding(mesh, P())
    return jax.tree.map(
        lambda a: lax.with_sharding_constraint(a, rep), tree_)


def make_sharded_fx_multi_step(*, mode: str, nbins: int,
                               window2d: np.ndarray, pairs: np.ndarray,
                               bandwidth: float, frequency: float,
                               mesh: jax.sharding.Mesh, num_samp: int,
                               impl: str = "planes",
                               quant_step: float = 1.0 / 32):
    """K-blocks-per-dispatch sharded step:

        multi(iq [K, nch, num_samp], delays [K, nch(,2)], history)
            -> (vis [K, ...], new_hist)

    A ``lax.scan`` over the per-block sharded step: one dispatch for K
    blocks, no layout change.  History formats match the per-block sharded
    step's, so full batches and remainder single steps mix freely in one
    run (the Correlator does exactly that)."""
    if impl != "planes":
        raise ValueError("sharded multi_step: planes impl only")
    step = make_sharded_fx_step(
        mode=mode, nbins=nbins, window2d=window2d, pairs=pairs,
        bandwidth=bandwidth, frequency=frequency, mesh=mesh,
        num_samp=num_samp, impl=impl, quant_step=quant_step)

    @jax.jit
    def multi(iq, delays, history):
        def body(hist, xs):
            blk, d = xs
            vis, hist = step(blk, d, hist)
            return hist, vis

        new_hist, vis = jax.lax.scan(body, history,
                                     (iq, jnp.asarray(delays)))
        return vis, new_hist

    return multi


def make_sharded_fx_step(*, mode: str, nbins: int, window2d: np.ndarray,
                         pairs: np.ndarray, bandwidth: float, frequency: float,
                         mesh: jax.sharding.Mesh, num_samp: int,
                         impl: str = "planes",
                         quant_step: float = 1.0 / 32):
    """Build a jitted sharded step: ``(iq [nch, num_samp], delays [nch],
    history [nch, ntaps-1, nbins]) -> (vis, new_history)``.

    ``vis`` is ``[nbl, nbins]`` (SPECTRUM) or ``[nbl]`` (CONTINUUM/TEST),
    fftshifted, matching the single-device path up to float reduction order.

    """
    ntaps = int(window2d.shape[0])
    if window2d.shape[1] != nbins:
        raise ValueError("window2d must be [ntaps, nbins]")
    t_sz = mesh.shape[TIME_AXIS]
    f_sz = mesh.shape[FREQ_AXIS]
    n_shards = t_sz * f_sz
    validate_shapes(num_samp, nbins, mesh, ntaps)
    s_rows = num_samp // nbins
    w2d = jnp.asarray(window2d, dtype=jnp.float32)
    pairs_a = jnp.asarray(pairs)
    continuum = mode in ("CONTINUUM", "TEST")

    def _exchange_halo(rows_stacked, hist_stacked):
        """rows/hist as single stacked arrays [2|1, nch, S_loc|ntaps-1, nbins]
        (planes stack both components; complex impl passes [1, ...])."""
        tail = rows_stacked[:, :, -(ntaps - 1):, :]
        if n_shards > 1:
            idx = lax.axis_index(AXES)
            prev = lax.ppermute(
                tail, AXES, [(i, i + 1) for i in range(n_shards - 1)])
            prev = jnp.where(idx == 0, hist_stacked.astype(tail.dtype), prev)
            new_hist = lax.psum(
                jnp.where(idx == n_shards - 1, tail, jnp.zeros_like(tail)),
                AXES)
        else:
            prev = hist_stacked.astype(tail.dtype)
            new_hist = tail
        return prev, new_hist

    # ------------------------------------------------------------------
    if impl == "planes":
        def local_fx(rows: Cplx, delays, history: Cplx):
            # rows: [nch, S_loc, nbins] planes; history: [nch, ntaps-1, nbins]
            if ntaps > 1:
                prev, new_hist = _exchange_halo(stack(rows), stack(history))
                xp = Cplx(
                    jnp.concatenate([prev[0], rows.re], axis=1),
                    jnp.concatenate([prev[1], rows.im], axis=1))
                new_hist = unstack(new_hist)
            else:
                xp, new_hist = rows, history
            fir = pl_ops.pfb_fir_planes(xp, w2d)
            spec = cfft.fft(fir)
            spec = pl_ops.fstc_rotate_planes(spec, delays, bandwidth,
                                             frequency)
            if f_sz > 1:
                # corner turn on one stacked array:
                # [2, nch, S_loc, nbins] -> [2, nch, S_loc*F, nbins/F]
                spec = unstack(lax.all_to_all(stack(spec), FREQ_AXIS,
                                              split_axis=3, concat_axis=2,
                                              tiled=True))
            # per-pair or Gram-matmul X-stage (pl_ops picks by nbl)
            acc = pl_ops.xcorr_baselines_planes(spec, pairs_a, shift=False)
            acc = unstack(lax.pmean(stack(acc), TIME_AXIS))
            return acc, new_hist

        sharded = jax.shard_map(
            local_fx, mesh=mesh,
            in_specs=(P(None, AXES, None), P(), P()),
            out_specs=(P(None, FREQ_AXIS), P()),
        )

        multihost = jax.process_count() > 1

        @jax.jit
        def step(iq: Cplx, delays, history: Cplx):
            from fxtpu.fx import _dequant
            iq = jax.tree.map(
                lambda a: lax.with_sharding_constraint(
                    a, NamedSharding(mesh, P(None, AXES))), iq)
            iq = pl_ops.dc_remove_planes(_dequant(iq, quant_step))
            rows = jax.tree.map(
                lambda a: lax.with_sharding_constraint(
                    a[:, : s_rows * nbins].reshape(a.shape[0], s_rows, nbins),
                    NamedSharding(mesh, P(None, AXES, None))), iq)
            vis, new_hist = sharded(rows, jnp.asarray(delays), history)
            vis = cfftshift(vis, axes=-1)
            if continuum:
                vis = Cplx(jnp.mean(vis.re, axis=-1) / bandwidth,
                           jnp.mean(vis.im, axis=-1) / bandwidth)
            if multihost:
                vis, new_hist = _replicate_out(mesh, (vis, new_hist))
            return vis, new_hist

        return step

    # ------------------------------------------------------------------
    if impl != "complex":
        raise ValueError(f"unknown impl {impl}")

    def local_fx_c(rows, delays, history):
        if ntaps > 1:
            prev, new_hist = _exchange_halo(rows[None], history[None])
            xp = jnp.concatenate([prev[0], rows], axis=1)
            new_hist = new_hist[0]
        else:
            xp, new_hist = rows, history
        fir = pfb_fir(xp, w2d)
        spec = jnp.fft.fft(fir, axis=-1)
        spec = fstc_rotate(spec, delays, bandwidth, frequency)
        if f_sz > 1:
            spec = lax.all_to_all(spec, FREQ_AXIS, split_axis=2,
                                  concat_axis=1, tiled=True)
        gp = jnp.take(spec, pairs_a[:, 0], axis=0)
        gq = jnp.take(spec, pairs_a[:, 1], axis=0)
        acc = jnp.mean(gp * jnp.conj(gq), axis=1)
        acc = lax.pmean(acc, TIME_AXIS)
        return acc, new_hist

    sharded_c = jax.shard_map(
        local_fx_c, mesh=mesh,
        in_specs=(P(None, AXES, None), P(), P()),
        out_specs=(P(None, FREQ_AXIS), P()),
    )

    multihost = jax.process_count() > 1

    @jax.jit
    def step_c(iq, delays, history):
        iq = iq.astype(jnp.complex64)
        iq = lax.with_sharding_constraint(
            iq, NamedSharding(mesh, P(None, AXES)))
        iq = iq - jnp.mean(iq, axis=-1, keepdims=True)
        rows = iq[:, : s_rows * nbins].reshape(iq.shape[0], s_rows, nbins)
        rows = lax.with_sharding_constraint(
            rows, NamedSharding(mesh, P(None, AXES, None)))
        vis, new_hist = sharded_c(rows, jnp.asarray(delays), history)
        vis = jnp.fft.fftshift(vis, axes=-1)
        if continuum:
            vis = continuum_reduce(vis, bandwidth)
        if multihost:
            vis, new_hist = _replicate_out(mesh, (vis, new_hist))
        return vis, new_hist

    return step_c
