"""Sharded host->mesh ingest (fxtpu.parallel.ingest): placement shardings,
engine integration, and per-process sample spans.  Runs on the conftest's
8 virtual CPU devices; the multi-process branch
(make_array_from_process_local_data) shares the sharding-spec code path
validated here and is exercised on real multi-host slices."""

import numpy as np
import pytest

import jax

from fxtpu.config import CorrelatorConfig
from fxtpu.fx import FxEngine
from fxtpu.ops.cplx import to_complex
from fxtpu.parallel import make_correlator_mesh
from fxtpu.parallel.ingest import block_sharding, local_sample_span, put_block


@pytest.fixture(scope="module")
def mesh():
    return make_correlator_mesh(4, 2, devices=jax.devices()[:8])


def _block(rng, nch=2, ns=2**13):
    return (rng.normal(size=(nch, ns)) + 1j * rng.normal(size=(nch, ns))
            ).astype(np.complex64)


def test_put_block_sharded_placement(rng, mesh):
    blk = _block(rng)
    iq = put_block(blk, mesh)
    want = block_sharding(mesh)
    assert iq.re.sharding == want and iq.im.sharding == want
    np.testing.assert_allclose(to_complex(iq), blk, atol=0)


def test_put_block_no_mesh_single_device(rng):
    blk = _block(rng)
    iq = put_block(blk, None)
    np.testing.assert_allclose(to_complex(iq), blk, atol=0)


def test_engine_prepare_block_uses_mesh_sharding(rng, mesh):
    cfg = CorrelatorConfig(num_samp=2**13, nbins=256, clamp_num_samp=False)
    eng = FxEngine(cfg, mesh=mesh)
    iq = eng.prepare_block(_block(rng, ns=cfg.num_samp))
    assert iq.re.sharding == block_sharding(mesh)
    # and the sharded step consumes it directly
    import jax.numpy as jnp
    vis, _ = eng.step(iq, jnp.zeros((2,), jnp.float32), eng.fresh_history())
    assert to_complex(vis).shape == (1, 256)


def test_local_sample_span_single_process_covers_all(mesh):
    start, stop = local_sample_span(mesh, 2**13)
    assert (start, stop) == (0, 2**13)  # one process owns every device


def test_int8_mesh_ingest_matches_f32(rng, mesh):
    """int8 planes ship through the mesh path (4x fewer H2D bytes) and the
    sharded step dequantizes IN-GRAPH — results must match the f32 mesh
    path to quantization precision."""
    import jax.numpy as jnp

    from fxtpu.sources.base import QuantizedSource
    from fxtpu.sources.synthetic import NoiseSource

    ns, nbins = 2**13, 256
    step = 1.0 / 32
    src_q = QuantizedSource(NoiseSource(nchan=2, seed=42), quant_step=step)
    blk_q = src_q.read_block(ns)
    # f32 oracle: the DEQUANTIZED values (identical math after the
    # on-device convert — tests the plumbing, not quantization SNR)
    blk_f = ((blk_q[..., 0].astype(np.float32)
              + 1j * blk_q[..., 1].astype(np.float32)) * step
             ).astype(np.complex64)

    cfg_f = CorrelatorConfig(num_samp=ns, nbins=nbins, clamp_num_samp=False)
    cfg_q = CorrelatorConfig(num_samp=ns, nbins=nbins, clamp_num_samp=False,
                             ingest_dtype="int8")
    eng_f = FxEngine(cfg_f, mesh=mesh)
    eng_q = FxEngine(cfg_q, mesh=mesh)

    iq_f = eng_f.prepare_block(blk_f)
    iq_q = eng_q.prepare_block(blk_q)
    # the int8 planes must reach the device AS int8, mesh-sharded
    assert iq_q.re.dtype == np.int8 and iq_q.im.dtype == np.int8
    assert iq_q.re.sharding == block_sharding(mesh)
    # 4x byte accounting: int8 planes are 2 B/sample vs 8 B for f32 pairs
    bytes_q = iq_q.re.nbytes + iq_q.im.nbytes
    bytes_f = iq_f.re.nbytes + iq_f.im.nbytes
    assert bytes_f == 4 * bytes_q

    d = jnp.zeros((2,), jnp.float32)
    vis_f, _ = eng_f.step(iq_f, d, eng_f.fresh_history())
    vis_q, _ = eng_q.step(iq_q, d, eng_q.fresh_history())
    vf, vq = to_complex(vis_f), to_complex(vis_q)
    scale = np.abs(vf).max()
    np.testing.assert_allclose(vq / scale, vf / scale, atol=1e-5)
