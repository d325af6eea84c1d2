"""True multi-process (multi-host) execution tests (SURVEY.md §5.8).

These launch REAL separate Python processes that rendezvous through
``jax.distributed.initialize`` (gloo collectives over TCP — the same
multi-controller code path a multi-host GPU run takes over NCCL), each
owning 4 virtual CPU devices of an 8-device global mesh, and assert the
distributed results equal the single-process runs bit-for-bit-close.

Reference analog being generalized: the single-host queue transport at
``/root/reference/effex/effex.py:105-110``.
"""

import os

import numpy as np
import pytest

import jax

from fxtpu.parallel.multihost import launch

# one launch spawns fresh interpreters + gloo rendezvous: ~20-40 s each
pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

NBINS = 256
NUM_SAMP = NBINS * 64


def _single_process_step():
    """The same deterministic step the `step` role runs, on this process's
    8 virtual devices (conftest)."""
    from fxtpu.config import CorrelatorConfig
    from fxtpu.fx import FxEngine
    from fxtpu.parallel.ingest import put_block
    from fxtpu.parallel.mesh import make_correlator_mesh

    mesh = make_correlator_mesh(4, 2)
    cfg = CorrelatorConfig(mode="SPECTRUM", nchan=2, ntaps=4, nbins=NBINS,
                           num_samp=NUM_SAMP, clamp_num_samp=False)
    eng = FxEngine(cfg, mesh=mesh)
    rng = np.random.default_rng(20260817)
    block = (rng.normal(size=(2, NUM_SAMP)).astype(np.float32)
             + 1j * rng.normal(size=(2, NUM_SAMP)).astype(np.float32)
             ).astype(np.complex64)
    iq = put_block(block, mesh)
    delays = np.asarray([0.0, 1.25e-6], np.float32)
    vis, hist = eng.step(iq, delays, eng.fresh_history())
    return (np.asarray(jax.device_get(vis)),
            np.stack([np.asarray(jax.device_get(hist.re)),
                      np.asarray(jax.device_get(hist.im))]))


def test_two_process_step_matches_single_process(tmp_path):
    """2-process sharded FX step (make_array_from_process_local_data
    ingest, each process materializing only its local sample span) must
    produce the single-process mesh result."""
    out = str(tmp_path / "mh_step.npz")
    args = ["--out", out, "--nbins", str(NBINS),
            "--num_samp", str(NUM_SAMP)]
    results = launch(2, "step", args)
    assert all(r.returncode == 0 for r in results)
    got = np.load(out)
    want_vis, want_hist = _single_process_step()
    np.testing.assert_allclose(got["vis"], want_vis, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(got["hist"], want_hist, rtol=1e-6, atol=1e-6)


def test_two_process_correlator_product_matches(tmp_path):
    """Full 2-process Correlator run over a replay recording — feeders
    read only their local spans, process 0 writes the CSV — must produce
    the same product as the single-process mesh run."""
    from fxtpu.config import CorrelatorConfig
    from fxtpu.correlator import Correlator
    from fxtpu.parallel.mesh import make_correlator_mesh
    from fxtpu.products import load_products
    from fxtpu.sources import NoiseSource, save_recording

    rec = save_recording(NoiseSource(nchan=2, seed=11, delays=[0.0, 2.5e-6]),
                         str(tmp_path / "rec.npy"), NUM_SAMP, 4)

    # --- single-process (mesh) oracle ---------------------------------
    ref_csv = str(tmp_path / "ref.csv")
    cfg = CorrelatorConfig(
        mode="SPECTRUM", nchan=2, nbins=NBINS, num_samp=NUM_SAMP,
        clamp_num_samp=False, source="replay", replay_file=rec,
        run_time=30, loglevel="WARNING", output_file=ref_csv,
        startup_duration=0.2)
    cor = Correlator(config=cfg, mesh=make_correlator_mesh(4, 2))
    cor.run_state_machine()
    ref_delays = cor.calibrated_delays.copy()

    # --- 2-process run -------------------------------------------------
    mh_csv = str(tmp_path / "mh.csv")
    results = launch(2, "correlate",
                     ["--recording", rec, "--out", mh_csv,
                      "--nbins", str(NBINS), "--num_samp", str(NUM_SAMP)])
    assert all(r.returncode == 0 for r in results)
    # worker 0 prints the calibrated delays — the injected 2.5 us must be
    # recovered by the in-graph multi-host calibration too (assert the
    # VALUE, not just that the run finished)
    w0 = next(r.stdout for r in results if "[correlate worker 0]" in r.stdout)
    assert "blocks=3" in w0, w0[-500:]
    import re
    m = re.search(r"delays_us=\[([^\]]+)\]", w0)
    assert m, w0[-500:]
    mh_delay_us = float(m.group(1).split()[-1])
    assert abs(mh_delay_us - 2.5) < 0.5 / 2.4e6 * 1e6  # 0.5-sample oracle

    meta_ref, data_ref = load_products(ref_csv)
    meta_mh, data_mh = load_products(mh_csv)
    assert meta_ref == meta_mh
    assert data_ref.shape == data_mh.shape == (3, NBINS)
    np.testing.assert_allclose(data_mh.real, data_ref.real,
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(data_mh.imag, data_ref.imag,
                               rtol=2e-4, atol=1e-5)
    # sanity: the reference run recovered the injected delay
    assert abs(ref_delays[1] - 2.5e-6) < 0.5 / 2.4e6


def test_local_sample_span_single_process():
    """Span accounting: in a single-process runtime every sample belongs
    to this process."""
    from fxtpu.parallel.ingest import local_sample_span
    from fxtpu.parallel.mesh import make_correlator_mesh

    mesh = make_correlator_mesh(4, 2)
    assert local_sample_span(mesh, 1024) == (0, 1024)


def test_span_sources_match_full_reads():
    """read_block_span must return exactly the [start, stop) slice of what
    read_block would have produced, for replay, synthetic-default, and
    quantized sources."""
    from fxtpu.sources import NoiseSource
    from fxtpu.sources.base import QuantizedSource
    from fxtpu.sources.replay import ReplaySource, save_recording
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        rec = save_recording(NoiseSource(nchan=2, seed=3), f"{d}/r.npy",
                             1024, 3)
        a, b = ReplaySource(rec), ReplaySource(rec)
        for _ in range(3):
            full = a.read_block(1024)
            span = b.read_block_span(1024, 256, 768)
            np.testing.assert_array_equal(full[:, 256:768], span)
        assert a.read_block(1024) is None
        assert b.read_block_span(1024, 256, 768) is None

        q1 = QuantizedSource(ReplaySource(rec))
        q2 = QuantizedSource(ReplaySource(rec))
        full = q1.read_block(1024)
        span = q2.read_block_span(1024, 0, 512)
        np.testing.assert_array_equal(full[:, :512], span)


def test_cli_multiprocess_run(tmp_path):
    """The CLI itself drives a 2-process distributed run (the same
    command a multi-host deployment runs per host): process 0 writes a
    valid CSV."""
    import subprocess
    import sys

    from fxtpu.parallel.multihost import _free_port
    from fxtpu.products import load_products
    from fxtpu.sources import NoiseSource, save_recording

    rec = save_recording(NoiseSource(nchan=2, seed=4), str(tmp_path / "r.npy"),
                         NUM_SAMP, 3)
    out = str(tmp_path / "vis_mh.csv")
    coord = f"127.0.0.1:{_free_port()}"
    common = [sys.executable, "-m", "fxtpu", "--source", "replay",
              "--replay_file", rec, "--num_samp", str(NUM_SAMP),
              "--resolution", str(NBINS), "--mode", "spectrum",
              "--omit_plot", "--no_keyboard", "--output", out,
              "--num_processes", "2", "--coordinator", coord,
              "--local_devices", "4", "-L", "WARNING"]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(common + ["--process_id", str(i)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        o, _ = p.communicate(timeout=600)
        outs.append(o)
    assert all(p.returncode == 0 for p in procs), outs
    md, data = load_products(out)
    assert md["mode"] == "SPECTRUM"
    assert data.shape == (2, NBINS)  # 3 blocks - 1 calibration block
    assert np.all(np.isfinite(data))
