"""System tests: the full state machine over synthetic/replay sources,
CSV products readable by the reference recipe, calibration recovery, and
the CLI.  The reference has NO automated analog of any of this (its
run_state_machine is never executed under pytest — SURVEY.md §4)."""

import numpy as np
import pytest

from fxtpu.config import CorrelatorConfig
from fxtpu.correlator import Correlator
from fxtpu.products import load_products
from fxtpu.sources import NoiseSource, ReplaySource, save_recording


def run_correlator(tmp_path, **kw):
    kw.setdefault("num_samp", 2**14)
    kw.setdefault("nbins", 2**10)
    kw.setdefault("run_time", 1)
    kw.setdefault("clamp_num_samp", False)
    kw.setdefault("loglevel", "WARNING")
    kw.setdefault("output_file", str(tmp_path / "vis.csv"))
    cfg = CorrelatorConfig(**kw)
    cor = Correlator(config=cfg)
    cor.run_state_machine()
    return cor


def test_spectrum_run_end_to_end(tmp_path):
    cor = run_correlator(tmp_path, mode="SPECTRUM", synthetic_delay=2e-6)
    assert cor.state == "SHUTDOWN"  # the machine ended through shutdown
    md, data = load_products(cor.output_file)
    assert md["mode"] == "SPECTRUM"
    assert data.ndim == 2 and data.shape[1] == 2**10
    assert data.shape[0] == cor.blocks_processed >= 1
    # calibration recovered the injected delay within the reference's
    # 0.5-sample oracle (test_effex.py:99)
    err_samples = abs(cor.calibrated_delays[1] - 2e-6) * 2.4e6
    assert err_samples < 0.5
    # calibrated cross-spectrum phase is flat in-band
    mean_spec = data.mean(axis=0)
    inner = slice(2**10 // 4, 3 * 2**10 // 4)
    ph = np.angle(mean_spec[inner])
    assert np.std(np.unwrap(ph)) < 0.3


def test_int8_ingest_end_to_end(tmp_path):
    """8-bit quantized ingest (int8 rings + int8 H2D, on-device dequant):
    calibration still recovers the injected delay and the calibrated
    spectrum phase stays flat — the quantization noise is far below the
    correlated signal at snr=10."""
    cor = run_correlator(tmp_path, mode="SPECTRUM", synthetic_delay=2e-6,
                         ingest_dtype="int8", blocks_per_dispatch=3)
    assert cor.bufs[0].dtype == np.int8
    err_samples = abs(cor.calibrated_delays[1] - 2e-6) * 2.4e6
    assert err_samples < 0.5
    _, data = load_products(cor.output_file)
    assert data.shape[0] == cor.blocks_processed >= 1
    ph = np.angle(data.mean(axis=0))
    inner = slice(2**10 // 4, 3 * 2**10 // 4)
    assert np.std(np.unwrap(ph[inner])) < 0.35


def test_int8_step_matches_dequantized_f32():
    """prepare_block(int8) through the step == from_complex of the
    dequantized values (identical math after the on-device convert)."""
    import jax.numpy as jnp
    from fxtpu.fx import FxEngine
    step = 1.0 / 32
    cfg = CorrelatorConfig(mode="SPECTRUM", num_samp=2**13, nbins=256,
                           clamp_num_samp=False, ingest_dtype="int8",
                           quant_step=step)
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, size=(2, cfg.num_samp, 2)).astype(np.int8)
    deq = ((q[..., 0].astype(np.float32)
            + 1j * q[..., 1].astype(np.float32)) * step
           ).astype(np.complex64)
    delays = jnp.asarray([0.0, 1e-7], jnp.float32)
    eng = FxEngine(cfg)
    cfg_f = CorrelatorConfig(mode="SPECTRUM", num_samp=2**13, nbins=256,
                             clamp_num_samp=False)
    eng_f = FxEngine(cfg_f)
    from fxtpu.ops.cplx import to_complex
    v_q, _ = eng.step(eng.prepare_block(q), delays, eng.fresh_history())
    v_f, _ = eng_f.step(eng_f.prepare_block(deq), delays,
                        eng_f.fresh_history())
    np.testing.assert_allclose(to_complex(v_q), to_complex(v_f), rtol=0,
                               atol=1e-6 * np.abs(to_complex(v_f)).max())


def test_first_staged_block_every_layout(tmp_path):
    """Correlator._first_staged_block returns BLOCK 0 for every staged
    batch layout: the [K, nch, ...] stack of f32 planes and of int8
    planes (mid-run recalibration estimates from this slice — taking the
    wrong axis hands the calibrator channel 0's blocks as channels)."""
    import jax

    from fxtpu.runtime.stager import Batch
    rng = np.random.default_rng(5)
    f32_blocks = [
        (rng.normal(size=(2, 2**13)) + 1j * rng.normal(size=(2, 2**13))
         ).astype(np.complex64) for _ in range(3)]
    i8_blocks = [rng.integers(-127, 128, size=(2, 2**13, 2)).astype(np.int8)
                 for _ in range(3)]
    cases = [
        (dict(), f32_blocks),
        (dict(ingest_dtype="int8"), i8_blocks),
    ]
    for kw, blks in cases:
        cfg = CorrelatorConfig(num_samp=2**13, nbins=2**10, run_time=1,
                               clamp_num_samp=False, loglevel="ERROR",
                               output_file=str(tmp_path / "v.csv"), **kw)
        cor = Correlator(config=cfg)
        batch = Batch(cor.engine.prepare_batch(blks), 3, True)
        first = cor._first_staged_block(batch)
        want = cor.engine.prepare_block(blks[0])
        for a, b in zip(jax.tree.leaves(first), jax.tree.leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), kw
        cor.close()


def test_calibrate_window_smaller_than_block(tmp_path):
    """calibrate_samples < num_samp: the delay is still recovered within
    the 0.5-sample oracle from the leading window only (keeps the cal
    executable's shape fixed across block sizes)."""
    cor = run_correlator(tmp_path, mode="SPECTRUM", synthetic_delay=2e-6,
                         calibrate_samples=2**12)
    err_samples = abs(cor.calibrated_delays[1] - 2e-6) * 2.4e6
    assert err_samples < 0.5


def test_continuum_run_end_to_end(tmp_path):
    cor = run_correlator(tmp_path, mode="CONTINUUM")
    md, data = load_products(cor.output_file)
    assert md["mode"] == "CONTINUUM"
    assert data.ndim == 1 and len(data) == cor.blocks_processed
    # correlated channels at snr=10: the block visibilities are COHERENT
    # — a common phase (the carrier-phase residual of the sub-sample
    # calibration error; ~1.15 rad here) with tiny scatter, and stable
    # amplitude.  A decorrelation regression gives random phases
    # (std ~ pi/sqrt(3)) and wildly varying amplitudes; the old
    # `|data| > 0` oracle was satisfied by pure noise.
    ph = np.angle(data)
    assert np.std(np.angle(np.exp(1j * (ph - ph[0])))) < 0.1
    amps = np.abs(data)
    assert amps.min() > 0.5 * amps.max()


def test_replay_run_matches_defined_length(tmp_path):
    src = NoiseSource(nchan=2, seed=8)
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**14, 6)
    cor = run_correlator(tmp_path, source="replay", replay_file=rec)
    # 6 recorded blocks: 1 consumed by calibrate-on-start, 5 correlated
    assert cor.blocks_processed == 5
    _, data = load_products(cor.output_file)
    assert data.shape[0] == 5


def test_no_calibrate_on_start(tmp_path):
    src = NoiseSource(nchan=2, seed=8)
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**14, 3)
    cor = run_correlator(tmp_path, source="replay", replay_file=rec,
                         calibrate_on_start=False)
    assert cor.blocks_processed == 3
    assert np.all(cor.calibrated_delays == 0)


def test_nchan4_run(tmp_path):
    cor = run_correlator(tmp_path, nchan=4, mode="SPECTRUM",
                         num_samp=2**13, nbins=2**9)
    md, data = load_products(cor.output_file)
    assert md["nchan"] == "4"
    # 6 baselines per block
    assert data.shape == (6 * cor.blocks_processed, 2**9)


def test_child_exception_shuts_down(tmp_path):
    from fxtpu.sources import FaultInjectingSource
    inner = NoiseSource(nchan=2, seed=1)
    src = FaultInjectingSource(inner, fail_at=3)
    cfg = CorrelatorConfig(num_samp=2**14, nbins=2**10, run_time=10,
                           clamp_num_samp=False, loglevel="ERROR",
                           output_file=str(tmp_path / "vis.csv"))
    cor = Correlator(config=cfg, source=src)
    cor.run_state_machine()  # must terminate despite the injected failure
    assert cor.blocks_processed <= 3


def test_single_channel_drop_realigns_end_to_end(tmp_path):
    """An injected SINGLE-channel stream gap (drop_channel) flows through
    a real Correlator run: the faulted channel's feeder skips the seq,
    the BlockAligner discards the siblings' now-unpairable blocks
    (realigned > 0), and the surviving product rows stay phase-coherent —
    misaligned noise blocks would decorrelate them (SURVEY §5.2/§5.3)."""
    from fxtpu.sources import FaultInjectingSource
    src = NoiseSource(nchan=2, seed=23, delays=[0.0, 1e-6])
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**14, 10)
    faulted = FaultInjectingSource(ReplaySource(rec), drop_every=3,
                                   drop_channel=1)
    cfg = CorrelatorConfig(num_samp=2**14, nbins=2**10, run_time=60,
                           clamp_num_samp=False, loglevel="WARNING",
                           output_file=str(tmp_path / "vis.csv"))
    cor = Correlator(config=cfg, source=faulted)
    cor.run_state_machine()
    # ch1 lost reads 3/6/9's blocks -> 2 full drops before exhaustion
    assert cor.aligner.realigned >= 2
    # 10 blocks, ch1 kept 8 of them -> 8 aligned pairs = 1 cal + 7 rows
    assert cor.blocks_processed == 7
    _, data = load_products(cor.output_file)
    assert np.atleast_2d(data).shape[0] == 7
    err_samples = abs(cor.calibrated_delays[1] - 1e-6) * 2.4e6
    assert err_samples < 0.5
    ph = np.angle(np.atleast_2d(data).mean(axis=0))
    inner = slice(2**10 // 4, 3 * 2**10 // 4)
    assert np.std(np.unwrap(ph[inner])) < 0.35
    # single-channel drops DIVERGE the channels' stream positions: a
    # snapshot of this run must refuse to resume (no one cursor can
    # reproduce both channels) instead of realigning wrongly
    snap = cor.snapshot(str(tmp_path / "div.state.npz"))
    cfg2 = CorrelatorConfig(num_samp=2**14, nbins=2**10, run_time=60,
                            clamp_num_samp=False, loglevel="WARNING",
                            calibrate_on_start=False, resume_from=snap,
                            output_file=str(tmp_path / "r.csv"))
    with pytest.raises(ValueError, match="cannot resume"):
        Correlator(config=cfg2, source=FaultInjectingSource(
            ReplaySource(rec), drop_every=3, drop_channel=1))


def test_cli_end_to_end(tmp_path):
    from fxtpu.cli import main
    out = str(tmp_path / "cli.csv")
    cor = main(["--time", "1", "--mode", "continuum",
                "--num_samp", "16384", "--resolution", "1024",
                "--true_delay", "1e-6", "--omit_plot", "--no_keyboard",
                "--output", out, "-L", "ERROR"])
    md, data = load_products(out)
    assert md["mode"] == "CONTINUUM"
    assert len(np.atleast_1d(data)) >= 1
    err_samples = abs(cor.calibrated_delays[1] - 1e-6) * 2.4e6
    assert err_samples < 0.5


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_recalibration_mid_run_staged(tmp_path, ingest):
    """Mid-run 'c' on the async staged path (blocks_per_dispatch > 1):
    calibration runs on the first block of the next staged device batch and
    the batch is still correlated (no samples dropped — documented
    deviation from the reference, which discards its cal chunk).  Both
    ingest widths: int8 batches carry int8 planes to the calibrator."""
    cfg = CorrelatorConfig(num_samp=2**14, nbins=2**10, run_time=1,
                           clamp_num_samp=False, loglevel="ERROR",
                           synthetic_delay=1e-6, blocks_per_dispatch=4,
                           ingest_dtype=ingest,
                           output_file=str(tmp_path / "vis.csv"))
    cor = Correlator(config=cfg)
    import threading
    import time as _time

    def press_c():
        for _ in range(200):
            if cor.state == "RUN" and cor.blocks_processed > 0:
                cor.kbd_queue.put("c")
                return
            _time.sleep(0.02)

    threading.Thread(target=press_c, daemon=True).start()
    cor.run_state_machine()
    assert cor.stager is not None and cor.stager.done
    err_samples = abs(cor.calibrated_delays[1] - 1e-6) * 2.4e6
    assert err_samples < 0.5
    _, data = load_products(cor.output_file)
    assert data.shape[0] == cor.blocks_processed >= 4


def test_recalibration_mid_run(tmp_path):
    """The 'c' command path: a queued keypress triggers CALIBRATE from RUN
    (effex.py:332-336)."""
    cfg = CorrelatorConfig(num_samp=2**14, nbins=2**10, run_time=1,
                           clamp_num_samp=False, loglevel="ERROR",
                           synthetic_delay=1e-6,
                           output_file=str(tmp_path / "vis.csv"))
    cor = Correlator(config=cfg)

    # inject the keypress once the machine is actually RUNning
    import threading

    def press_c():
        import time
        for _ in range(100):
            if cor.state == "RUN":
                cor.kbd_queue.put("c")
                return
            time.sleep(0.02)

    threading.Thread(target=press_c, daemon=True).start()
    cor.run_state_machine()
    err_samples = abs(cor.calibrated_delays[1] - 1e-6) * 2.4e6
    assert err_samples < 0.5


def test_integration_blocks_accumulation(tmp_path):
    """integration_blocks=3: three block visibilities average into one
    output row (SURVEY.md §5.4 long-integration extension)."""
    src = NoiseSource(nchan=2, seed=12)
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**14, 7)
    cor = run_correlator(tmp_path, source="replay", replay_file=rec,
                         mode="SPECTRUM", integration_blocks=3)
    # 7 blocks: 1 calibrate + 6 correlated -> 2 integrated rows
    assert cor.blocks_processed == 6
    _, data = load_products(cor.output_file)
    assert data.shape[0] == 2


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_snapshot_resume_roundtrip(tmp_path, ingest):
    """A resumed run continues the replay exactly where the snapshot was
    taken: total written rows across both runs equals a single full run.
    int8 ingest resumes identically — quantization is deterministic and
    the f32 planes history snapshots losslessly."""
    src = NoiseSource(nchan=2, seed=13)
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**14, 8)

    # full single run for the oracle
    cor_full = run_correlator(tmp_path, source="replay", replay_file=rec,
                              ingest_dtype=ingest,
                              output_file=str(tmp_path / "full.csv"))
    _, full = load_products(cor_full.output_file)
    assert full.shape[0] == 7  # 8 blocks - 1 calibrate

    # run A: snapshot every 2 blocks, then simulate interrupt by a short
    # replay (only the first 5 blocks available)
    recA = str(tmp_path / "recA.npy")
    np.save(recA, np.load(rec)[:, : 5 * 2**14])
    corA = run_correlator(tmp_path, source="replay", replay_file=recA,
                          snapshot_every=2, ingest_dtype=ingest,
                          output_file=str(tmp_path / "a.csv"))
    assert corA.blocks_processed == 4
    snap = corA.snapshot_path
    import os
    assert os.path.exists(snap)

    # run B: resume from A's snapshot over the FULL recording; disable
    # calibrate-on-start (delays come from the snapshot)
    corB = run_correlator(tmp_path, source="replay", replay_file=rec,
                          calibrate_on_start=False, resume_from=snap,
                          ingest_dtype=ingest,
                          output_file=str(tmp_path / "b.csv"))
    _, b = load_products(str(tmp_path / "b.csv"))
    assert corB.blocks_processed == 7  # continued 4 -> 7
    # resumed delays match the original calibration
    assert np.allclose(corB.calibrated_delays, corA.calibrated_delays)
    # and the resumed rows equal the tail of the full run
    b = np.atleast_2d(b)
    np.testing.assert_allclose(b, full[4:], rtol=2e-4, atol=1e-9)


def test_zero_copy_feeders_are_the_production_path(tmp_path):
    """A plain replay Correlator run (not a bench rig) spawns one feeder
    per channel, each on the zero-copy reserve/commit producer loop (the
    >=100 MS/s host plane must be what production actually runs).  Products match the single-feeder path."""
    src = NoiseSource(nchan=2, seed=17)
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**14, 6)

    cor = run_correlator(tmp_path, source="replay", replay_file=rec,
                         output_file=str(tmp_path / "zc.csv"))
    assert len(cor.feeders) == 2
    assert all(f.zero_copy for f in cor.feeders)

    cor1 = run_correlator(tmp_path, source="replay", replay_file=rec,
                          channel_feeders=False,
                          output_file=str(tmp_path / "one.csv"))
    assert len(cor1.feeders) == 1 and not cor1.feeders[0].zero_copy
    _, zc = load_products(str(tmp_path / "zc.csv"))
    _, one = load_products(str(tmp_path / "one.csv"))
    np.testing.assert_allclose(zc, one, rtol=2e-5, atol=1e-10)


def test_zero_copy_feeders_int8(tmp_path):
    """int8 ingest splits per channel too: QuantizedSource splits quantize
    straight into the int8 ring slots (read_block_into)."""
    src = NoiseSource(nchan=2, seed=18)
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**14, 6)
    cor = run_correlator(tmp_path, source="replay", replay_file=rec,
                         ingest_dtype="int8",
                         output_file=str(tmp_path / "zc8.csv"))
    assert len(cor.feeders) == 2
    assert all(f.zero_copy for f in cor.feeders)
    assert cor.bufs[0].dtype == np.int8
    _, d = load_products(str(tmp_path / "zc8.csv"))
    assert np.atleast_2d(d).shape[0] == cor.blocks_processed >= 1


def test_snapshot_resume_synthetic_source(tmp_path):
    """Resume with a NoiseSource regenerates the SAME noise the
    uninterrupted run would have (SURVEY §5.4 resume contract): the
    snapshot carries the generator state at ``blocks_consumed`` — from the
    feeder's per-block state log, NOT the source's current state, which
    has read AHEAD into the rings — so the resumed rows equal the tail of
    a single full run."""
    from fxtpu.sources import LimitedSource

    def run(limit, output, **kw):
        cfg = CorrelatorConfig(num_samp=2**14, nbins=2**10, run_time=60,
                               clamp_num_samp=False, loglevel="WARNING",
                               output_file=str(tmp_path / output), **kw)
        src = LimitedSource(NoiseSource(nchan=2, seed=31,
                                        delays=[0.0, 1e-6]), limit)
        cor = Correlator(config=cfg, source=src)
        cor.run_state_machine()
        return cor

    # oracle: one uninterrupted 8-block run (1 calibrate + 7 rows)
    cor_full = run(8, "full.csv")
    _, full = load_products(cor_full.output_file)
    assert full.shape[0] == 7

    # run A: same stream, exhausted after 5 blocks, snapshotting every 2
    corA = run(5, "a.csv", snapshot_every=2)
    assert corA.blocks_processed == 4
    import os
    assert os.path.exists(corA.snapshot_path)

    # run B: FRESH same-seed source + restore -> continues blocks 5..7
    corB = run(3, "b.csv", calibrate_on_start=False,
               resume_from=corA.snapshot_path)
    assert corB.blocks_processed == 7
    assert np.allclose(corB.calibrated_delays, corA.calibrated_delays)
    _, b = load_products(str(tmp_path / "b.csv"))
    np.testing.assert_allclose(np.atleast_2d(b), full[4:], rtol=2e-4,
                               atol=1e-9)


def test_snapshot_resume_with_aligned_drops(tmp_path):
    """Source-reported drops open GAPS in the ring seqs, so the consumed
    COUNT is no longer a stream position: the snapshot must key its
    source-state lookup on the last processed block's SEQ (r3 review
    finding — the count-keyed lookup silently restored an earlier
    position and re-correlated already-processed samples)."""
    from fxtpu.sources import FaultInjectingSource

    src = NoiseSource(nchan=2, seed=41)
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**14, 10)

    def run(replay, output, **kw):
        cfg = CorrelatorConfig(num_samp=2**14, nbins=2**10, run_time=60,
                               clamp_num_samp=False, loglevel="WARNING",
                               output_file=str(tmp_path / output), **kw)
        cor = Correlator(config=cfg, source=FaultInjectingSource(
            ReplaySource(replay), drop_every=3))
        cor.run_state_machine()
        return cor

    # oracle: uninterrupted faulted run — drops at reads 3/6 lose blocks
    # 3 and 7; 8 blocks survive = 1 cal + 7 rows
    cor_full = run(rec, "full.csv")
    _, full = load_products(cor_full.output_file)
    assert full.shape[0] == 7

    # run A: only the first 6 recorded blocks available
    recA = str(tmp_path / "recA.npy")
    np.save(recA, np.load(rec)[:, : 6 * 2**14])
    corA = run(recA, "a.csv", snapshot_every=2)
    assert corA.blocks_processed == 4  # kept seqs 0,1,3,4,5

    # run B: fresh faulted source + restore -> continues the SCHEDULE
    # (count) and the STREAM (cursor) exactly where A's snapshot was
    corB = run(rec, "b.csv", calibrate_on_start=False,
               resume_from=corA.snapshot_path)
    assert corB.blocks_processed == 7
    _, b = load_products(str(tmp_path / "b.csv"))
    np.testing.assert_allclose(np.atleast_2d(b), full[4:], rtol=2e-4,
                               atol=1e-9)


def test_resume_refuses_without_stream_state(tmp_path):
    """A snapshot with no source stream state + a non-seekable source must
    refuse to resume (silently correlating DIFFERENT noise against the
    snapshotted tap history is the failure mode this guards)."""
    from fxtpu.sources import LimitedSource

    cfg = CorrelatorConfig(num_samp=2**14, nbins=2**10, run_time=60,
                           clamp_num_samp=False, loglevel="WARNING",
                           snapshot_every=2,
                           output_file=str(tmp_path / "a.csv"))
    src = LimitedSource(NoiseSource(nchan=2, seed=32), 5)
    cor = Correlator(config=cfg, source=src)
    cor.run_state_machine()
    snap = cor.snapshot_path

    # strip the stream state (a legacy / live-source snapshot)
    with np.load(snap, allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files if k != "meta_source_state"}
    np.savez(snap, **payload)

    cfg2 = CorrelatorConfig(num_samp=2**14, nbins=2**10, run_time=60,
                            clamp_num_samp=False, loglevel="WARNING",
                            calibrate_on_start=False, resume_from=snap,
                            output_file=str(tmp_path / "b.csv"))
    with pytest.raises(ValueError, match="cannot resume"):
        Correlator(config=cfg2, source=LimitedSource(
            NoiseSource(nchan=2, seed=32), 3))


def test_metrics_report(tmp_path):
    cor = run_correlator(tmp_path, mode="CONTINUUM")
    r = cor.metrics.rates()
    assert r["samples_per_s"] > 0
    assert cor.metrics.get("blocks") == cor.blocks_processed
    assert "fx_step" in cor.metrics.report()


def test_blocks_per_dispatch_batching(tmp_path):
    """Batched (scanned) dispatch produces the same product rows as
    per-block dispatch over the same recording."""
    src = NoiseSource(nchan=2, seed=21)
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**14, 9)
    cor1 = run_correlator(tmp_path, source="replay", replay_file=rec,
                          output_file=str(tmp_path / "one.csv"))
    corK = run_correlator(tmp_path, source="replay", replay_file=rec,
                          blocks_per_dispatch=4,
                          output_file=str(tmp_path / "k.csv"))
    _, d1 = load_products(str(tmp_path / "one.csv"))
    _, dK = load_products(str(tmp_path / "k.csv"))
    assert d1.shape == dK.shape == (8, 2**10)
    np.testing.assert_allclose(dK, d1, rtol=2e-4, atol=1e-12)


def test_blocks_per_dispatch_test_mode_sweep(tmp_path):
    """TEST-mode sweep advances identically under batched dispatch."""
    src = NoiseSource(nchan=2, seed=22, snr=100)
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**14, 9)
    kw = dict(source="replay", replay_file=rec, mode="TEST",
              test_sweep_step=1e-7, test_offset_steps=4)
    cor1 = run_correlator(tmp_path, output_file=str(tmp_path / "one.csv"),
                          **kw)
    corK = run_correlator(tmp_path, blocks_per_dispatch=4,
                          output_file=str(tmp_path / "k.csv"), **kw)
    assert np.allclose(cor1.calibrated_delays, corK.calibrated_delays)
    _, d1 = load_products(str(tmp_path / "one.csv"))
    _, dK = load_products(str(tmp_path / "k.csv"))
    np.testing.assert_allclose(np.abs(dK), np.abs(d1), rtol=2e-3)


def test_mesh_sharded_correlator_run(tmp_path):
    """Full state machine with the engine sharded over a 4x2 (time, freq)
    virtual mesh — products match the single-device run."""
    from fxtpu.parallel import make_correlator_mesh
    src = NoiseSource(nchan=2, seed=31)
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**16, 5)

    cor1 = run_correlator(tmp_path, num_samp=2**16, source="replay",
                          replay_file=rec,
                          output_file=str(tmp_path / "one.csv"))

    cfg = CorrelatorConfig(num_samp=2**16, nbins=2**10, run_time=1,
                           clamp_num_samp=False, loglevel="WARNING",
                           source="replay", replay_file=rec,
                           output_file=str(tmp_path / "mesh.csv"))
    corM = Correlator(config=cfg, mesh=make_correlator_mesh(4, 2))
    corM.run_state_machine()

    _, d1 = load_products(str(tmp_path / "one.csv"))
    _, dM = load_products(str(tmp_path / "mesh.csv"))
    assert d1.shape == dM.shape == (4, 2**10)
    np.testing.assert_allclose(dM, d1, rtol=1e-3, atol=1e-11)
    assert np.allclose(cor1.calibrated_delays, corM.calibrated_delays,
                       atol=1e-9)


def test_cli_mesh_run(tmp_path):
    from fxtpu.cli import main
    out = str(tmp_path / "cli_mesh.csv")
    cor = main(["--time", "1", "--mode", "spectrum",
                "--num_samp", "65536", "--resolution", "1024",
                "--mesh_time", "4", "--mesh_freq", "2",
                "--omit_plot", "--no_keyboard", "--output", out,
                "-L", "ERROR"])
    _, data = load_products(out)
    assert data.shape[-1] == 1024


def test_int8_batched_snapshot_end_to_end(tmp_path):
    """Full Correlator run at int8 ingest on the async staged batch path
    with periodic snapshots: calibration still recovers the injected
    delay, the product's phase is flat in band, and the snapshot holds the
    planes history."""
    import os

    from fxtpu.runtime import checkpoint
    cor = run_correlator(tmp_path, mode="SPECTRUM", synthetic_delay=2e-6,
                         ingest_dtype="int8", blocks_per_dispatch=2,
                         snapshot_every=2)
    err_samples = abs(cor.calibrated_delays[1] - 2e-6) * 2.4e6
    assert err_samples < 0.5
    _, data = load_products(cor.output_file)
    assert data.shape[0] == cor.blocks_processed >= 1
    ph = np.angle(data.mean(axis=0))
    inner = slice(2**10 // 4, 3 * 2**10 // 4)
    assert np.std(np.unwrap(ph[inner])) < 0.35
    assert os.path.exists(cor.snapshot_path)
    state = checkpoint.load_state(cor.snapshot_path)
    assert state["history"].shape == (2, cor.config.ntaps - 1, 2**10)


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_nchan2_with_autos_emits_all_baselines(tmp_path, ingest):
    """nchan=2 + include_autos has THREE baselines — (0,0), (1,1), (0,1),
    autos first — so the single-row reference-parity squeeze must not
    apply: squeezing vis[0] would write the channel-0 AUTOSPECTRUM as the
    product and silently discard the cross visibility (r2 review
    finding).  Both ingest widths."""
    cor = run_correlator(tmp_path, mode="SPECTRUM", nchan=2,
                         ingest_dtype=ingest, include_autos=True,
                         synthetic_delay=1e-6)
    assert len(cor.engine.pairs) == 3
    _, data = load_products(cor.output_file)
    assert data.shape == (3 * cor.blocks_processed, 2**10)
    # rows come in (auto0, auto1, cross) triples: autos are real and
    # positive, the cross is genuinely complex
    auto0 = data[0::3]
    cross = data[2::3]
    assert np.abs(auto0.imag).max() < 1e-3 * np.abs(auto0.real).max()
    assert np.abs(cross.imag).max() > 1e-3 * np.abs(cross.real).max()


def test_int8_engine_accepts_complex_blocks():
    """An int8-ingest engine handed COMPLEX samples (no QuantizedSource
    upstream) quantizes at cfg.quant_step itself, so the step sees the
    same codes a quantizing source would send (r2 review finding).  The
    result must equal feeding the explicitly quantized int8 block, for
    single blocks and batches alike."""
    import jax.numpy as jnp

    from fxtpu.fx import FxEngine
    from fxtpu.ops.cplx import to_complex
    from fxtpu.runtime.native import quantize_c64
    step = 1.0 / 32
    cfg = CorrelatorConfig(mode="SPECTRUM", num_samp=2**13, nbins=256,
                           clamp_num_samp=False, ingest_dtype="int8",
                           quant_step=step)
    eng = FxEngine(cfg)
    rng = np.random.default_rng(4)
    blk = (rng.normal(size=(2, cfg.num_samp))
           + 1j * rng.normal(size=(2, cfg.num_samp))
           ).astype(np.complex64)
    q = quantize_c64(blk, step)
    delays = jnp.asarray([0.0, 1e-7], jnp.float32)
    v_c, _ = eng.step(eng.prepare_block(blk), delays, eng.fresh_history())
    v_q, _ = eng.step(eng.prepare_block(q), delays, eng.fresh_history())
    np.testing.assert_array_equal(np.asarray(to_complex(v_c)),
                                  np.asarray(to_complex(v_q)))
    b_c = eng.prepare_batch([blk, blk])
    b_q = eng.prepare_batch([q, q])
    assert b_c.re.dtype == jnp.int8 and b_c.re.shape == (2, 2, cfg.num_samp)
    np.testing.assert_array_equal(np.asarray(b_c.re), np.asarray(b_q.re))
    np.testing.assert_array_equal(np.asarray(b_c.im), np.asarray(b_q.im))


def test_zero_copy_feeders_synthetic(tmp_path):
    """A PLAIN SYNTHETIC run (no replay detour) spawns per-channel
    zero-copy feeders: NoiseSource splits via counter-keyed regeneration
   , so the default `python -m fxtpu` config
    exercises the production ingest path.  Products match the
    single-feeder run bit-for-bit — the splits ARE the same stream."""
    cor = run_correlator(tmp_path, synthetic_delay=1e-6,
                         output_file=str(tmp_path / "zc.csv"))
    assert len(cor.feeders) == 2
    assert all(f.zero_copy for f in cor.feeders)

    cor1 = run_correlator(tmp_path, synthetic_delay=1e-6,
                          channel_feeders=False,
                          output_file=str(tmp_path / "one.csv"))
    assert len(cor1.feeders) == 1 and not cor1.feeders[0].zero_copy
    _, zc = load_products(str(tmp_path / "zc.csv"))
    _, one = load_products(str(tmp_path / "one.csv"))
    n = min(len(zc), len(one))  # wall-clock run_time: row counts may differ
    assert n >= 1
    np.testing.assert_allclose(zc[:n], one[:n], rtol=2e-5, atol=1e-10)


def test_single_channel_drop_synthetic_no_replay(tmp_path):
    """drop_channel fault injection straight over a NoiseSource — the
    splittable synthetics make the realign path reachable without
    recording to .npy first."""
    from fxtpu.sources import FaultInjectingSource, LimitedSource
    inner = LimitedSource(NoiseSource(nchan=2, seed=23, delays=[0, 1e-6]),
                          10)
    faulted = FaultInjectingSource(inner, drop_every=3, drop_channel=1)
    cfg = CorrelatorConfig(num_samp=2**14, nbins=2**10, run_time=60,
                           clamp_num_samp=False, loglevel="WARNING",
                           output_file=str(tmp_path / "vis.csv"))
    cor = Correlator(config=cfg, source=faulted)
    cor.run_state_machine()
    assert cor.aligner.realigned >= 2
    assert cor.blocks_processed == 7  # 10 blocks, ch1 kept 8 -> 1 cal + 7
    _, data = load_products(cor.output_file)
    assert np.atleast_2d(data).shape[0] == 7
    err_samples = abs(cor.calibrated_delays[1] - 1e-6) * 2.4e6
    assert err_samples < 0.5
    ph = np.angle(np.atleast_2d(data).mean(axis=0))
    inner_band = slice(2**10 // 4, 3 * 2**10 // 4)
    assert np.std(np.unwrap(ph[inner_band])) < 0.35


def test_mesh_batched_dispatch_end_to_end(tmp_path):
    """Mesh Correlator run with blocks_per_dispatch > 1: the sharded
    multi_step batches K blocks per dispatch and products still match the
    single-device run."""
    from fxtpu.parallel import make_correlator_mesh
    src = NoiseSource(nchan=2, seed=37)
    rec = save_recording(src, str(tmp_path / "rec.npy"), 2**16, 9)

    cor1 = run_correlator(tmp_path, num_samp=2**16, source="replay",
                          replay_file=rec,
                          output_file=str(tmp_path / "one.csv"))

    cfg = CorrelatorConfig(num_samp=2**16, nbins=2**10, run_time=1,
                           clamp_num_samp=False, loglevel="WARNING",
                           source="replay", replay_file=rec,
                           blocks_per_dispatch=4, buffer_chunks=16,
                           output_file=str(tmp_path / "mesh.csv"))
    corM = Correlator(config=cfg, mesh=make_correlator_mesh(4, 2))
    assert corM._dispatch_batch == 4  # scan path takes the full batch
    corM.run_state_machine()

    _, d1 = load_products(str(tmp_path / "one.csv"))
    _, dM = load_products(str(tmp_path / "mesh.csv"))
    assert d1.shape == dM.shape == (8, 2**10)
    np.testing.assert_allclose(dM, d1, rtol=1e-3, atol=1e-11)
    assert np.allclose(cor1.calibrated_delays, corM.calibrated_delays,
                       atol=1e-9)


def test_rtl_u8_capture_end_to_end(tmp_path):
    """A NATIVE rtl_sdr capture (raw interleaved u8 I,Q, one file per
    channel) drives the full int8 pipeline: 8-bit from file to packed
    kernel with no float detour, per-channel zero-copy feeders, and
    calibration recovers the delay baked into the capture."""
    from fxtpu.sources.base import QuantizedSource
    q = QuantizedSource(NoiseSource(nchan=2, seed=47, delays=[0, 2e-6]))
    arr = np.concatenate([q.read_block(2**14) for _ in range(6)], axis=1)
    paths = []
    for c in range(2):
        u8 = (arr[c].astype(np.int16) + 128).astype(np.uint8)
        p = str(tmp_path / f"ch{c}.iq")
        u8.tofile(p)
        paths.append(p)

    cor = run_correlator(tmp_path, source="replay",
                         replay_file=",".join(paths),
                         ingest_dtype="int8",
                         output_file=str(tmp_path / "u8.csv"))
    assert len(cor.feeders) == 2
    assert all(f.zero_copy for f in cor.feeders)
    assert cor.bufs[0].dtype == np.int8
    err_samples = abs(cor.calibrated_delays[1] - 2e-6) * 2.4e6
    assert err_samples < 0.5
    _, data = load_products(str(tmp_path / "u8.csv"))
    assert np.atleast_2d(data).shape[0] == cor.blocks_processed >= 1
    ph = np.angle(np.atleast_2d(data).mean(axis=0))
    band = slice(2**10 // 4, 3 * 2**10 // 4)
    assert np.std(np.unwrap(ph[band])) < 0.35


def test_keyboard_thread_requests_recalibration(tmp_path, monkeypatch):
    """The ACTUAL stdin-reader thread (_get_kbd) runs under the suite:
    a fake TTY delivering 'c' drives a live mid-run recalibration
    through the real keyboard path (not an injection into kbd_queue)."""
    import io
    import os as _os
    import sys as _sys

    r_fd, w_fd = _os.pipe()

    class FakeTty(io.TextIOWrapper):
        def isatty(self):
            return True

    fake = FakeTty(_os.fdopen(r_fd, "rb", buffering=0))
    monkeypatch.setattr(_sys, "stdin", fake)

    cfg = CorrelatorConfig(num_samp=2**14, nbins=2**10, run_time=3,
                           clamp_num_samp=False, loglevel="WARNING",
                           keyboard_control=True,
                           output_file=str(tmp_path / "kbd.csv"))
    cor = Correlator(config=cfg)

    import threading
    import time as _time

    def press_c():
        # wait for the machine to reach RUN, then 'type' c + newline
        for _ in range(200):
            if cor.state == "RUN" and cor.blocks_processed >= 1:
                break
            _time.sleep(0.05)
        _os.write(w_fd, b"c")

    t = threading.Thread(target=press_c, daemon=True)
    t.start()
    cor.run_state_machine()
    t.join(1.0)
    _os.close(w_fd)
    # the recalibration actually ran: one calibrate at startup + one from
    # the keyboard request
    cal_timer = cor.metrics.timer("calibrate")
    assert cal_timer is not None and cal_timer.count >= 2
