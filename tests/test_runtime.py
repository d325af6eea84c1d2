"""Host runtime: ring buffer semantics, drop accounting, seq alignment,
feeder supervision — the explicit-sequence-number discipline from
SURVEY.md §5.2 that the reference (mp.Queue pairs) cannot test."""

import os
import threading
import time
from queue import Queue

import numpy as np
import pytest

from fxtpu.runtime import BlockAligner, BufferFull, Feeder, RingBuffer
from fxtpu.sources import FaultInjectingSource, NoiseSource


def test_ring_fifo_and_seq():
    rb = RingBuffer(4, (8,), dtype=np.float32)
    for i in range(3):
        rb.put(np.full(8, i, np.float32))
    assert rb.qsize() == 3
    for i in range(3):
        seq, blk = rb.get()
        assert seq == i
        assert blk[0] == i
    assert rb.get(timeout=0.01) is None


def test_ring_raise_policy():
    rb = RingBuffer(2, (4,), policy="raise")
    rb.put(np.zeros(4)), rb.put(np.zeros(4))
    with pytest.raises(BufferFull):
        rb.put(np.zeros(4), timeout=0.05)


def test_ring_drop_policy_counts():
    rb = RingBuffer(2, (4,), policy="drop")
    assert rb.put(np.zeros(4)) == 0
    assert rb.put(np.zeros(4)) == 1
    assert rb.put(np.ones(4)) == -1  # dropped
    assert rb.drops == 1
    assert rb.qsize() == 2


def test_ring_overwrite_policy():
    rb = RingBuffer(2, (4,), policy="overwrite")
    rb.put(np.full(4, 0.0))
    rb.put(np.full(4, 1.0))
    rb.put(np.full(4, 2.0))  # overwrites oldest
    assert rb.drops == 1
    seq, blk = rb.get()
    assert seq == 1 and blk[0] == 1.0


def test_ring_short_block_zero_padded():
    rb = RingBuffer(2, (8,))
    rb.put(np.ones(5, np.complex64))
    _, blk = rb.get()
    assert np.all(blk[:5] == 1) and np.all(blk[5:] == 0)


def test_ring_blocking_put_get_across_threads():
    rb = RingBuffer(1, (4,))
    rb.put(np.zeros(4))
    got = []

    def consumer():
        time.sleep(0.05)
        got.append(rb.get(timeout=1))
        got.append(rb.get(timeout=1))

    t = threading.Thread(target=consumer)
    t.start()
    rb.put(np.ones(4), timeout=1)  # blocks until consumer frees a slot
    t.join()
    assert len(got) == 2 and got[1][1][0] == 1


def test_aligner_realigns_after_drop():
    """A drop in one channel discards the matching seq in the other."""
    b0, b1 = RingBuffer(8, (4,)), RingBuffer(8, (4,))
    # channel 0 got blocks 0,1,2 ; channel 1 dropped block 1
    for seq in (0, 1, 2):
        b0.put(np.full(4, seq), seq=seq)
    for seq in (0, 2):
        b1.put(np.full(4, 10 + seq), seq=seq)
    al = BlockAligner([b0, b1])
    blk = al.get(timeout=0.5)
    assert blk[0][0] == 0 and blk[1][0] == 10
    blk = al.get(timeout=0.5)  # seq 1 on ch0 must be skipped
    assert blk[0][0] == 2 and blk[1][0] == 12
    assert al.realigned == 1


def test_feeder_streams_and_closes_buffers():
    src = NoiseSource(nchan=2, seed=1)
    bufs = [RingBuffer(64, (1024,)) for _ in range(2)]
    f = Feeder(src, bufs, 1024, start_time=0.0, run_time=0.2).start()
    al = BlockAligner(bufs)
    blocks = 0
    while True:
        blk = al.get(timeout=1.0)
        if blk is None:
            break
        assert blk.shape == (2, 1024)
        blocks += 1
    f.join(2.0)
    assert blocks > 0
    assert blocks == f.blocks_fed
    assert all(b.closed for b in bufs)


def test_feeder_reports_child_exception():
    """Supervision: injected source failure lands in the exception queue
    (effex.py:656-659 contract)."""
    src = FaultInjectingSource(NoiseSource(nchan=2, seed=1), fail_at=3)
    bufs = [RingBuffer(64, (512,)) for _ in range(2)]
    excq = Queue()
    f = Feeder(src, bufs, 512, start_time=0.0, run_time=5.0, exc_queue=excq)
    f._thread = threading.Thread(target=f._run, daemon=True)
    f._thread.start()
    f.join(5.0)
    assert not excq.empty()
    assert "injected source failure" in excq.get()


def test_feeder_backpressure_nonrealtime_survives_full_ring():
    """A non-realtime source (synthetic/replay) backpressures on a full
    ring instead of dying with BufferFull: a consumer stalled longer than
    the put timeout (e.g. an XLA first-compile) still gets every block."""
    src = NoiseSource(nchan=1, seed=2)
    assert not src.realtime
    bufs = [RingBuffer(2, (256,))]
    f = Feeder(src, bufs, 256, start_time=0.0, run_time=0.5,
               put_timeout=0.05).start()
    time.sleep(0.3)               # ring (2 slots) is full, 6x the timeout
    assert f.alive                # would be dead under the realtime contract
    got = 0
    while True:
        item = bufs[0].get(timeout=0.5)
        if item is None:
            break
        got += 1
    f.join(2.0)
    assert got == f.blocks_fed
    assert bufs[0].drops == 0


def test_feeder_realtime_full_ring_raises():
    """Realtime sources keep the reference contract (effex.py:653-659):
    a full ring past the put timeout reports through exc_queue and dies."""
    src = NoiseSource(nchan=1, seed=3)
    src.realtime = True
    bufs = [RingBuffer(2, (256,))]
    excq = Queue()
    f = Feeder(src, bufs, 256, start_time=0.0, run_time=5.0,
               exc_queue=excq, put_timeout=0.05).start()
    f.join(5.0)
    assert not f.alive
    assert not excq.empty()
    assert "BufferFull" in excq.get()


def test_feeder_source_exhaustion_ends_stream(tmp_path):
    """Replay-style finite sources end the stream cleanly."""
    from fxtpu.sources import ReplaySource, save_recording
    src = NoiseSource(nchan=2, seed=5)
    path = save_recording(src, str(tmp_path / "rec.npy"), 512, 4)
    rep = ReplaySource(path)
    bufs = [RingBuffer(16, (512,)) for _ in range(2)]
    f = Feeder(rep, bufs, 512, start_time=0.0, run_time=30.0).start()
    f.join(5.0)
    assert f.blocks_fed == 4


# ---------------------------------------------------------------------------
# native C++ ring buffer (skipped when native/libfxring.so isn't built).
# NOT importorskip: that would silently skip the WHOLE module — including
# the pure-Python ring/feeder/stager tests above — if the wrapper module
# ever failed to import; an import failure should FAIL loudly instead.
# ---------------------------------------------------------------------------
from fxtpu.runtime import native  # noqa: E402


@pytest.mark.skipif(not native.native_available(),
                    reason="native lib not built (make -C native)")
class TestNativeRing:
    def test_fifo_seq_and_drops(self):
        rb = native.NativeRingBuffer(4, (8,), np.complex64, policy="drop")
        for i in range(4):
            assert rb.put(np.full(8, i, np.complex64)) == i
        assert rb.put(np.zeros(8, np.complex64), timeout=0.01) == -1
        assert rb.drops == 1
        for i in range(4):
            seq, blk = rb.get(timeout=0.5)
            assert seq == i and blk[0] == i
        rb.close()

    def test_raise_policy_and_close(self):
        from fxtpu.runtime import BufferFull
        rb = native.NativeRingBuffer(2, (4,))
        rb.put(np.zeros(4, np.complex64))
        rb.put(np.zeros(4, np.complex64))
        with pytest.raises(BufferFull):
            rb.put(np.zeros(4, np.complex64), timeout=0.02)
        rb.close()
        assert rb.get(timeout=0.1) is not None  # drain
        assert rb.get(timeout=0.1) is not None
        assert rb.get(timeout=0.1) is None      # closed-and-drained

    def test_short_block_zero_padded(self):
        rb = native.NativeRingBuffer(2, (8,))
        rb.put(np.ones(5, np.complex64))
        _, blk = rb.get(timeout=0.5)
        assert np.all(blk[:5] == 1) and np.all(blk[5:] == 0)

    def test_zero_copy_view(self):
        rb = native.NativeRingBuffer(2, (16,))
        rb.put(np.arange(16, dtype=np.complex64))
        seq, view = rb.get_view(timeout=0.5)
        assert seq == 0 and view[3] == 3
        rb.release()
        assert rb.qsize() == 0

    def test_reserve_commit_matches_put(self):
        """Zero-copy producer: writing the reserved slot then committing is
        observably identical to put() (same data, same seq ordering)."""
        rb = native.NativeRingBuffer(4, (16,))
        if not rb.can_reserve:
            pytest.skip("libfxring.so lacks rb_reserve (rebuild native)")
        for i in range(3):
            view = rb.reserve(timeout=0.5)
            view[:] = np.arange(16, dtype=np.complex64) + i
            rb.commit()
        for i in range(3):
            seq, blk = rb.get(timeout=0.5)
            assert seq == i
            np.testing.assert_array_equal(
                blk, np.arange(16, dtype=np.complex64) + i)
        rb.close()

    def test_reserve_timeout_policies(self):
        from fxtpu.runtime import BufferFull
        rb = native.NativeRingBuffer(1, (4,), policy="drop")
        if not rb.can_reserve:
            pytest.skip("libfxring.so lacks rb_reserve (rebuild native)")
        rb.reserve(timeout=0.5)[:] = 1
        rb.commit()
        assert rb.reserve(timeout=0.02) is None   # full: drop policy
        assert rb.drops == 1
        rb2 = native.NativeRingBuffer(1, (4,), policy="raise")
        rb2.reserve(timeout=0.5)[:] = 1
        rb2.commit()
        with pytest.raises(BufferFull):
            rb2.reserve(timeout=0.02)
        rb.close(); rb2.close()

    def test_feeder_zero_copy_single_channel_replay(self, tmp_path):
        """A 1-channel source + 1 native ring activates the reserve/commit
        producer (the per-channel parallel-feeder configuration); the
        streamed data must equal the recording, in order."""
        from fxtpu.sources import save_recording
        from fxtpu.sources.replay import ReplaySource
        rec = save_recording(NoiseSource(nchan=2, seed=3),
                             str(tmp_path / "r.npy"), 256, 4)
        src = ReplaySource(rec).select_channels([1])
        want = src._data.copy()
        buf = native.NativeRingBuffer(8, (256,))
        if not buf.can_reserve:
            pytest.skip("libfxring.so lacks rb_reserve (rebuild native)")
        f = Feeder(src, [buf], 256, run_time=10.0).start()
        got = []
        while True:
            item = buf.get(timeout=1.0)
            if item is None:
                break
            got.append(item[1])
        f.join(2.0)
        assert f.zero_copy, "reserve/commit producer loop did not activate"
        assert len(got) == 4  # non-loop replay: exactly the recording
        np.testing.assert_array_equal(np.concatenate(got), want[0])

    def test_feeder_zero_copy_int8_quantized(self, tmp_path):
        """QuantizedSource.read_block_into quantizes straight into the int8
        ring slot; consumed blocks match the copy-path quantization."""
        from fxtpu.sources import save_recording
        from fxtpu.sources.base import QuantizedSource
        from fxtpu.sources.replay import ReplaySource
        rec = save_recording(NoiseSource(nchan=1, seed=9),
                             str(tmp_path / "r.npy"), 128, 2)
        src = QuantizedSource(ReplaySource(rec))
        want = QuantizedSource(ReplaySource(rec)).read_block(128)
        buf = native.NativeRingBuffer(8, (128, 2), dtype=np.int8)
        if not buf.can_reserve:
            pytest.skip("libfxring.so lacks rb_reserve (rebuild native)")
        f = Feeder(src, [buf], 128).start()
        seq, blk = buf.get(timeout=1.0)
        f.join(2.0)
        assert f.zero_copy, "reserve/commit producer loop did not activate"
        assert seq == 0 and blk.dtype == np.int8
        np.testing.assert_array_equal(blk, want[0])

    def test_feeder_end_to_end_with_native_rings(self):
        src = NoiseSource(nchan=2, seed=6)
        bufs = [native.NativeRingBuffer(32, (1024,)) for _ in range(2)]
        f = Feeder(src, bufs, 1024, start_time=0.0, run_time=0.2).start()
        al = BlockAligner(bufs)
        n = 0
        while True:
            blk = al.get(timeout=1.0)
            if blk is None:
                break
            assert blk.shape == (2, 1024)
            n += 1
        f.join(2.0)
        assert n == f.blocks_fed > 0

    def test_sustained_rate_over_100MSps(self):
        """Streaming floor: the ring must sustain >=100 Msamp/s.
        (Best of 3 runs — CI boxes share cores with other work.)"""
        import threading
        import time as _t
        nblocks, nsamp = 400, 2**17
        best = 0.0
        for _ in range(3):
            rb = native.NativeRingBuffer(32, (nsamp,))
            src = np.ones(nsamp, np.complex64)

            def prod():
                for i in range(nblocks):
                    rb.put(src, timeout=10, seq=i)
                rb.close()

            t = threading.Thread(target=prod)
            t0 = _t.time()
            t.start()
            got = 0
            while True:
                r = rb.get_view(timeout=1)
                if r is None:
                    break
                rb.release()
                got += 1
            assert got == nblocks
            best = max(best, got * nsamp / (_t.time() - t0))
            if best > 100e6:
                break
        assert best > 100e6, f"only {best/1e6:.0f} Msamp/s"


def test_host_pipeline_bench_smoke():
    """The host-isolated pipeline bench (device sink stubbed) runs and
    accounts drops; the real rates are recorded by `python bench.py
    --host_pipeline` (>=100 MS/s with per-channel feeders on the bench
    host — the streaming floor)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    res = bench.bench_host_pipeline(block_pow=16, seconds=0.5)
    assert res["samples_per_s"] > 1e6
    assert res["drops"] == 0
    res8 = bench.bench_host_pipeline(block_pow=16, seconds=0.5,
                                     ingest="int8")
    assert res8["samples_per_s"] > 1e6


class TestNativeDataplane:
    """Parity of the native host data-plane kernels (native/dataplane.cpp)
    against their numpy-fallback expressions — both run regardless of
    whether the library is built (the wrappers fall back identically)."""

    def _block(self, shape, rng):
        return (rng.normal(size=shape).astype(np.float32)
                + 1j * rng.normal(size=shape).astype(np.float32)
                ).astype(np.complex64)

    def test_quantize_c64_matches_numpy(self):
        rng = np.random.default_rng(7)
        block = self._block((2, 4097), rng) * 3.0
        q = native.quantize_c64(block, 1.0 / 32)
        ref = np.empty((*block.shape, 2), np.int8)
        np.clip(np.rint(block.real * 32.0), -127, 127, out=ref[..., 0],
                casting="unsafe")
        np.clip(np.rint(block.imag * 32.0), -127, 127, out=ref[..., 1],
                casting="unsafe")
        assert np.array_equal(q, ref)
        # saturation: values beyond the int8 range clip, never wrap
        hot = np.full(16, 99.0 + 99.0j, np.complex64)
        qh = native.quantize_c64(hot, 1.0 / 32)
        assert np.all(qh == 127)
        assert np.all(native.quantize_c64(-hot, 1.0 / 32) == -127)

    def test_quantize_c64_into_out_matches_alloc(self):
        """The out= form (zero-copy producer: quantize straight into a ring
        slot) produces byte-identical results to the allocating form, on
        both the native and numpy-fallback branches."""
        rng = np.random.default_rng(11)
        block = self._block((513,), rng) * 2.0
        want = native.quantize_c64(block, 1.0 / 32)
        out = np.empty((513, 2), np.int8)
        got = native.quantize_c64(block, 1.0 / 32, out=out)
        assert got is out
        np.testing.assert_array_equal(got, want)

    def test_split_planes_match(self):
        rng = np.random.default_rng(8)
        c = self._block((3, 1000), rng)
        re, im = native.split_planes_c64(c)
        assert re.dtype == np.float32 and re.flags.c_contiguous
        assert np.array_equal(re, c.real) and np.array_equal(im, c.imag)
        q = native.quantize_c64(c, 1.0 / 32)
        r8, i8 = native.split_planes_i8(q)
        assert np.array_equal(r8, q[..., 0])
        assert np.array_equal(i8, q[..., 1])


@pytest.mark.skipif(not native.native_available(),
                    reason="native lib not built (make -C native)")
def test_aligner_view_path_realigns_with_native_rings():
    """The zero-copy (peek/release) alignment path keeps the realign
    semantics of the copy path: laggard slots are consumed and counted,
    timeouts leave unconsumed slots in place."""
    from fxtpu.runtime.feeder import BlockAligner
    b0 = native.NativeRingBuffer(8, (4,), np.complex64)
    b1 = native.NativeRingBuffer(8, (4,), np.complex64)
    for seq in (0, 1, 2):
        b0.put(np.full(4, seq, np.complex64), seq=seq)
    for seq in (0, 2):
        b1.put(np.full(4, 10 + seq, np.complex64), seq=seq)
    al = BlockAligner([b0, b1])
    assert al._views
    blk = al.get(timeout=0.5)
    assert blk[0][0] == 0 and blk[1][0] == 10
    blk = al.get(timeout=0.5)  # seq 1 on ch0 must be skipped
    assert blk[0][0] == 2 and blk[1][0] == 12
    assert al.realigned == 1
    # nothing left: a timeout returns None without consuming anything
    assert al.get(timeout=0.05) is None
    b0.put(np.full(4, 3, np.complex64), seq=3)
    b1.put(np.full(4, 13, np.complex64), seq=3)
    blk = al.get(timeout=0.5)
    assert blk[0][0] == 3 and blk[1][0] == 13


# ---------------------------------------------------------------------------
# Round-2 review regressions: consumer-copy safety, view ownership, stream
# termination with unpairable residuals, stop() waking a blocked producer.

def test_ring_get_copies_out_of_slot():
    """get() must return a COPY: popping frees the slot, and when the ring
    was full the producer's very next put reuses exactly that slot — a
    returned view would race it."""
    rb = RingBuffer(1, (4,))
    rb.put(np.zeros(4))
    t = threading.Thread(target=lambda: rb.put(np.ones(4), timeout=1))
    t.start()
    time.sleep(0.05)          # producer is now blocked on the full ring
    seq, blk = rb.get(timeout=1)
    t.join()                  # producer woke and overwrote the slot
    assert seq == 0 and np.all(blk == 0)


def test_ring_get_view_owns_slot_until_release():
    """get_view() keeps the slot owned by the consumer: a producer cannot
    overwrite it until release() consumes it (same contract as the native
    ring's rb_peek/rb_release)."""
    rb = RingBuffer(1, (4,))
    rb.put(np.zeros(4))
    seq, view = rb.get_view(timeout=0.5)
    assert seq == 0
    with pytest.raises(BufferFull):
        rb.put(np.ones(4), timeout=0.05)   # slot still owned
    assert np.all(view == 0)
    rb.release()
    assert rb.put(np.full(4, 2.0), timeout=0.5) == 1


def test_aligner_single_copy_path_on_python_rings():
    """Python rings now expose get_view/release, so the aligner's
    single-copy path engages without the native lib."""
    bufs = [RingBuffer(4, (4,)) for _ in range(2)]
    al = BlockAligner(bufs)
    assert al._views
    bufs[0].put(np.zeros(4), seq=0)
    bufs[1].put(np.ones(4), seq=0)
    blk = al.get(timeout=0.5)
    assert blk is not None and blk.shape == (2, 4)
    assert blk[0][0] == 0 and blk[1][0] == 1
    assert all(b.empty() for b in bufs)


def test_stager_ends_despite_unpairable_residual():
    """A seq dropped in one ring leaves a permanently unpairable block in
    a sibling ring; with the feeder done, the stager must still emit its
    end-of-stream sentinel instead of spinning on `not b.empty()`."""
    from fxtpu.runtime.stager import DeviceStager
    b0, b1 = RingBuffer(8, (4,)), RingBuffer(8, (4,))
    b0.put(np.zeros(4), seq=0)
    b1.put(np.full(4, 10.0), seq=0)
    b1.put(np.full(4, 11.0), seq=1)   # ch0's seq 1 was dropped upstream
    al = BlockAligner([b0, b1])
    st = DeviceStager(al, prepare_block=lambda b: b, batch=1,
                      feeding=lambda: False).start()
    got = []
    deadline = time.time() + 10
    while time.time() < deadline and not st.done:
        item = st.get(timeout=0.1)
        if item is not None:
            got.append(item)
    assert st.done            # pre-fix: spins forever, sentinel never sent
    assert len(got) == 1      # the aligned seq-0 pair still came through


def test_feeder_stop_wakes_blocked_put():
    """stop() closes the rings, so a put blocked on a full ring wakes
    immediately (not after the 30 s put_timeout) and a user-initiated stop
    is not reported as a feeder failure."""
    class RealtimeNoise(NoiseSource):
        realtime = True

    src = RealtimeNoise(nchan=1, seed=1)
    bufs = [RingBuffer(1, (256,))]
    excq = Queue()
    f = Feeder(src, bufs, 256, start_time=0.0, run_time=30.0,
               exc_queue=excq, put_timeout=30.0).start()
    deadline = time.time() + 5
    while not bufs[0].full() and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)           # let the feeder block inside put()
    t0 = time.time()
    f.stop()
    f.join(5.0)
    assert not f.alive
    assert time.time() - t0 < 5.0
    assert excq.empty()       # clean stop: no spurious BufferFull report


@pytest.mark.skipif(not native.native_available(),
                    reason="native lib not built (make -C native)")
def test_native_put_timeout_none_blocks():
    """timeout=None means wait-forever on the native ring too (it used to
    translate to 0.0 s — fail on the first full poll — while the Python
    ring and native get() treated None as forever)."""
    rb = native.NativeRingBuffer(1, (4,), np.float32)
    rb.put(np.zeros(4, np.float32))

    def consumer():
        time.sleep(0.2)
        rb.get(timeout=1)

    t = threading.Thread(target=consumer)
    t.start()
    seq = rb.put(np.ones(4, np.float32))   # must block, then succeed
    t.join()
    assert seq == 1


@pytest.mark.skipif(native._dataplane() is None,
                    reason="native data plane not built")
def test_quantize_c64_native_matches_numpy_with_nonfinite():
    """The native one-pass quantizer equals the numpy fallback, including
    NaN/Inf samples (NaN -> 0, +/-Inf -> +/-127, the fallback's
    clip/cast)."""
    rng = np.random.default_rng(7)
    blk = (rng.normal(size=(2, 384)) * 3
           + 1j * rng.normal(size=(2, 384))).astype(np.complex64)
    blk[0, 5] = np.nan + 1j * np.inf
    blk[1, 9] = -np.inf + 0j
    step = 1.0 / 32
    q_native = native.quantize_c64(blk, step)
    # a strided (non-contiguous) view disqualifies the native loop
    wide = np.zeros((2, 2 * blk.shape[1]), np.complex64)
    wide[:, ::2] = blk
    assert not wide[:, ::2].flags.c_contiguous
    q_numpy = native.quantize_c64(wide[:, ::2], step)
    np.testing.assert_array_equal(q_native, q_numpy)
    assert q_native[0, 5, 0] == 0 and q_native[0, 5, 1] == 127
    assert q_native[1, 9, 0] == -127
