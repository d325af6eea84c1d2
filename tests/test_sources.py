"""Source implementations: correlated synthetic signals with known ground
truth, replay roundtrip, fault injection — the hardware-free L1 layer the
reference never had (SURVEY.md §4)."""

import numpy as np
import pytest

from fxtpu.config import CorrelatorConfig
from fxtpu.sources import (FaultInjectingSource, NoiseSource, ReplaySource,
                           SinusoidSource, make_source, save_recording)
from fxtpu.sources.synthetic import fractional_delay


def test_noise_source_shapes_and_determinism():
    a = NoiseSource(nchan=3, seed=9).read_block(1024)
    b = NoiseSource(nchan=3, seed=9).read_block(1024)
    assert a.shape == (3, 1024) and a.dtype == np.complex64
    np.testing.assert_array_equal(a, b)


def test_noise_source_injected_delay_is_recoverable():
    d = 5.0 / 2.4e6  # 5 samples
    src = NoiseSource(nchan=2, sample_rate=2.4e6, delays=[0.0, d],
                      snr=1000, seed=2)
    blk = src.read_block(2**14)
    # cross-correlate at integer lags
    x = np.correlate(blk[1], blk[0], mode="full")
    lag = np.argmax(np.abs(x)) - (len(blk[0]) - 1)
    assert lag == 5


def test_noise_source_snr_scaling():
    hi = NoiseSource(nchan=2, snr=1e6, seed=3).read_block(4096)
    corr = np.abs(np.vdot(hi[0], hi[1])) / (
        np.linalg.norm(hi[0]) * np.linalg.norm(hi[1]))
    assert corr > 0.99
    lo = NoiseSource(nchan=2, snr=0.01, seed=3).read_block(4096)
    corr_lo = np.abs(np.vdot(lo[0], lo[1])) / (
        np.linalg.norm(lo[0]) * np.linalg.norm(lo[1]))
    assert corr_lo < 0.2


def test_sinusoid_source_tone_and_delay_phase():
    f0 = 1e5
    src = SinusoidSource(nchan=2, sample_rate=1e6, tone_freq=f0,
                         delays=[0.0, 2e-6])
    blk = src.read_block(4096)
    spec = np.fft.fft(blk[0])
    peak = np.fft.fftfreq(4096, d=1e-6)[np.argmax(np.abs(spec))]
    assert abs(peak - f0) < 1e6 / 4096
    # a tone delayed by d shows phase 2 pi f d between channels
    ph = np.angle(np.vdot(blk[1], blk[0]))
    expect = 2 * np.pi * f0 * 2e-6 % (2 * np.pi)
    assert abs((ph - expect + np.pi) % (2 * np.pi) - np.pi) < 0.01


def test_fractional_delay_integer_matches_roll(rng):
    x = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(np.complex64)
    np.testing.assert_allclose(fractional_delay(x, 3), np.roll(x, 3),
                               atol=1e-4)


def test_replay_roundtrip(tmp_path):
    src = NoiseSource(nchan=2, seed=4)
    path = save_recording(src, str(tmp_path / "rec.npy"), 256, 3)
    rep = ReplaySource(path)
    assert rep.nchan == 2 and rep.total_samples == 768
    blocks = [rep.read_block(256) for _ in range(3)]
    assert all(b is not None for b in blocks)
    assert rep.read_block(256) is None  # exhausted
    loop = ReplaySource(path, loop=True)
    for _ in range(5):
        assert loop.read_block(256) is not None


def test_replay_raw_c64(tmp_path):
    data = (np.arange(512) + 1j).astype(np.complex64)
    p0, p1 = str(tmp_path / "ch0.c64"), str(tmp_path / "ch1.c64")
    data.tofile(p0)
    (data * 2).tofile(p1)
    rep = ReplaySource([p0, p1])
    blk = rep.read_block(512)
    assert blk.shape == (2, 512)
    np.testing.assert_array_equal(blk[1], blk[0] * 2)


def test_replay_is_memory_mapped(tmp_path):
    """A .npy replay opens memory-mapped (bench-scale captures are GBs;
    only the touched block pages ever load), reads identically to the
    in-memory path, and splits/selects stay mapped (views, not
    materializing fancy-indexes)."""
    src = NoiseSource(nchan=2, seed=6)
    path = save_recording(src, str(tmp_path / "rec.npy"), 256, 3)
    rep = ReplaySource(path)
    assert isinstance(rep._data, np.memmap)
    mem = ReplaySource(path, mmap=False)
    assert not isinstance(mem._data, np.memmap)
    for _ in range(3):
        np.testing.assert_array_equal(rep.read_block(256),
                                      mem.read_block(256))
    split = ReplaySource(path).split_channels()
    assert all(isinstance(s._data.base, np.memmap) or
               isinstance(s._data, np.memmap) for s in split)
    sel = ReplaySource(path).select_channels([1])
    assert isinstance(sel._data.base, np.memmap) or isinstance(
        sel._data, np.memmap)
    np.testing.assert_array_equal(sel.read_block(256), split[1].read_block(256))


def test_fault_injection_short_and_fail():
    src = FaultInjectingSource(NoiseSource(nchan=2, seed=1), short_every=2)
    assert src.read_block(128).shape == (2, 128)
    assert src.read_block(128).shape == (2, 64)
    failing = FaultInjectingSource(NoiseSource(nchan=2, seed=1), fail_at=1)
    with pytest.raises(RuntimeError):
        failing.read_block(128)


def test_quantized_source_int8_roundtrip():
    """QuantizedSource emits int8 [nch, ns, 2] with q*step within one LSB
    of the float source (away from clipping)."""
    from fxtpu.sources.base import QuantizedSource
    step = 1.0 / 32
    inner = NoiseSource(nchan=2, seed=4, scale=0.5)
    ref = NoiseSource(nchan=2, seed=4, scale=0.5)
    q = QuantizedSource(inner, quant_step=step)
    blk = q.read_block(4096)
    want = ref.read_block(4096)
    assert blk.dtype == np.int8 and blk.shape == (2, 4096, 2)
    deq = (blk[..., 0].astype(np.float32)
           + 1j * blk[..., 1].astype(np.float32)) * step
    unclipped = (np.abs(want.real) < 126 * step) & \
        (np.abs(want.imag) < 126 * step)
    err = np.abs(deq - want)[unclipped]
    assert err.max() <= step  # within one LSB per component


def test_quantized_source_tuning_passthrough():
    from fxtpu.sources.base import QuantizedSource
    inner = NoiseSource(nchan=2, seed=4)
    q = QuantizedSource(inner)
    q.sample_rate = 1.2e6
    q.center_freq = 1.0e9
    assert inner.sample_rate == 1.2e6 and inner.center_freq == 1.0e9


def test_make_source_from_config(tmp_path):
    cfg = CorrelatorConfig(source="synthetic", nchan=4, synthetic_delay=1e-6)
    src = make_source(cfg)
    assert isinstance(src, NoiseSource) and src.nchan == 4
    assert src.delays[0] == 0 and src.delays[1] == 1e-6
    with pytest.raises(ValueError):
        make_source(CorrelatorConfig(source="replay"))


def test_rtlsdr_plugin_gated_import():
    import fxtpu.sources.rtlsdr as r
    if not r.HAVE_RTLSDR:
        with pytest.raises(ImportError):
            r.RtlSdrSource()


def test_noise_source_split_equals_unsplit():
    """Per-channel splits of a NoiseSource regenerate the unsplit source's
    channel slices BIT-EXACTLY (counter-keyed generation), including a
    mid-stream split — what routes the default synthetic run onto the
    per-channel zero-copy feeders."""
    full = NoiseSource(nchan=3, seed=42, delays=[0, 1e-6, 2e-6], snr=5.0)
    ref = [full.read_block(2048) for _ in range(4)]

    fresh = NoiseSource(nchan=3, seed=42, delays=[0, 1e-6, 2e-6], snr=5.0)
    splits = fresh.split_channels()
    assert len(splits) == 3 and all(s.nchan == 1 for s in splits)
    for k in range(4):
        for c, s in enumerate(splits):
            np.testing.assert_array_equal(s.read_block(2048)[0], ref[k][c])

    # mid-stream split: advance 2 blocks, split, continue at block 2
    mid = NoiseSource(nchan=3, seed=42, delays=[0, 1e-6, 2e-6], snr=5.0)
    mid.read_block(2048)
    mid.read_block(2048)
    for c, s in enumerate(mid.split_channels()):
        np.testing.assert_array_equal(s.read_block(2048)[0], ref[2][c])


def test_sinusoid_source_split_equals_unsplit():
    full = SinusoidSource(nchan=2, seed=7, delays=[0, 5e-7],
                          noise_scale=0.05)
    ref = [full.read_block(1024) for _ in range(3)]
    splits = SinusoidSource(nchan=2, seed=7, delays=[0, 5e-7],
                            noise_scale=0.05).split_channels()
    for k in range(3):
        for c, s in enumerate(splits):
            np.testing.assert_array_equal(s.read_block(1024)[0], ref[k][c])


def test_synthetic_split_snapshot_resume():
    """A split source's snapshot restores onto a fresh PARENT source: the
    counter-keyed schema is identical, so per-channel feeder state logs
    feed Correlator resume with no special casing."""
    src = NoiseSource(nchan=2, seed=3)
    split = src.split_channels()[1]
    split.read_block(512)
    split.read_block(512)
    state = split.snapshot_state()
    parent = NoiseSource(nchan=2, seed=3)
    parent.restore_state(state)
    want = split.read_block(512)[0]
    np.testing.assert_array_equal(parent.read_block(512)[1], want)


def test_fault_split_fail_at_fires_once():
    """fail_at rides exactly ONE split (drop_channel's, else channel 0) —
    fanning it out would fire the injected failure once per feeder
    (r3 advisor finding)."""
    inner = NoiseSource(nchan=3, seed=11)
    f = FaultInjectingSource(inner, fail_at=2)
    splits = f.split_channels()
    assert [s.fail_at for s in splits] == [2, -1, -1]
    fd = FaultInjectingSource(NoiseSource(nchan=3, seed=11),
                              fail_at=2, short_every=2, drop_every=2,
                              drop_channel=2)
    splits = fd.split_channels()
    assert [s.fail_at for s in splits] == [-1, -1, 2]
    assert [s.short_every for s in splits] == [0, 0, 2]
    assert [s.drop_every for s in splits] == [0, 0, 2]


def _write_u8_capture(tmp_path, int8_blocks):
    """int8 [nch, n, 2] -> per-channel raw u8 interleaved files (the
    rtl_sdr byte stream: int8 + 128)."""
    arr = np.concatenate(int8_blocks, axis=1)
    paths = []
    for c in range(arr.shape[0]):
        u8 = (arr[c].astype(np.int16) + 128).astype(np.uint8)
        p = str(tmp_path / f"cap{c}.iq")
        u8.tofile(p)
        paths.append(p)
    return paths


def test_rtl_u8_replay_roundtrip(tmp_path):
    """Native rtl_sdr capture round trip: quantized int8 blocks written
    as raw u8 files replay BIT-EXACTLY through RtlU8ReplaySource (the
    u8 ^ 0x80 re-bias is exact), and the complex form equals the int8
    dequantization."""
    from fxtpu.sources.base import QuantizedSource
    from fxtpu.sources.replay import RtlU8ReplaySource
    q = QuantizedSource(NoiseSource(nchan=2, seed=44, delays=[0, 1e-6]))
    blocks = [q.read_block(2048) for _ in range(3)]
    paths = _write_u8_capture(tmp_path, blocks)

    src = RtlU8ReplaySource(paths)
    assert src.nchan == 2 and src.total_samples == 3 * 2048
    for want in blocks:
        got = src.read_block(2048)
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, want)
    assert src.read_block(2048) is None  # exhausted, not looping

    csrc = RtlU8ReplaySource(paths, as_complex=True, quant_step=q.quant_step)
    got = csrc.read_block(2048)
    want = (blocks[0][..., 0].astype(np.float32)
            + 1j * blocks[0][..., 1].astype(np.float32)) * q.quant_step
    np.testing.assert_array_equal(got, want.astype(np.complex64))


def test_rtl_u8_replay_splits_and_resumes(tmp_path):
    from fxtpu.sources.base import QuantizedSource
    from fxtpu.sources.replay import RtlU8ReplaySource
    q = QuantizedSource(NoiseSource(nchan=2, seed=45))
    blocks = [q.read_block(1024) for _ in range(4)]
    paths = _write_u8_capture(tmp_path, blocks)
    src = RtlU8ReplaySource(paths)
    src.read_block(1024)
    splits = src.split_channels()
    for c, s in enumerate(splits):
        np.testing.assert_array_equal(s.read_block(1024)[0], blocks[1][c])
        # zero-copy producer form
        out = np.empty((1024, 2), np.int8)
        assert s.read_block_into(out, 1024)
        np.testing.assert_array_equal(out, blocks[2][c])
    # snapshot/restore onto a fresh parent
    state = splits[0].snapshot_state()
    fresh = RtlU8ReplaySource(paths)
    fresh.restore_state(state)
    np.testing.assert_array_equal(fresh.read_block(1024), blocks[3])


def test_make_source_routes_u8_extension(tmp_path):
    from fxtpu.sources.base import QuantizedSource
    from fxtpu.sources.replay import RtlU8ReplaySource
    q = QuantizedSource(NoiseSource(nchan=2, seed=46))
    paths = _write_u8_capture(tmp_path, [q.read_block(1024)])
    cfg = CorrelatorConfig(source="replay",
                           replay_file=",".join(paths),
                           ingest_dtype="int8", nchan=2)
    src = make_source(cfg)
    assert isinstance(src, RtlU8ReplaySource) and not src.as_complex
    cfgc = CorrelatorConfig(source="replay", replay_file=",".join(paths),
                            nchan=2)
    srcc = make_source(cfgc)
    assert isinstance(srcc, RtlU8ReplaySource) and srcc.as_complex
