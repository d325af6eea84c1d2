"""Benchmark: steady-state FX-correlator throughput on one GPU.

Measures aggregate samples/s through the jitted PFB + FFT + X-engine step
for one ``CONFIGS`` entry (default: the flagship 2-channel 4096-bin
configuration).  vs_baseline compares against the reference's implied
sustained real-time rate: 2 ch x 2.4 MS/s = 4.8 Msamples/s aggregate
(defaults at effex.py:47,713-718).

Runs only on a GPU (``--cpu`` is the explicit opt-in for a functional CPU
run, whose numbers are not hardware statements); any failure exits
non-zero.  Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "samples/s", "vs_baseline": N, ...}
"""

import json
import time

import numpy as np

REFERENCE_AGGREGATE_SAMPLES_PER_S = 4.8e6  # effex.py implied real-time rate


def bench(block_pow: int = 21, nbins: int = 4096, nchan: int = 2,
          iters: int = 30, warmup: int = 5, mode: str = "SPECTRUM",
          ntaps: int = 4, include_autos: bool = False,
          blocks_per_call: int = 128, ingest: str = "complex64"):
    """Steady-state throughput of the step.  ``blocks_per_call`` > 1
    scans K distinct blocks per dispatch (history carried in-graph),
    amortizing the per-dispatch latency — the production streaming shape."""
    import jax
    import jax.numpy as jnp

    from fxtpu.config import CorrelatorConfig
    from fxtpu.fx import FxEngine

    num_samp = 2 ** block_pow
    cfg = CorrelatorConfig(mode=mode, nchan=nchan, num_samp=num_samp,
                           nbins=nbins, ntaps=ntaps,
                           include_autos=include_autos,
                           clamp_num_samp=False, ingest_dtype=ingest)
    eng = FxEngine(cfg)
    rng = np.random.default_rng(0)
    k = max(1, blocks_per_call)
    if ingest == "int8":
        # production radio samples: 8-bit quantized IQ planes
        raw = [rng.integers(-127, 128, size=(nchan, num_samp, 2)
                            ).astype(np.int8) for _ in range(k)]
    else:
        raw = [(rng.normal(size=(nchan, num_samp)).astype(np.float32)
                + 1j * rng.normal(size=(nchan, num_samp))
                .astype(np.float32)) for _ in range(k)]
    history = eng.fresh_history()

    if k == 1:
        step, iq = eng.step, eng.prepare_block(raw[0])
        delays = jnp.zeros((nchan,), jnp.float32)
    else:
        step = eng.multi_step
        iq = eng.prepare_batch(raw)
        delays = jnp.zeros((k, nchan), jnp.float32)

    vis, history = step(iq, delays, history)
    jax.block_until_ready(vis)
    for _ in range(warmup):
        vis, history = step(iq, delays, history)
    jax.block_until_ready(vis)

    t0 = time.perf_counter()
    for _ in range(iters):
        vis, history = step(iq, delays, history)
    jax.block_until_ready(vis)
    dt = time.perf_counter() - t0

    agg_samples = nchan * num_samp * k * iters
    samples_per_s = agg_samples / dt
    frames = num_samp // nbins
    spectra_per_s = frames * k * iters / dt
    return {
        "samples_per_s": samples_per_s,
        "spectra_per_s": spectra_per_s,
        "block_seconds": dt / (iters * k),
        "num_samp": num_samp,
        "nbins": nbins,
        "nchan": nchan,
    }


def bench_pipeline(block_pow: int = 21, nbins: int = 4096, nchan: int = 2,
                   seconds: float = 12.0, blocks_per_dispatch: int = 8,
                   ingest: str = "complex64"):
    """End-to-end host pipeline rate: replayed source -> ring buffers ->
    aligner -> H2D -> step -> CSV rows (the sustained-streaming number,
    not just the device step).  Reports the STEADY-STATE rate — the span
    after the first device dispatch returns — so one-time XLA compilation
    doesn't masquerade as pipeline throughput."""
    import tempfile

    import jax
    import numpy as np

    from fxtpu.config import CorrelatorConfig
    from fxtpu.correlator import Correlator
    from fxtpu.sources import NoiseSource, save_recording

    num_samp = 2 ** block_pow
    with tempfile.TemporaryDirectory() as d:
        rec = save_recording(NoiseSource(nchan=nchan, seed=1),
                             f"{d}/rec.npy", num_samp, 4)
        cfg = CorrelatorConfig(
            mode="CONTINUUM", nchan=nchan, num_samp=num_samp, nbins=nbins,
            run_time=max(seconds, 1), clamp_num_samp=False,
            loglevel="WARNING", source="replay", replay_file=rec,
            blocks_per_dispatch=blocks_per_dispatch,
            buffer_chunks=4 * blocks_per_dispatch,
            ingest_dtype=ingest,
            output_file=f"{d}/vis.csv")
        # Warm every executable the run will use (single step, K-scan
        # multi step, calibrator) BEFORE the timed run — step builders are
        # memoized process-wide, so the measured Correlator reuses these
        # compiled programs and the feed window isn't eaten by
        # first-compile stalls.
        import jax
        import jax.numpy as jnp

        from fxtpu.fx import FxEngine

        from fxtpu.ops.planes import pack_delays

        eng = FxEngine(cfg)
        k = blocks_per_dispatch
        if ingest == "int8":
            arr = np.zeros((k, nchan, num_samp, 2), np.int8)
        else:
            arr = np.zeros((k, nchan, num_samp), np.complex64)
        hist = eng.fresh_history()
        # warm with PRODUCTION avals: the Correlator dispatches PACKED
        # [..., nch, 2] delays and calibrates via calibrate_block —
        # warming plain [k, nch] delays compiles executables the timed
        # run never uses, and it still pays the first-compile stall
        dk = jnp.asarray(pack_delays(np.zeros((k, nchan)), cfg.frequency))
        d1 = jnp.asarray(pack_delays(np.zeros(nchan), cfg.frequency))
        _, hist2 = eng.multi_step(eng.prepare_batch(arr), dk, hist)
        _, _ = eng.step(eng.prepare_block(arr[0]), d1, hist)
        ncal = min(cfg.calibrate_samples, num_samp)
        jax.block_until_ready(
            eng.calibrate_block(eng.prepare_block(arr[0]), ncal))
        del arr

        cor = Correlator(config=cfg)
        cor.source.loop = True  # stream the recording for run_time seconds
        cor.run_state_machine()
        r = cor.metrics.rates(since="steady")
        return {"samples_per_s": r["samples_per_s"],
                "blocks": cor.blocks_processed}


def bench_host_pipeline(block_pow: int = 21, nchan: int = 2,
                        seconds: float = 6.0, ingest: str = "complex64",
                        channel_feeders: bool = True):
    """HOST pipeline rate with the device sink stubbed: replayed source ->
    per-channel parallel feeder threads -> rings -> aligner -> plane-split
    staging buffers (the exact bytes a device_put would ship).  No JAX, no
    H2D — this isolates the host data plane from the device.  Every byte
    flows source read -> ring slot copy -> aligned gather -> contiguous
    plane split, i.e. the full production path up to the device
    boundary."""
    import tempfile

    from fxtpu.runtime.feeder import BlockAligner, Feeder
    from fxtpu.runtime.native import make_ring
    from fxtpu.sources import NoiseSource, save_recording
    from fxtpu.sources.base import QuantizedSource
    from fxtpu.sources.replay import ReplaySource

    num_samp = 2 ** block_pow
    if ingest == "int8":
        ring_shape, ring_dtype = (num_samp, 2), np.int8
    else:
        ring_shape, ring_dtype = (num_samp,), np.complex64
    with tempfile.TemporaryDirectory() as d:
        rec = save_recording(NoiseSource(nchan=nchan, seed=1),
                             f"{d}/rec.npy", num_samp, 4)

        def make_chan_source(c):
            src = ReplaySource(rec, loop=True).select_channels([c])
            return QuantizedSource(src) if ingest == "int8" else src

        bufs = [make_ring(8, ring_shape, dtype=ring_dtype)
                for _ in range(nchan)]
        if channel_feeders:
            feeders = [Feeder(make_chan_source(c), [bufs[c]], num_samp)
                       for c in range(nchan)]
        else:
            src = ReplaySource(rec, loop=True)
            if ingest == "int8":
                src = QuantizedSource(src)
            feeders = [Feeder(src, bufs, num_samp)]
        aligner = BlockAligner(bufs)
        for f in feeders:
            f.start()

        # staging: the exact contiguous planes prepare_block would hand to
        # device_put (native single-pass split when libfxring is built)
        from fxtpu.runtime.native import split_planes_c64, split_planes_i8
        stage = None
        blocks = 0
        deadline = time.perf_counter() + seconds
        t0 = time.perf_counter()
        while time.perf_counter() < deadline:
            block = aligner.get(timeout=1.0)
            if block is None:
                break
            if ingest == "int8":
                stage = split_planes_i8(block)
            else:
                stage = split_planes_c64(block)
            blocks += 1
        del stage
        dt = time.perf_counter() - t0
        for f in feeders:
            f.stop()
        for f in feeders:
            f.join(2.0)
        rate = blocks * nchan * num_samp / dt
        return {"samples_per_s": rate, "blocks": blocks,
                "bytes_per_s": rate * (2 if ingest == "int8" else 8),
                "drops": sum(b.drops for b in bufs)}


CONFIGS = {
    # the flagship: 2-ch 4096-bin spectrum correlate (the reference's
    # resolution, effex.py:713-718), 2^21-sample blocks, K=128 per dispatch
    "default": dict(block_pow=21, nbins=4096, nchan=2),
    # wideband stress: 8192-bin PFB, 32-tap branches
    "wideband": dict(block_pow=21, nbins=8192, nchan=2, ntaps=32,
                     blocks_per_call=64),
    # the wideband shape at the radio's own 8-bit sample width
    "wideband_int8": dict(block_pow=21, nbins=8192, nchan=2, ntaps=32,
                          blocks_per_call=32, ingest="int8"),
    # the flagship shape at 8-bit ingest (int8 planes H2D, dequantized
    # in-graph)
    "default_int8": dict(block_pow=21, nbins=4096, nchan=2, ingest="int8"),
    # 8-input FX correlator (36 baselines with autos): Gram-matmul X-stage
    "nchan8": dict(block_pow=20, nbins=4096, nchan=8, include_autos=True,
                   blocks_per_call=64),
}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--config", default="default", choices=sorted(CONFIGS))
    p.add_argument("--pipeline", action="store_true",
                   help="measure the end-to-end host pipeline instead of "
                        "the device step")
    p.add_argument("--host_pipeline", action="store_true",
                   help="measure the HOST data plane alone (device sink "
                        "stubbed; no JAX/H2D)")
    p.add_argument("--single_feeder", action="store_true",
                   help="host_pipeline: one multi-channel feeder thread "
                        "instead of per-channel parallel feeders")
    p.add_argument("--ingest", default="complex64",
                   choices=["complex64", "int8"],
                   help="pipeline ingest dtype (int8 = 8-bit quantized)")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--cpu", action="store_true",
                   help="run on CPU (functional smoke of every config "
                        "path — numbers are NOT hardware statements)")
    args = p.parse_args(argv)

    if args.host_pipeline:
        res = bench_host_pipeline(ingest=args.ingest,
                                  channel_feeders=not args.single_feeder)
        out = {
            "metric": ("2ch_host_pipeline_throughput"
                       if args.ingest == "complex64"
                       else "2ch_host_pipeline_throughput_int8"),
            "value": round(res["samples_per_s"], 1),
            "unit": "samples/s",
            "vs_baseline": round(
                res["samples_per_s"] / REFERENCE_AGGREGATE_SAMPLES_PER_S, 3),
            "bytes_per_s": round(res["bytes_per_s"], 1),
            "drops": res["drops"],
            "device": "host-only (device sink stubbed)",
        }
        print(json.dumps(out))
        return

    import jax

    import fxtpu  # noqa: F401  (compile-cache location)
    from fxtpu.runtime.device import card_line, device_info, require_gpu

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        card = "cpu (functional run, not a hardware statement)"
    else:
        require_gpu()
        card = card_line()
    print(f"card: {card}", flush=True)

    if args.pipeline:
        metric = ("2ch_end_to_end_pipeline_throughput"
                  if args.ingest == "complex64"
                  else "2ch_end_to_end_pipeline_throughput_int8")
        res = bench_pipeline(ingest=args.ingest)
        extra = {}
    else:
        metric = ("2ch_4096bin_pfb_fft_x_aggregate_throughput"
                  if args.config == "default"
                  else f"{args.config}_pfb_fft_x_aggregate_throughput")
        res = bench(iters=args.iters, **CONFIGS[args.config])
        extra = {"spectra_per_s": round(res["spectra_per_s"], 1),
                 "block_seconds": res["block_seconds"]}
    print(json.dumps({
        "metric": metric,
        "value": round(res["samples_per_s"], 1),
        "unit": "samples/s",
        "vs_baseline": round(
            res["samples_per_s"] / REFERENCE_AGGREGATE_SAMPLES_PER_S, 3),
        **extra,
        "card": card,
        "device": device_info(),
    }))


if __name__ == "__main__":
    main()
