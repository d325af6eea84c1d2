"""The Correlator: state machine, orchestration, and the host hot loop.

Behavioral contract reproduced from the reference ``Correlator``
(``/root/reference/effex/effex.py:23-696``), rebuilt around a JAX device
runtime:

  * same five states with the same guarded transitions and
    :class:`StateTransitionError` on illegal edges (``effex.py:204-228``);
  * same three modes (SPECTRUM / CONTINUUM / TEST) with the same semantics;
  * calibrate-on-start: the first data block is consumed by CALIBRATE
    (``effex.py:351-353``), re-triggerable live via the 'c' key
    (``effex.py:332-336``) — here behind a flag;
  * property setters with the same validation + hardware pass-through
    behavior (``effex.py:231-320``);
  * supervision: child exceptions arrive on an exception queue and force
    SHUTDOWN (``effex.py:165-173,344-347``); buffer-full warnings
    (``effex.py:338-342``); graceful end-of-run drain (``effex.py:375-385``).

Differences (deliberate):

  * the per-chunk GPU work is ONE jitted XLA program (see fxtpu.fx) and the
    device pipeline stays asynchronous — the host loop dispatches block k+1
    while the device crunches block k and the writer thread forces block
    k-1's
    transfer;
  * N channels / arbitrary baselines; per-channel delay vector;
  * PFB tap history is carried across blocks (streaming-continuous F-stage);
  * sources are pluggable (synthetic / replay / live-SDR) so no hardware is
    required anywhere (the reference needs two physical SDRs even for its
    test suite — SURVEY.md §4).
"""

from __future__ import annotations

import logging
import sys
import threading
import time
from queue import Queue
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from fxtpu.config import MODES, STATES, CorrelatorConfig
from fxtpu.fx import FxEngine
from fxtpu import products
from fxtpu.runtime.feeder import BlockAligner, Feeder
from fxtpu.sources import make_source
from fxtpu.sources.base import Source

LINESEP = "-" * 80


class StateTransitionError(Exception):
    """Illegal state-machine edge (``effex.py:186-193`` parity)."""

    def __init__(self, prev, next):
        self.prev = prev
        self.next = next
        self.message = (f"Transition from {self.prev} to {self.next} "
                        "is not permitted.")

    def __str__(self):
        return repr(self.message)


#: Legal edges (``effex.py:210-224``): value = allowed next states.
_ALLOWED = {
    "OFF": ("STARTUP",),
    "STARTUP": ("CALIBRATE", "RUN", "SHUTDOWN"),
    "RUN": ("CALIBRATE", "SHUTDOWN"),
    "CALIBRATE": ("RUN", "SHUTDOWN"),
    "SHUTDOWN": ("OFF",),
}


class Correlator:
    """N-channel streaming FX correlator on a JAX device (a GPU).

    Accepts either a :class:`~fxtpu.config.CorrelatorConfig` or the
    reference's keyword arguments (``effex.py:45-53``)."""

    _states = STATES
    _modes = MODES
    StateTransitionError = StateTransitionError  # reference exposes it nested

    def __init__(self, config: Optional[CorrelatorConfig] = None,
                 source: Optional[Source] = None,
                 mesh: Optional[jax.sharding.Mesh] = None,
                 **kwargs):
        if config is None:
            config = CorrelatorConfig(**kwargs)
        elif kwargs:
            import dataclasses
            config = dataclasses.replace(config, **kwargs)
        self.config = config

        # --- logging (effex.py:55-72) ----------------------------------
        level = getattr(logging, config.loglevel)
        self.logger = logging.getLogger("fxtpu.correlator")
        self.logger.setLevel(level)
        if not self.logger.handlers:
            fmt = logging.Formatter(
                "{asctime} - {name} - {levelname:<8} - {message}", style="{")
            fh = logging.FileHandler("log_fxtpu.log")
            ch = logging.StreamHandler()
            for h in (fh, ch):
                h.setFormatter(fmt)
                self.logger.addHandler(h)
        for h in self.logger.handlers:
            h.setLevel(level)

        # --- supervision channel (effex.py:73-74) -----------------------
        self.exc_queue: Queue = Queue()

        # --- source (replaces the 2 fixed SDRs, effex.py:81-82) ---------
        self.source = source if source is not None else make_source(config)
        if self.source.nchan != config.nchan:
            raise ValueError(
                f"source has {self.source.nchan} channels, config says "
                f"{config.nchan}")

        # Validated pass-through properties (effex.py:84-89).
        self.run_time = config.run_time
        self.bandwidth = config.bandwidth
        self.frequency = config.frequency
        self.num_samp = config.num_samp
        self.nbins = config.nbins
        self.gain = config.gain

        # --- state machine (effex.py:94-99) ------------------------------
        self._state = "OFF"
        self.mode = config.mode
        self.start_time = -1.0

        # --- multi-host: each process feeds only the sample span its mesh
        # devices own (SURVEY.md §5.8; fxtpu.parallel.ingest) --------------
        self._is_primary = jax.process_index() == 0
        self.sample_span = None
        if mesh is not None and jax.process_count() > 1:
            from fxtpu.parallel.ingest import local_sample_span
            self.sample_span = local_sample_span(mesh, config.num_samp)
            self.logger.info(
                "multi-host run: process %d/%d feeds samples [%d, %d) of "
                "each block", jax.process_index(), jax.process_count(),
                *self.sample_span)
        local_samp = (config.num_samp if self.sample_span is None
                      else self.sample_span[1] - self.sample_span[0])

        # --- host buffering (effex.py:105-110): native C++ ring when the
        # shared library is built, Python fallback otherwise.  int8 ingest
        # keeps the rings 8-bit too (1/8 the footprint of complex64) -------
        from fxtpu.runtime.native import make_ring
        if config.ingest_dtype == "int8":
            ring_shape, ring_dtype = (local_samp, 2), np.int8
        else:
            ring_shape, ring_dtype = (local_samp,), np.complex64
        self.bufs = [
            make_ring(config.buffer_chunks, ring_shape, dtype=ring_dtype)
            for _ in range(config.nchan)
        ]
        self.aligner = BlockAligner(self.bufs)
        self.feeders: list = []
        self.stager = None  # DeviceStager, started on first RUN entry

        # --- compute engine (F+X, device side) ---------------------------
        self.engine = FxEngine(config, mesh=mesh)
        self.history = self.engine.fresh_history()

        # --- science data (effex.py:129-141) ------------------------------
        self.calibrated_delays = np.zeros(config.nchan, dtype=np.float64)
        self.vis_out: Queue = Queue()
        self.output_file = config.output_file
        self.kbd_queue: Queue = Queue(1)
        self.writer: Optional[products.VisibilityWriter] = None
        self.blocks_processed = 0
        self._blocks_consumed = 0  # incl. calibration blocks (resume seek)
        self._consumed_seq = -1    # ring seq of the last PROCESSED block —
        #                            the stream position snapshot() keys
        #                            the source-state lookup on (counts
        #                            diverge from seqs on drops)

        # --- TEST mode sweep (effex.py:144-155) ---------------------------
        self.test_delay_sweep_step = config.test_delay_sweep_step
        self.test_delay_offset = config.test_delay_offset

        # --- metrics + long-integration state (SURVEY.md §5.1/§5.4) --------
        from fxtpu.runtime.metrics import Metrics
        self.metrics = Metrics()
        self._accumulator = None      # Cplx running sum over blocks
        self._gcal = None             # memoized multi-host cal program
        self._accumulated = 0
        self.snapshot_path = (config.snapshot_path
                              or self.output_file + ".state.npz")
        if config.resume_from:
            self._restore(config.resume_from)

    # ------------------------------------------------------------------
    # Properties with validation + source pass-through (effex.py:231-320)
    # ------------------------------------------------------------------
    @property
    def feeder(self) -> Optional[Feeder]:
        """Primary feeder (None before streaming starts).  Production may
        run one feeder PER CHANNEL (``self.feeders``) so each pairs a
        1-channel source with 1 native ring — the zero-copy
        reserve/commit producer's activation condition."""
        return self.feeders[0] if self.feeders else None

    @feeder.setter
    def feeder(self, value):
        self.feeders = [] if value is None else [value]

    @property
    def _feeding(self) -> bool:
        return any(f.alive for f in self.feeders)

    @property
    def state(self):
        """The current state in the correlator's internal state machine."""
        return self._state

    @state.setter
    def state(self, input_state):
        self.logger.debug("State transition: %s to %s", self._state,
                          input_state)
        if input_state not in self._states:
            self.close()
            raise ValueError(
                f"State {input_state} is not in known states: {self._states}")
        if input_state not in _ALLOWED[self._state]:
            self.close()
            raise StateTransitionError(self._state, input_state)
        self._state = input_state

    @property
    def run_time(self):
        return self._run_time

    @run_time.setter
    def run_time(self, value):
        if value < 1:
            self.close()
            raise ValueError(f"run time {value} is not allowed; "
                             "run times must be >= 1 second.")
        self._run_time = value

    @property
    def bandwidth(self):
        return self._bandwidth

    @bandwidth.setter
    def bandwidth(self, value):
        ceiling = getattr(self.source, "max_stable_bandwidth", None)
        if ceiling and value > ceiling:
            self.logger.warning(
                "Bandwidth value %s is greater than %s, and the source "
                "may not be stable.", value, ceiling)
        self._bandwidth = value
        self.source.sample_rate = value
        self._sync_engine(bandwidth=value)

    @property
    def frequency(self):
        return self._frequency

    @frequency.setter
    def frequency(self, value):
        self._frequency = value
        self.source.center_freq = value
        self._sync_engine(frequency=value)

    @property
    def num_samp(self):
        return self._num_samp

    @num_samp.setter
    def num_samp(self, value):
        from fxtpu.config import MAX_NUM_SAMP, MIN_NUM_SAMP
        value = int(round(value))
        if self.config.clamp_num_samp:
            value = min(max(value, MIN_NUM_SAMP), MAX_NUM_SAMP)
        self._num_samp = value
        self._sync_engine(num_samp=value)

    @property
    def nbins(self):
        return self._nbins

    @nbins.setter
    def nbins(self, value):
        self._nbins = value
        self._sync_engine(nbins=value)

    @property
    def gain(self):
        return self._gain

    @gain.setter
    def gain(self, value):
        self._gain = value
        self.source.gain = value

    @property
    def mode(self):
        return self._mode

    @mode.setter
    def mode(self, input_mode):
        input_mode = str(input_mode).upper()
        if input_mode not in self._modes:
            raise ValueError(
                f"Mode input {input_mode} is not in known modes: {self._modes}")
        self._mode = input_mode
        self._sync_engine(mode=input_mode)

    def _sync_engine(self, **changes):
        """Rebuild the compute engine after a compute-relevant property
        mutation, so mutated correlators actually correlate at the new
        shape (the reference read these properties live in every
        ``_pfb_xcorr`` call, ``effex.py:497-527``; here the compiled step
        is built once, so a post-init mutation must rebuild it).  Step and
        calibrator builders are memoized process-wide (fx._STEP_CACHE), so
        reverting a value — or a no-op rewrite — never recompiles.

        ``num_samp`` mutation also resizes the host ring buffers; that is
        only legal before streaming starts (the feeder owns the rings
        once running)."""
        if getattr(self, "engine", None) is None:
            return  # still inside __init__: engine not built yet
        import dataclasses
        if all(getattr(self.config, k) == v for k, v in changes.items()):
            return
        if "num_samp" in changes and self.feeder is not None:
            raise RuntimeError(
                "num_samp cannot change after streaming has started: the "
                "ring buffers are sized per block and owned by the feeder")
        if "nbins" in changes and self.stager is not None:
            raise RuntimeError(
                "nbins cannot change while the async stager is running: "
                "staged batches are framed by the OLD engine's "
                "prepare_batch and would reach the new step mis-framed")
        self.config = dataclasses.replace(self.config, **changes)
        self.engine = FxEngine(self.config, mesh=self.engine.mesh,
                               impl=self.engine.impl)
        self.history = self.engine.fresh_history()
        self._accumulator = None
        self._gcal = None  # closes over the old engine's cal + ncal
        self._accumulated = 0
        self.test_delay_sweep_step = self.config.test_delay_sweep_step
        self.test_delay_offset = self.config.test_delay_offset
        if "num_samp" in changes:
            from fxtpu.runtime.native import make_ring
            cfg = self.config
            if self.sample_span is not None:
                # multi-process runtime: the rings hold only this
                # process's span of each global block — recompute it for
                # the new block size (the stale span would feed
                # wrong-length local slices to
                # make_array_from_process_local_data)
                from fxtpu.parallel.ingest import local_sample_span
                self.sample_span = local_sample_span(self.engine.mesh,
                                                     cfg.num_samp)
            local_samp = (cfg.num_samp if self.sample_span is None
                          else self.sample_span[1] - self.sample_span[0])
            if cfg.ingest_dtype == "int8":
                ring_shape, ring_dtype = (local_samp, 2), np.int8
            else:
                ring_shape, ring_dtype = (local_samp,), np.complex64
            self.bufs = [
                make_ring(cfg.buffer_chunks, ring_shape, dtype=ring_dtype)
                for _ in range(cfg.nchan)
            ]
            self.aligner = BlockAligner(self.bufs)
        self.logger.debug("engine rebuilt after property mutation: %s",
                          changes)

    # ------------------------------------------------------------------
    # Supervision helpers (effex.py:158-180)
    # ------------------------------------------------------------------
    def _get_kbd(self, queue):
        while self.state in ("STARTUP", "RUN", "CALIBRATE"):
            queue.put(sys.stdin.read(1))

    def _child_threw_exception(self) -> bool:
        if not self.exc_queue.empty():
            exc_formatted = self.exc_queue.get_nowait()
            self.logger.error("Parent caught child exception:\n%s",
                              exc_formatted)
            return True
        return False

    def close(self):
        """Release the source (``sdr.close()`` analog, ``effex.py:176-180``)."""
        stager = getattr(self, "stager", None)
        if stager is not None:
            stager.stop()
        for feeder in getattr(self, "feeders", []):
            feeder.stop()
        source = getattr(self, "source", None)
        if source is not None:
            source.close()
            self.logger.info("Source closed.")

    # ------------------------------------------------------------------
    # Main loop (effex.py:326-417)
    # ------------------------------------------------------------------
    def run_state_machine(self):
        """Run the machine to completion: OFF -> STARTUP -> (CALIBRATE <->
        RUN) -> SHUTDOWN -> done."""
        from fxtpu.runtime.metrics import profiler_trace
        with profiler_trace(self.config.profile_dir):
            self._run_machine()
        self.logger.info("%s", self.metrics.report())
        for c, buf in enumerate(self.bufs):
            if buf.drops:
                self.logger.warning("channel %d dropped %d blocks", c,
                                    buf.drops)

    def _run_machine(self):
        from fxtpu.runtime.feeder import StreamDrainTracker
        warned_full = [False] * self.config.nchan
        drain = StreamDrainTracker()
        while True:
            # user input: 'c' requests recalibration (effex.py:332-336)
            if not self.kbd_queue.empty():
                kbd_in = self.kbd_queue.get_nowait()
                if kbd_in == "c":
                    self.logger.info("Calibration requested.")
                    self.state = "CALIBRATE"

            # buffer-full warnings with drop accounting (effex.py:338-342)
            for c, buf in enumerate(self.bufs):
                if buf.full() and not warned_full[c]:
                    self.logger.warning(
                        "Channel %d ring buffer filled up. "
                        "Data may have been lost! (drops so far: %d)",
                        c, buf.drops)
                    warned_full[c] = True
                elif not buf.full():
                    warned_full[c] = False

            if self._child_threw_exception():
                self.logger.debug("Shutting down: child threw exception.")
                self.state = "SHUTDOWN"

            if self.state == "OFF":
                self.state = "STARTUP"
            elif self.state == "STARTUP":
                self._startup_task()
                if self.config.calibrate_on_start:
                    self.state = "CALIBRATE"
                else:
                    self.state = "RUN"
                    self._maybe_start_stager()
            elif self.state in ("CALIBRATE", "RUN"):
                if time.time() < self.start_time:
                    continue
                if self.stager is not None:
                    if not self._staged_iteration():
                        break
                    continue
                t_fetch = time.time()
                block = self.aligner.get(timeout=1.0)
                self.logger.debug("Fetching samples took %f s",
                                  time.time() - t_fetch)
                if block is None:
                    if not drain.miss(self._feeding, self.bufs):
                        self.logger.debug("Buffers empty, waiting")
                        continue
                    # Feeder done and buffers drained: wait for output drain
                    # then shut down (effex.py:375-385).
                    if self.vis_out.empty():
                        self.logger.info(
                            "IQ processing complete, buffers drained. "
                            "Shutting down.")
                        self.state = "SHUTDOWN"
                    else:
                        self.logger.debug(
                            "Time up, waiting for output buffer to drain.")
                        time.sleep(0.05)
                    continue

                drain.got_block()
                self._blocks_consumed += 1
                self._consumed_seq = self.aligner.last_seq
                self.metrics.count("samples_in",
                                   self.config.nchan * self.num_samp)
                if self.state == "CALIBRATE":
                    # split to planes + H2D (pinned-copy analog)
                    with self.metrics.stage("h2d"):
                        iq = self.engine.prepare_block(block)
                    with self.metrics.stage("calibrate"):
                        self._calibrate_task(iq)
                    self.state = "RUN"
                    self._maybe_start_stager()
                elif self.state == "RUN":
                    t_gpu = time.time()
                    with self.metrics.stage("fx_step"):
                        self._run_blocks([block])
                    self.metrics.mark_once("steady")
                    self.logger.debug("device dispatch took %f s",
                                      time.time() - t_gpu)
                    self._maybe_snapshot()
            elif self.state == "SHUTDOWN":
                self.close()
                break

            self.logger.debug("ring buffer sizes: %s; vis_out: %d",
                              [b.qsize() for b in self.bufs],
                              self.vis_out.qsize())
        if self.writer is not None:
            self.writer.join(timeout=5.0)

    # ------------------------------------------------------------------
    # Tasks (effex.py:420-494)
    # ------------------------------------------------------------------
    def _startup_task(self):
        """Write the CSV header and start feeder/writer/keyboard threads
        (``effex.py:420-474``).  In a multi-host run only process 0 writes
        products; every process feeds its own sample span and dispatches
        the same global device programs in lockstep."""
        if self._is_primary:
            products.write_metadata(self.output_file, self.config)

        self.start_time = time.time() + self.config.startup_duration
        self.logger.info(
            "Cross-correlation will begin at %s",
            time.strftime("%a, %d %b %Y %H:%M:%S",
                          time.localtime(self.start_time)))

        # Per-channel feeders whenever the source can split (replay and
        # its quantized wrapper): each pairs a 1-channel source with its
        # own native ring, which is exactly the zero-copy reserve/commit
        # producer's activation condition — the ≥100 MS/s host plane runs
        # in production, not just in the bench rig (r2 review).  Sources
        # that can't split (one generator / one USB device) keep the
        # single multi-channel feeder.
        splits = (self.source.split_channels()
                  if self.config.channel_feeders and self.sample_span is None
                  else None)
        if splits is not None:
            self.feeders = [
                Feeder(src, [buf], self.num_samp,
                       start_time=self.start_time, run_time=self.run_time,
                       exc_queue=self.exc_queue).start()
                for src, buf in zip(splits, self.bufs)]
            self.logger.debug("Started %d per-channel feeder threads.",
                              len(self.feeders))
        else:
            self.feeder = Feeder(self.source, self.bufs, self.num_samp,
                                 start_time=self.start_time,
                                 run_time=self.run_time,
                                 exc_queue=self.exc_queue,
                                 sample_span=self.sample_span).start()
            self.logger.debug("Started feeder thread.")

        if self._is_primary:
            self.writer = products.VisibilityWriter(
                self.output_file, self.vis_out,
                active_fn=lambda: self.state in ("STARTUP", "RUN",
                                                 "CALIBRATE"),
            ).start()
            self.logger.debug("Started output buffering thread.")

        if self.config.keyboard_control and sys.stdin.isatty():
            threading.Thread(target=self._get_kbd, args=(self.kbd_queue,),
                             daemon=True).start()
            print(LINESEP)
            print("Listening for user input. Input a character & return:")
            print(LINESEP)
            print("c : request delay recalibration")
            print(LINESEP)

    def _calibrate_task(self, iq):
        """Estimate per-channel delays from the current block
        (``effex.py:476-487``).  Assumes a flat-PSD noise-like input.

        Estimation uses the leading ``calibrate_samples`` of the block (the
        reference's whole chunk is 2^18 — the default window — so this IS
        the reference behavior at reference shapes); the fixed window keeps
        one compiled cal executable valid for every block size."""
        self.logger.debug("Starting calibration")
        ncal = min(self.config.calibrate_samples, self.num_samp)
        if self.sample_span is not None:
            # Multi-host: the block is a GLOBAL sharded array no process
            # fully holds, and eager ops on non-addressable Arrays raise —
            # run slice + cal as one jitted global program with the delay
            # vector replicated so every host reads identical values.  The
            # input is replicated in-graph first: the estimator's FFT runs
            # over the whole sample axis (delays feed identical host-side
            # pack_delays on every process).
            from jax.sharding import NamedSharding, PartitionSpec as P
            if self._gcal is None:
                # memoized: jit caches per function OBJECT, so building a
                # fresh closure per 'c' recalibration would pay the full
                # XLA compile every time and stall the lockstep dispatch
                # on all hosts
                mesh = self.engine.mesh
                cal = self.engine.calibrate

                rep = NamedSharding(mesh, P())

                def gcal(x):
                    x = jax.tree.map(
                        lambda a: jax.lax.with_sharding_constraint(a, rep), x)
                    x = jax.tree.map(
                        lambda a: a.reshape(a.shape[0], -1)[..., :ncal], x)
                    return cal(x)

                self._gcal = jax.jit(gcal,
                                     out_shardings=NamedSharding(mesh, P()))
            out = self._gcal(iq)
            delays = np.asarray(jax.device_get(out), dtype=np.float64)
        else:
            # engine.calibrate_block windows to ncal samples — the single
            # calibrate-input transform shared with warm-up code
            delays = np.asarray(self.engine.calibrate_block(iq, ncal),
                                dtype=np.float64)
        if self.mode == "TEST":
            delays[1:] -= self.test_delay_offset  # effex.py:578-579
        self.calibrated_delays = delays
        self.logger.info("Estimated delay (us): %s",
                         1e6 * self.calibrated_delays[1:])

    def _run_task(self, iq):
        """One F+X step on the device; returns the visibility (still
        on device — the writer thread forces the transfer).  Delays go in
        PACKED (delay, frac(fc*d)) form: the carrier cycles are reduced in
        float64 host-side so the in-graph f32 phase is exact to ~1e-6 rad
        (see ops.planes.pack_delays)."""
        from fxtpu.ops.planes import pack_delays
        delays = jnp.asarray(pack_delays(self.calibrated_delays,
                                         self.frequency))
        vis, self.history = self.engine.step(iq, delays, self.history)
        if len(self.engine.pairs) == 1:
            # reference-parity: one row per block — ONLY when there is
            # exactly one baseline (nchan=2 with autos has 3: autos come
            # FIRST in baseline_pairs, so vis[0] would be the ch0
            # autospectrum, not the cross visibility)
            vis = vis[0]
        return vis

    @property
    def _dispatch_batch(self) -> int:
        """Blocks per device dispatch: the engine sizes the batch
        (multi-process runs stay per-block — see
        FxEngine.dispatch_batch_for)."""
        return self.engine.dispatch_batch_for(
            self.config.blocks_per_dispatch)

    def _emit(self, vis):
        self.blocks_processed += 1
        self.metrics.count("blocks")
        if self._integrate(vis):
            self.metrics.count("spectra_out")

    def _run_blocks(self, blocks):
        """Correlate a batch of aligned host blocks: one scanned device
        dispatch when the batch is full, single steps otherwise."""
        k = len(blocks)
        # only the full batch uses the scanned dispatch (each distinct scan
        # length is a separate compile); remainders take single steps
        if k == self._dispatch_batch and k > 1:
            self._dispatch_multi(self.engine.prepare_batch(blocks), k)
            return
        for b in blocks:
            if self.mode == "TEST":
                # artificial delay sweep (effex.py:403-404)
                self.calibrated_delays[1:] += self.test_delay_sweep_step
            iq = self.engine.prepare_block(b)
            self._emit(self._run_task(iq))

    def _dispatch_multi(self, iq, k: int):
        """One K-block device dispatch on already-prepared input."""
        from fxtpu.ops.planes import pack_delays
        delays_k = np.repeat(self.calibrated_delays[None], k, axis=0)
        if self.mode == "TEST":
            # per-block sweep advance inside the dispatch
            steps = np.arange(1, k + 1) * self.test_delay_sweep_step
            delays_k[:, 1:] += steps[:, None]
            self.calibrated_delays[1:] += k * self.test_delay_sweep_step
        vis, self.history = self.engine.multi_step(
            iq, jnp.asarray(pack_delays(delays_k, self.frequency)),
            self.history)
        for i in range(k):
            v = vis[i]
            if len(self.engine.pairs) == 1:
                v = v[0]  # single-baseline squeeze (see _run_task)
            self._emit(v)

    # ------------------------------------------------------------------
    # Async staged ingest (runtime/stager.py): overlaps host gather, plane
    # split, and H2D with the device dispatches.  Active when
    # blocks_per_dispatch > 1 on the single-device planes path.
    # ------------------------------------------------------------------
    def _maybe_start_stager(self):
        if self.stager is not None or self._dispatch_batch <= 1:
            return
        from fxtpu.runtime.stager import DeviceStager
        self.stager = DeviceStager(
            self.aligner, self.engine.prepare_block,
            batch=self._dispatch_batch, exc_queue=self.exc_queue,
            feeding=lambda: self._feeding,
            prepare_batch=self.engine.prepare_batch,
        ).start()
        self.logger.debug("Started device stager (batch=%d).",
                          self._dispatch_batch)

    def _staged_iteration(self) -> bool:
        """One main-loop iteration on the staged path.  Returns False when
        the machine should stop (SHUTDOWN handled here)."""
        batch = self.stager.get(timeout=0.1)
        if batch is None:
            if not self.stager.done:
                return True  # nothing staged yet
            if self.vis_out.empty():
                self.logger.info(
                    "IQ processing complete, buffers drained. Shutting down.")
                self.state = "SHUTDOWN"
                self.close()
                return False
            time.sleep(0.05)
            return True

        self._blocks_consumed += batch.k
        self._consumed_seq = batch.last_seq
        self.metrics.count("samples_in",
                           batch.k * self.config.nchan * self.num_samp)
        if self.state == "CALIBRATE":
            # Mid-run recalibration ('c'): estimate from the first staged
            # block, then correlate the whole batch with the fresh delays.
            # (The reference discards its calibration chunk; here no
            # samples are dropped — the cal block is also correlated.)
            first = self._first_staged_block(batch)
            with self.metrics.stage("calibrate"):
                self._calibrate_task(first)
            self.state = "RUN"
        with self.metrics.stage("fx_step"):
            if batch.stacked:
                self._dispatch_multi(batch.iq, batch.k)
            else:
                if self.mode == "TEST":
                    self.calibrated_delays[1:] += self.test_delay_sweep_step
                self._emit(self._run_task(batch.iq))
        self.metrics.mark_once("steady")
        self._maybe_snapshot()
        return True

    def _first_staged_block(self, batch):
        """Block 0 of a staged batch, in single-block input form (batches
        stack blocks on the first axis, FxEngine.prepare_batch)."""
        if not batch.stacked:
            return batch.iq
        return jax.tree.map(lambda a: a[0], batch.iq)

    def _maybe_snapshot(self):
        if (self.config.snapshot_every and
                self.blocks_processed % self.config.snapshot_every == 0):
            with self.metrics.stage("snapshot"):
                self.snapshot()

    # ------------------------------------------------------------------
    # Long-integration accumulation + snapshots (SURVEY.md §5.4)
    # ------------------------------------------------------------------
    def _integrate(self, vis) -> bool:
        """Accumulate ``integration_blocks`` block visibilities per output
        row (default 1 = reference parity: every block is written).
        Returns True when a row was emitted."""
        m = self.config.integration_blocks
        if m <= 1:
            if self._is_primary:
                self.vis_out.put(vis)
            return True
        from fxtpu.ops.cplx import Cplx
        if self._accumulator is None:
            self._accumulator = vis
        else:
            a, v = self._accumulator, vis
            self._accumulator = (Cplx(a.re + v.re, a.im + v.im)
                                 if isinstance(v, Cplx) else a + v)
        self._accumulated += 1
        if self._accumulated >= m:
            a = self._accumulator
            out = (Cplx(a.re / m, a.im / m) if isinstance(a, Cplx)
                   else a / m)
            if self._is_primary:
                self.vis_out.put(out)
            self._accumulator = None
            self._accumulated = 0
            return True
        return False

    def snapshot(self, path: Optional[str] = None) -> str:
        """Write a resumable state snapshot (history, delays, accumulator,
        block counter)."""
        import json

        from fxtpu.runtime import checkpoint
        path = path or self.snapshot_path
        meta = {"blocks_consumed": np.int64(self._blocks_consumed)}
        # full generator/cursor state: a resumed run reproduces the SAME
        # stream an uninterrupted one would (SURVEY §5.4) — the block-index
        # seek alone silently regenerates different noise for synthetic
        # sources.  The feeder reads AHEAD of the consumer, so the state
        # must come from its per-block log — keyed by the last PROCESSED
        # block's SEQ (+1), not the consumed count: seqs gap on drops, and
        # the count would silently restore an earlier stream position.
        # The direct source state is only correct before the feeder starts.
        if self.feeder is not None:
            src_state = self.feeder.source_state_at(self._consumed_seq + 1)
        else:
            src_state = self.source.snapshot_state()
        if src_state is not None:
            meta["source_state"] = json.dumps(src_state)
        checkpoint.save_state(
            path, history=self.history, delays=self.calibrated_delays,
            blocks_processed=self.blocks_processed,
            accumulator=self._accumulator, accumulated=self._accumulated,
            meta=meta)
        self.logger.debug("state snapshot -> %s", path)
        return path

    def _restore(self, path: str):
        from fxtpu.runtime import checkpoint
        from fxtpu.ops.cplx import to_complex
        state = checkpoint.load_state(path)
        hist = state["history"]
        if self.engine.impl == "planes":
            self.history = hist
        else:
            self.history = jnp.asarray(to_complex(hist))
        self.calibrated_delays = np.asarray(state["delays"])
        self.blocks_processed = state["blocks_processed"]
        self._accumulator = state["accumulator"]
        self._accumulated = state["accumulated"]
        self._blocks_consumed = int(state["meta"].get(
            "blocks_consumed", self.blocks_processed))
        src_state = state["meta"].get("source_state")
        if src_state is not None:
            # restore the exact generator/cursor state (replay position,
            # synthetic RNG, sinusoid phase) via the Source protocol
            import json
            self.source.restore_state(json.loads(str(src_state)))
        elif hasattr(self.source, "_pos"):
            # pre-source-state snapshot of a seekable replay: legacy seek
            self.source._pos = self._blocks_consumed * self.num_samp
        else:
            # refuse loudly instead of silently correlating DIFFERENT
            # samples against the snapshotted tap history: live sources
            # cannot reproduce their stream, and a legacy snapshot of a
            # synthetic source carries no RNG state to restore
            raise ValueError(
                f"cannot resume from {path}: no source stream state in "
                f"the snapshot and {type(self.source).__name__} is not "
                "seekable (snapshot/resume requires a replay or "
                "synthetic source; live streams cannot be reproduced)")
        self.logger.info("resumed from %s at block %d", path,
                         self.blocks_processed)
