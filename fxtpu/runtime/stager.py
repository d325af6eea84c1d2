"""Async device stager: overlaps host gather + H2D with device compute.

The reference's hot loop is strictly serial — dequeue, pinned-copy, GPU
work, repeat (``/root/reference/effex/effex.py:362-410``); its only overlap
comes from the producer processes.  When the device step is fast, the
END-TO-END rate is set by the host side: gathering aligned blocks, stacking K of them, splitting complex
planes, and the host->device transfer.  Done inline, those serialize with
the dispatch; done here, they pipeline:

    feeder thread:   source -> per-channel ring buffers
    stager thread:   aligner -> stack K blocks -> planes -> enqueue H2D
                     (jnp.asarray is asynchronous: the copy overlaps both
                     this thread's next gather AND the device's current
                     dispatch)  -> bounded queue of device-resident batches
    main loop:       pop device batch -> one scanned multi-step dispatch

A queue depth of 2 double-buffers the transfers; deeper adds device memory
(K * nchan * num_samp * 8 bytes per staged batch) without throughput.
"""

from __future__ import annotations

import logging
import threading
import traceback
from queue import Empty, Full, Queue
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class Batch:
    """One staged unit of work.

    ``iq`` is the device-resident input: for full batches, the stacked
    ``[k, nch, num_samp]`` pair ``prepare_batch`` staged; for tail blocks (``k == 1`` and ``stacked == False``), a
    single-block ``prepare_block`` input.
    """

    __slots__ = ("iq", "k", "stacked", "last_seq")

    def __init__(self, iq, k: int, stacked: bool, last_seq: int = -1):
        self.iq = iq
        self.k = k
        self.stacked = stacked
        #: Ring seq of this batch's LAST block — the consumer's stream
        #: position after processing it (snapshot's source-state key;
        #: seqs can have gaps, so the consumed COUNT is not a position)
        self.last_seq = last_seq


class DeviceStager:
    """Thread that turns aligned host blocks into device-resident batches."""

    def __init__(self, aligner, prepare_block, batch: int, depth: int = 2,
                 exc_queue: Optional[Queue] = None,
                 feeding=lambda: False, prepare_batch=None):
        """``aligner``: BlockAligner to pull from; ``prepare_block``: host
        complex array -> device input (FxEngine.prepare_block);
        ``prepare_batch``: K-block list -> one multi_step input
        (FxEngine.prepare_batch; defaults to prepare_block over an
        np.stack);
        ``batch``: blocks per staged dispatch (K); ``feeding``: callable,
        True while the upstream feeder may still produce blocks."""
        self.aligner = aligner
        self.prepare_block = prepare_block
        self.prepare_batch = (prepare_batch if prepare_batch is not None
                              else lambda blocks:
                              prepare_block(np.stack(blocks)))
        self.batch = int(batch)
        self.exc_queue = exc_queue
        self.feeding = feeding
        self.out: Queue = Queue(maxsize=depth)
        self.staged_blocks = 0
        self.done = False  # end-of-stream sentinel observed by the consumer
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "DeviceStager":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fxtpu-stager")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        # unblock a full queue so the thread can observe the stop flag
        try:
            self.out.get_nowait()
        except Empty:
            pass

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def get(self, timeout: float = 0.1) -> Optional[Batch]:
        """Next staged batch, or None on timeout or end of stream (after
        which ``self.done`` is True — that's how the consumer tells a
        drained stream from a not-ready one)."""
        if self.done:
            return None
        try:
            item = self.out.get(timeout=timeout)
        except Empty:
            return None
        if item is None:
            self.done = True
            return None
        return item

    def _gather(self):
        """Collect up to ``batch`` aligned (seq, block) pairs; short list
        at stream end (StreamDrainTracker decides when a miss means
        done)."""
        from fxtpu.runtime.feeder import StreamDrainTracker
        blocks: List = []
        drain = StreamDrainTracker()
        while len(blocks) < self.batch and not self._stop.is_set():
            blk = self.aligner.get(timeout=0.05)
            if blk is None:
                if drain.miss(self.feeding(), self.aligner.bufs):
                    break  # drained (or unpairable residual) and done
            else:
                drain.got_block()
                blocks.append((self.aligner.last_seq, blk))
        return blocks

    def _run(self):
        try:
            while not self._stop.is_set():
                blocks = self._gather()
                if not blocks:
                    break
                if len(blocks) == self.batch and self.batch > 1:
                    # host stack + one transfer per plane: ONE jax entry
                    # point per batch for the data plane
                    iq = self.prepare_batch(
                        [b for _, b in blocks])  # async H2D enqueue
                    item = Batch(iq, self.batch, stacked=True,
                                 last_seq=blocks[-1][0])
                    self.staged_blocks += self.batch
                    self._put(item)
                else:
                    # tail (or batch==1): single-block units so the main
                    # loop reuses the single-step executable
                    for seq, b in blocks:
                        self._put(Batch(self.prepare_block(b), 1,
                                        stacked=False, last_seq=seq))
                        self.staged_blocks += 1
        except Exception:
            logger.exception("stager thread failed")
            if self.exc_queue is not None:
                self.exc_queue.put(traceback.format_exc())
        finally:
            self.out.put(None)  # end-of-stream sentinel

    def _put(self, item: Batch):
        while not self._stop.is_set():
            try:
                self.out.put(item, timeout=0.1)
                return
            except Full:
                continue
