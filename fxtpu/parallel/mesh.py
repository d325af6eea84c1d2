"""Device-mesh construction for the correlator.

Two mesh axes (SURVEY.md §2.2 / §5.7 — the multi-device generalization of the
reference's producer/consumer process parallelism):

  * ``time``  — time-block (PFB frame) sharding: the data-parallel analog.
    Visibility integration across time shards is a ``psum``.
  * ``freq``  — frequency-bin sharding: the tensor-parallel analog.  The
    F-stage output is corner-turned (``all_to_all``) from frame-sharded to
    bin-sharded layout for the X-stage — the classic FX-correlator corner
    turn, over NVLink between the cards of one host.

The PFB's ``(ntaps-1)*nbins`` samples of tap history at every shard boundary
travel by ``ppermute`` halo exchange over the linearized (time, freq) shard
index (SURVEY.md §5.7: the ring/context-parallel analog).

Multi-host: call :func:`init_distributed` on every host before building the
mesh; ``jax.make_mesh`` lays out the global device order so that the 'freq'
axis (all_to_all-heavy) stays within hosts where possible.  The cards of
one host are joined all to all, so the mesh follows the algorithm, not a
physical topology.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import jax
import numpy as np

logger = logging.getLogger(__name__)

TIME_AXIS = "time"
FREQ_AXIS = "freq"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """Multi-host runtime bring-up (`jax.distributed.initialize`).  No-op
    when running single-process (the common dev/test path)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_correlator_mesh(mesh_time: int = 0, mesh_freq: int = 1,
                         devices=None) -> jax.sharding.Mesh:
    """Build a ``(time, freq)`` mesh.  ``mesh_time=0`` means "all remaining
    devices"."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if mesh_time == 0:
        if n % mesh_freq:
            raise ValueError(f"{n} devices not divisible by mesh_freq={mesh_freq}")
        mesh_time = n // mesh_freq
    if mesh_time * mesh_freq > n:
        raise ValueError(
            f"mesh {mesh_time}x{mesh_freq} needs {mesh_time * mesh_freq} "
            f"devices, have {n}")
    devices = np.asarray(devices[: mesh_time * mesh_freq]).reshape(
        mesh_time, mesh_freq)
    return jax.sharding.Mesh(devices, (TIME_AXIS, FREQ_AXIS))


def block_sharding(mesh: jax.sharding.Mesh) -> jax.sharding.NamedSharding:
    """Sharding for an input IQ block ``[nchan, num_samp]``: the sample axis
    split across every device (row-compatible with the PFB reshape as long
    as ``num_samp/nbins`` divides by the mesh size)."""
    return jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, (TIME_AXIS, FREQ_AXIS)))


def validate_shapes(num_samp: int, nbins: int, mesh: jax.sharding.Mesh,
                    ntaps: int = 1) -> Tuple[int, int]:
    """Check divisibility constraints; returns (rows_per_shard, bins_per_shard)."""
    t = mesh.shape[TIME_AXIS]
    f = mesh.shape[FREQ_AXIS]
    s = num_samp // nbins
    if s % (t * f):
        raise ValueError(
            f"frames per block ({s}) must divide by mesh size {t * f}")
    if nbins % f:
        raise ValueError(f"nbins ({nbins}) must divide by mesh_freq ({f})")
    rows = s // (t * f)
    if rows < ntaps - 1:
        raise ValueError(
            f"each shard owns {rows} PFB rows but the tap-history halo "
            f"needs {ntaps - 1}; use a bigger block or a smaller mesh")
    return rows, nbins // f
