"""Host -> mesh ingest: sharded device placement of IQ blocks.

The reference's ingest is ``gpu_iq[:] = data`` into cuSignal pinned memory
(``/root/reference/effex/effex.py:109-110,391-392``).  The mesh
equivalents (SURVEY.md §5.8):

  * single process: ``jax.device_put`` with the block's NamedSharding —
    XLA splits the host buffer straight onto the mesh devices;
  * multi-host: each host feeds only the shard slices its devices own via
    ``jax.make_array_from_process_local_data`` — no host ever materializes
    the global block.  The feeder reads only :func:`local_sample_span`
    from its source (see fxtpu.runtime.feeder.Feeder ``sample_span``).

Both paths produce the same global Array, so the sharded FX step is
oblivious to how many hosts fed it.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np

from fxtpu.ops.cplx import Cplx
from fxtpu.parallel.mesh import FREQ_AXIS, TIME_AXIS, block_sharding

__all__ = ["block_sharding", "put_block", "local_sample_span"]


def put_block(block: np.ndarray, mesh: Optional[jax.sharding.Mesh],
              global_num_samp: Optional[int] = None) -> Cplx:
    """Place one host block onto the device / mesh as dual planes.

    ``block``: ``[nch, num_samp]`` complex64, or 8-bit quantized planes
    ``[nch, num_samp, 2]`` int8 (shipped as int8 — 4x fewer H2D bytes —
    and dequantized on-device by the step, see fx._dequant).  A LEADING
    K axis (a stacked multi-dispatch batch, ``[K, nch, ...]``) keeps the
    sample axis sharded — the layout the scanned sharded multi_step
    slices per block.

    Single-host fast path: device_put with the mesh sharding (XLA scatters
    the buffer).  Under a multi-process runtime, ``block`` is this
    process's LOCAL span of the sample axis (the feeder reads only
    :func:`local_sample_span`) and ``global_num_samp`` names the global
    block length; placement uses make_array_from_process_local_data so no
    host ever materializes samples it doesn't own.
    """
    if block.dtype == np.int8 and block.shape[-1] == 2:
        re = np.ascontiguousarray(block[..., 0])
        im = np.ascontiguousarray(block[..., 1])
    else:
        re = np.ascontiguousarray(block.real, dtype=np.float32)
        im = np.ascontiguousarray(block.imag, dtype=np.float32)
    if mesh is None:
        return Cplx(jax.device_put(re), jax.device_put(im))
    if re.ndim == 3:  # stacked batch [K, nch, num_samp]
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, None,
                                             (TIME_AXIS, FREQ_AXIS)))
    else:
        sharding = block_sharding(mesh)
    if jax.process_count() == 1:
        return Cplx(jax.device_put(re, sharding), jax.device_put(im, sharding))
    gshape = (*re.shape[:-1], global_num_samp or re.shape[-1])
    mk = jax.make_array_from_process_local_data
    return Cplx(mk(sharding, re, gshape), mk(sharding, im, gshape))


def local_sample_span(mesh: jax.sharding.Mesh, num_samp: int):
    """The [start, stop) span of the global sample axis this process's
    devices own — what a multi-host feeder should read from its source.

    Requires this process's devices to be CONTIGUOUS in the linearized
    (time, freq) device order (the standard make_mesh layout keeps each
    host's devices together); raises otherwise, since a non-contiguous
    span cannot be expressed as one [start, stop) read.
    """
    total = mesh.shape[TIME_AXIS] * mesh.shape[FREQ_AXIS]
    per = num_samp // total
    addressable = [d for d in mesh.devices.flat
                   if d.process_index == jax.process_index()]
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    idxs = sorted(order[d] for d in addressable)
    if idxs != list(range(idxs[0], idxs[-1] + 1)):
        raise ValueError(
            "this process's devices are not contiguous in the mesh's "
            f"linearized (time, freq) order: {idxs}; lay the mesh out so "
            "each host owns a contiguous run of shards")
    return idxs[0] * per, (idxs[-1] + 1) * per
