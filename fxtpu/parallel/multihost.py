"""Multi-process (multi-host) execution: worker entry point + launcher.

This is the executable half of SURVEY.md §5.8 — the multi-controller
generalization of the reference's single-host transport (pickled arrays
over ``multiprocessing.Queue``, ``/root/reference/effex/effex.py:105-110``):
every process runs the same program over a global device mesh, feeds only
the sample span its own devices own
(``fxtpu.parallel.ingest.local_sample_span``), and places data with
``jax.make_array_from_process_local_data``; XLA collectives do the rest.

Backends:

  * GPU (the default): one card per process.  :func:`launch` pins each
    worker's card with ``CUDA_VISIBLE_DEVICES``; a process started by hand
    takes local card ``process_id`` (every process on one host) unless
    ``CUDA_VISIBLE_DEVICES`` already names a single card.  A JAX process
    reserves most of a card's memory when it starts, so two processes
    must never share one.
  * CPU, only when asked (``platform='cpu'``, ``--platform cpu``, or
    ``JAX_PLATFORMS=cpu`` as the test harness sets it): each process owns
    ``local_devices`` virtual CPU devices and collectives run over gloo/TCP.

Two entry styles:

  * :func:`launch` — spawn N local worker processes that rendezvous via
    ``jax.distributed.initialize``.
  * ``python -m fxtpu.parallel.multihost --role ... --process_id i ...`` —
    the worker itself; also what a multi-host deployment runs per host
    (with ``--coordinator host0:port``).

Roles:

  * ``step``      — one sharded FX step on a deterministic block; saves the
                    visibility (process 0) for parity checks.
  * ``correlate`` — a full Correlator run over a replay recording, each
                    process feeding its local span; process 0 writes the
                    CSV product.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import List, Optional


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wants_cpu(platform: str = "auto") -> bool:
    """True when this run was asked to use the CPU backend: explicitly
    (``platform='cpu'``) or, under ``'auto'``, by ``JAX_PLATFORMS=cpu``."""
    if platform == "auto":
        return os.environ.get("JAX_PLATFORMS", "") == "cpu"
    return platform == "cpu"


def init_runtime(process_id: int, num_processes: int, coordinator: str,
                 local_devices: int = 4, platform: str = "auto"):
    """Bring up the multi-controller runtime in THIS process.  Must run
    before any JAX backend touch.  On the CPU (only when asked, see
    :func:`wants_cpu`) each process gets ``local_devices`` virtual devices
    and gloo collectives; otherwise the GPU backend with one card per
    process (module docstring)."""
    cpu = wants_cpu(platform)
    kw = {}
    if cpu:
        flags = os.environ.get("XLA_FLAGS", "")
        if "--xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count"
                f"={local_devices}").strip()
    elif "," in os.environ.get("CUDA_VISIBLE_DEVICES", ","):
        kw["local_device_ids"] = [process_id]
    import jax
    if cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    elif platform != "auto":
        jax.config.update("jax_platforms", platform)
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id, **kw)
    return jax


def launch(num_processes: int, role: str, role_args: List[str],
           local_devices: int = 4, timeout: float = 600.0,
           coordinator: Optional[str] = None, platform: str = "auto"):
    """Spawn ``num_processes`` local workers and wait for all of them.
    On the GPU each worker is pinned to card ``pid`` through
    ``CUDA_VISIBLE_DEVICES``.  Returns the list of
    ``subprocess.CompletedProcess``; raises on any nonzero exit with the
    failing worker's output."""
    coordinator = coordinator or f"127.0.0.1:{_free_port()}"
    cpu = wants_cpu(platform)
    cards = [c for c in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
             if c]
    procs = []
    for pid in range(num_processes):
        env = dict(os.environ)
        # each worker picks its own device-count flag in init_runtime
        env.pop("XLA_FLAGS", None)
        if not cpu:
            env["CUDA_VISIBLE_DEVICES"] = cards[pid] if cards else str(pid)
        cmd = [sys.executable, "-m", "fxtpu.parallel.multihost",
               "--role", role,
               "--process_id", str(pid),
               "--num_processes", str(num_processes),
               "--coordinator", coordinator,
               "--local_devices", str(local_devices),
               "--platform", "cpu" if cpu else platform] + role_args
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    results = []
    failed = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"multihost worker {pid} timed out")
        results.append(subprocess.CompletedProcess(p.args, p.returncode,
                                                   out, None))
        if p.returncode != 0:
            failed.append((pid, out))
    if failed:
        msgs = "\n\n".join(f"--- worker {pid} (rc != 0) ---\n{out[-4000:]}"
                           for pid, out in failed)
        raise RuntimeError(f"multihost workers failed:\n{msgs}")
    return results


# ---------------------------------------------------------------------------
# Worker roles
# ---------------------------------------------------------------------------

def _build_mesh(mesh_freq: int):
    import jax

    from fxtpu.parallel.mesh import make_correlator_mesh
    n = len(jax.devices())
    return make_correlator_mesh(n // mesh_freq, mesh_freq)


def _role_step(args):
    """One sharded FX step over a deterministic global block; process 0
    saves the visibility + new history to ``--out`` (.npz)."""
    import numpy as np

    import jax

    from fxtpu.config import CorrelatorConfig
    from fxtpu.fx import FxEngine
    from fxtpu.parallel.ingest import local_sample_span, put_block

    mesh = _build_mesh(args.mesh_freq)
    nbins = args.nbins
    num_samp = args.num_samp
    cfg = CorrelatorConfig(mode="SPECTRUM", nchan=2, ntaps=4, nbins=nbins,
                           num_samp=num_samp, clamp_num_samp=False)
    eng = FxEngine(cfg, mesh=mesh)

    rng = np.random.default_rng(20260817)
    block = (rng.normal(size=(2, num_samp)).astype(np.float32)
             + 1j * rng.normal(size=(2, num_samp)).astype(np.float32)
             ).astype(np.complex64)
    start, stop = local_sample_span(mesh, num_samp)
    local = np.ascontiguousarray(block[:, start:stop])
    iq = put_block(local, mesh, global_num_samp=num_samp)
    delays = np.asarray([0.0, 1.25e-6], np.float32)
    history = eng.fresh_history()
    vis, new_hist = eng.step(iq, delays, history)
    vis_np = np.asarray(jax.device_get(vis))
    hist_np = np.stack([np.asarray(jax.device_get(new_hist.re)),
                        np.asarray(jax.device_get(new_hist.im))])
    assert np.all(np.isfinite(vis_np)), "non-finite visibility"
    if jax.process_index() == 0 and args.out:
        np.savez(args.out, vis=vis_np, hist=hist_np)
    print(f"[step worker {jax.process_index()}] OK "
          f"mesh={dict(mesh.shape)} vis={vis_np.shape}", flush=True)


def _role_correlate(args):
    """Full Correlator run over a replay recording; process 0 writes the
    CSV product.  Every process feeds only its local sample span."""
    import numpy as np

    import jax

    from fxtpu.config import CorrelatorConfig
    from fxtpu.correlator import Correlator

    mesh = _build_mesh(args.mesh_freq)
    cfg = CorrelatorConfig(
        mode=args.mode, nchan=2, nbins=args.nbins, num_samp=args.num_samp,
        clamp_num_samp=False, source="replay", replay_file=args.recording,
        run_time=30, loglevel="WARNING", output_file=args.out,
        calibrate_on_start=True, startup_duration=0.2)
    cor = Correlator(config=cfg, mesh=mesh)
    cor.run_state_machine()
    print(f"[correlate worker {jax.process_index()}] OK "
          f"blocks={cor.blocks_processed} "
          f"delays_us={1e6 * cor.calibrated_delays}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--role", required=True, choices=["step", "correlate"])
    p.add_argument("--process_id", type=int, required=True)
    p.add_argument("--num_processes", type=int, required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--local_devices", type=int, default=4)
    p.add_argument("--mesh_freq", type=int, default=2)
    p.add_argument("--nbins", type=int, default=256)
    p.add_argument("--num_samp", type=int, default=256 * 64)
    p.add_argument("--mode", default="SPECTRUM")
    p.add_argument("--platform", default="auto",
                   choices=["auto", "cpu", "gpu"])
    p.add_argument("--recording", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    init_runtime(args.process_id, args.num_processes, args.coordinator,
                 args.local_devices, args.platform)
    if args.role == "step":
        _role_step(args)
    else:
        _role_correlate(args)


if __name__ == "__main__":
    main()
