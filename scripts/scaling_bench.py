"""Scaling-efficiency benchmark: sharded FX step over 1..N devices.

Measures aggregate samples/s of the mesh-sharded correlator step
(`fxtpu.parallel.sharded`: halo ppermute -> F-stage -> corner-turn
all_to_all -> X-stage psum) at a fixed PER-DEVICE workload (weak scaling,
the production streaming regime: more chips correlate more bandwidth-time),
and reports efficiency vs the single-device rate.

On a host with several GPUs this is the scaling number (one process
drives every card).  Pass ``--cpu N`` to run the sweep on an N-device
virtual CPU mesh instead (functional validation of the collective
program, NOT a performance statement — it prints which).

Usage:  python scripts/scaling_bench.py [--devices 1 2 4 8] [--freq 2]
        [--block_pow 21] [--nbins 4096] [--iters 10] [--cpu 8]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(n_dev: int, mesh_freq: int, block_pow: int, nbins: int,
            iters: int, warmup: int = 3) -> float:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fxtpu.config import CorrelatorConfig
    from fxtpu.fx import FxEngine
    from fxtpu.parallel import make_correlator_mesh
    from fxtpu.parallel.mesh import block_sharding

    # weak scaling: num_samp per device is constant
    num_samp = (2 ** block_pow) * n_dev
    f = mesh_freq if n_dev % mesh_freq == 0 and n_dev >= mesh_freq else 1
    mesh = make_correlator_mesh(n_dev // f, f,
                                devices=jax.devices()[:n_dev])
    cfg = CorrelatorConfig(mode="SPECTRUM", nchan=2, num_samp=num_samp,
                           nbins=nbins, clamp_num_samp=False)
    eng = FxEngine(cfg, mesh=mesh)
    rng = np.random.default_rng(0)
    blk = (rng.normal(size=(2, num_samp)).astype(np.float32)
           + 1j * rng.normal(size=(2, num_samp)).astype(np.float32))
    iq = jax.device_put(eng.prepare_block(blk), block_sharding(mesh))
    delays = jnp.zeros((2,), jnp.float32)
    hist = eng.fresh_history()

    vis, hist = eng.step(iq, delays, hist)
    jax.block_until_ready(vis)
    for _ in range(warmup):
        vis, hist = eng.step(iq, delays, hist)
    jax.block_until_ready(vis)
    t0 = time.perf_counter()
    for _ in range(iters):
        vis, hist = eng.step(iq, delays, hist)
    jax.block_until_ready(vis)
    dt = time.perf_counter() - t0
    return 2 * num_samp * iters / dt


def measure_multi(n_dev: int, block_pow: int, nbins: int, iters: int,
                  k: int) -> dict:
    """Per-dispatch-overhead amortization A/B on one mesh: K blocks as K
    sequential sharded dispatches vs ONE sharded multi_step dispatch.
    Same math both ways — results asserted equal in tests/test_sharded.py;
    this measures the dispatch wall only."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fxtpu.config import CorrelatorConfig
    from fxtpu.fx import FxEngine
    from fxtpu.parallel import make_correlator_mesh

    num_samp = 2 ** block_pow
    mesh = make_correlator_mesh(n_dev, 1, devices=jax.devices()[:n_dev])
    cfg = CorrelatorConfig(mode="SPECTRUM", nchan=2, num_samp=num_samp,
                           nbins=nbins, clamp_num_samp=False)
    eng = FxEngine(cfg, mesh=mesh)
    k = eng.dispatch_batch_for(k)
    rng = np.random.default_rng(0)
    blocks = [(rng.normal(size=(2, num_samp)).astype(np.float32)
               + 1j * rng.normal(size=(2, num_samp)).astype(np.float32))
              for _ in range(k)]
    iq1 = [eng.prepare_block(b) for b in blocks]
    iqk = eng.prepare_batch(blocks)
    d1 = jnp.zeros((2,), jnp.float32)
    dk = jnp.zeros((k, 2), jnp.float32)

    def run_single():
        h = eng.fresh_history()
        for b in iq1:
            v, h = eng.step(b, d1, h)
        return v

    def run_multi():
        v, _ = eng.multi_step(iqk, dk, eng.fresh_history())
        return v

    out = {"devices": n_dev, "k": k}
    for name, fn in (("single", run_single), ("multi", run_multi)):
        jax.block_until_ready(fn())  # compile
        t0 = time.perf_counter()
        for _ in range(iters):
            v = fn()
        jax.block_until_ready(v)
        dt = time.perf_counter() - t0
        out[f"{name}_samples_per_s"] = round(2 * num_samp * k * iters / dt, 1)
    out["multi_speedup"] = round(
        out["multi_samples_per_s"] / out["single_samples_per_s"], 3)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, nargs="+", default=None,
                   help="device counts to sweep (default: 1,2,4,..,N)")
    p.add_argument("--freq", type=int, default=2,
                   help="mesh_freq for multi-device points")
    p.add_argument("--block_pow", type=int, default=21)
    p.add_argument("--nbins", type=int, default=4096)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--cpu", type=int, default=0, metavar="N",
                   help="run on an N-device virtual CPU mesh (functional "
                        "validation, not a performance statement)")
    p.add_argument("--multi", type=int, default=0, metavar="K",
                   help="instead of the scaling sweep, A/B K-block multi "
                        "dispatch vs K single dispatches on each mesh "
                        "size (per-dispatch overhead amortization)")
    args = p.parse_args()

    if args.cpu:
        # must precede the first jax use: XLA_FLAGS is read at backend
        # init
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu}")
        import jax
        jax.config.update("jax_platforms", "cpu")

    import jax

    import fxtpu  # noqa: F401  (compile-cache location)
    n = len(jax.devices())
    platform = jax.devices()[0].platform
    counts = args.devices or [c for c in (1, 2, 4, 8, 16, 32) if c <= n]
    if platform != "gpu" or n == 1:
        print(f"# NOTE: {n} {platform} device(s) — functional-scaling "
              "validation only, not a hardware performance statement",
              file=sys.stderr)

    if args.multi:
        rows = []
        for c in counts:
            if c < 2:
                continue
            row = measure_multi(c, args.block_pow, args.nbins, args.iters,
                                args.multi)
            rows.append(row)
            print(json.dumps(row))
        print(json.dumps({"metric": "sharded_multi_dispatch_amortization",
                          "platform": platform, "rows": rows}))
        return

    base = None
    rows = []
    for c in counts:
        rate = measure(c, args.freq, args.block_pow, args.nbins, args.iters)
        if base is None:
            base = rate  # single-device (or smallest) reference
            base_c = c
        eff = rate / (base * c / base_c)
        rows.append({"devices": c, "samples_per_s": round(rate, 1),
                     "per_device": round(rate / c, 1),
                     "efficiency_vs_linear": round(eff, 4)})
        print(json.dumps(rows[-1]))
    print(json.dumps({"metric": "sharded_scaling_sweep",
                      "platform": platform, "rows": rows}))


if __name__ == "__main__":
    main()
