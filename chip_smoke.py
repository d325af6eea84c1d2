"""On-card smoke run of the FX correlator: proves the main path runs on a GPU.

    python chip_smoke.py               # phases (a)-(c), one card
    python chip_smoke.py --four-cards  # phase (d) only, four cards

Phases:
  (a) device      JAX's first device is a GPU; anything else exits non-zero
                  before any result is printed (no CPU fallback).
  (b) cli         ``fxtpu.cli.main`` end to end in SPECTRUM mode: the
                  synthetic source at complex64, then a replayed recording
                  at int8 ingest.  Checks the calibrated delay, the CSV
                  (reference loading recipe), in-band phase flatness and
                  the block count.
  (c) configs     every ``bench.CONFIGS`` entry at its own shape:
                  ``FxEngine.multi_step`` over K blocks with the history
                  carried, the first two blocks against the float64
                  reference (``fxtpu.reference``).
  (d) four-cards  the sharded step and sharded multi_step on (4,1) and
                  (2,2) meshes at the flagship and 32-tap shapes, against
                  the single-device step on the same blocks and the float64
                  reference; prints the compiled collective volumes.

Every phase prints its max error next to its tolerance and its seconds per
dispatch (information, not a benchmark).  Any failure exits non-zero.  The
last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

#: Tolerance on max |device - float64 reference| / max |reference|.  The
#: step is single precision end to end: f32 FIR, complex64 cuFFT, f32
#: X-stage dots at HIGHEST.  Measured errors on an H100 are 3e-7 to 8e-7
#: (PERF.md), the f32 rounding floor for a 4096-8192-point transform and a
#: few hundred summed frames; 1e-5 leaves a 10x margin for other shapes and
#: summation orders, and still fails any stage that falls to TF32 (about
#: 3e-4 here) or bf16.
TOLERANCE = 1e-5

#: Phase (b) checks (the verify recipe): the injected delay, the
#: 0.5-sample calibration oracle at 2.4 MS/s, and in-band phase flatness.
TRUE_DELAY = 2e-6
DELAY_TOL = 0.21e-6
PHASE_STD_MAX = 0.3

def select_phases(four_cards: bool):
    """The phases one invocation runs after the device check: the
    four-card phase alone, or every single-card phase."""
    return ["four_cards"] if four_cards else ["cli", "configs"]


def _report(name, err, tol, sec=None, extra=""):
    ok = err <= tol
    t = f", {sec:.6f} s/dispatch" if sec is not None else ""
    print(f"[{name}] max err {err:.3e} (tolerance {tol:.0e}){t}{extra}"
          f" -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: error {err:.3e} above {tol:.0e}")


def _versions():
    import importlib.metadata as md

    import jax
    out = {"jax": jax.__version__}
    for pkg in ("jaxlib", "jax-cuda12-plugin", "jax-cuda13-plugin",
                "jax-cuda12-pjrt", "jax-cuda13-pjrt"):
        try:
            out[pkg] = md.version(pkg)
        except md.PackageNotFoundError:
            pass
    return out


def _precisions():
    from fxtpu.ops import planes
    return {
        "fft": "jnp.fft on complex64 (cuFFT, single precision)",
        "gram_x_dots": str(planes.GRAM_PRECISION),
        "fir_fstc_dequant": "f32 elementwise (no dots)",
    }


# ---------------------------------------------------------------- data
def correlated_blocks(rng, nchan, num_samp, n, ingest="complex64",
                      quant_step=1.0 / 32):
    """``n`` blocks of a common signal plus per-channel noise (so cross
    baselines are as large as autos and the max-relative error is
    meaningful for every baseline); int8 codes for int8 ingest."""
    import numpy as np
    out = []
    for _ in range(n):
        s = rng.standard_normal(num_samp, np.float32) \
            + 1j * rng.standard_normal(num_samp, np.float32)
        x = 0.7 * (s[None] + rng.standard_normal((nchan, num_samp),
                                                 np.float32)
                   + 1j * rng.standard_normal((nchan, num_samp), np.float32))
        x = x.astype(np.complex64)
        if ingest == "int8":
            from fxtpu.runtime.native import quantize_c64
            x = quantize_c64(x, quant_step)
        out.append(x)
    return out


# ---------------------------------------------------------------- (b)
def run_cli(workdir, extra, label):
    """One ``fxtpu.cli.main`` run; checks the product like the verify
    recipe does."""
    import numpy as np

    from fxtpu.cli import main as cli_main
    out = os.path.join(workdir, f"vis_{label}.csv")
    t0 = time.perf_counter()
    cor = cli_main(["--mode", "spectrum", "--num_samp", "262144",
                    "--true_delay", str(TRUE_DELAY),
                    "--blocks_per_dispatch", "16", "--time", "10",
                    "--omit_plot", "--no_keyboard", "--output", out,
                    "-L", "WARNING", *extra])
    wall = time.perf_counter() - t0
    delay = float(cor.calibrated_delays[1])
    data = np.loadtxt(out, dtype=np.complex128, delimiter=",", skiprows=2)
    data = np.atleast_2d(data)
    ph = np.unwrap(np.angle(data.mean(axis=0)))
    nb = data.shape[-1]
    std = float(np.std(ph[nb // 4: 3 * nb // 4]))
    print(f"[cli:{label}] blocks={cor.blocks_processed} rows={data.shape} "
          f"delay={delay * 1e6:.4f} us (truth {TRUE_DELAY * 1e6} us, "
          f"tolerance {DELAY_TOL * 1e6} us) in-band phase std {std:.4f} rad "
          f"(max {PHASE_STD_MAX}) wall {wall:.1f} s", flush=True)
    assert cor.blocks_processed > 0, label
    assert data.shape == (cor.blocks_processed, 4096), (label, data.shape)
    assert np.all(np.isfinite(data)), label
    assert abs(delay - TRUE_DELAY) < DELAY_TOL, (label, delay)
    assert std < PHASE_STD_MAX, (label, std)


def phase_cli():
    from fxtpu.sources import NoiseSource, save_recording
    with tempfile.TemporaryDirectory() as d:
        run_cli(d, [], "synthetic_c64")
        rec = save_recording(
            NoiseSource(nchan=2, delays=[0.0, TRUE_DELAY], seed=5),
            os.path.join(d, "rec.npy"), 262144, 40)
        run_cli(d, ["--source", "replay", "--replay_file", rec,
                    "--ingest", "int8"], "replay_int8")


# ---------------------------------------------------------------- (c)
def check_config(name, kw, rng, k=None, iters=3):
    """One bench config at its own shape: K-block multi_step, first two
    blocks against the float64 reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fxtpu import reference
    from fxtpu.config import CorrelatorConfig
    from fxtpu.fx import FxEngine
    from fxtpu.ops.cplx import to_complex
    from fxtpu.ops.planes import pack_delays

    nchan = kw.get("nchan", 2)
    ingest = kw.get("ingest", "complex64")
    cfg = CorrelatorConfig(
        mode="SPECTRUM", nchan=nchan, num_samp=2 ** kw["block_pow"],
        nbins=kw["nbins"], ntaps=kw.get("ntaps", 4),
        include_autos=kw.get("include_autos", False),
        clamp_num_samp=False, ingest_dtype=ingest)
    k = k or kw.get("blocks_per_call", 128)
    eng = FxEngine(cfg)
    distinct = correlated_blocks(rng, nchan, cfg.num_samp, 4, ingest,
                                 cfg.quant_step)
    d_sec = np.array([0.0] + [1.3e-7 * (c + 1) for c in range(nchan - 1)])
    dk = jnp.asarray(pack_delays(np.repeat(d_sec[None], k, 0),
                                 cfg.frequency))
    iq = eng.prepare_batch([distinct[i % 4] for i in range(k)])
    hist = eng.fresh_history()
    t0 = time.perf_counter()
    vis, _ = eng.multi_step(iq, dk, hist)
    jax.block_until_ready(vis)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        out = eng.multi_step(iq, dk, hist)
    jax.block_until_ready(out)
    sec = (time.perf_counter() - t0) / iters
    got = to_complex(vis)
    assert got.shape == (k, len(eng.pairs), cfg.nbins), got.shape
    assert np.all(np.isfinite(got)), name
    want = reference.fx_blocks(distinct[:2], eng.window2d, eng.pairs,
                               bandwidth=cfg.bandwidth,
                               frequency=cfg.frequency, delays=d_sec,
                               quant_step=cfg.quant_step)
    err = reference.max_rel_error(got[:2], want)
    _report(f"configs:{name}", err, TOLERANCE, sec,
            f" (K={k}, {sec / k * 1e3:.4f} ms/block, first call "
            f"{first:.1f} s)")


def phase_configs():
    import numpy as np

    import bench
    rng = np.random.default_rng(20261016)
    for name, kw in bench.CONFIGS.items():
        check_config(name, kw, rng)


# ---------------------------------------------------------------- (d)
def check_mesh(shape, label, nbins, ntaps, rng, k=8, num_samp=2 ** 21):
    """Sharded step + sharded multi_step on one mesh vs the single-device
    step on the same blocks and the float64 reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fxtpu import reference
    from fxtpu.config import CorrelatorConfig
    from fxtpu.fx import FxEngine
    from fxtpu.ops.cplx import to_complex
    from fxtpu.ops.planes import pack_delays
    from fxtpu.parallel import make_correlator_mesh
    from fxtpu.parallel.accounting import collective_lines, hlo_volume

    mesh = make_correlator_mesh(*shape)
    cfg = CorrelatorConfig(mode="SPECTRUM", nchan=2, num_samp=num_samp,
                           nbins=nbins, ntaps=ntaps, clamp_num_samp=False)
    blocks = correlated_blocks(rng, 2, cfg.num_samp, k)
    d_sec = np.array([0.0, 4.1e-7])
    d1 = jnp.asarray(pack_delays(d_sec, cfg.frequency))
    dk = jnp.asarray(pack_delays(np.repeat(d_sec[None], k, 0),
                                 cfg.frequency))
    eng1 = FxEngine(cfg)
    engm = FxEngine(cfg, mesh=mesh)
    want = reference.fx_blocks(blocks[:2], eng1.window2d, eng1.pairs,
                               bandwidth=cfg.bandwidth,
                               frequency=cfg.frequency, delays=d_sec)
    h1, hm, single, sharded = (eng1.fresh_history(), engm.fresh_history(),
                               [], [])
    for b in blocks:
        v1, h1 = eng1.step(eng1.prepare_block(b), d1, h1)
        vm, hm = engm.step(engm.prepare_block(b), d1, hm)
        single.append(to_complex(v1))
        sharded.append(to_complex(vm))
    single, sharded = np.stack(single), np.stack(sharded)
    _report(f"four_cards:{label}:step-vs-single", reference.max_rel_error(
        sharded, single), TOLERANCE)
    _report(f"four_cards:{label}:step-vs-reference",
            reference.max_rel_error(sharded[:2], want), TOLERANCE)
    iq = engm.prepare_batch(blocks)
    hist = engm.fresh_history()
    vis, _ = engm.multi_step(iq, dk, hist)
    jax.block_until_ready(vis)
    t0 = time.perf_counter()
    for _ in range(3):
        out = engm.multi_step(iq, dk, hist)
    jax.block_until_ready(out)
    sec = (time.perf_counter() - t0) / 3
    _report(f"four_cards:{label}:multi-vs-single",
            reference.max_rel_error(to_complex(vis), single), TOLERANCE, sec,
            f" (K={k}, {sec / k * 1e3:.4f} ms/block)")
    hlo = engm.step.lower(engm.prepare_block(blocks[0]), d1,
                          engm.fresh_history()).compile().as_text()
    for _, line in collective_lines(hlo):
        print(f"[four_cards:{label}] hlo: {line.strip()[:160]}")
    print(f"[four_cards:{label}] measured_volume per block (bytes): "
          f"{json.dumps(hlo_volume(hlo))}", flush=True)


def phase_four_cards():
    import jax
    import numpy as np

    n = len(jax.devices())
    if n < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, JAX sees {n}")
    rng = np.random.default_rng(20261017)
    for shape in ((4, 1), (2, 2)):
        for label, nbins, ntaps in (("flagship", 4096, 4),
                                    ("taps32", 8192, 32)):
            check_mesh(shape, f"{shape[0]}x{shape[1]}:{label}", nbins,
                       ntaps, rng)


# ---------------------------------------------------------------- main
def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card phase (needs 4 GPUs)")
    args = p.parse_args(argv)
    phases = select_phases(args.four_cards)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    import fxtpu  # noqa: F401  (compile-cache location)
    from fxtpu.runtime.device import card_line, device_info, require_gpu

    # (a) device: a GPU or nothing — raises before any result is printed
    require_gpu()
    print(f"card: {card_line()}", flush=True)
    print(f"versions: {json.dumps(_versions())}", flush=True)
    print(f"precision: {json.dumps(_precisions())}", flush=True)
    print(f"[device] {device_info()} -> ok", flush=True)
    t0 = time.perf_counter()
    for name in phases:
        ts = time.perf_counter()
        {"cli": phase_cli, "configs": phase_configs,
         "four_cards": phase_four_cards}[name]()
        print(f"[{name}] phase done in {time.perf_counter() - ts:.1f} s",
              flush=True)
    print(f"all phases done in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": device_info()}))


if __name__ == "__main__":
    main()
