"""The production planes step against the float64 NumPy reference
(``fxtpu.reference``) over a grid of PFB shapes and both ingest widths.

Each case streams two blocks through ``FxEngine.step`` with the tap history
carried, so the history handoff is checked at every (nbins, ntaps) as well.
The data is a common signal plus per-channel noise, so the cross baseline
is as large as the autos and one max-relative error covers every baseline.
Tolerance 1e-5: the step is single precision end to end and measures a few
1e-7 here and on the GPU."""

import jax.numpy as jnp
import numpy as np
import pytest

from fxtpu import reference
from fxtpu.config import CorrelatorConfig
from fxtpu.fx import FxEngine
from fxtpu.ops.cplx import to_complex
from fxtpu.ops.planes import pack_delays

TOL = 1e-5


def correlated(rng, nchan, num_samp, n, int8=False, quant_step=1.0 / 32):
    out = []
    for _ in range(n):
        s = rng.normal(size=num_samp) + 1j * rng.normal(size=num_samp)
        x = 0.7 * (s[None] + rng.normal(size=(nchan, num_samp))
                   + 1j * rng.normal(size=(nchan, num_samp)))
        if int8:
            q = np.empty((nchan, num_samp, 2), np.int8)
            q[..., 0] = np.clip(np.rint(x.real / quant_step), -127, 127)
            q[..., 1] = np.clip(np.rint(x.imag / quant_step), -127, 127)
            out.append(q)
        else:
            out.append(x.astype(np.complex64))
    return out


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("ntaps", [1, 4, 16, 32])
@pytest.mark.parametrize("nbins", [256, 1024, 4096, 8192])
def test_step_matches_reference(nbins, ntaps, ingest):
    frames = max(ntaps, 8)
    cfg = CorrelatorConfig(mode="SPECTRUM", nchan=2, nbins=nbins,
                           ntaps=ntaps, num_samp=nbins * frames,
                           clamp_num_samp=False, ingest_dtype=ingest)
    rng = np.random.default_rng(nbins + ntaps)
    blocks = correlated(rng, 2, cfg.num_samp, 2, ingest == "int8",
                        cfg.quant_step)
    d_sec = np.array([0.0, 3.7e-7])
    delays = jnp.asarray(pack_delays(d_sec, cfg.frequency))
    eng = FxEngine(cfg)
    hist, got = eng.fresh_history(), []
    for b in blocks:
        vis, hist = eng.step(eng.prepare_block(b), delays, hist)
        got.append(to_complex(vis))
    want = reference.fx_blocks(blocks, eng.window2d, eng.pairs,
                               bandwidth=cfg.bandwidth,
                               frequency=cfg.frequency, delays=d_sec,
                               quant_step=cfg.quant_step)
    got = np.stack(got)
    assert got.shape == want.shape == (2, 1, nbins)
    assert reference.max_rel_error(got, want) < TOL
