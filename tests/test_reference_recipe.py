"""Product-contract test that executes the REFERENCE's exact parsing lines.

Rather than reimplementing the reference's CSV parsing recipe, this
extracts the literal recipe lines from
``/root/reference/effex/post_process.py`` (header split at :201-204,
skiprows selection at :205-209, complex128 loadtxt at :217) at runtime and
``exec``s them unmodified against files fxtpu wrote — byte-level proof
that a reference user's own tooling reads our products.  Skipped when the
reference tree isn't present (the recipe is quoted nowhere in this repo).
"""

import os

import numpy as np
import pytest

REF = "/root/reference/effex/post_process.py"

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF), reason="reference tree not available")


class _Args:
    def __init__(self, filename):
        self.filename = filename


def run_reference_recipe(filename):
    """Extract and exec the reference's own parsing lines (from
    ``metadata = {}`` through the complex128 ``np.loadtxt``) verbatim."""
    src = open(REF).read()
    start = src.index("    metadata = {}")
    stop = src.index("    post_process(")
    snippet = "\n".join(line[4:] for line in
                        src[start:stop].splitlines())
    ns = {"np": np, "args": _Args(filename)}
    exec(compile(snippet, REF, "exec"), ns)  # the reference's exact lines
    return ns["metadata"], ns["skiprows"], ns["output"]


def _write_product(tmp_path, mode, nbins=64, rows=3):
    from queue import Queue

    from fxtpu.config import CorrelatorConfig
    from fxtpu import products

    path = str(tmp_path / f"vis_{mode}.csv")
    cfg = CorrelatorConfig(mode=mode, nbins=nbins, num_samp=nbins * 8,
                           clamp_num_samp=False, output_file=path)
    products.write_metadata(path, cfg)
    rng = np.random.default_rng(5)
    vis_rows = []
    q = Queue()
    for _ in range(rows):
        if mode == "SPECTRUM":
            v = (rng.normal(size=nbins) + 1j * rng.normal(size=nbins)
                 ).astype(np.complex64)
        else:
            v = np.complex64(rng.normal() + 1j * rng.normal())
        vis_rows.append(v)
        q.put(v)
    w = products.VisibilityWriter(path, q, active_fn=lambda: False).start()
    w.join(5.0)
    return path, cfg, np.asarray(vis_rows)


@pytest.mark.parametrize("mode", ["SPECTRUM", "CONTINUUM", "TEST"])
def test_reference_parser_reads_fxtpu_product(tmp_path, mode):
    path, cfg, want = _write_product(tmp_path, mode)
    metadata, skiprows, output = run_reference_recipe(path)

    # header fields parse to the config values through the reference's
    # key:value split (effex.py:671-678 format contract)
    assert float(metadata["bandwidth"]) == cfg.bandwidth
    assert float(metadata["frequency"]) == cfg.frequency
    assert int(metadata["resolution"]) == cfg.nbins
    assert metadata["mode"].lower() == mode.lower()
    # the reference picks skiprows 2 only for spectrum (post_process.py:205-209)
    assert skiprows == (2 if mode == "SPECTRUM" else 1)
    # and the complex payload round-trips bit-exactly at c64 precision
    got = np.atleast_1d(output)
    if mode == "SPECTRUM":
        assert got.shape == want.shape
    else:
        assert got.shape == (len(want),)
    np.testing.assert_array_equal(got.astype(np.complex64), want)


def test_reference_recipe_freq_row_matches(tmp_path):
    """SPECTRUM: row 2 (the shifted RF frequency axis) must agree with the
    reference's freqs = fftshift(fftfreq(nbins, 1/bw) + fc) (effex.py:679-682)."""
    path, cfg, _ = _write_product(tmp_path, "SPECTRUM")
    with open(path) as fh:
        fh.readline()
        freq_row = np.asarray([complex(v) for v in
                               fh.readline().strip().split(",")])
    want = np.fft.fftshift(
        np.fft.fftfreq(cfg.nbins, d=1.0 / cfg.bandwidth) + cfg.frequency)
    np.testing.assert_allclose(freq_row.real, want, rtol=0, atol=1e-6)
