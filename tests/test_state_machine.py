"""State-machine and property tests, mirroring the reference system-level
suite (test_effex.py:124-248) — but hardware-free: the fixture builds a
correlator over a synthetic source instead of opening two USB SDRs."""

import numpy as np
import pytest

from fxtpu.config import CorrelatorConfig
from fxtpu.correlator import Correlator, StateTransitionError
from fxtpu.sources import NoiseSource


def make_cor(**kw):
    kw.setdefault("num_samp", 2**14)
    kw.setdefault("nbins", 2**10)
    kw.setdefault("clamp_num_samp", False)
    return Correlator(config=CorrelatorConfig(**kw))


@pytest.fixture(scope="class")
def cor():
    c = make_cor()
    yield c
    c.close()


def step_and_assert(cor, sequence):
    # test_effex.py:52-56
    for state in sequence:
        cor.state = state
        assert state == cor.state


@pytest.mark.usefixtures("cor")
class TestNominal:
    def test_correlator_init(self, cor):
        # test_effex.py:127-134 defaults
        assert cor.state == "OFF"
        assert cor.mode == "SPECTRUM"
        assert cor.bandwidth == 2.4e6
        assert cor.frequency == 1.4204e9
        assert cor.gain == 49.6

    def test_change_bandwidth(self, cor):
        cor.bandwidth = 2.3e6
        assert cor.bandwidth == 2.3e6
        assert cor.source.sample_rate == 2.3e6  # hardware pass-through

    def test_change_nbins(self, cor):
        cor.nbins = 2**11
        assert cor.nbins == 2**11

    def test_change_frequency(self, cor):
        cor.frequency = 1.419e9
        assert cor.frequency == 1.419e9
        assert cor.source.center_freq == 1.419e9

    def test_change_gain(self, cor):
        cor.gain = 29.7
        assert cor.gain == 29.7
        assert cor.source.gain == 29.7

    def test_nominal_state_transitions(self, cor):
        # test_effex.py:157-159
        step_and_assert(cor, ("STARTUP", "RUN", "CALIBRATE", "RUN",
                              "SHUTDOWN", "OFF"))

    def test_early_aborts(self, cor):
        # test_effex.py:162-170
        step_and_assert(cor, ("STARTUP", "SHUTDOWN", "OFF"))
        step_and_assert(cor, ("STARTUP", "RUN", "SHUTDOWN", "OFF"))
        step_and_assert(cor, ("STARTUP", "RUN", "CALIBRATE", "SHUTDOWN",
                              "OFF"))
        step_and_assert(cor, ("STARTUP", "RUN", "CALIBRATE", "RUN",
                              "SHUTDOWN", "OFF"))


# Illegal transitions use fresh instances: the reference's shared fixture
# leaks closed-SDR state between these tests; ours are independent.
def test_bad_transition_from_OFF():
    cor = make_cor()
    with pytest.raises(StateTransitionError):
        cor.state = "OFF"
    cor = make_cor()
    with pytest.raises(StateTransitionError):
        cor.state = "RUN"


def test_bad_transition_from_STARTUP():
    cor = make_cor()
    cor.state = "STARTUP"
    with pytest.raises(StateTransitionError):
        cor.state = "STARTUP"


def test_bad_transition_from_RUN():
    cor = make_cor()
    cor.state = "STARTUP"
    cor.state = "RUN"
    with pytest.raises(StateTransitionError):
        cor.state = "RUN"
    cor = make_cor()
    cor.state = "STARTUP"
    cor.state = "RUN"
    with pytest.raises(StateTransitionError):
        cor.state = "STARTUP"


def test_bad_transition_from_CALIBRATE():
    cor = make_cor()
    cor.state = "STARTUP"
    cor.state = "RUN"
    cor.state = "CALIBRATE"
    with pytest.raises(StateTransitionError):
        cor.state = "CALIBRATE"
    cor = make_cor()
    cor.state = "STARTUP"
    cor.state = "RUN"
    cor.state = "CALIBRATE"
    with pytest.raises(StateTransitionError):
        cor.state = "STARTUP"


def test_unknown_state_raises():
    cor = make_cor()
    with pytest.raises(ValueError):
        cor.state = "WARP"


def test_nested_exception_alias():
    # reference exposes Correlator.StateTransitionError (test_effex.py:175)
    assert Correlator.StateTransitionError is StateTransitionError


# ------------------------------------------------------------------
# Off-nominal init (test_effex.py:225-248)
# ------------------------------------------------------------------
def test_bad_run_time_init():
    with pytest.raises(ValueError):
        make_cor(run_time=0)


def test_bad_bandwidth_init():
    # Should not raise; sources may warn if they declare a ceiling.
    cor = make_cor(bandwidth=3.0e6)
    cor.close()


def test_bad_mode_init():
    with pytest.raises(ValueError):
        make_cor(mode="FOO")


def test_alt_mode_init():
    alt = make_cor(mode="CONTINUUM")
    assert alt.state == "OFF"
    assert alt.mode == "CONTINUUM"
    alt.close()


def test_mode_lowercase_accepted():
    alt = make_cor(mode="continuum")
    assert alt.mode == "CONTINUUM"
    alt.close()


def test_num_samp_clamping():
    # effex.py:277-284: silent clamp to [2^8, 2^18]
    cor = Correlator(config=CorrelatorConfig(num_samp=2**20, nbins=2**10))
    assert cor.num_samp == 2**18
    cor.close()
    cor = Correlator(config=CorrelatorConfig(num_samp=4, nbins=2, ntaps=1))
    assert cor.num_samp == 2**8
    cor.close()


def test_pfb_constraint_enforced():
    # effex.py:118-124: at least one full window per block
    with pytest.raises(ValueError):
        CorrelatorConfig(num_samp=2**10, nbins=2**10, ntaps=4,
                         clamp_num_samp=False)


def test_child_exception_forces_shutdown():
    """Supervision contract (effex.py:165-173,344-347)."""
    cor = make_cor()
    cor.exc_queue.put("boom traceback")
    assert cor._child_threw_exception()
    assert not cor._child_threw_exception()


def test_reference_kwarg_constructor():
    """The reference's kwargs shape works directly (effex.py:45-53)."""
    cor = Correlator(run_time=1, bandwidth=2.4e6, frequency=1.4204e9,
                     num_samp=2**14, nbins=2**10, gain=49.6,
                     mode="SPECTRUM", loglevel="WARNING",
                     clamp_num_samp=False)
    assert cor.mode == "SPECTRUM"
    cor.close()


class TestMutationRebuildsEngine:
    """Post-init property mutation must rebuild the compute engine so the
    correlator actually correlates at the new shape (the reference read
    these live in every _pfb_xcorr call, effex.py:497-527; storage-only
    mutation would silently desync compute)."""

    def test_nbins_mutation_changes_output_shape(self):
        cor = make_cor(mode="SPECTRUM")
        cor.nbins = 2**9
        assert cor.engine.cfg.nbins == 2**9
        iq, delays, history = cor.engine.example_inputs(seed=3)
        vis, _ = cor.engine.step(iq, delays, history)
        assert vis.shape == (1, 2**9)
        assert cor.history.shape == (2, cor.config.ntaps - 1, 2**9)
        cor.close()

    def test_num_samp_mutation_resizes_rings(self):
        cor = make_cor()
        cor.num_samp = 2**13
        assert cor.config.num_samp == 2**13
        assert cor.bufs[0].block_shape == (2**13,)
        iq, delays, history = cor.engine.example_inputs(seed=3)
        assert iq.shape[-1] == 2**13
        cor.close()

    def test_num_samp_mutation_after_start_raises(self):
        cor = make_cor()
        cor.feeder = object()  # simulate streaming started
        with pytest.raises(RuntimeError):
            cor.num_samp = 2**13
        cor.feeder = None
        cor.close()

    def test_mode_mutation_switches_reduction(self):
        cor = make_cor(mode="SPECTRUM")
        cor.mode = "CONTINUUM"
        iq, delays, history = cor.engine.example_inputs(seed=3)
        vis, _ = cor.engine.step(iq, delays, history)
        assert vis.shape == (1,)  # continuum scalar per baseline
        cor.close()

    def test_frequency_mutation_changes_fstc(self):
        cor = make_cor(mode="SPECTRUM")
        iq, delays, history = cor.engine.example_inputs(seed=3)
        d = np.asarray([0.0, 1e-7], np.float32)
        v1, _ = cor.engine.step(iq, d, history)
        cor.frequency = 1.2e9
        v2, _ = cor.engine.step(iq, d, history)
        from fxtpu.ops.cplx import to_complex
        assert not np.allclose(to_complex(v1), to_complex(v2))
        cor.close()

    def test_noop_mutation_keeps_engine(self):
        cor = make_cor()
        eng = cor.engine
        cor.nbins = cor.nbins
        assert cor.engine is eng
        cor.close()

    def test_invalid_mutation_raises(self):
        # shrinking num_samp below one full PFB window must fail loudly
        cor = make_cor(num_samp=2**14, nbins=2**10, ntaps=4)
        with pytest.raises(ValueError):
            cor.num_samp = 2**10
        cor.close()


def test_complex128_dtype_rejected():
    """The dtype knob must not silently lie: the device step is single
    precision, so complex128 raises and points to the float64 reference."""
    with pytest.raises(ValueError, match="fxtpu.reference"):
        CorrelatorConfig(dtype="complex128")


def test_kbd_thread_reads_stdin_through_a_real_tty(monkeypatch):
    """The live keyboard path (`Correlator._get_kbd`): startup spawns it
    only when stdin IS a tty (`correlator.py` keyboard gate), so the
    suite normally injects into kbd_queue directly and the actual
    stdin-reader thread never runs.  Here a pty
    makes stdin a real tty: the thread must deliver the typed character
    (char + return, as the startup banner instructs — the pty is in
    canonical mode) and exit once the state leaves the listening set."""
    import os
    import pty
    import queue
    import sys
    import threading

    master, slave = pty.openpty()
    fake_stdin = os.fdopen(slave, "r")
    assert fake_stdin.isatty()         # the premise of the launch gate
    monkeypatch.setattr(sys, "stdin", fake_stdin)

    class _Shell:                      # just the attribute _get_kbd reads
        state = "RUN"

    shell = _Shell()
    kq = queue.Queue(4)
    th = threading.Thread(target=Correlator._get_kbd,
                          args=(shell, kq), daemon=True)
    th.start()

    os.write(master, b"c\n")           # the recalibration keystroke
    assert kq.get(timeout=10) == "c"

    shell.state = "SHUTDOWN"
    os.write(master, b"x\n")           # unblock any read in flight
    th.join(timeout=10)
    alive = th.is_alive()
    os.close(master)                   # EOF to the slave side
    assert not alive
    # nothing past the state change beyond the reads already in flight
    leftovers = []
    while not kq.empty():
        leftovers.append(kq.get_nowait())
    assert set(leftovers) <= {"\n", "x"}
