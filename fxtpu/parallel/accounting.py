"""Per-block collective-volume accounting for the sharded FX step.

Scaling across cards cannot be judged from one card's numbers, but the
thing that predicts it can be PROVEN: the bytes each block moves between
devices.  This module gives both sides of that proof:

  * :func:`predicted_volume` — the analytic per-block payload model from
    the sharded-step design (`parallel/sharded.py`):

      - halo ``ppermute``: the stacked ``[2, nch, ntaps-1, nbins]`` tail,
      - psums: the integrated ``[nbl, nbins/F]`` product + the stream
        tail + the DC-removal mean,
      - corner turn ``all_to_all`` (F>1): the full local spectra
        ``[2, nch, S/n, nbins]`` — O(num_samp) per device.

  * :func:`measured_volume` — the same numbers read back from the ACTUAL
    compiled executable: lower + compile the jitted step, parse every
    collective op (all-reduce / collective-permute / all-to-all /
    all-gather / reduce-scatter, sync or async-start form) and sum each
    op's result payload bytes.

`tests/test_accounting.py` asserts they agree, so the volume model is
checked against what XLA actually emits, not just stated.  The reference
has no distributed execution at all (its transport is single-host
multiprocessing queues, ``/root/reference/effex/effex.py:105-106``).

Payload convention: bytes of each collective's RESULT array(s) — the
per-device payload the transfer delivers (compiled HLO text carries
shapes only on results; operands print as bare %names).  Async forms
count once: `-done` lines never match (no '(' directly after the op
token), and the `-start` result tuples of collective-permute/all-to-all
— `(operand-alias, result, u32[] contexts...)` — are halved after
dropping the scalar context tokens, per their documented HLO shape.
Not wire bytes — those depend on the algorithms NCCL picks per topology.
"""

from __future__ import annotations

import re
from typing import Dict

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_OPS = ("all-reduce", "collective-permute", "all-to-all", "all-gather",
        "reduce-scatter")

# the op token in instruction position, sync or async-start ('-done('
# fails the trailing-paren match, so completions never double-count)
_LINE_RE = re.compile(r"\s(" + "|".join(_OPS) + r")(-start)?\(")
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue  # replica_groups=[..], layout annotations, etc.
        if not dims:
            continue  # u32[] context tokens on async ops, not payload
        n = 1
        for d in dims.split(","):
            n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def measured_volume(step, *example_args) -> Dict[str, int]:
    """Compile ``step`` (a jitted callable) on its example args and return
    per-collective-op result-payload bytes, summed over the program."""
    return hlo_volume(step.lower(*example_args).compile().as_text())


def collective_lines(hlo: str):
    """The (op, line) pairs of every collective instruction in compiled
    HLO text, sync or async-start form."""
    for line in hlo.splitlines():
        m = _LINE_RE.search(line)
        if m and " = " in line[: m.start() + 1]:
            yield m, line


def hlo_volume(hlo: str) -> Dict[str, int]:
    """Per-collective-op result-payload bytes of compiled HLO text."""
    out = {op: 0 for op in _OPS}
    for m, line in collective_lines(hlo):
        # the result shape(s): between ' = ' and the op token.  Dtype-
        # prefixed brackets only — layout tiles, replica_groups=[1,8] and
        # u32[] context tokens all fail _shape_bytes's filter
        seg = line[: m.start()].split(" = ", 1)[1]
        nbytes = _shape_bytes(seg)
        if m.group(2):
            if m.group(1) in ("collective-permute", "all-to-all"):
                # async-start tuple = (operand alias, result, ..) with
                # operand size == result size for these two ops — halve
                nbytes //= 2
            elif m.group(1) != "all-reduce":
                # all-reduce-start's result is its output (a tuple of
                # outputs when XLA combined several); all-gather and
                # reduce-scatter -start tuples mix operand and result
                # sizes, so halving would be silently wrong — fail loudly
                raise NotImplementedError(
                    f"async {m.group(1)}-start in compiled HLO: the "
                    "operand/result tuple sizes differ for this op — "
                    "extend hlo_volume to subtract the operand alias "
                    "instead of halving")
        out[m.group(1)] += nbytes
    return out


def predicted_volume(*, nch: int, nbl: int, nbins: int, num_samp: int,
                     ntaps: int, mesh_time: int, mesh_freq: int,
                     continuum: bool = False) -> Dict[str, int]:
    """Analytic per-block collective payload (bytes) of the sharded step.

    Mirrors `parallel/sharded.py` op by op; see the test for the
    measured-equals-predicted assertion."""
    n = mesh_time * mesh_freq
    halo = ntaps - 1
    s_rows = num_samp // nbins
    f32 = 4
    out = {op: 0 for op in _OPS}
    if n == 1:
        return out
    # stacked-planes tail [2, nch, halo, nbins]
    tail = 2 * nch * halo * nbins * f32
    out["collective-permute"] = tail if ntaps > 1 else 0
    # DC-removal mean over the sample-sharded block [2, nch]
    # + pmean of the integrated product [2, nbl, nbins/F]
    # + the stream-tail handoff psum
    out["all-reduce"] = (2 * nch * f32
                         + (2 * nbl * (nbins // mesh_freq) * f32
                            if mesh_time > 1 else 0)
                         + (tail if ntaps > 1 else 0))
    if mesh_freq > 1:
        # corner turn: each device's FULL local spectra block
        # [2, nch, s_rows/n, nbins] — O(num_samp), the scaling wall
        out["all-to-all"] = 2 * nch * (s_rows // n) * nbins * f32
        # fftshift of the bin-sharded output: a halves swap across
        # the freq axis [2, nbl, nbins/F]
        out["collective-permute"] += 2 * nbl * (nbins // mesh_freq) * f32
        if continuum:
            # the bin mean of the bin-sharded product [2, nbl]
            out["all-reduce"] += 2 * nbl * f32
    return out


#: NOMINAL per-card, one-direction NVLink bandwidth (bytes/s) by
#: ``device_kind`` substring — the denominator of the collective-time
#: model.  H100 SXM: 900 GB/s of NVLink to the other cards of the host,
#: 450 GB/s each way (NVIDIA H100 data sheet).  A published rate, not a
#: measurement; no program reaches it.
LINK_BW = {"H100": 450e9}


def link_bandwidth(device_kind: str) -> float:
    """Nominal one-direction NVLink rate of a card; raises for a card the
    table does not list (no rate is assumed)."""
    for key, bw in LINK_BW.items():
        if key.lower() in device_kind.lower():
            return bw
    raise KeyError(f"no NVLink rate known for device {device_kind!r}; "
                   f"known: {sorted(LINK_BW)}")


def predicted_collective_time(volumes: Dict[str, int], n_shards: int,
                              link_bw: float) -> float:
    """Seconds to move one step's collective payload among ``n_shards``
    cards of one host joined all to all through NVSwitch, each card
    injecting at most ``link_bw`` bytes/s in each direction.

    Through a switch no transfer crosses an intermediate card, so every
    pattern is bound by each card's own injection rate: a permute sends
    its payload once (bytes/BW); an all-to-all sends the (n-1)/n of its
    payload bound for the other cards concurrently; all-gather and
    reduce-scatter move (n-1)/n; an all-reduce, as the ring (or
    reduce-scatter + all-gather) NCCL runs, 2(n-1)/n.  No-overlap model —
    compute/collective overlap only helps, so the efficiency this
    predicts is a LOWER bound given the volumes."""
    if n_shards <= 1:
        return 0.0
    frac = (n_shards - 1) / n_shards
    t = volumes.get("collective-permute", 0) / link_bw
    t += 2 * frac * volumes.get("all-reduce", 0) / link_bw
    t += frac * volumes.get("all-to-all", 0) / link_bw
    t += frac * (volumes.get("all-gather", 0)
                 + volumes.get("reduce-scatter", 0)) / link_bw
    return t


def predicted_scaling_efficiency(*, samples_per_s_single: float, nch: int,
                                 nbl: int, nbins: int, num_samp: int,
                                 ntaps: int, n_shards: int,
                                 device_kind: str, mesh_freq: int = 1,
                                 continuum: bool = False) -> dict:
    """The byte accounting turned into a time prediction: given a MEASURED
    single-card rate, predict the n-card scaling efficiency of the
    frame-sharded per-block step at the nominal NVLink rate.

      eff = t_comp/n / (t_comp/n + t_coll)

    Returns the per-block compute/collective times and the efficiency."""
    t_comp = nch * num_samp / samples_per_s_single
    vols = predicted_volume(nch=nch, nbl=nbl, nbins=nbins,
                            num_samp=num_samp, ntaps=ntaps,
                            mesh_time=n_shards // mesh_freq,
                            mesh_freq=mesh_freq, continuum=continuum)
    t_coll = predicted_collective_time(vols, n_shards,
                                       link_bandwidth(device_kind))
    t_shard = t_comp / n_shards
    return {
        "per_block_compute_s": t_shard,
        "per_block_collective_s": t_coll,
        "volumes": vols,
        "efficiency": t_shard / (t_shard + t_coll) if t_coll else 1.0,
        "aggregate_samples_per_s":
            nch * num_samp / (t_shard + t_coll),
    }
